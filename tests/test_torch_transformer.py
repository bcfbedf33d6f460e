"""The port's Transformer (`paddle_tpu_torch/models/transformer.py`) on the
CPU, held against the JAX package's.

- Programs op by op: `build_transformer` + Adam (and its startup
  Program, with the sinusoid table's `assign_value`), equal to the JAX
  ones (types, slots, var names, attrs) with weight sharing on and off,
  the fused attention op in bshd and bhsd and the unfused path, is_test,
  the encode program, the decode step with and without `reuse_cross_kv`,
  and bf16 AMP. Equal names give equal dropout masks.
- `TransformerConfig.tiny()` with dropout 0.1 (b 2, s 16, padded source
  and target), 3 Adam steps on one batch from the JAX startup state: fp32
  losses within rtol 1e-5, every persistable within atol 1e-5; under bf16
  AMP each loss within one bf16 ulp (2^-8 relative) of the JAX loss or of
  the port's same step with every matmul summed in float64 and rounded
  once (XLA's excess precision on the CPU skips roundings the lowerings
  ask for: ROADMAP Queue 3). The JAX side runs its Pallas kernels in
  interpret mode with PADDLE_TPU_SHORT_ATTN=bshd.
- Incremental decode (`tests/test_decoding.py:269-374` there): the decode
  step's logits, fed the encode program's cross K / V, equal the full
  is_test graph's within rtol 1e-5, atol 1e-6, as does the step that
  projects the fed encoder output again; the step has 4 ops a layer fewer
  and bumps `profiler`'s `cross_kv_reuse` once a layer. The full is_test
  logits agree with the JAX package's on the same weights.
- `assign_value` (`layers.assign` of an array, `NumpyArrayInitializer`)
  against the JAX ops.

The `gpu` test (`python -m pytest -m gpu --noconftest
tests/test_torch_transformer.py` on the card) runs Transformer-tiny's
steps on the card against the CPU."""

import importlib
import json

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.ops.kernels import CAUSAL_LAUNCHES, LAUNCHES
from paddle_tpu_torch.scope import to_numpy

B, S = 2, 16
STEPS = 3
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_ULP = 2.0**-8


def _jax():
    import paddle_tpu as jfluid
    from paddle_tpu.models import transformer as jtf

    return jfluid, jtf


def _tf(fluid):
    return importlib.import_module(fluid.__name__ + ".models.transformer")


def _config(tf, cfg_kw, layout):
    """tiny() with `cfg_kw`; the port takes the layout as an argument, the
    JAX config reads it from PADDLE_TPU_ATTN_LAYOUT (set by the caller)."""
    cfg = tf.TransformerConfig.tiny()
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    if tf.__name__.startswith("paddle_tpu_torch"):
        cfg.attn_layout = layout
    return cfg


def _program(fluid, kind, cfg_kw=None, layout="bshd", amp=None):
    """-> (main, startup, handles) of `kind`: train, test, encode, step or
    step_naive; train runs Adam(1e-3), under mixed_precision.decorate when
    `amp` is a dict."""
    tf = _tf(fluid)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        cfg = _config(tf, cfg_kw or {}, layout)
        if kind in ("train", "test"):
            h = tf.build_transformer(cfg, B, S, S, is_test=kind == "test")
        elif kind == "encode":
            h = tf.build_transformer_encode(cfg, B, S)
        else:
            h = tf.build_transformer_decode_step(cfg, B, S, S,
                                                 reuse_cross_kv=kind == "step")
        if kind == "train":
            opt = fluid.optimizer.Adam(1e-3)
            if amp is not None:
                mp = importlib.import_module(fluid.__name__ + ".contrib.mixed_precision")
                opt = mp.decorate(opt, **amp)
            opt.minimize(h["loss"])
    return main, startup, h


PROGRAM_CASES = {
    "train": ("train", {}, "bshd", None),
    "train-unshared": ("train", dict(weight_sharing=False), "bshd", None),
    "train-unfused": ("train", dict(use_flash_attention=False), "bshd", None),
    "train-bhsd": ("train", {}, "bhsd", None),
    "test": ("test", {}, "bshd", None),
    "test-unfused": ("test", dict(use_flash_attention=False), "bshd", None),
    "encode": ("encode", {}, "bshd", None),
    "encode-unfused": ("encode", dict(use_flash_attention=False), "bshd", None),
    "step": ("step", {}, "bshd", None),
    "step-naive": ("step_naive", {}, "bshd", None),
    "step-unfused-unshared": ("step", dict(use_flash_attention=False, weight_sharing=False),
                              "bshd", None),
    "amp-bf16": ("train", {}, "bshd", {}),
    "amp-bf16-dynamic": ("train", {}, "bshd", dict(use_dynamic_loss_scaling=True)),
}


@pytest.mark.parametrize("name", sorted(PROGRAM_CASES))
def test_transformer_programs_equal_jax_op_by_op(name, monkeypatch):
    kind, cfg_kw, layout, amp = PROGRAM_CASES[name]
    jfluid, _ = _jax()
    monkeypatch.setenv("PADDLE_TPU_ATTN_LAYOUT", layout)
    jmain, jstartup, jh = _program(jfluid, kind, cfg_kw, layout, amp)
    tmain, tstartup, th = _program(tfluid, kind, cfg_kw, layout, amp)
    assert jh["feeds"] == th["feeds"]
    for jp, tp in ((jmain, tmain), (jstartup, tstartup)):
        jd, td = jp.to_dict(), tp.to_dict()
        jops, tops = jd["blocks"][0]["ops"], td["blocks"][0]["ops"]
        assert [o["type"] for o in jops] == [o["type"] for o in tops]
        for jo, to in zip(jops, tops):
            assert jo == to, jo["type"]
        assert json.dumps(jd, sort_keys=True) == json.dumps(td, sort_keys=True)
    ops = tmain.global_block().ops
    attn = [op for op in ops if op.type == "fused_multihead_attention"]
    n = 2  # tiny(): 2 encoder and 2 decoder layers
    encoder, decoder = kind in ("train", "test", "encode"), kind != "encode"
    if cfg_kw.get("use_flash_attention", True):  # causal: the decoder's self-attention
        assert len(attn) == n * encoder + 2 * n * decoder
        assert all(op.attr("layout") == layout for op in attn)
        assert sum(op.attr("causal") for op in attn) == n * decoder
    else:  # the causal triangle as an assign_value
        assert not attn
        assert ("assign_value" in [op.type for op in ops]) == decoder
    # the sinusoid tables of the programs' embeddings
    assert [op.type for op in tstartup.global_block().ops].count("assign_value") == (
        encoder + decoder)


def _feed(cfg, seed=0):
    """Random ids; source and target padded past a random length of at
    least half the row (the masks' zeros make the key biases live)."""
    rs = np.random.RandomState(seed)
    pos = np.tile(np.arange(S, dtype=np.int64), (B, 1))

    def mask():
        lengths = rs.randint(S // 2, S + 1, size=B)
        return (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)

    return {
        "src_ids": rs.randint(1, cfg["src_vocab"], (B, S)).astype(np.int64),
        "trg_ids": rs.randint(1, cfg["trg_vocab"], (B, S)).astype(np.int64),
        "lbl_ids": rs.randint(1, cfg["trg_vocab"], (B, S)).astype(np.int64),
        "src_mask": mask(),
        "trg_mask": mask(),
        f"src_emb_posids_{S}": pos,
        f"trg_emb_posids_{S}": pos,
    }


TINY_VOCAB = dict(src_vocab=200, trg_vocab=200)
TRAIN_CASES = {"fused": {}, "unfused": dict(use_flash_attention=False)}


def _jax_state_and_steps(cfg_kw, monkeypatch, feed, amp=None):
    """The JAX startup state, then its STEPS steps -> (state0, losses,
    persistables)."""
    jfluid, _ = _jax()
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_SHORT_ATTN", "bshd")
    if not cfg_kw.get("use_flash_attention", True):
        # the JAX package's IR verifier (on under its tests) refuses its
        # own unfused decoder: trg_pad [b, 1, 1, t] + the causal triangle
        # [1, 1, t, t] declares [b, 1, 1, t] and gives [b, 1, t, t]
        # (ROADMAP Queue 3); the lowering broadcasts, so run it unverified
        monkeypatch.setenv("PADDLE_TPU_VERIFY", "0")
    main, startup, h = _program(jfluid, "train", cfg_kw, amp=amp)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    state0 = {n: np.asarray(scope.get(n)) for n in names}
    losses = [float(np.asarray(exe.run(main, feed=dict(feed), fetch_list=[h["loss"]],
                                       scope=scope)[0]).reshape(-1)[0]) for _ in range(STEPS)]
    return state0, losses, {n: np.asarray(scope.get(n)) for n in names}


def _port_steps(cfg_kw, state, feed, place=None, amp=None):
    """The port's STEPS steps from `state` (None: its own startup) ->
    (losses, persistables)."""
    main, startup, h = _program(tfluid, "train", cfg_kw, amp=amp)
    place = place or tfluid.CPUPlace()
    scope = tfluid.Scope()
    exe = tfluid.Executor(place)
    exe.run(startup, scope=scope)
    if state is not None:
        tfluid.io.set_persistables_from_numpy(scope, state, exe.device)
    losses = [float(np.asarray(exe.run(main, feed=dict(feed), fetch_list=[h["loss"]],
                                       scope=scope)[0]).reshape(-1)[0]) for _ in range(STEPS)]
    names = [v.name for v in main.list_vars() if v.persistable]
    return losses, {n: to_numpy(scope.get(n)) for n in names if scope.has(n)}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_transformer_tiny_trains_like_jax(case, monkeypatch):
    cfg_kw = TRAIN_CASES[case]
    feed = _feed(TINY_VOCAB)
    state0, jl, js = _jax_state_and_steps(cfg_kw, monkeypatch, feed)
    launches = dict(LAUNCHES)
    tl, ts = _port_steps(cfg_kw, state0, feed)
    assert LAUNCHES == launches  # the CPU runs the plain versions
    assert sorted(ts) == sorted(js)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    for n in js:
        np.testing.assert_allclose(ts[n], js[n], err_msg=n, **TOL)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]


def _float64_matmuls():
    """torch.matmul summed in float64 and rounded once to its inputs'
    dtype, for the step's duration."""
    matmul = torch.matmul

    def mm(x, y):
        return matmul(x.double(), y.double()).to(torch.promote_types(x.dtype, y.dtype))

    return mm


def test_transformer_tiny_bf16_amp_trains_like_jax(monkeypatch):
    """bench.py's recipe in small: Adam under mixed_precision.decorate in
    bf16 (no loss scaling): each loss within one bf16 ulp of the JAX loss
    or of the float64-matmul step; fp32 master weights, finite."""
    amp = {}
    feed = _feed(TINY_VOCAB)
    state0, jl, js = _jax_state_and_steps({}, monkeypatch, feed, amp=amp)
    tl, ts = _port_steps({}, state0, feed, amp=amp)
    with monkeypatch.context() as m:
        m.setattr(torch, "matmul", _float64_matmuls())
        fl, _ = _port_steps({}, state0, feed, amp=amp)
    for t, j, f in zip(tl, jl, fl):
        assert min(abs(t - j), abs(t - f)) <= BF16_ULP * abs(t), (tl, jl, fl)
    assert sorted(ts) == sorted(js)
    for n, v in ts.items():
        if v.dtype.kind == "f":
            assert v.dtype == np.float32 and np.isfinite(v).all(), n
    assert tl[-1] < tl[0]


def _run(fluid, main, feed, fetch, scope):
    exe = fluid.Executor(fluid.CPUPlace())
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


def test_decode_step_reuses_cross_kv_projection():
    """The encode program once, then the decode step fed its cross K / V:
    logits equal to the full is_test graph's and to the step that projects
    the fed encoder output again; 4 ops a layer fewer; the counter bumped
    once a layer."""
    from paddle_tpu_torch import profiler

    cfg_kw = dict(src_vocab=32, trg_vocab=32, d_model=16, n_heads=2, d_ff=32, n_layers=2,
                  max_len=16, dropout=0.1)
    full_main, full_start, h_full = _program(tfluid, "test", cfg_kw)
    enc_main, _, h_enc = _program(tfluid, "encode", cfg_kw)
    naive_main, _, h_naive = _program(tfluid, "step_naive", cfg_kw)
    before = profiler.counters().get("cross_kv_reuse", 0)
    step_main, _, h_step = _program(tfluid, "step", cfg_kw)
    assert profiler.counters().get("cross_kv_reuse", 0) == before + cfg_kw["n_layers"]
    n_naive = len(naive_main.global_block().ops)
    n_reuse = len(step_main.global_block().ops)
    assert n_naive - n_reuse == 4 * cfg_kw["n_layers"], (n_naive, n_reuse)

    rng = np.random.RandomState(3)
    pos = np.tile(np.arange(S), (B, 1)).astype("int64")
    src = rng.randint(1, 32, (B, S)).astype("int64")
    trg = rng.randint(1, 32, (B, S)).astype("int64")
    ones = np.ones((B, S), "float32")
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(full_start, scope=scope)
    feed_full = {"src_ids": src, "trg_ids": trg, "lbl_ids": trg, "src_mask": ones,
                 "trg_mask": ones, h_full["src_pos_name"]: pos, h_full["trg_pos_name"]: pos}
    (ref_logits,) = _run(tfluid, full_main, feed_full, [h_full["logits"]], scope)
    kv_names = [n for pair in h_enc["cross_kv_names"] for n in pair]
    enc_out = _run(tfluid, enc_main, {"src_ids": src, "src_mask": ones,
                                      h_enc["src_pos_name"]: pos},
                   [h_enc["enc"].name] + kv_names, scope)
    enc_val, kv_vals = enc_out[0], enc_out[1:]
    feed_step = {"trg_ids": trg, "src_mask": ones, "trg_mask": ones,
                 h_step["trg_pos_name"]: pos}
    for i in range(cfg_kw["n_layers"]):
        feed_step[f"dec{i}.cross.k_cached"] = np.asarray(kv_vals[2 * i])
        feed_step[f"dec{i}.cross.v_cached"] = np.asarray(kv_vals[2 * i + 1])
    (reuse_logits,) = _run(tfluid, step_main, feed_step, [h_step["logits"]], scope)
    feed_naive = {"trg_ids": trg, "src_mask": ones, "trg_mask": ones,
                  "enc_out": np.asarray(enc_val), h_naive["trg_pos_name"]: pos}
    (naive_logits,) = _run(tfluid, naive_main, feed_naive, [h_naive["logits"]], scope)
    np.testing.assert_allclose(reuse_logits, naive_logits, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(reuse_logits, ref_logits, rtol=1e-5, atol=1e-6)

    # the full is_test logits against the JAX package's, on the same weights
    jfluid, _ = _jax()
    jmain, jstart, jh = _program(jfluid, "test", cfg_kw)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=jscope)
    state = {v.name: np.asarray(jscope.get(v.name)) for v in jmain.list_vars()
             if v.persistable}
    (j_logits,) = _run(jfluid, jmain, dict(feed_full), [jh["logits"]], jscope)
    tfluid.io.set_persistables_from_numpy(scope, state, "cpu")
    (t_logits,) = _run(tfluid, full_main, dict(feed_full), [h_full["logits"]], scope)
    np.testing.assert_allclose(t_logits, np.asarray(j_logits), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("value, dtype", [
    (np.arange(12, dtype=np.float32).reshape(3, 4) / 7, "float32"),
    (np.arange(-3, 3, dtype=np.int32).reshape(2, 3), "int32"),
    (np.arange(5, dtype=np.int64), "int64"),
])
def test_assign_value_and_numpy_initializer_match_jax(value, dtype):
    """layers.assign of an array (assign_value in the main program) and a
    parameter filled by NumpyArrayInitializer (assign_value in the startup
    program) against the JAX ops on the same Programs."""
    jfluid, _ = _jax()
    outs = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            got = fluid.layers.assign(value)
            fetch = [got]
            if dtype == "float32":
                init = importlib.import_module(fluid.__name__ + ".initializer")
                helper = importlib.import_module(fluid.__name__ + ".layer_helper")
                table = helper.LayerHelper("table").create_parameter(
                    fluid.ParamAttr(name="table",
                                    initializer=init.NumpyArrayInitializer(value * 3)),
                    list(value.shape), "float32")
                fetch.append(fluid.layers.scale(table, scale=1.0))
        assert [op.type for op in main.global_block().ops][0] == "assign_value"
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        outs.append([np.asarray(o) for o in exe.run(main, feed={}, fetch_list=fetch,
                                                     scope=scope)])
        outs[-1].append((main.to_dict(), startup.to_dict()))
    (j, t) = outs
    assert json.dumps(j[-1], sort_keys=True) == json.dumps(t[-1], sort_keys=True)
    for a, b in zip(j[:-1], t[:-1]):
        assert a.shape == b.shape
        np.testing.assert_array_equal(b, a.astype(b.dtype))
    np.testing.assert_array_equal(t[0], value)


def test_elementwise_add_grad_sums_a_broadcast_x():
    """X [2, 1, 1, 4] + Y [1, 1, 4, 4] (the unfused decoder's padding bias
    plus its causal triangle): both grads summed down to their inputs'
    shapes, held against numpy. The JAX lowering passes X's cotangent
    through unreduced (ROADMAP Queue 3); its dead-op pass drops that grad
    in the Transformer, so no JAX run is the reference here."""
    rs = np.random.RandomState(0)
    xv, yv, gv = (rs.randn(*s).astype(np.float32) for s in
                  ((2, 1, 1, 4), (1, 1, 4, 4), (2, 1, 4, 4)))
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [2, 1, 1, 4], append_batch_size=False,
                               stop_gradient=False)
        y = tfluid.layers.data("y", [1, 1, 4, 4], append_batch_size=False,
                               stop_gradient=False)
        g = tfluid.layers.data("g", [2, 1, 4, 4], append_batch_size=False)
        out = tfluid.layers.elementwise_add(x, y)
        tfluid.append_backward(tfluid.layers.reduce_sum(tfluid.layers.elementwise_mul(out, g)))
    dx, dy = _run(tfluid, main, {"x": xv, "y": yv, "g": gv}, ["x@GRAD", "y@GRAD"],
                  tfluid.Scope())
    np.testing.assert_allclose(dx, gv.sum(axis=2, keepdims=True), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dy, gv.sum(axis=0, keepdims=True), rtol=1e-6, atol=1e-6)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_transformer.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_transformer_tiny_trains_like_cpu(cuda_device):
    """Transformer-tiny, 3 steps on the card through the kernels (each step
    launches 6 short forward, 2 of them causal, 6 short backward and 10
    LayerNorm backward kernels) against the same 3 steps on the CPU from
    the card's startup state: losses rtol 1e-5, persistables atol 1e-5."""
    feed = _feed(TINY_VOCAB)
    main, startup, _ = _program(tfluid, "train", {})
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CUDAPlace(0)).run(startup, scope=scope)
    state0 = {v.name: to_numpy(scope.get(v.name)) for v in main.list_vars()
              if v.persistable and scope.has(v.name)}
    before, causal_before = dict(LAUNCHES), dict(CAUSAL_LAUNCHES)
    gl, gs = _port_steps({}, state0, feed, place=tfluid.CUDAPlace(0))
    torch.cuda.synchronize()
    per_step = {n: (LAUNCHES[n] - before[n]) / STEPS for n in LAUNCHES}
    assert per_step == dict({n: 0 for n in LAUNCHES}, mha_short_fwd=6, mha_short_bwd=6,
                            layer_norm_bwd=10)
    causal = {n: (CAUSAL_LAUNCHES[n] - causal_before[n]) / STEPS for n in CAUSAL_LAUNCHES}
    assert causal == dict({n: 0 for n in CAUSAL_LAUNCHES}, mha_short_fwd=2, mha_short_bwd=2)
    cl, cs = _port_steps({}, state0, feed)
    np.testing.assert_allclose(gl, cl, rtol=1e-5, atol=0)
    for n in cs:
        np.testing.assert_allclose(gs[n], cs[n], err_msg=n, atol=1e-5, rtol=1e-5)
