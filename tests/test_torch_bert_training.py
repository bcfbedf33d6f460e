"""The training slice on the CPU, held against the JAX package.

- Each lowering the BERT pretrain step adds, and its grad, through both
  packages' Executors: the same tiny Program built with each package's
  layers, the same numpy inputs, `gradients(out, inputs, cotangent)`.
  This covers the lowerings of full pretraining too, and square and
  reduce_mean (over everything and over dims): transpose2, split
  (the parts' cotangents concatenated back), slice (zero-padded), tanh,
  sqrt, sign, elementwise_max, clip, clip_by_norm (clipped, kept and at
  a zero norm), squared_l2_norm, square_error_cost, fill_constant's
  str_value, check_finite_and_unscale (finite, with an inf, with a nan:
  zeros by selection) and update_loss_scaling over a scripted run of
  found_inf that closes both windows.
- The port's `build_bert_pretrain` + `Adam.minimize` Program equals the
  JAX one op by op (types, slots, var names, attrs): `rng_for` hashes the
  names, so equal names are what makes the dropout masks equal.
- BERT-tiny (b 2, s 32, max_preds 5) trains 3 steps from the JAX startup
  state copied in by name, with dropout 0.1 and with dropout 0. The JAX
  side runs its Pallas attention kernels in interpret mode
  (PADDLE_TPU_PALLAS_INTERPRET=1, PADDLE_TPU_SHORT_ATTN=bshd): its plain
  attention path draws a different dropout mask from its kernels.

Tolerances: op outputs and grads atol 1e-5 / rtol 1e-5 (fp32 summation
order); the BERT-tiny losses rtol 1e-5 and every persistable atol 1e-5
after 3 Adam steps (measured: losses equal, persistables within 1e-7).
The `gpu` test runs the same 3 steps on the card and on the CPU
(`python -m pytest -m gpu --noconftest tests/test_torch_bert_training.py`)."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain
from paddle_tpu_torch.ops.kernels import LAUNCHES
from paddle_tpu_torch.scope import to_numpy

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)
B, S, P = 2, 32, 5
TOL = dict(atol=1e-5, rtol=1e-5)


def _programs(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetch = build(fluid)
    return main, startup, fetch


def _run_op_case(build, feed):
    """Build with each package, run one step on the CPU -> [jax, port]
    lists of fetched numpy arrays."""
    import paddle_tpu as jfluid

    results = []
    for fluid in (jfluid, tfluid):
        main, startup, fetch = _programs(fluid, build)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        results.append([np.asarray(a) for a in exe.run(
            main, feed=dict(feed), fetch_list=fetch, scope=scope)])
    return results


def _data(fluid, name, shape, dtype="float32", grad=True):
    return fluid.layers.data(name, shape, dtype=dtype, append_batch_size=False,
                             stop_gradient=not grad)


def _with_grads(fluid, out, inputs):
    """[out] + d(out . g)/d(inputs) for the fed cotangent g."""
    g = _data(fluid, "g", list(out.shape), grad=False)
    return [out] + fluid.gradients([out], inputs, target_gradients=[g])


RS = np.random.RandomState(3)
X345 = RS.randn(3, 4, 5).astype(np.float32)
Y45 = (RS.rand(4, 5) + 0.5).astype(np.float32)
Y4 = (RS.rand(4) + 0.5).astype(np.float32)
G345 = RS.randn(3, 4, 5).astype(np.float32)


def _binary(op, yshape, axis):
    def build(fluid):
        x = _data(fluid, "x", [3, 4, 5])
        y = _data(fluid, "y", yshape)
        return _with_grads(fluid, getattr(fluid.layers, op)(x, y, axis=axis), [x, y])
    return build


def _matmul(fluid):
    x = _data(fluid, "x", [2, 3, 4])
    y = _data(fluid, "y", [5, 4])
    return _with_grads(fluid, fluid.layers.matmul(x, y, transpose_y=True, alpha=0.5),
                       [x, y])


def _sums(fluid):
    xs = [_data(fluid, n, [3, 4, 5]) for n in ("x", "y", "z")]
    return _with_grads(fluid, fluid.layers.sums(xs), xs)


def _reduce_sum_all(fluid):
    x = _data(fluid, "x", [3, 4, 5])
    return _with_grads(fluid, fluid.layers.reduce_sum(x), [x])


def _reduce_sum_dim(fluid):
    x = _data(fluid, "x", [3, 4, 5])
    return _with_grads(fluid, fluid.layers.reduce_sum(x, dim=[1], keep_dim=True), [x])


def _reduce_mean_all(fluid):
    x = _data(fluid, "x", [3, 4, 5])
    return _with_grads(fluid, fluid.layers.reduce_mean(x), [x])


def _reduce_mean_dim(fluid):
    x = _data(fluid, "x", [3, 4, 5])
    return _with_grads(fluid, fluid.layers.reduce_mean(x, dim=[0, 2]), [x])


def _cumsum(fluid):
    x = _data(fluid, "x", [3, 4, 5])
    ex = fluid.layers.cumsum(x, axis=1, exclusive=True)
    rev = fluid.layers.cumsum(x, axis=0, exclusive=True, reverse=True)
    return _with_grads(fluid, fluid.layers.elementwise_add(ex, rev), [x])


def _gather(fluid):
    x = _data(fluid, "x", [10, 4])
    idx = _data(fluid, "idx", [6], dtype="int64", grad=False)
    return _with_grads(fluid, fluid.layers.gather(x, idx), [x])


def _fill_bsl(fluid):
    ids = _data(fluid, "ids", [7, 3], dtype="int64", grad=False)
    ones = fluid.layers.fill_constant_batch_size_like(ids, shape=[-1, 1], dtype="int64",
                                                      value=1)
    row = fluid.layers.cumsum(ones, axis=0, exclusive=True)
    return [ones, ids + row * 3]


def _dropout(fluid):
    x = _data(fluid, "x", [4, 5, 16])
    out = fluid.layers.dropout(x, 0.3, dropout_implementation="upscale_in_train")
    return _with_grads(fluid, out, [x])


def _dropout_grad_op(fluid, with_mask):
    """x -> dropout (upscale_in_train, 0.3), then a dropout_grad appended as
    a program serialized before mask regeneration holds it: no rng_name
    attr, and the forward's saved Mask as an input when `with_mask`."""
    x = _data(fluid, "x", [4, 5, 16])
    g = _data(fluid, "g", [4, 5, 16], grad=False)
    out = fluid.layers.dropout(x, 0.3, dropout_implementation="upscale_in_train")
    block = fluid.default_main_program().global_block()
    inputs = {"GRAD_Out": [g]}
    if with_mask:
        inputs["Mask"] = [block.var(block.ops[-1].output("Mask")[0])]
    dx = block.create_var(name="dx", shape=[4, 5, 16], dtype="float32")
    block.append_op("dropout_grad", inputs, {"IGRAD_X": [dx]},
                    {"dropout_prob": 0.3, "dropout_implementation": "upscale_in_train"})
    return [out, dx]


def _swce(fluid):
    logits = _data(fluid, "logits", [6, 10])
    label = _data(fluid, "label", [6, 1], dtype="int64", grad=False)
    loss = fluid.layers.softmax_with_cross_entropy(logits, label)
    return _with_grads(fluid, loss, [logits])


def _layer_norm(fluid):
    x = _data(fluid, "x", [3, 4, 16])
    out = fluid.layers.layer_norm(x, begin_norm_axis=2, name="ln")
    block = fluid.default_main_program().global_block()
    return _with_grads(fluid, out, [x, block.var("ln.w_0"), block.var("ln.w_1")])


def _with_grads_multi(fluid, outs, inputs):
    """outs + d(sum_i outs_i . g_i)/d(inputs) for fed cotangents g0, g1, ..."""
    gs = [_data(fluid, f"g{i}", list(o.shape), grad=False) for i, o in enumerate(outs)]
    return list(outs) + fluid.gradients(list(outs), inputs, target_gradients=gs)


def _unary_op(layer, **kw):
    def build(fluid):
        x = _data(fluid, "x", [3, 4, 5])
        out = getattr(fluid.layers, layer)(x, **kw)
        return _with_grads(fluid, out, [x]) if layer != "sign" else [out]
    return build


def _transpose(fluid):
    x = _data(fluid, "x", [3, 4, 5])
    return _with_grads(fluid, fluid.layers.transpose(x, [2, 0, 1]), [x])


def _split(sections):
    def build(fluid):
        x = _data(fluid, "x", [3, 4, 5])
        return _with_grads_multi(fluid, fluid.layers.split(x, sections, dim=-1), [x])
    return build


def _slice(fluid):
    x = _data(fluid, "x", [3, 4, 5])
    out = fluid.layers.slice(x, [1, 2], [1, -4], [3, 100])
    return _with_grads(fluid, out, [x])


def _square_error_cost(fluid):
    x, y = (_data(fluid, n, [3, 4, 5]) for n in ("x", "y"))
    return _with_grads(fluid, fluid.layers.square_error_cost(x, y), [x, y])


def _squared_l2_norm(fluid):
    """The lowering through a hand-appended op, as GradientClipByGlobalNorm
    appends it."""
    x = _data(fluid, "x", [3, 4, 5])
    block = fluid.default_main_program().global_block()
    out = block.create_var(name="sq", shape=(1,), dtype="float32")
    block.append_op("squared_l2_norm", {"X": [x]}, {"Out": [out]}, {})
    return _with_grads(fluid, out, [x])


def _fill_constant_str_value(fluid):
    """str_value, when set, over value (ROADMAP's case)."""
    block = fluid.default_main_program().global_block()
    out = block.create_var(name="c", shape=(2,), dtype="float32")
    block.append_op("fill_constant", {}, {"Out": [out]},
                    {"shape": [2], "value": 0.0, "str_value": "3.5", "dtype": "float32"})
    return [out]


def _check_finite_and_unscale(fluid):
    block = fluid.default_main_program().global_block()
    xs = [_data(fluid, n, [3, 4, 5], grad=False) for n in ("x", "y")]
    scale = _data(fluid, "scale", [1], grad=False)
    outs = [block.create_var(name=f"u{i}", shape=(3, 4, 5), dtype="float32") for i in range(2)]
    found = block.create_var(name="found", shape=(1,), dtype="bool")
    block.append_op("check_finite_and_unscale", {"X": xs, "Scale": [scale]},
                    {"Out": outs, "FoundInfinite": [found]}, {})
    return outs + [found]


# found_inf over eight steps: two finite steps close the growth window
# (incr_every_n_steps 1: the count before the increment exceeds 1), then
# bad steps close the decrease window (decr_every_n_nan_or_inf 1) twice,
# then growth again
FOUND_SEQ = [False, False, False, True, True, True, True, False, False, False]


def _update_loss_scaling(fluid):
    block = fluid.default_main_program().global_block()
    scale = _data(fluid, "scale", [1], grad=False)
    good = _data(fluid, "good", [1], dtype="int32", grad=False)
    bad = _data(fluid, "bad", [1], dtype="int32", grad=False)
    fetch = []
    for i, _ in enumerate(FOUND_SEQ):
        found = _data(fluid, f"f{i}", [1], dtype="bool", grad=False)
        nxt = [block.create_var(name=f"{n}{i}", shape=(1,), dtype=d)
               for n, d in (("s", "float32"), ("gs", "int32"), ("bs", "int32"))]
        block.append_op(
            "update_loss_scaling",
            {"FoundInfinite": [found], "PrevLossScaling": [scale], "InGoodSteps": [good],
             "InBadSteps": [bad]},
            {"LossScalingOut": [nxt[0]], "OutGoodSteps": [nxt[1]], "OutBadSteps": [nxt[2]]},
            {"incr_every_n_steps": 1, "decr_every_n_nan_or_inf": 1, "incr_ratio": 2.0,
             "decr_ratio": 0.5})
        scale, good, bad = nxt
        fetch += nxt
    return fetch


def _poisoned(value):
    x = RS.randn(3, 4, 5).astype(np.float32)
    x[1, 2, 3] = value
    return dict(x=x, y=RS.randn(3, 4, 5).astype(np.float32),
                scale=np.array([1024.0], np.float32))


OP_CASES = {
    "elementwise_mul": (_binary("elementwise_mul", [4, 5], -1), dict(y=Y45, g=G345)),
    "elementwise_div": (_binary("elementwise_div", [4], 1), dict(y=Y4, g=G345)),
    "elementwise_add_grad": (_binary("elementwise_add", [4], 1), dict(y=Y4, g=G345)),
    "matmul": (_matmul, dict(x=RS.randn(2, 3, 4).astype(np.float32),
                             y=RS.randn(5, 4).astype(np.float32),
                             g=RS.randn(2, 3, 5).astype(np.float32))),
    "sum": (_sums, dict(y=2 * X345, z=-X345, g=G345)),
    "reduce_sum": (_reduce_sum_all, dict(g=np.array([1.5], np.float32))),
    "reduce_sum_dim": (_reduce_sum_dim, dict(g=RS.randn(3, 1, 5).astype(np.float32))),
    "cumsum": (_cumsum, dict(g=G345)),
    "gather": (_gather, dict(x=RS.randn(10, 4).astype(np.float32),
                             idx=np.array([3, 0, 9, 3, 3, 7], np.int64),
                             g=RS.randn(6, 4).astype(np.float32))),
    "fill_constant_batch_size_like": (_fill_bsl, dict(
        ids=RS.randint(0, 9, (7, 3)).astype(np.int64))),
    "dropout": (_dropout, dict(x=RS.randn(4, 5, 16).astype(np.float32),
                               g=RS.randn(4, 5, 16).astype(np.float32))),
    "dropout_grad_saved_mask": (lambda fluid: _dropout_grad_op(fluid, True), dict(
        x=RS.randn(4, 5, 16).astype(np.float32), g=RS.randn(4, 5, 16).astype(np.float32))),
    "softmax_with_cross_entropy": (_swce, dict(
        logits=(3 * RS.randn(6, 10)).astype(np.float32),
        label=RS.randint(0, 10, (6, 1)).astype(np.int64),
        g=RS.rand(6, 1).astype(np.float32))),
    "layer_norm_grad": (_layer_norm, dict(x=(2 * RS.randn(3, 4, 16)).astype(np.float32),
                                          g=RS.randn(3, 4, 16).astype(np.float32))),
    "transpose2": (_transpose, dict(g=RS.randn(5, 3, 4).astype(np.float32))),
    "split_num": (_split(5), {f"g{i}": RS.randn(3, 4, 1).astype(np.float32)
                              for i in range(5)}),
    "split_sections": (_split([1, 3, 1]), dict(g0=RS.randn(3, 4, 1).astype(np.float32),
                                               g1=RS.randn(3, 4, 3).astype(np.float32),
                                               g2=RS.randn(3, 4, 1).astype(np.float32))),
    "slice": (_slice, dict(g=RS.randn(3, 2, 4).astype(np.float32))),
    "tanh": (_unary_op("tanh"), dict(g=G345)),
    "sqrt": (_unary_op("sqrt"), dict(x=(RS.rand(3, 4, 5) + 0.1).astype(np.float32), g=G345)),
    "sign": (_unary_op("sign"), dict(x=np.where(RS.rand(3, 4, 5) < 0.2, 0.0, X345)
                                     .astype(np.float32))),
    "elementwise_max": (_binary("elementwise_max", [4, 5], -1),
                        dict(y=RS.randn(4, 5).astype(np.float32), g=G345)),
    "clip": (_unary_op("clip", min=-0.5, max=0.8), dict(g=G345)),
    "clip_by_norm_clipped": (_unary_op("clip_by_norm", max_norm=2.0), dict(g=G345)),
    "clip_by_norm_kept": (_unary_op("clip_by_norm", max_norm=100.0), dict(g=G345)),
    "clip_by_norm_zero": (_unary_op("clip_by_norm", max_norm=1.0),
                          dict(x=np.zeros((3, 4, 5), np.float32), g=G345)),
    "squared_l2_norm": (_squared_l2_norm, dict(g=np.array([0.7], np.float32))),
    "square_error_cost": (_square_error_cost,
                          dict(y=RS.randn(3, 4, 5).astype(np.float32), g=G345)),
    "fill_constant_str_value": (_fill_constant_str_value, {}),
    "check_finite_and_unscale": (_check_finite_and_unscale, dict(
        x=X345, y=RS.randn(3, 4, 5).astype(np.float32), scale=np.array([1024.0], np.float32))),
    "check_finite_and_unscale_inf": (_check_finite_and_unscale, _poisoned(np.inf)),
    "check_finite_and_unscale_nan": (_check_finite_and_unscale, _poisoned(np.nan)),
    "update_loss_scaling": (_update_loss_scaling, dict(
        scale=np.array([8.0], np.float32), good=np.zeros(1, np.int32),
        bad=np.zeros(1, np.int32),
        **{f"f{i}": np.array([f]) for i, f in enumerate(FOUND_SEQ)})),
    "square": (_unary_op("square"), dict(g=G345)),
    "reduce_mean_all": (_reduce_mean_all, dict(g=np.array([0.7], np.float32))),
    "reduce_mean_dim": (_reduce_mean_dim, dict(g=RS.randn(4).astype(np.float32))),
}


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_and_grad_match_jax(name):
    build, feed = OP_CASES[name]
    feed = dict(feed)
    feed.setdefault("x", X345)
    jax_out, port_out = _run_op_case(build, feed)
    assert len(jax_out) == len(port_out)
    for j, t in zip(jax_out, port_out):
        assert j.shape == t.shape
        assert j.dtype == t.dtype or j.dtype.kind == t.dtype.kind == "i"  # JAX: int32
        np.testing.assert_allclose(t, j, **TOL)
    if name.startswith("check_finite"):  # zeros by selection: no nan leaks
        assert port_out[2][0] == name.endswith(("inf", "nan"))
        assert all(np.isfinite(u).all() for u in port_out[:2])
    if name == "fill_constant_str_value":
        assert port_out[0].tolist() == [3.5, 3.5]
    if name == "update_loss_scaling":  # the windows crossed both ways
        scales = [float(v[0]) for v in port_out[::3]]
        assert max(scales) > 8.0 and min(scales) < 8.0, scales
    if name.startswith("dropout"):  # some kept and some dropped, grads on the same ones
        kept = port_out[0] != 0
        assert 0.5 < kept.mean() < 0.9
        assert np.array_equal(kept, port_out[1] != 0)


def test_dropout_grad_without_rng_name_or_mask_raises():
    """Neither an rng_name attr nor a saved Mask: both packages refuse."""
    import paddle_tpu as jfluid

    rs = np.random.RandomState(0)
    feed = {n: rs.randn(4, 5, 16).astype(np.float32) for n in ("x", "g")}
    for fluid in (jfluid, tfluid):
        main, startup, fetch = _programs(fluid, lambda f: _dropout_grad_op(f, False))
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(ValueError, match="rng_name.*Mask"):
            exe.run(main, feed=dict(feed), fetch_list=fetch, scope=scope)


@pytest.mark.parametrize("optimizer, n_state", [("Adam", 5), ("SGD", 1)])
def test_optimizer_matches_jax(optimizer, n_state):
    """Three steps on a constant-initialized parameter: the param and, for
    Adam, both moments and both beta powers."""
    def build(fluid):
        from_attr = fluid.ParamAttr(name="w", initializer=fluid.initializer.Constant(0.3))
        x = _data(fluid, "x", [4, 6], grad=False)
        h = fluid.layers.fc(x, 3, param_attr=from_attr, bias_attr=False)
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(h, h))
        getattr(fluid.optimizer, optimizer)(0.01).minimize(loss)
        return [loss]

    import paddle_tpu as jfluid

    feed = {"x": RS.randn(4, 6).astype(np.float32)}
    states = []
    for fluid in (jfluid, tfluid):
        main, startup, fetch = _programs(fluid, build)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        losses = [np.asarray(exe.run(main, feed=dict(feed), fetch_list=fetch,
                                     scope=scope)[0]) for _ in range(3)]
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        states.append((losses, {n: np.asarray(to_numpy(scope.get(n))) for n in names}))
    (jl, js), (tl, ts) = states
    assert sorted(js) == sorted(ts) and len(js) == n_state  # w (+ Adam's 4)
    np.testing.assert_allclose(tl, jl, **TOL)
    for n in js:
        np.testing.assert_allclose(ts[n], js[n], err_msg=n, **TOL)


# ---------------------------------------------------------------------------
# BERT-tiny pretraining
# ---------------------------------------------------------------------------


def _bert_programs(fluid, cfg, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        handles = build(cfg, B, S, mlm_only=True, max_preds=P)
        fluid.optimizer.Adam(1e-4).minimize(handles["loss"])
    return main, startup, handles


def _jax_bert(dropout):
    import paddle_tpu as jfluid
    from paddle_tpu.models.bert import BertConfig as JBertConfig
    from paddle_tpu.models.bert import build_bert_pretrain as j_build

    cfg = JBertConfig(**TINY, hidden_dropout=dropout, attention_dropout=dropout,
                      fused_qkv=False, attn_layout="bshd")
    return _bert_programs(jfluid, cfg, j_build)


def _port_bert(dropout):
    cfg = BertConfig(**TINY, hidden_dropout=dropout, attention_dropout=dropout)
    return _bert_programs(tfluid, cfg, build_bert_pretrain)


def _bert_feed(seed=0):
    """The recipe of the JAX package's `_bert_feed` with max_preds, plus
    padded keys (input_mask zeros) so the attention bias is live."""
    rs = np.random.RandomState(seed)
    lengths = rs.randint(S // 2, S + 1, size=B)
    return {
        "src_ids": rs.randint(0, TINY["vocab_size"], (B, S)).astype(np.int64),
        "sent_ids": rs.randint(0, 2, (B, S)).astype(np.int64),
        "pos_ids": np.tile(np.arange(S, dtype=np.int64), (B, 1)),
        "input_mask": (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32),
        "mask_label": rs.randint(0, TINY["vocab_size"], (B, P)).astype(np.int64),
        "mask_weight": np.ones((B, P), np.float32),
        "mask_pos": np.stack([rs.choice(S, P, replace=False)
                              for _ in range(B)]).astype(np.int64),
    }


def test_pretrain_program_equals_jax_op_by_op():
    (jmain, jstartup, jh), (tmain, tstartup, th) = _jax_bert(0.1), _port_bert(0.1)
    assert jh["loss"].name == th["loss"].name
    for jp, tp in ((jmain, tmain), (jstartup, tstartup)):
        jd, td = jp.to_dict(), tp.to_dict()
        jops, tops = jd["blocks"][0]["ops"], td["blocks"][0]["ops"]
        assert [o["type"] for o in jops] == [o["type"] for o in tops]
        for jo, to in zip(jops, tops):
            assert jo == to, jo["type"]
        assert jd["blocks"][0]["vars"] == td["blocks"][0]["vars"]
        assert json.dumps(jd, sort_keys=True) == json.dumps(td, sort_keys=True)
    types = [o["type"] for o in jmain.to_dict()["blocks"][0]["ops"]]
    assert len(types) == 303 and len(set(types)) == 26


def _train(fluid, main, startup, handles, state, feed, steps, place):
    """Startup, then the given state by name, then `steps` runs on one
    batch -> (losses, persistables as numpy)."""
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    if state is not None:
        tfluid.io.set_persistables_from_numpy(scope, state, exe.device)
    losses = [float(np.asarray(exe.run(main, feed=dict(feed), fetch_list=[handles["loss"]],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(steps)]
    names = [v.name for v in main.list_vars() if v.persistable]
    return losses, {n: np.asarray(to_numpy(scope.get(n))) for n in names if scope.has(n)}


@pytest.mark.parametrize("dropout", [0.1, 0.0])
def test_bert_tiny_trains_like_jax(dropout, monkeypatch):
    import paddle_tpu as jfluid

    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_SHORT_ATTN", "bshd")
    feed = _bert_feed()
    jmain, jstartup, jh = _jax_bert(dropout)
    # the JAX startup state, then three JAX steps from it
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jstartup, scope=scope)
    names = sorted(v.name for v in jmain.list_vars() if v.persistable)
    state0 = {n: np.asarray(scope.get(n)) for n in names}
    jl = [float(np.asarray(exe.run(jmain, feed=dict(feed), fetch_list=[jh["loss"]],
                                   scope=scope)[0]).reshape(-1)[0]) for _ in range(3)]
    js = {n: np.asarray(scope.get(n)) for n in names}

    tmain, tstartup, th = _port_bert(dropout)
    tnames = sorted(v.name for v in tmain.list_vars() if v.persistable)
    assert tnames == names  # params, Adam moments and beta powers
    launches = dict(LAUNCHES)
    tl, ts = _train(tfluid, tmain, tstartup, th, state0, feed, 3, tfluid.CPUPlace())
    assert LAUNCHES == launches
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    for n in names:
        np.testing.assert_allclose(ts[n], js[n], err_msg=n, **TOL)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]


def test_training_graph_is_reused_not_recomputed():
    """Every __auto_grad__ of the BERT step pulls its cotangents through the
    graph its forward op recorded: none re-runs a forward."""
    main, startup, handles = _port_bert(0.1)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=_bert_feed(), fetch_list=[handles["loss"]], scope=scope)
    assert exe.recomputed_forwards == []
    assert not any(scope.get(v.name).requires_grad or scope.get(v.name).is_inference()
                   for v in main.list_vars() if v.persistable)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_bert_training.py` on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_bert_tiny_trains_like_cpu(cuda_device):
    """BERT-tiny with dropout: 3 steps on the card through the kernels
    against the same 3 steps on the CPU, from the card's startup state."""
    main, startup, handles = _port_bert(0.1)
    feed = _bert_feed()
    before = dict(LAUNCHES)
    gl, gs = _train(tfluid, main, startup, handles, None, feed, 3, tfluid.CUDAPlace(0))
    torch.cuda.synchronize()
    per_step = {n: (LAUNCHES[n] - before[n]) / 3 for n in LAUNCHES}
    assert per_step == {"mha_short_fwd": 2, "mha_short_bwd": 2, "flash_fwd": 0,
                        "flash_bwd": 0, "layer_norm_bwd": 6, "fused_prologue_conv1x1": 0,
                        "conv1x1_with_stats": 0}
    # the card's startup state is the CPU run's starting point
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    state0 = {v.name: to_numpy(scope.get(v.name)) for v in main.list_vars()
              if v.persistable and scope.has(v.name)}
    cl, cs = _train(tfluid, main, startup, handles, state0, feed, 3, tfluid.CPUPlace())
    np.testing.assert_allclose(gl, cl, rtol=1e-5, atol=0)
    for n in cs:
        np.testing.assert_allclose(gs[n], cs[n], err_msg=n, atol=1e-5, rtol=1e-5)
