"""Full BERT pretraining on the CPU, held against the JAX package: every
`BertConfig` attention path, both heads, AMP with loss scaling, AdamW,
Lamb, weight decay and gradient clipping.

- Programs op by op: the port's `build_bert_pretrain` + optimizer Program
  and its startup Program equal the JAX ones (types, slots, var names,
  attrs) for each attention path (bshd, bhsd, unfused, fused_qkv,
  untied), each head (`mlm_only` True / False x `max_preds` P / None),
  fp32, bf16 AMP, bf16 with dynamic scaling and fp16, AdamW and Lamb, L1
  and L2 decay (the optimizer's and a parameter's own), each clip and
  `set_gradient_clip`. Equal names give equal dropout masks.
- BERT-tiny (b 2, s 32), 3 steps on one batch from the JAX startup state
  with dropout 0.1: the full head (NSP and the MLM head over every
  position) with the bhsd layout, Lamb and a global-norm clip; and the
  unfused path with fused_qkv, an untied MLM projection, AdamW, an L1
  decay on the pooler and a clip by value. The JAX side runs its Pallas
  kernels in interpret mode (PADDLE_TPU_PALLAS_INTERPRET=1), with
  PADDLE_TPU_SHORT_ATTN=bhsd for the bhsd layout.

Tolerances: fp32 losses rtol 1e-5, every persistable atol 1e-5 (the
gates of tests/test_torch_bert_training.py). bf16 AMP: each step's loss
within one bf16 ulp (2^-8 relative) of the JAX loss or of the port's
same step with every matmul summed in float64 and rounded once; XLA's
excess precision on the CPU keeps fp32 across fused bf16 ops where the
lowerings ask for a rounding (ROADMAP Queue 3), as in
tests/test_torch_resnet.py.

The `gpu` tests (`python -m pytest -m gpu --noconftest
tests/test_torch_bert_pretrain.py` on the card) check that an fp16 input
to kernels #1-#8 runs their fp16 versions and agrees with the plain
versions within one fp16 ulp, that it still raises TypeError naming the
ROADMAP entry at the fused-block kernels (#9-#10), and run the bhsd
BERT-tiny card against CPU."""

import importlib
import json

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.ops.kernels import LAUNCHES
from paddle_tpu_torch.scope import to_numpy
from test_torch_kernels import fp16_ulp

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)
B, S, P = 2, 32, 5
STEPS = 3
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_ULP = 2.0**-8


def _jax():
    import paddle_tpu as jfluid
    from paddle_tpu.models import bert as jbert

    return jfluid, jbert


def _program(fluid, bert, cfg_kw, mlm_only, max_preds, make_opt, amp=None, tweak=None,
             global_clip=None):
    """-> (main, startup, handles, the AMP wrapper or None). `tweak(fluid,
    main)` runs after the model is built and before the optimizer."""
    cfg = bert.BertConfig(**TINY, **cfg_kw)
    main, startup = fluid.Program(), fluid.Program()
    fluid.clip.set_gradient_clip(global_clip(fluid) if global_clip else None)
    try:
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            handles = bert.build_bert_pretrain(cfg, B, S, mlm_only=mlm_only,
                                               max_preds=max_preds)
            if tweak:
                tweak(fluid, main)
            opt = make_opt(fluid)
            if amp is not None:
                mp = importlib.import_module(fluid.__name__ + ".contrib.mixed_precision")
                opt = mp.decorate(opt, **amp)
            opt.minimize(handles["loss"])
    finally:
        fluid.clip.set_gradient_clip(None)
    return main, startup, handles, opt if amp is not None else None


def _both_programs(**kw):
    jfluid, jbert = _jax()
    from paddle_tpu_torch.models import bert as tbert

    return _program(jfluid, jbert, **kw), _program(tfluid, tbert, **kw)


def _adam(fluid):
    return fluid.optimizer.Adam(1e-4)


def _pooler_l1(fluid, main):
    """An L1 decay on the pooler's weight, set on the parameter as its
    ParamAttr would set it."""
    main.global_block().var("pooler.w_0").regularizer = fluid.regularizer.L1Decay(1e-3)


PATHS = {
    "bshd": dict(),
    "bhsd": dict(attn_layout="bhsd"),
    "unfused": dict(use_flash_attention=False),
    "fused_qkv": dict(fused_qkv=True),
    "untied": dict(tie_mlm_weights=False),
}
HEADS = {"mlm_gathered": (True, P), "mlm_all": (True, None), "nsp_gathered": (False, P),
         "nsp_all": (False, None)}
PROGRAM_CASES = {
    **{f"{p}-{h}": dict(cfg_kw=PATHS[p], mlm_only=HEADS[h][0], max_preds=HEADS[h][1],
                        make_opt=_adam)
       for p in PATHS for h in HEADS},
    **{f"amp-{name}": dict(cfg_kw={}, mlm_only=False, max_preds=None, make_opt=_adam, amp=amp)
       for name, amp in (("bf16", {}), ("bf16_dynamic", dict(use_dynamic_loss_scaling=True)),
                         ("fp16", dict(amp_dtype="float16")),
                         ("fp16_static", dict(amp_dtype="float16",
                                              use_dynamic_loss_scaling=False)))},
    **{f"opt-{name}": dict(cfg_kw={}, mlm_only=False, max_preds=P, make_opt=make)
       for name, make in (
           ("adamw", lambda f: f.optimizer.AdamW(1e-3, weight_decay=0.01)),
           ("lamb", lambda f: f.optimizer.Lamb(1e-3, lamb_weight_decay=0.01)),
           ("l1", lambda f: f.optimizer.Adam(1e-4, regularization=f.regularizer.L1Decay(1e-4))),
           ("l2", lambda f: f.optimizer.Adam(1e-4, regularization=f.regularizer.L2Decay(1e-4))),
           ("clip_value", lambda f: f.optimizer.Adam(
               1e-4, grad_clip=f.clip.GradientClipByValue(0.5))),
           ("clip_norm", lambda f: f.optimizer.Adam(
               1e-4, grad_clip=f.clip.GradientClipByNorm(0.5))),
           ("clip_global_norm", lambda f: f.optimizer.Adam(
               1e-4, grad_clip=f.clip.GradientClipByGlobalNorm(1.0))))},
    "opt-param_attr_l1": dict(cfg_kw={}, mlm_only=False, max_preds=P, make_opt=_adam,
                              tweak=_pooler_l1),
    "opt-param_attr_l1_with_l2": dict(
        cfg_kw={}, mlm_only=False, max_preds=P, tweak=_pooler_l1,
        make_opt=lambda f: f.optimizer.Adam(1e-4, regularization=f.regularizer.L2Decay(1e-4))),
    "opt-set_gradient_clip": dict(cfg_kw={}, mlm_only=False, max_preds=P, make_opt=_adam,
                                  global_clip=lambda f: f.clip.GradientClipByGlobalNorm(1.0)),
}


@pytest.mark.parametrize("name", sorted(PROGRAM_CASES))
def test_pretrain_programs_equal_jax_op_by_op(name):
    (jmain, jstartup, jh, _), (tmain, tstartup, th, _) = _both_programs(**PROGRAM_CASES[name])
    assert jh["loss"].name == th["loss"].name and jh["feeds"] == th["feeds"]
    for jp, tp in ((jmain, tmain), (jstartup, tstartup)):
        jd, td = jp.to_dict(), tp.to_dict()
        jops, tops = jd["blocks"][0]["ops"], td["blocks"][0]["ops"]
        assert [o["type"] for o in jops] == [o["type"] for o in tops]
        for jo, to in zip(jops, tops):
            assert jo == to, jo["type"]
        assert json.dumps(jd, sort_keys=True) == json.dumps(td, sort_keys=True)
    types = [op.type for op in tmain.global_block().ops]
    attn = [op for op in tmain.global_block().ops if op.type == "fused_multihead_attention"]
    path = name.split("-")[0]
    if path == "unfused":
        assert not attn and types.count("softmax") == TINY["num_layers"]
    elif path in PATHS:
        want = "bhsd" if path == "bhsd" else "bshd"
        assert len(attn) == TINY["num_layers"]
        assert all(op.attr("layout") == want for op in attn)
    if "nsp" in name or name.startswith(("amp", "opt")):
        assert {"slice", "tanh"} <= set(types)


def _feed(full, seed=0):
    """Random ids, padded keys (input_mask zeros, so the bias is live),
    mask labels and weights over every position or over P gathered ones,
    and NSP labels."""
    rs = np.random.RandomState(seed)
    lengths = rs.randint(S // 2, S + 1, size=B)
    lbl = (B, S) if full else (B, P)
    feed = {
        "src_ids": rs.randint(0, TINY["vocab_size"], (B, S)).astype(np.int64),
        "sent_ids": rs.randint(0, 2, (B, S)).astype(np.int64),
        "pos_ids": np.tile(np.arange(S, dtype=np.int64), (B, 1)),
        "input_mask": (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32),
        "mask_label": rs.randint(0, TINY["vocab_size"], lbl).astype(np.int64),
        "mask_weight": (rs.rand(*lbl) < 0.3).astype(np.float32) if full
        else np.ones(lbl, np.float32),
        "nsp_label": rs.randint(0, 2, (B, 1)).astype(np.int64),
    }
    if not full:
        feed["mask_pos"] = np.stack([rs.choice(S, P, replace=False)
                                     for _ in range(B)]).astype(np.int64)
    return feed


# BERT-tiny training cases: (program keywords, JAX short-attention mode)
TRAIN_CASES = {
    "bhsd_full": (dict(
        cfg_kw=dict(attn_layout="bhsd"), mlm_only=False, max_preds=None,
        make_opt=lambda f: f.optimizer.Lamb(1e-2, lamb_weight_decay=0.01,
                                            grad_clip=f.clip.GradientClipByGlobalNorm(1.0))),
        "bhsd"),
    "unfused": (dict(
        cfg_kw=dict(use_flash_attention=False, fused_qkv=True, tie_mlm_weights=False),
        mlm_only=False, max_preds=P, tweak=_pooler_l1,
        make_opt=lambda f: f.optimizer.AdamW(1e-3, weight_decay=0.01,
                                             grad_clip=f.clip.GradientClipByValue(0.5))),
        "0"),
}


def _jax_state_and_steps(kw, monkeypatch, short_attn, feed):
    """The JAX startup state, then its STEPS steps -> (state0, losses,
    persistables)."""
    jfluid, jbert = _jax()
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_SHORT_ATTN", short_attn)
    main, startup, h, _ = _program(jfluid, jbert, **kw)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    state0 = {n: np.asarray(scope.get(n)) for n in names}
    losses = [float(np.asarray(exe.run(main, feed=dict(feed), fetch_list=[h["loss"]],
                                       scope=scope)[0]).reshape(-1)[0]) for _ in range(STEPS)]
    return state0, losses, {n: np.asarray(scope.get(n)) for n in names}


def _port_steps(kw, state, feed, place=None, fetch_scale=False):
    """The port's STEPS steps from `state` (None: its own startup) ->
    (losses, persistables, scales)."""
    from paddle_tpu_torch.models import bert as tbert

    main, startup, h, opt = _program(tfluid, tbert, **kw)
    place = place or tfluid.CPUPlace()
    scope = tfluid.Scope()
    exe = tfluid.Executor(place)
    exe.run(startup, scope=scope)
    if state is not None:
        tfluid.io.set_persistables_from_numpy(scope, state, exe.device)
    fetch = [h["loss"]] + ([opt.get_loss_scaling()] if fetch_scale else [])
    losses, scales = [], []
    for _ in range(STEPS):
        out = exe.run(main, feed=dict(feed), fetch_list=fetch, scope=scope)
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        scales += [float(np.asarray(out[1]).reshape(-1)[0])] if fetch_scale else []
    names = [v.name for v in main.list_vars() if v.persistable]
    return losses, {n: to_numpy(scope.get(n)) for n in names if scope.has(n)}, scales


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_bert_tiny_pretrains_like_jax(case, monkeypatch):
    kw, short_attn = TRAIN_CASES[case]
    feed = _feed(kw["max_preds"] is None)
    state0, jl, js = _jax_state_and_steps(kw, monkeypatch, short_attn, feed)
    launches = dict(LAUNCHES)
    tl, ts, _ = _port_steps(kw, state0, feed)
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


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_bert_tiny_bf16_amp_pretrains_like_jax(case, monkeypatch):
    """Under bf16 AMP with dynamic loss scaling: each step's loss within
    one bf16 ulp of the JAX loss or of the float64-matmul step, the scale
    fetched each step equal to the JAX package's, and finite fp32 master
    weights."""
    kw, short_attn = TRAIN_CASES[case]
    kw = dict(kw, amp=dict(use_dynamic_loss_scaling=True, init_loss_scaling=2.0**10,
                           incr_every_n_steps=2))
    feed = _feed(kw["max_preds"] is None)
    state0, jl, js = _jax_state_and_steps(kw, monkeypatch, short_attn, feed)
    tl, ts, scales = _port_steps(kw, state0, feed, fetch_scale=True)
    with monkeypatch.context() as m:
        m.setattr(torch, "matmul", _float64_matmuls())
        fl, _, _ = _port_steps(kw, state0, feed)
    for t, j, f in zip(tl, jl, fl):
        assert min(abs(t - j), abs(t - f)) <= BF16_ULP * abs(t), (tl, jl, fl)
    scale_name = next(n for n in js if n.startswith("loss_scaling"))
    assert scales[-1] == float(js[scale_name][0]) and scales == [1024.0, 1024.0, 2048.0]
    for n, v in ts.items():
        if v.dtype.kind == "f":
            assert v.dtype == np.float32 and np.isfinite(v).all(), n
    assert tl[-1] < tl[0]


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_bert_pretrain.py` on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_fp16_input_to_each_kernel_raises(cuda_device):
    """An fp16 input on the card: kernels #1-#8 (attention and LayerNorm
    backward) launch their fp16 versions and agree with their plain
    versions within one fp16 ulp of each output's largest magnitude; the
    fused-block kernels (#9-#10) still raise TypeError naming ROADMAP's
    "fp16 for #9-#10" line and launch nothing."""
    from paddle_tpu_torch.ops.kernels import fused_block as fb
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        attention_delta, flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    from paddle_tpu_torch.ops.kernels.layer_norm import ln_bwd, ln_bwd_plain
    from paddle_tpu_torch.ops.kernels.mha_short import (
        short_attention, short_attention_bwd, short_attention_bwd_plain,
        short_attention_plain)

    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def t(*shape, dtype=torch.float16):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(dtype)

    q, k, v, do = t(2, 4, 64, 32), t(2, 4, 64, 32), t(2, 4, 64, 32), t(2, 4, 64, 32)
    x, dy = t(8, 64), t(8, 64)
    xf = x.float()
    mean, rstd = xf.mean(1), torch.rsqrt(xf.var(1, unbiased=False) + 1e-5)
    scale = t(64, dtype=torch.float32)

    def bwd(fwd, fn):
        out, lse = fwd(q, k, v, causal=True)
        return lambda: fn(q, k, v, None, do, lse, attention_delta(out, do, "bhsd"), causal=True)

    calls = {
        "mha_short_fwd": (lambda: short_attention(q, k, v, causal=True),
                          lambda: short_attention_plain(q, k, v, causal=True)),
        "mha_short_bwd": (bwd(short_attention_plain, short_attention_bwd),
                          bwd(short_attention_plain, short_attention_bwd_plain)),
        "flash_fwd": (lambda: flash_attention(q, k, v, causal=True),
                      lambda: flash_attention_plain(q, k, v, causal=True)),
        "flash_bwd": (bwd(flash_attention_plain, flash_attention_bwd),
                      bwd(flash_attention_plain, flash_attention_bwd_plain)),
        "layer_norm_bwd": (lambda: ln_bwd(x, dy, mean, rstd, scale),
                           lambda: ln_bwd_plain(x, dy, mean, rstd, scale)),
    }
    raises = {
        "fused_prologue_conv1x1": lambda: fb.fused_prologue_conv1x1(
            t(64, 64), t(64, dtype=torch.float32), t(64, dtype=torch.float32), t(64, 64),
            t(64, 64)),
        "conv1x1_with_stats": lambda: fb.conv1x1_with_stats(t(64, 64), t(64, 64)),
    }
    assert sorted([*calls, *raises]) == sorted(LAUNCHES)
    for name, (call, plain) in calls.items():
        before = LAUNCHES[name]
        got, ref = call(), plain()
        torch.cuda.synchronize()
        assert LAUNCHES[name] == before + 1, name
        for g, r in zip(got, ref):
            if g.dtype == torch.float16:
                err = float((g.float() - r.float()).abs().max())
                assert err <= fp16_ulp(r.float().cpu().numpy()), (name, err)
            else:  # lse, dscale, dbias: float32
                np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                           atol=1e-4 * max(1.0, float(r.abs().max())),
                                           rtol=0, err_msg=name)
    before = dict(LAUNCHES)
    for name, call in raises.items():
        with pytest.raises(TypeError, match="fp16 for #9-#10"):
            call()
    assert LAUNCHES == before


@pytest.mark.gpu
def test_cuda_bhsd_bert_tiny_pretrains_like_cpu(cuda_device):
    """The full head with the bhsd layout, Lamb and a global-norm clip:
    3 steps on the card through the kernels (each step launches 2 short
    forward and 2 short backward kernels, bhsd, and 6 LayerNorm backward
    kernels) against the same 3 steps on the CPU from the card's startup
    state."""
    kw, _ = TRAIN_CASES["bhsd_full"]
    feed = _feed(True)
    before = dict(LAUNCHES)
    gl, gs, _ = _port_steps(kw, None, feed, place=tfluid.CUDAPlace(0))
    torch.cuda.synchronize()
    per_step = {n: (LAUNCHES[n] - before[n]) / STEPS for n in LAUNCHES}
    assert per_step == dict({n: 0 for n in LAUNCHES}, mha_short_fwd=2, mha_short_bwd=2,
                            layer_norm_bwd=2 * TINY["num_layers"] + 2)
    from paddle_tpu_torch.models import bert as tbert

    main, startup, _, _ = _program(tfluid, tbert, **kw)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    state0 = {v.name: to_numpy(scope.get(v.name)) for v in main.list_vars()
              if v.persistable and scope.has(v.name)}
    gl, gs, _ = _port_steps(kw, state0, feed, place=tfluid.CUDAPlace(0))
    cl, cs, _ = _port_steps(kw, state0, feed)
    np.testing.assert_allclose(gl, cl, rtol=1e-5, atol=0)
    for n in cs:
        np.testing.assert_allclose(gs[n], cs[n], err_msg=n, atol=1e-5, rtol=1e-5)
