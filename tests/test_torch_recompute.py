"""RecomputeOptimizer and recompute_scope in the port, on the CPU, held
against the JAX package's recompute step and against the port's plain
step.

- The 3-segment fc stack of tests/test_aux.py: the port's recompute step
  against the JAX package's recompute step and against the port's
  explicit-backward step, 5 Adam steps.
- BERT-tiny (4 layers, dropout 0.1, `BertConfig(recompute=True)`): its
  Program equals the JAX package's op for op, `recompute_segment` tags
  included; 3 Adam steps under RecomputeOptimizer from the JAX startup
  state against the JAX recompute steps (the JAX side runs its Pallas
  attention in interpret mode, PADDLE_TPU_PALLAS_INTERPRET=1 and
  PADDLE_TPU_SHORT_ATTN=bshd); each segment runs twice a step (the
  forward and its recomputation in the backward), returns the layer's
  output alone, and no __auto_grad__ runs; under mixed_precision.decorate
  in bf16 too.
- Fetching a backward intermediate raises; a grad and the loss fetch.

Tolerances: fc stack and fp32 BERT losses rtol 1e-5 (fp32 summation
order), every persistable atol 1e-5 after 3 Adam steps, the gates of
tests/test_torch_bert_training.py. bf16: each loss within one bf16 ulp
(2^-8 relative) of the JAX loss or of the port's same step with every
matmul summed in float64 and rounded once, the gate of
tests/test_torch_bert_pretrain.py (XLA's excess precision on the CPU
keeps fp32 across fused bf16 ops where the port rounds).

The `gpu` test (`python -m pytest -m gpu --noconftest
tests/test_torch_recompute.py` on the card) runs the recompute BERT-tiny
3 steps on the card against the CPU from one state.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain
from paddle_tpu_torch.ops.kernels import LAUNCHES
from paddle_tpu_torch.scope import to_numpy
from test_torch_bert_pretrain import _float64_matmuls
from test_torch_bert_training import _bert_feed

TINY = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
            intermediate_size=128, max_position=64)
B, S, P = 2, 32, 5
STEPS = 3
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_ULP = 2.0**-8


# -- the fc stack of tests/test_aux.py ------------------------------------------


def _fc_stack(fluid, recompute):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8])
        y = fluid.layers.data("y", [1])
        h = x
        for i in range(3):
            with fluid.recompute_scope(i):
                h = fluid.layers.fc(h, 16, act="tanh",
                                    param_attr=fluid.initializer.Constant(0.05 + 0.01 * i))
        pred = fluid.layers.fc(h, 1, param_attr=fluid.initializer.Constant(0.1))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        opt = fluid.optimizer.Adam(1e-2)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
        opt.minimize(loss)
    return main, startup, loss


def _fc_losses(fluid, recompute):
    rng = np.random.RandomState(0)
    feeds = [(rng.randn(16, 8).astype("float32"), rng.randn(16, 1).astype("float32"))
             for _ in range(5)]
    main, startup, loss = _fc_stack(fluid, recompute)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return [float(np.asarray(exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss],
                                     scope=scope)[0]).reshape(-1)[0])
            for xv, yv in feeds]


def test_fc_stack_recompute_matches_jax_and_plain():
    import paddle_tpu as jfluid

    main, _, _ = _fc_stack(tfluid, True)
    tags = [op.attr("recompute_segment") for op in main.global_block().ops
            if op.attr("op_role") == 0]
    assert sorted(set(t for t in tags if t is not None)) == [0, 1, 2]
    port_rc = _fc_losses(tfluid, True)
    np.testing.assert_allclose(port_rc, _fc_losses(jfluid, True), rtol=1e-5, atol=0)
    np.testing.assert_allclose(port_rc, _fc_losses(tfluid, False), rtol=1e-5, atol=0)
    assert all(np.isfinite(port_rc))


# -- BERT-tiny ------------------------------------------------------------------


def _bert_programs(fluid, cfg, build, amp=None):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        h = build(cfg, B, S, mlm_only=True, max_preds=P)
        opt = fluid.optimizer.RecomputeOptimizer(fluid.optimizer.Adam(1e-4))
        if amp is not None:
            opt = fluid.contrib.mixed_precision.decorate(opt, **amp)
        opt.minimize(h["loss"])
    return main, startup, h


def _jax_bert(amp=None):
    import paddle_tpu as jfluid
    from paddle_tpu.models.bert import BertConfig as JBertConfig
    from paddle_tpu.models.bert import build_bert_pretrain as j_build

    cfg = JBertConfig(**TINY, hidden_dropout=0.1, attention_dropout=0.1, fused_qkv=False,
                      attn_layout="bshd", recompute=True)
    return _bert_programs(jfluid, cfg, j_build, amp)


def _port_bert(amp=None):
    cfg = BertConfig(**TINY, hidden_dropout=0.1, attention_dropout=0.1, recompute=True)
    return _bert_programs(tfluid, cfg, build_bert_pretrain, amp)


def _jax_steps(monkeypatch, feed, amp=None):
    """The JAX startup state, then its STEPS recompute steps -> (state0,
    losses, persistables)."""
    import paddle_tpu as jfluid

    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_SHORT_ATTN", "bshd")
    main, startup, h = _jax_bert(amp)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    state0 = {n: np.asarray(scope.get(n)) for n in names}
    losses = [float(np.asarray(exe.run(main, feed=dict(feed), fetch_list=[h["loss"]],
                                       scope=scope)[0]).reshape(-1)[0]) for _ in range(STEPS)]
    return state0, losses, {n: np.asarray(scope.get(n)) for n in names}


def _port_steps(state, feed, place=None, amp=None):
    """The port's STEPS recompute steps from `state` (None: its own
    startup) -> (losses, persistables, executor)."""
    main, startup, h = _port_bert(amp)
    scope = tfluid.Scope()
    exe = tfluid.Executor(place or tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    if state is not None:
        tfluid.io.set_persistables_from_numpy(scope, state, exe.device)
    losses = [float(np.asarray(exe.run(main, feed=dict(feed), fetch_list=[h["loss"]],
                                       scope=scope)[0]).reshape(-1)[0]) for _ in range(STEPS)]
    names = [v.name for v in main.list_vars() if v.persistable]
    return losses, {n: to_numpy(scope.get(n)) for n in names if scope.has(n)}, exe


def test_recompute_bert_program_equals_jax_op_by_op():
    (jmain, _, jh), (tmain, _, th) = _jax_bert(), _port_bert()
    assert jmain._recompute_loss == tmain._recompute_loss == th["loss"].name
    jops = jmain.to_dict()["blocks"][0]["ops"]
    tops = tmain.to_dict()["blocks"][0]["ops"]
    assert len(jops) == len(tops)
    for jo, to in zip(jops, tops):
        assert jo == to, jo["type"]
    segs = [o["attrs"].get("recompute_segment") for o in tops]
    assert sorted({s for s in segs if s is not None}) == list(range(TINY["num_layers"]))


def test_bert_tiny_recompute_trains_like_jax(monkeypatch):
    feed = _bert_feed()
    state0, jl, js = _jax_steps(monkeypatch, feed)
    calls, returned = [], []
    segment_fn = texecutor._segment_fn

    def counted(*a):
        fn = segment_fn(*a)
        returned.append(a[3])

        def run(*vals):
            calls.append(1)
            return fn(*vals)

        return run

    monkeypatch.setattr(texecutor, "_segment_fn", counted)
    launches = dict(LAUNCHES)
    tl, ts, exe = _port_steps(state0, feed)
    assert LAUNCHES == launches  # the CPU runs the plain versions
    # each layer's segment runs in the forward and again in the backward
    assert len(calls) == 2 * TINY["num_layers"] * STEPS
    # a layer's segment hands on its output alone: its other activations
    # are not held across the step
    assert [len(names) for names in returned] == [1] * TINY["num_layers"] * STEPS
    assert exe.recomputed_forwards == [] and exe.deferred_forwards == []
    assert sorted(ts) == sorted(js)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    for n in js:
        np.testing.assert_allclose(ts[n], js[n], err_msg=n, **TOL)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]


def test_bert_tiny_recompute_bf16_amp_trains_like_jax(monkeypatch):
    """mixed_precision.decorate(RecomputeOptimizer(Adam)) in bf16: the
    decorator hands minimize to the RecomputeOptimizer whole (no loss
    scaling), which tags the program; each loss within one bf16 ulp of
    the JAX loss or of the float64-matmul step, fp32 master weights."""
    feed = _bert_feed()
    state0, jl, js = _jax_steps(monkeypatch, feed, amp={})
    tl, ts, _ = _port_steps(state0, feed, amp={})
    with monkeypatch.context() as m:
        m.setattr(torch, "matmul", _float64_matmuls())
        fl, _, _ = _port_steps(state0, feed, amp={})
    for t, j, f in zip(tl, jl, fl):
        assert min(abs(t - j), abs(t - f)) <= BF16_ULP * abs(t), (tl, jl, fl)
    assert sorted(ts) == sorted(js)
    for n, v in ts.items():
        if v.dtype.kind == "f":
            assert v.dtype == np.float32 and np.isfinite(v).all(), n
    assert tl[-1] < tl[0]


def test_fetching_a_backward_intermediate_raises():
    main, startup, loss = _fc_stack(tfluid, True)
    block = main.global_block()
    grad_of_act = next(n for op in block.ops if op.type == "__auto_grad__"
                       for n in op.output_arg_names() if n and "@PARTIAL" in n)
    param_grad = next(n for op in block.ops if op.type == "adam" for n in op.input("Grad"))
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((4, 8), np.float32), "y": np.zeros((4, 1), np.float32)}
    with pytest.raises(RuntimeError, match="not available under RecomputeOptimizer"):
        exe.run(main, feed=feed, fetch_list=[grad_of_act], scope=scope)
    lv, gv = exe.run(main, feed=feed, fetch_list=[loss, param_grad], scope=scope)
    assert np.isfinite(lv).all() and np.isfinite(gv).all() and np.abs(gv).sum() > 0


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_recompute.py` on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_recompute_bert_tiny_trains_like_cpu(cuda_device):
    """The recompute BERT-tiny: 3 steps on the card through the attention
    kernels against the same 3 steps on the CPU, from the card's startup
    state; the short forward runs twice a layer (forward and
    recomputation), the LayerNorm backward kernel never."""
    feed = _bert_feed()
    before = dict(LAUNCHES)
    gl, gs, _ = _port_steps(None, feed, place=tfluid.CUDAPlace(0))
    torch.cuda.synchronize()
    per_step = {n: (LAUNCHES[n] - before[n]) / STEPS for n in LAUNCHES}
    layers = TINY["num_layers"]
    assert per_step["mha_short_fwd"] == 2 * layers and per_step["mha_short_bwd"] == layers
    assert per_step["layer_norm_bwd"] == 0
    main, startup, _ = _port_bert()
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    state0 = {v.name: to_numpy(scope.get(v.name)) for v in main.list_vars()
              if v.persistable and scope.has(v.name)}
    cl, cs, _ = _port_steps(state0, feed)
    np.testing.assert_allclose(gl, cl, rtol=1e-5, atol=0)
    for n in cs:
        np.testing.assert_allclose(gs[n], cs[n], err_msg=n, **TOL)
