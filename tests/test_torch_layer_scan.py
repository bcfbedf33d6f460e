"""The port's fuse_layer_scan pass and `layer_scan` lowering on the CPU,
held against the JAX package's (paddle_tpu/passes/fuse_layer_scan.py,
paddle_tpu/ops/scan_ops.py) and against the port's unfused steps.

- Post-pass Programs with PADDLE_TPU_FUSE_LAYER_SCAN=1 equal the JAX
  package's op for op, every `layer_scan` attr included (the template
  ops whole, num_iters, carry_out_names, stacked_templates, ys_names,
  crc_names, crc_rows, sig): BERT-base masked-LM in fp32 and bf16 AMP
  (1343 -> 75 ops) and Transformer-base under bf16 AMP (1755 -> 100),
  built and not run. As in tests/test_torch_passes.py one difference is
  allowed, the dtype attr of a folded int64 constant (int32 in the JAX
  package, which runs with x64 off).
- The twin of tests/test_passes.py's fc-stack test: fused and unfused
  bit-equal, the counters bumped; the opt-in gating, the cache
  signature and the pass order.
- BERT-tiny and Transformer-tiny, 4 layers each with dropout 0.1, 3 Adam
  steps fused against unfused from one state: losses and every
  persistable bit-equal, and no __auto_grad__ re-runs a forward
  (`Executor.recomputed_forwards` and `deferred_forwards` empty), though
  the backward run fuses all 4 layers and the forward run 3.
- The fused port against the fused JAX package from the JAX startup
  state (its attention kernels in interpret mode,
  PADDLE_TPU_PALLAS_INTERPRET=1, PADDLE_TPU_SHORT_ATTN=bshd): losses
  rtol 1e-5, persistables atol 1e-5, the gates of
  tests/test_torch_bert_training.py (fp32 summation order).

The `gpu` test (`python -m pytest -m gpu --noconftest
tests/test_torch_layer_scan.py` on the card) runs BERT-tiny fused against
unfused on the card: bit-equal, and the same kernel launches a step.
"""

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.ops.kernels import LAUNCHES
from paddle_tpu_torch.ops.registry import graph_users
from paddle_tpu_torch.passes import (PASS_REGISTRY, apply_program_passes, cache_signature,
                                     resolve_pass_names)
from paddle_tpu_torch.scope import to_numpy
from test_torch_bert_training import _bert_feed
from test_torch_transformer import TINY_VOCAB
from test_torch_transformer import _feed as _transformer_feed

B, S, P = 2, 32, 5
STEPS = 3
TOL = dict(atol=1e-5, rtol=1e-5)
BERT_TINY = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
                 intermediate_size=128, max_position=64, hidden_dropout=0.1,
                 attention_dropout=0.1)
TRANSFORMER_TINY = dict(n_layers=4, dropout=0.1)


@pytest.fixture(autouse=True)
def _scan_env(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PASSES", raising=False)
    monkeypatch.delenv("PADDLE_TPU_OPTIMIZER_OVERLAP", raising=False)
    monkeypatch.delenv("PADDLE_TPU_FUSE_LAYER_SCAN", raising=False)
    monkeypatch.delenv("PADDLE_TPU_SCAN_MIN_SEGMENTS", raising=False)
    monkeypatch.delenv("PADDLE_TPU_SCAN_MIN_OPS", raising=False)


def _guarded(fluid, build, seed=None):
    main, startup = fluid.Program(), fluid.Program()
    if seed is not None:
        main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = build(fluid)
    return main, startup, out


def _feed_names(main):
    return tuple(sorted(v.name for v in main.global_block().vars.values() if v.is_data))


def _op_dict(op):
    d = op.to_dict()
    if op.type == "layer_scan":
        d["attrs"]["template_ops"] = [t.to_dict() for t in op.attr("template_ops")]
    return d


# -- post-pass Programs against the JAX package's -------------------------------


def _bert_base(fluid, amp):
    bert = importlib.import_module(fluid.__name__ + ".models.bert")
    mp = importlib.import_module(fluid.__name__ + ".contrib.mixed_precision")
    h = bert.build_bert_pretrain(bert.BertConfig.base(), 8, 128, mlm_only=True,
                                 max_preds=20)
    opt = fluid.optimizer.Adam(1e-4)
    (mp.decorate(opt) if amp else opt).minimize(h["loss"])
    return [h["loss"].name]


def _transformer_base(fluid):
    tr = importlib.import_module(fluid.__name__ + ".models.transformer")
    mp = importlib.import_module(fluid.__name__ + ".contrib.mixed_precision")
    h = tr.build_transformer(tr.TransformerConfig.base(), 256, 64, 64)
    mp.decorate(fluid.optimizer.Adam(1e-4)).minimize(h["loss"])
    return [h["loss"].name]


PROGRAM_CASES = {
    # name: (build(fluid) -> fetch names, ops before, ops after, runs)
    "bert_fp32": (lambda f: _bert_base(f, False), 1343, 75, 3),
    "bert_bf16": (lambda f: _bert_base(f, True), 1343, 75, 3),
    "transformer_bf16": (_transformer_base, 1755, 100, 7),
}


@pytest.mark.parametrize("name", sorted(PROGRAM_CASES))
def test_fused_program_equals_jax(name, monkeypatch):
    import paddle_tpu as jfluid
    from paddle_tpu.passes import apply_program_passes as japply

    monkeypatch.setenv("PADDLE_TPU_VERIFY", "0")
    monkeypatch.setenv("PADDLE_TPU_FUSE_LAYER_SCAN", "1")
    build, before, after, runs = PROGRAM_CASES[name]
    jmain, _, jfetch = _guarded(jfluid, build)
    tmain, _, tfetch = _guarded(tfluid, build)
    _, jblock, jstats = japply(jmain, _feed_names(jmain), tuple(jfetch))
    counters = tprofiler.counters()
    _, tblock, tstats = apply_program_passes(tmain, _feed_names(tmain), tuple(tfetch))
    assert (tstats["ops_before"], tstats["ops_after"]) == (before, after)
    assert tstats == jstats
    jops = [_op_dict(op) for op in jblock.ops]
    tops = [_op_dict(op) for op in tblock.ops]
    assert [o["type"] for o in jops] == [o["type"] for o in tops]
    for jo, to in zip(jops, tops):
        if to["type"] == "assign_value" and to["attrs"].get("dtype") == "int64":
            assert jo["attrs"]["dtype"] == "int32"
            jo["attrs"]["dtype"] = "int64"
        assert jo == to, to["type"]
    scans = [op for op in tblock.ops if op.type == "layer_scan"]
    assert len(scans) == runs
    grew = {k: tprofiler.counters().get(k, 0) - counters.get(k, 0)
            for k in ("scan_fused_runs", "scan_fused_layers", "scan_fused_ops_removed")}
    assert grew["scan_fused_runs"] == runs
    assert grew["scan_fused_layers"] == sum(op.attr("num_iters") for op in scans)
    assert grew["scan_fused_ops_removed"] == sum(
        op.attr("num_iters") * len(op.attr("template_ops")) - 1 for op in scans)
    # every backward body's __auto_grad__ is a graph user, once a layer
    users = graph_users(tblock)
    for op in scans:
        n_grads = sum(t.type == "__auto_grad__" for t in op.attr("template_ops"))
        assert n_grads == 0 or len(users) >= n_grads * op.attr("num_iters")


# -- the fc stack, gating and order (tests/test_passes.py's twins) ---------------


def _fc_stack(fluid, n_layers=4, width=16):
    x = fluid.layers.data("x", [width])
    h = x
    for _ in range(n_layers):
        h = fluid.layers.fc(h, width, act="relu")
        h = fluid.layers.fc(h, width, act="relu")
    return h


def test_fuse_layer_scan_stacks_fc_run_bitwise(monkeypatch):
    outs, counts = {}, {}
    for mode in ("off", "on"):
        if mode == "on":
            monkeypatch.setenv("PADDLE_TPU_FUSE_LAYER_SCAN", "1")
        main, startup, h = _guarded(tfluid, _fc_stack, seed=5)
        before = tprofiler.counters().get("scan_fused_layers", 0)
        _, blk, _ = apply_program_passes(main, ("x",), (h.name,))
        counts[mode] = len(blk.ops)
        types = [op.type for op in blk.ops]
        if mode == "on":
            assert "layer_scan" in types
            assert tprofiler.counters().get("scan_fused_layers", 0) >= before + 4
        else:
            assert "layer_scan" not in types
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        xv = np.random.RandomState(3).randn(2, 16).astype("float32")
        (out,) = exe.run(main, feed={"x": xv}, fetch_list=[h], scope=scope)
        outs[mode] = np.asarray(out).copy()
    assert counts["on"] < counts["off"]
    assert np.array_equal(outs["off"], outs["on"])


def test_opt_in_gated_signed_and_ordered(monkeypatch):
    assert "fuse_layer_scan" in PASS_REGISTRY
    bs = tfluid.BuildStrategy()
    base_names, base_sig = resolve_pass_names(bs), cache_signature(bs)
    assert "fuse_layer_scan" not in base_names
    bs.fuse_layer_scan = True
    bs.optimizer_overlap = True
    names = resolve_pass_names(bs)
    assert "fuse_layer_scan" in names and cache_signature(bs) != base_sig
    assert names.index("fuse_layer_scan") < names.index("fuse_optimizer")
    assert names.index("fuse_optimizer") < names.index("optimizer_overlap")
    env_base = cache_signature(None)
    monkeypatch.setenv("PADDLE_TPU_FUSE_LAYER_SCAN", "1")
    assert "fuse_layer_scan" in resolve_pass_names(None)
    assert cache_signature(None) != env_base
    # the JAX package resolves the same set
    from paddle_tpu.passes import resolve_pass_names as jresolve

    jnames = [n for n in jresolve(None) if n in PASS_REGISTRY]
    assert tuple(jnames) == resolve_pass_names(None)


def test_min_segments_and_ops_floor(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSE_LAYER_SCAN", "1")
    main, _, h = _guarded(tfluid, _fc_stack)
    # 8 fc + relu blocks of one width: one run of 8 segments of 3 ops
    monkeypatch.setenv("PADDLE_TPU_SCAN_MIN_SEGMENTS", "9")
    _, blk, _ = apply_program_passes(main, ("x",), (h.name,))
    assert "layer_scan" not in [op.type for op in blk.ops]
    monkeypatch.setenv("PADDLE_TPU_SCAN_MIN_SEGMENTS", "8")
    monkeypatch.setenv("PADDLE_TPU_SCAN_MIN_OPS", "25")
    _, blk, _ = apply_program_passes(main, ("x",), (h.name,))
    assert "layer_scan" not in [op.type for op in blk.ops]
    monkeypatch.setenv("PADDLE_TPU_SCAN_MIN_OPS", "24")
    _, blk, _ = apply_program_passes(main, ("x",), (h.name,))
    scans = [op for op in blk.ops if op.type == "layer_scan"]
    assert len(scans) == 1 and scans[0].attr("num_iters") == 8
    assert len(scans[0].attr("template_ops")) == 3


def test_build_strategy_knob_fuses_a_run():
    main, startup, h = _guarded(tfluid, _fc_stack, seed=5)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    xv = np.random.RandomState(3).randn(2, 16).astype("float32")
    (off,) = exe.run(main, feed={"x": xv}, fetch_list=[h], scope=scope)
    off_ops = exe.last_pass_stats["ops_after"]
    bs = tfluid.BuildStrategy()
    bs.fuse_layer_scan = True
    (on,) = exe.run(main, feed={"x": xv}, fetch_list=[h], scope=scope, build_strategy=bs)
    assert exe.last_pass_stats["ops_after"] < off_ops
    assert np.array_equal(off, on)


# -- training steps --------------------------------------------------------------


def _bert_build(bert_mod, cfg_cls):
    def build(fluid):
        h = bert_mod.build_bert_pretrain(cfg_cls(**BERT_TINY), B, S, mlm_only=True,
                                         max_preds=P)
        fluid.optimizer.Adam(1e-4).minimize(h["loss"])
        return h
    return build


def _transformer_build(tr):
    def build(fluid):
        cfg = tr.TransformerConfig.tiny()
        for k, v in TRANSFORMER_TINY.items():
            setattr(cfg, k, v)
        h = tr.build_transformer(cfg, B, S // 2, S // 2)
        fluid.optimizer.Adam(1e-3).minimize(h["loss"])
        return h
    return build


def _model_build(fluid, model):
    if model == "bert":
        bert = importlib.import_module(fluid.__name__ + ".models.bert")
        return _bert_build(bert, bert.BertConfig)
    return _transformer_build(importlib.import_module(fluid.__name__ + ".models.transformer"))


def _feed(model, seed=0):
    return _bert_feed(seed) if model == "bert" else _transformer_feed(TINY_VOCAB, seed)


def _port_steps(model, state, fused, monkeypatch, place=None):
    """STEPS port steps from `state` (None: the port's startup, seed 11)
    -> (losses, persistables, executor, post-pass op types)."""
    if fused:
        monkeypatch.setenv("PADDLE_TPU_FUSE_LAYER_SCAN", "1")
    else:
        monkeypatch.delenv("PADDLE_TPU_FUSE_LAYER_SCAN", raising=False)
    main, startup, h = _guarded(tfluid, _model_build(tfluid, model), seed=11)
    scope = tfluid.Scope()
    exe = tfluid.Executor(place or tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    if state is not None:
        tfluid.io.set_persistables_from_numpy(scope, state, exe.device)
    losses, types = [], None
    for _ in range(STEPS):
        out = exe.run(main, feed=_feed(model), fetch_list=[h["loss"]], scope=scope)
        losses.append(np.asarray(out[0]).copy())
        assert exe.recomputed_forwards == [] and exe.deferred_forwards == []
        if types is None:
            passed = exe._passed_program(main, _feed(model), [h["loss"].name], scope)
            types = [op.type for op in passed.global_block().ops]
    names = [v.name for v in main.list_vars() if v.persistable]
    return losses, {n: to_numpy(scope.get(n)) for n in names if scope.has(n)}, exe, types


def _start_state(model):
    main, startup, _ = _guarded(tfluid, _model_build(tfluid, model), seed=11)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    return {v.name: to_numpy(scope.get(v.name)) for v in main.list_vars()
            if v.persistable and scope.has(v.name)}


@pytest.mark.parametrize("model", ["bert", "transformer"])
def test_fused_steps_bit_equal_unfused(model, monkeypatch):
    state0 = _start_state(model)
    ul, us, _, utypes = _port_steps(model, state0, False, monkeypatch)
    fl, fs, _, ftypes = _port_steps(model, state0, True, monkeypatch)
    assert "layer_scan" not in utypes and "layer_scan" in ftypes
    assert len(ftypes) < len(utypes)
    for a, b in zip(ul, fl):
        assert np.array_equal(a, b), (ul, fl)
    assert sorted(us) == sorted(fs)
    for n in us:
        assert np.array_equal(us[n], fs[n]), n
    assert float(fl[-1].reshape(-1)[0]) < float(fl[0].reshape(-1)[0])


@pytest.mark.parametrize("model", ["bert", "transformer"])
def test_fused_steps_match_fused_jax(model, monkeypatch):
    import paddle_tpu as jfluid

    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_SHORT_ATTN", "bshd")
    monkeypatch.setenv("PADDLE_TPU_FUSE_LAYER_SCAN", "1")
    jmain, jstartup, jh = _guarded(jfluid, _model_build(jfluid, model), seed=11)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jstartup, scope=scope)
    names = sorted(v.name for v in jmain.list_vars() if v.persistable)
    state0 = {n: np.asarray(scope.get(n)) for n in names}
    jl = [float(np.asarray(exe.run(jmain, feed=_feed(model), fetch_list=[jh["loss"]],
                                   scope=scope)[0]).reshape(-1)[0]) for _ in range(STEPS)]
    js = {n: np.asarray(scope.get(n)) for n in names}
    launches = dict(LAUNCHES)
    tl, ts, _, types = _port_steps(model, state0, True, monkeypatch)
    assert LAUNCHES == launches  # the CPU runs the plain versions
    assert "layer_scan" in types
    np.testing.assert_allclose([float(x.reshape(-1)[0]) for x in tl], jl, rtol=1e-5, atol=0)
    assert sorted(ts) == sorted(js)
    for n in js:
        np.testing.assert_allclose(ts[n], js[n], err_msg=n, **TOL)


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_layer_scan.py` on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_fused_bert_tiny_bit_equal_unfused(cuda_device, monkeypatch):
    """BERT-tiny fused against unfused on the card from one state: losses
    and persistables bit-equal, the same kernel launches a step."""
    torch.use_deterministic_algorithms(True)
    try:
        state0 = _start_state("bert")
        runs = {}
        for fused in (False, True):
            before = dict(LAUNCHES)
            runs[fused] = _port_steps("bert", state0, fused, monkeypatch,
                                      place=tfluid.CUDAPlace(0))
            torch.cuda.synchronize()
            runs[fused] += ({n: LAUNCHES[n] - before[n] for n in LAUNCHES},)
    finally:
        torch.use_deterministic_algorithms(False)
    (ul, us, _, _, ulaunch), (fl, fs, _, _, flaunch) = runs[False], runs[True]
    assert ulaunch == flaunch and ulaunch["mha_short_fwd"] == 4 * STEPS
    for a, b in zip(ul, fl):
        assert np.array_equal(a, b)
    for n in us:
        assert np.array_equal(us[n], fs[n]), n
