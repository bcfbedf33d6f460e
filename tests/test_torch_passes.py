"""The port's Program passes (paddle_tpu_torch/passes/) on the CPU, held
against the JAX package's (paddle_tpu/passes/).

- Post-pass Programs op by op: for each Program the port's card paths
  build at base width (BERT masked-LM in fp32, bf16 AMP and fp16 AMP with
  dynamic scaling; full pretraining; Transformer-base under bf16 AMP;
  ResNet-50 training in fp32 and AMP; the ResNet-50 eval clone with the
  startup scope), the port's passes give the JAX package's op list:
  types, slots, names and attrs, in order, with the same op counts. One
  difference is allowed, the dtype attr of a folded int64 constant: the
  JAX package runs int64 as int32 (x64 off), the port's lowering keeps
  int64, and const_fold folds in the lowering's dtype. The folded BN
  weights of the eval clone are bit-equal to the JAX package's (both fold
  in numpy float32).
- Twins of tests/test_passes.py: registry, PADDLE_TPU_PASSES and the
  BuildStrategy knobs (both packages resolve the same pass set), the
  user's Program not mutated, dce, copy_prop, const_fold, the fused
  optimizers against the unfused ones, the Transformer-tiny step with the
  passes on and off, fuse_conv_bn, layout_opt and optimizer_overlap.
- The Executor's pass cache: a second run runs no pass; flipping
  PADDLE_TPU_PASSES between runs re-resolves.

Tolerances, each with its reason:
- fused_sgd / fused_momentum / fused_adam / fused_adamw: bit-equal to the
  unfused ops (each tensor takes the per-op lowering's operations).
  fused_lamb: rtol 1e-6, atol 1e-7 (the JAX test's gate), since its
  per-tensor norms are torch._foreach_norm's sums, not torch.sum's.
- Passes on vs off on programs without layout_opt's rewrite
  (Transformer-tiny, the fc stacks): the JAX test's rtol 1e-6, atol 1e-7;
  measured bit-equal.
- layout_opt on the CPU is not bit-equal: the NHWC convolutions are
  oneDNN's channels_last kernels and the NHWC batch norms sum over
  another axis order. ResNet-18 (32x32, b 4) steps, each from one state,
  with and without the passes: losses rtol 1e-4 and each persistable
  within 1e-3 of its largest magnitude, the gates of
  tests/test_torch_resnet.py (measured: losses within 3.3e-6 relative,
  persistables within 2.4e-4 of their largest, the first step's
  velocities). A conv block's outputs and grads, and the channel-bias
  eval graph: atol and rtol 1e-5, the single-op gate there.
- fuse_conv_bn: the JAX test's rtol 1e-5, atol 1e-6 on the eval outputs
  of ResNet-18 (measured: 2.4e-7 folded alone, 1.4e-6 with the NHWC
  layout too, 5.2e-6 relative).

The `gpu` test (`python -m pytest -m gpu --noconftest
tests/test_torch_passes.py` on the card) runs each fused optimizer
against its unfused op on the card at rtol 1e-6, atol 1e-7 and reports
whether they are bit-equal.
"""

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.passes import PASS_REGISTRY, apply_program_passes, resolve_pass_names
from paddle_tpu_torch.scope import to_numpy

DEFAULT_PASSES = ("const_fold", "copy_prop", "dce", "fuse_conv_bn", "layout_opt",
                  "fuse_optimizer")
FUSED_TOL = dict(rtol=1e-6, atol=1e-7)
RN_LOSS_RTOL, RN_STATE_TOL = 1e-4, 1e-3
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _no_pass_env(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PASSES", raising=False)
    monkeypatch.delenv("PADDLE_TPU_OPTIMIZER_OVERLAP", raising=False)
    # the JAX package's IR verifier is no part of its passes' output
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "0")


def _jax():
    import paddle_tpu as jfluid

    return jfluid


def _types(block):
    return [op.type for op in block.ops]


def _guarded(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = build(fluid)
    return main, startup, out


# -- post-pass Programs against the JAX package's ------------------------------


def _bert(fluid, amp=None, full=False):
    bert = importlib.import_module(fluid.__name__ + ".models.bert")
    mp = importlib.import_module(fluid.__name__ + ".contrib.mixed_precision")
    cfg = bert.BertConfig.base()
    if full:
        cfg.attn_layout = "bhsd"
        h = bert.build_bert_pretrain(cfg, 8, 128, mlm_only=False, max_preds=None)
        opt = mp.decorate(fluid.optimizer.Lamb(
            1e-3, lamb_weight_decay=0.01, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)),
            use_dynamic_loss_scaling=True)
    else:
        h = bert.build_bert_pretrain(cfg, 8, 128, mlm_only=True, max_preds=20)
        opt = fluid.optimizer.Adam(1e-4)
        opt = mp.decorate(opt, **amp) if amp is not None else opt
    opt.minimize(h["loss"])
    return [h["loss"].name]


def _transformer(fluid):
    tr = importlib.import_module(fluid.__name__ + ".models.transformer")
    mp = importlib.import_module(fluid.__name__ + ".contrib.mixed_precision")
    h = tr.build_transformer(tr.TransformerConfig.base(), 256, 64, 64)
    mp.decorate(fluid.optimizer.Adam(1e-4)).minimize(h["loss"])
    return [h["loss"].name]


def _resnet(fluid, amp=False, depth=50, b=128, hw=224, classes=1000, train=True):
    rn = importlib.import_module(fluid.__name__ + ".models.resnet")
    mp = importlib.import_module(fluid.__name__ + ".contrib.mixed_precision")
    img = fluid.layers.data("img", [b, 3, hw, hw], append_batch_size=False)
    label = fluid.layers.data("label", [b, 1], dtype="int64", append_batch_size=False)
    pred, loss, _, _ = rn.resnet(img, label, depth=depth, class_num=classes)
    if train:
        opt = fluid.optimizer.Momentum(0.1, 0.9)
        (mp.decorate(opt) if amp else opt).minimize(loss)
    return pred, loss


PROGRAM_CASES = {
    # name: (build(fluid) -> fetch names, ops before, ops after)
    "bert_fp32": (lambda f: _bert(f), 1343, 654),
    "bert_bf16": (lambda f: _bert(f, amp={}), 1343, 654),
    "bert_fp16_dynamic": (lambda f: _bert(
        f, amp=dict(amp_dtype="float16", use_dynamic_loss_scaling=True)), 1348, 657),
    "bert_full": (lambda f: _bert(f, full=True), 1941, 1186),
    "transformer_bf16": (_transformer, 1755, 865),
    "resnet50_fp32": (lambda f: [_resnet(f)[1].name], 861, 378),
    "resnet50_amp": (lambda f: [_resnet(f, amp=True)[1].name], 861, 378),
}


def _feed_names(main):
    return tuple(sorted(v.name for v in main.global_block().vars.values() if v.is_data))


def _assert_same_ops(jblock, tblock):
    """The two op lists equal, but for the dtype of a folded int64
    constant (int32 in the JAX package)."""
    jops = [op.to_dict() for op in jblock.ops]
    tops = [op.to_dict() for op in tblock.ops]
    assert [o["type"] for o in jops] == [o["type"] for o in tops]
    for jo, to in zip(jops, tops):
        if to["type"] == "assign_value" and to["attrs"].get("dtype") == "int64":
            assert jo["attrs"]["dtype"] == "int32"
            jo["attrs"]["dtype"] = "int64"
        assert jo == to, to["type"]


@pytest.mark.parametrize("name", sorted(PROGRAM_CASES))
def test_post_pass_program_equals_jax(name):
    build, before, after = PROGRAM_CASES[name]
    jfluid = _jax()
    from paddle_tpu.passes import apply_program_passes as japply

    jmain, _, jfetch = _guarded(jfluid, build)
    tmain, _, tfetch = _guarded(tfluid, build)
    assert jfetch == tfetch and _feed_names(jmain) == _feed_names(tmain)
    _, jblock, jstats = japply(jmain, _feed_names(jmain), tuple(jfetch))
    _, tblock, tstats = apply_program_passes(tmain, _feed_names(tmain), tuple(tfetch))
    assert (tstats["ops_before"], tstats["ops_after"]) == (before, after)
    assert tstats == jstats
    _assert_same_ops(jblock, tblock)
    types = _types(tblock)
    assert "assign" not in types or name.startswith("resnet")
    fused = [t for t in types if t in ("fused_adam", "fused_lamb", "fused_momentum")]
    assert len(fused) == 1 and fused[0][len("fused_"):] not in types
    if name.startswith("resnet"):
        assert types.count("transpose2") == 3 and "top_k" not in types
        assert all(op.attr("data_format") == "NHWC" for op in tblock.ops
                   if op.type in ("conv2d", "pool2d"))


def test_resnet50_eval_clone_folds_like_jax():
    """The eval clone with the startup scope: 183 -> 92 ops, every
    batch_norm and its relu folded into the conv, and each @bnfold tensor
    bit-equal to the JAX package's."""
    jfluid = _jax()
    from paddle_tpu.passes import apply_program_passes as japply

    progs = {}
    for fluid in (jfluid, tfluid):
        main, startup, (pred, _) = _guarded(fluid, lambda f: _resnet(f))
        test = main.clone(for_test=True)
        logits = next(op.input("X")[0] for op in test.global_block().ops
                      if op.type == "softmax")
        progs[fluid.__name__] = (test, startup, (pred.name, logits))
    jtest, jstartup, fetch = progs["paddle_tpu"]
    ttest = progs["paddle_tpu_torch"][0]
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    tscope = tfluid.Scope()
    tfluid.io.set_persistables_from_numpy(
        tscope, {v.name: np.asarray(jscope.get(v.name)) for v in jtest.list_vars()
                 if v.persistable and jscope.has(v.name)}, "cpu")
    _, jblock, jstats = japply(jtest, ("img",), fetch, scope=jscope)
    _, tblock, tstats = apply_program_passes(ttest, ("img",), fetch, scope=tscope)
    assert (tstats["ops_before"], tstats["ops_after"]) == (183, 92)
    assert tstats == jstats
    _assert_same_ops(jblock, tblock)
    before = _types(ttest.global_block())
    assert before.count("batch_norm") == 53 and _types(tblock).count("batch_norm") == 0
    fused = [op for op in tblock.ops if op.type == "conv2d"]
    assert len(fused) == 53 and sum(op.attr("fused_act") == "relu" for op in fused) == 33
    folded = sorted(n for op in fused for n in op.input("Filter") + op.input("Bias"))
    assert len(folded) == 106 and all("@bnfold." in n for n in folded)
    for n in folded:
        t = tscope.get(n)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), np.asarray(jscope.get(n))), n


# -- registry, selection, the user's Program -----------------------------------


def test_registry_has_the_passes():
    # the opt-in passes: the overlap split, the layer scan and (since the
    # autoshard planner is ported) shard_propagation
    assert set(PASS_REGISTRY) == set(DEFAULT_PASSES) | {"optimizer_overlap",
                                                        "fuse_layer_scan",
                                                        "shard_propagation"}
    assert resolve_pass_names() == DEFAULT_PASSES


@pytest.mark.parametrize("env", ["none", "", "off", "dce", "layout_opt,const_fold",
                                 "fuse_optimizer,optimizer_overlap", None, "overlap_knob"])
def test_pass_selection_resolves_like_jax(env, monkeypatch):
    from paddle_tpu.passes import resolve_pass_names as jresolve

    if env == "overlap_knob":
        monkeypatch.setenv("PADDLE_TPU_OPTIMIZER_OVERLAP", "1")
    elif env is not None:
        monkeypatch.setenv("PADDLE_TPU_PASSES", env)
    assert resolve_pass_names() == jresolve(None)


def test_cache_signature_names_passes_and_versions(monkeypatch):
    from paddle_tpu.passes import cache_signature as jsignature
    from paddle_tpu_torch.passes import cache_signature

    assert cache_signature() == jsignature() == ",".join(f"{n}:1" for n in DEFAULT_PASSES)
    monkeypatch.setenv("PADDLE_TPU_OPTIMIZER_OVERLAP", "1")
    assert cache_signature().endswith(",optimizer_overlap:1")
    monkeypatch.setenv("PADDLE_TPU_PASSES", "none")
    assert cache_signature() == jsignature() == "nopass"


def test_env_override(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PASSES", "none")
    assert resolve_pass_names() == ()
    monkeypatch.setenv("PADDLE_TPU_PASSES", "all")
    assert set(resolve_pass_names()) == set(PASS_REGISTRY)
    monkeypatch.setenv("PADDLE_TPU_PASSES", "dce")
    assert resolve_pass_names() == ("dce",)
    monkeypatch.setenv("PADDLE_TPU_PASSES", "nope")
    with pytest.raises(ValueError, match="nope"):
        resolve_pass_names()


def test_build_strategy_knobs_gate_passes(monkeypatch):
    bs = tfluid.BuildStrategy()
    assert resolve_pass_names(bs) == DEFAULT_PASSES
    bs.optimizer_overlap = True
    assert resolve_pass_names(bs)[-1] == "optimizer_overlap"
    bs.optimizer_overlap = False
    for knob, name in (("fuse_all_optimizer_ops", "fuse_optimizer"), ("memory_optimize", "dce"),
                       ("enable_inplace", "copy_prop"), ("fuse_conv_bn", "fuse_conv_bn"),
                       ("enable_layout_opt", "layout_opt")):
        setattr(bs, knob, False)
        assert name not in resolve_pass_names(bs)
    bs.constant_folding = False
    assert resolve_pass_names(bs) == ()
    monkeypatch.setenv("PADDLE_TPU_PASSES", "dce")
    assert resolve_pass_names(bs) == ("dce",)


def _fc_head(fluid, dead_head=True):
    x = fluid.layers.data("x", [4])
    h = fluid.layers.fc(x, 8)
    dead = fluid.layers.fc(h, 3) if dead_head else None
    return x, h, dead, fluid.layers.mean(h)


def test_original_program_is_not_mutated():
    main, _, (_, _, _, loss) = _guarded(tfluid, _fc_head)
    before = [op.to_dict() for op in main.global_block().ops]
    p2, _, stats = apply_program_passes(main, ("x",), (loss.name,))
    assert [op.to_dict() for op in main.global_block().ops] == before
    assert p2 is not main and stats["ops_after"] < stats["ops_before"]


# -- dce, copy_prop, const_fold -------------------------------------------------


def test_dce_removes_dead_ops_keeps_fetched():
    main, _, (_, _, dead, loss) = _guarded(tfluid, _fc_head)
    _, b2, stats = apply_program_passes(main, ("x",), (loss.name,))
    assert stats["passes"]["dce"] >= 2  # the dead fc: mul + elementwise_add
    assert dead.name not in {n for op in b2.ops for n in op.output_arg_names()}
    _, b3, _ = apply_program_passes(main, ("x",), (dead.name,))
    assert dead.name in {n for op in b3.ops for n in op.output_arg_names()}


def test_dce_keeps_persistable_writes():
    def build(fluid):
        x, h, _, loss = _fc_head(fluid, dead_head=False)
        block = fluid.default_main_program().global_block()
        shadow = block.create_var(name="shadow_stat", shape=[8], dtype="float32",
                                  persistable=True)
        block.append_op("reduce_sum", {"X": [h.name]}, {"Out": [shadow.name]},
                        {"dim": [0], "keep_dim": False})
        return loss

    main, startup, loss = _guarded(tfluid, build)
    _, b2, _ = apply_program_passes(main, ("x",), (loss.name,))
    assert any("shadow_stat" in op.output_arg_names() for op in b2.ops)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[loss], scope=scope)
    assert to_numpy(scope.get("shadow_stat")).shape == (8,)


def test_dce_keeps_order_rng_ops_and_collectives():
    def build(fluid):
        _, _, _, loss = _fc_head(fluid, dead_head=False)
        block = fluid.default_main_program().global_block()
        noise = block.create_var(name="dead_noise", shape=[2, 2], dtype="float32")
        block.append_op("uniform_random", {}, {"Out": [noise.name]},
                        {"shape": [2, 2], "min": -1.0, "max": 1.0, "dtype": "float32"})
        coll = block.create_var(name="dead_coll", shape=[2, 2], dtype="float32")
        block.append_op("c_allreduce_sum", {"X": [noise.name]}, {"Out": [coll.name]}, {})
        return loss

    main, _, loss = _guarded(tfluid, build)
    _, b2, _ = apply_program_passes(main, ("x",), (loss.name,))
    assert {"uniform_random", "c_allreduce_sum"} <= set(_types(b2))


def test_dropout_not_anchored():
    def build(fluid):
        _, h, _, loss = _fc_head(fluid, dead_head=False)
        fluid.layers.dropout(h, dropout_prob=0.5)  # dead
        return loss

    main, _, loss = _guarded(tfluid, build)
    _, b2, _ = apply_program_passes(main, ("x",), (loss.name,))
    assert "dropout" not in _types(b2)


def _regression(fluid, opt=None, hidden=None):
    x = fluid.layers.data("x", [8])
    y = fluid.layers.data("y", [1])
    h = fluid.layers.fc(x, hidden, act="relu") if hidden else x
    pred = fluid.layers.fc(h, 1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    (opt or fluid.optimizer.SGD(0.1)).minimize(loss)
    return loss


def test_copy_prop_drops_grad_accumulation_assigns():
    main, _, loss = _guarded(tfluid, _regression)
    n_assigns = _types(main.global_block()).count("assign")
    assert n_assigns >= 2
    _, b2, stats = apply_program_passes(main, ("x", "y"), (loss.name,))
    assert stats["passes"]["copy_prop"] >= n_assigns - 1
    fused = [op for op in b2.ops if op.type == "fused_sgd"]
    assert fused and all(g.endswith("@GRAD") for g in fused[0].input("Grad"))


def test_copy_prop_keeps_fetched_source_binding():
    def build(fluid):
        x = fluid.layers.data("x", [4])
        h = fluid.layers.fc(x, 4)
        block = fluid.default_main_program().global_block()
        alias = block.create_var(name="alias_out", shape=[4], dtype="float32")
        block.append_op("assign", {"X": [h.name]}, {"Out": [alias.name]}, {})
        return h, alias

    main, startup, (h, alias) = _guarded(tfluid, build)
    _, b2, _ = apply_program_passes(main, ("x",), (h.name, alias.name))
    assert "assign" in _types(b2)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    a, b = exe.run(main, feed={"x": np.random.RandomState(0).randn(2, 4).astype("float32")},
                   fetch_list=[h, alias], scope=scope)
    assert np.array_equal(a, b)


def _const_chain(fluid, str_value=""):
    """x + cast(cast(scale(fill_constant(3)) * 2 + 1, int32), float32)."""
    x = fluid.layers.data("x", [4])
    block = fluid.default_main_program().global_block()
    c = fluid.layers.fill_constant([4], "float32", 3.0)
    if str_value:
        block.ops[-1].attrs["str_value"] = str_value
    s = fluid.layers.scale(c, scale=2.0, bias=1.0)
    names = [s.name]
    for i, dtype in enumerate(("int32", "float32")):
        v = block.create_var(name=f"cast_{i}", shape=[4], dtype=dtype)
        block.append_op("cast", {"X": [names[-1]]}, {"Out": [v.name]},
                        {"in_dtype": "float32" if i == 0 else "int32", "out_dtype": dtype})
        names.append(v.name)
    return x + block.var(names[-1])


@pytest.mark.parametrize("str_value,want", [("", 7.0), ("2.5", 6.0)])
def test_const_fold_collapses_chain(str_value, want):
    """The chain folds into one assign_value (str_value over value, as the
    fill_constant lowering reads it), and the port and the JAX package
    fold it alike."""
    jfluid = _jax()
    from paddle_tpu.passes import apply_program_passes as japply

    tmain, tstartup, out = _guarded(tfluid, lambda f: _const_chain(f, str_value))
    jmain, _, jout = _guarded(jfluid, lambda f: _const_chain(f, str_value))
    _, b2, stats = apply_program_passes(tmain, ("x",), (out.name,))
    _, jb2, _ = japply(jmain, ("x",), (jout.name,))
    _assert_same_ops(jb2, b2)
    types = _types(b2)
    assert "fill_constant" not in types and "scale" not in types and "cast" not in types
    assert types.count("assign_value") == 1 and stats["passes"]["const_fold"] >= 3
    exe = tfluid.Executor(tfluid.CPUPlace())
    (ov,) = exe.run(tmain, feed={"x": np.zeros((2, 4), "float32")}, fetch_list=[out],
                    scope=tfluid.Scope())
    assert np.array_equal(ov, np.full((2, 4), want, np.float32))


def test_const_fold_skips_persistable_writes_and_feeds():
    def build(fluid):
        x = fluid.layers.data("x", [4])
        block = fluid.default_main_program().global_block()
        pv = block.create_var(name="pconst", shape=[4], dtype="float32", persistable=True)
        block.append_op("fill_constant", {}, {"Out": [pv.name]},
                        {"shape": [4], "value": 5.0, "dtype": "float32"})
        return x + pv

    main, _, out = _guarded(tfluid, build)
    _, b2, _ = apply_program_passes(main, ("x",), (out.name,))
    assert "fill_constant" in _types(b2)


# -- fused optimizers -----------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda f: f.optimizer.SGD(0.05),
    "momentum": lambda f: f.optimizer.Momentum(0.05, 0.9),
    "nesterov": lambda f: f.optimizer.Momentum(0.05, 0.9, use_nesterov=True),
    "adam": lambda f: f.optimizer.Adam(0.01),
    "adamw": lambda f: f.optimizer.AdamW(0.01, weight_decay=0.01),
    "lamb": lambda f: f.optimizer.Lamb(0.01),
}
FUSED_TYPE = {"nesterov": "fused_momentum"}


def _regression_steps(opt_name, monkeypatch, passes, steps=5, place=None):
    """5 steps of the fc regression -> (losses, persistables, op types)."""
    if passes is None:
        monkeypatch.delenv("PADDLE_TPU_PASSES", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_PASSES", passes)
    main, startup, loss = _guarded(
        tfluid, lambda f: _regression(f, OPTIMIZERS[opt_name](f), hidden=16))
    startup.random_seed = 11
    scope, exe = tfluid.Scope(), tfluid.Executor(place or tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(16, 8).astype("float32"), "y": rng.randn(16, 1).astype("float32")}
    losses = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0] for _ in range(steps)]
    state = {v.name: to_numpy(scope.get(v.name)) for v in main.list_vars() if v.persistable}
    types = _types(exe._passed_program(main, feed, [loss.name], scope).global_block())
    return np.concatenate(losses), state, types


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_fused_optimizer_matches_unfused(opt_name, monkeypatch):
    """The default pass set fuses the 4 per-parameter updates into one op,
    and its steps equal the unfused steps: bit for bit but for Lamb."""
    off, s_off, t_off = _regression_steps(opt_name, monkeypatch, "none")
    on, s_on, t_on = _regression_steps(opt_name, monkeypatch, None)
    base = "momentum" if opt_name == "nesterov" else opt_name
    assert t_off.count(base) == 4 and base not in t_on
    assert t_on.count(FUSED_TYPE.get(opt_name, f"fused_{base}")) == 1
    assert sorted(s_on) == sorted(s_off)
    if opt_name == "lamb":
        np.testing.assert_allclose(on, off, **FUSED_TOL)
        for n in s_off:
            np.testing.assert_allclose(s_on[n], s_off[n], err_msg=n, **FUSED_TOL)
    else:
        assert np.array_equal(on, off)
        for n in s_off:
            assert np.array_equal(s_on[n], s_off[n]), n


def _optimizer_op_inputs(rs, shapes, adam):
    """Per-parameter inputs of one optimizer op each, the beta powers of
    each parameter its own (a checkpoint may hold differing ones)."""
    ins = []
    for i, shape in enumerate(shapes):
        d = {"Param": rs.randn(*shape), "Grad": rs.randn(*shape), "Velocity": rs.randn(*shape),
             "Moment1": rs.randn(*shape) * 0.1, "Moment2": rs.rand(*shape) * 0.01}
        if adam:
            d["Beta1Pow"] = np.array([0.9 ** (i + 1)])
            d["Beta2Pow"] = np.array([0.999 ** (i + 2)])
        ins.append({k: v.astype(np.float32) for k, v in d.items()})
    return ins


ATTRS = {
    "sgd": {}, "momentum": {"mu": 0.9}, "nesterov": {"mu": 0.9, "use_nesterov": True},
    "adam": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
    "adamw": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "coeff": 0.01},
    "lamb": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6, "weight_decay": 0.01},
}


def _fused_against_per_op(name, device):
    """One fused op against its per-op lowerings on the same tensors ->
    [(slot, fused output, per-op output)]."""
    from paddle_tpu_torch.framework import Operator
    from paddle_tpu_torch.ops.registry import LoweringContext, lower_op
    from paddle_tpu_torch.passes.fuse_optimizer import FUSABLE

    base = "momentum" if name == "nesterov" else name
    per_param, _, out_slots = FUSABLE[base]
    rs = np.random.RandomState(5)
    ins = _optimizer_op_inputs(rs, [(7, 5), (5,), (3, 4, 2), (1,)], base not in ("sgd",
                                                                                 "momentum"))
    ctx = LoweringContext(device=device)
    ctx.values["lr"] = torch.tensor([0.01], device=device)
    names = []
    for i, d in enumerate(ins):
        names.append({s: f"{s}_{i}" for s in per_param})
        for s in per_param:
            ctx.values[f"{s}_{i}"] = torch.from_numpy(d[s]).to(device)
    per_op = []
    for i, nm in enumerate(names):
        op = Operator(None, base, {**{s: [nm[s]] for s in per_param}, "LearningRate": ["lr"]},
                      {s: [f"{s}_{i}_out"] for s in out_slots}, ATTRS[name])
        lower_op(ctx, op)
        per_op.append({s: ctx.values[f"{s}_{i}_out"] for s in out_slots})
    fused = Operator(None, f"fused_{base}",
                     {**{s: [nm[s] for nm in names] for s in per_param}, "LearningRate": ["lr"]},
                     {s: [f"{s}_{i}_fused" for i in range(len(names))] for s in out_slots},
                     ATTRS[name])
    lower_op(ctx, fused)
    return [(s, ctx.values[f"{s}_{i}_fused"], per_op[i][s]) for i in range(len(names))
            for s in out_slots]


@pytest.mark.parametrize("name", sorted(ATTRS))
def test_fused_lowering_equals_per_op_lowerings(name):
    """Each fused lowering against its per-op lowering on four parameters
    of different shapes, each with its own beta powers: bit-equal on the
    CPU, fused_lamb within rtol 1e-6, atol 1e-7."""
    for slot, got, want in _fused_against_per_op(name, torch.device("cpu")):
        assert got.shape == want.shape and got.dtype == want.dtype, slot
        if name == "lamb":
            np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=slot, **FUSED_TOL)
        else:
            assert torch.equal(got, want), slot


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ATTRS))
def test_cuda_fused_lowering_against_per_op(name):
    """On the card: each fused lowering (torch._foreach_* multi-tensor
    launches) against its per-op lowerings at rtol 1e-6, atol 1e-7, and
    whether they are bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_passes.py` on the card")
    pairs = _fused_against_per_op(name, torch.device("cuda"))
    bit_equal = all(torch.equal(got, want) for _, got, want in pairs)
    print(f"[fused optimizer on the card] {name}: bit-equal to the per-op lowering: "
          f"{bit_equal}")
    for slot, got, want in pairs:
        assert got.is_cuda and got.shape == want.shape and got.dtype == want.dtype, slot
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), err_msg=slot,
                                   **FUSED_TOL)


def test_fusion_skips_duplicate_params():
    def build(fluid):
        x = fluid.layers.data("x", [4])
        h = fluid.layers.fc(x, 4, bias_attr=False)
        loss = fluid.layers.mean(h)
        (p, g), = fluid.backward.append_backward(loss)
        block = fluid.default_main_program().global_block()
        lr = fluid.layers.fill_constant([1], "float32", 0.1)
        for _ in range(2):
            block.append_op("sgd", {"Param": [p.name], "Grad": [g.name],
                                    "LearningRate": [lr.name]},
                            {"ParamOut": [p.name]}, {"op_role": 2})
        return loss

    main, _, loss = _guarded(tfluid, build)
    _, b2, _ = apply_program_passes(main, ("x",), (loss.name,))
    assert "fused_sgd" not in _types(b2) and _types(b2).count("sgd") == 2


# -- end to end -----------------------------------------------------------------


def test_transformer_tiny_step_with_passes_on_and_off(monkeypatch):
    """Transformer-tiny (dropout 0.1, Adam), 3 steps from one seed: the
    losses with the default passes equal those without, within the JAX
    test's rtol 1e-6 / atol 1e-7 (measured bit-equal), and the forward
    graphs are reused with the passes on."""
    from paddle_tpu_torch.models.transformer import TransformerConfig, build_transformer

    b, s = 2, 8
    rng = np.random.RandomState(0)
    pos = np.tile(np.arange(s), (b, 1)).astype("int64")
    base_feed = {"src_ids": rng.randint(1, 64, (b, s)).astype("int64"),
                 "trg_ids": rng.randint(1, 64, (b, s)).astype("int64"),
                 "lbl_ids": rng.randint(1, 64, (b, s)).astype("int64"),
                 "src_mask": np.ones((b, s), "float32"), "trg_mask": np.ones((b, s), "float32")}
    cfg = TransformerConfig(src_vocab=64, trg_vocab=64, d_model=16, n_heads=2, d_ff=32,
                            n_layers=2, max_len=16, dropout=0.1)
    losses = {}
    for mode in ("none", None):
        if mode:
            monkeypatch.setenv("PADDLE_TPU_PASSES", mode)
        else:
            monkeypatch.delenv("PADDLE_TPU_PASSES")

        def build(fluid):
            h = build_transformer(cfg, b, s, s)
            fluid.optimizer.Adam(1e-3).minimize(h["loss"])
            return h

        main, startup, h = _guarded(tfluid, build)
        main.random_seed = startup.random_seed = 5
        feed = dict(base_feed, **{h["src_pos_name"]: pos, h["trg_pos_name"]: pos})
        scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        losses[mode] = [exe.run(main, feed=feed, fetch_list=[h["loss"]], scope=scope)[0]
                        for _ in range(3)]
        assert exe.recomputed_forwards == []
    assert np.array_equal(losses["none"], losses[None])
    np.testing.assert_allclose(losses[None], losses["none"], **FUSED_TOL)


def test_pass_cache_second_run_runs_no_pass(monkeypatch):
    main, startup, loss = _guarded(tfluid, _regression)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 8), np.float32), "y": np.ones((2, 1), np.float32)}
    before = tprofiler.counters().get("program_ops_before", 0)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    stats = exe.last_pass_stats
    assert stats["ops_before"] > stats["ops_after"] and stats["ms"] > 0
    after_first = tprofiler.counters()["program_ops_before"]
    assert after_first == before + stats["ops_before"]
    # the decode loop varies its batch: the shapes are not in the key
    feed4 = {"x": np.ones((4, 8), np.float32), "y": np.ones((4, 1), np.float32)}
    exe.run(main, feed=feed4, fetch_list=[loss], scope=scope)
    assert exe.last_pass_stats is None
    assert tprofiler.counters()["program_ops_before"] == after_first
    # another fetch list, scope or pass set runs the passes again
    exe.run(main, feed=feed, fetch_list=[], scope=scope)
    assert exe.last_pass_stats is not None
    monkeypatch.setenv("PADDLE_TPU_PASSES", "dce")
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert list(exe.last_pass_stats["passes"]) == ["dce"]
    monkeypatch.setenv("PADDLE_TPU_PASSES", "none")
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert exe.last_pass_stats is None
    (loss_off,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(loss_off).all()


def test_run_build_strategy_chooses_the_passes():
    """Executor.run's build_strategy gates the passes of that run, and the
    pass set's cache_signature is part of the cache key."""
    main, startup, loss = _guarded(tfluid, _regression)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 8), np.float32), "y": np.ones((2, 1), np.float32)}
    only_dce = tfluid.BuildStrategy()
    for knob in ("constant_folding", "enable_inplace", "fuse_conv_bn", "enable_layout_opt",
                 "fuse_all_optimizer_ops"):
        setattr(only_dce, knob, False)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope, build_strategy=only_dce)
    assert list(exe.last_pass_stats["passes"]) == ["dce"]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope, build_strategy=only_dce)
    assert exe.last_pass_stats is None
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert tuple(exe.last_pass_stats["passes"]) == DEFAULT_PASSES


def test_pass_cache_is_capped_and_holds_no_unchanged_program(monkeypatch):
    """At most _PASS_CACHE_CAP entries, the least recently used out first;
    an entry whose passes changed nothing holds no strong reference to
    the user's Program."""
    import gc
    import weakref

    from paddle_tpu_torch import executor as executor_mod

    monkeypatch.setattr(executor_mod, "_PASS_CACHE_CAP", 2)
    feed = {"x": np.ones((2, 8), np.float32), "y": np.ones((2, 1), np.float32)}
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    programs = []
    for _ in range(3):
        main, startup, loss = _guarded(tfluid, _regression)
        exe.run(startup, scope=scope)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        programs.append((main, loss))
    assert len(exe._pass_cache) == 2
    # the first program's entry went first; a run of it passes again
    exe.run(programs[0][0], feed=feed, fetch_list=[programs[0][1]], scope=scope)
    assert exe.last_pass_stats is not None and len(exe._pass_cache) == 2

    monkeypatch.setenv("PADDLE_TPU_PASSES", "none")
    main, startup, loss = _guarded(tfluid, _regression)
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    ref = weakref.ref(main)
    del main, startup, loss
    gc.collect()
    assert ref() is None


def test_eval_clone_folds_again_after_a_training_step(monkeypatch):
    """Paddle's loop of train, eval, train, eval on one Executor and one
    scope: each training step writes new conv weights and BN statistics,
    so each eval after one folds them again (fuse_conv_bn's gate, rtol
    1e-5 atol 1e-6, against the same loop with PADDLE_TPU_PASSES=none);
    an eval with no step before it runs no pass. Only fuse_conv_bn runs,
    so the training steps of the two loops are the same program and the
    loops' states stay bit-equal."""
    main, startup, (pred, loss) = _guarded(
        tfluid, lambda f: _resnet(f, depth=18, b=4, hw=32, classes=10))
    main.random_seed = startup.random_seed = 3
    test = main.clone(for_test=True)
    rs = np.random.RandomState(4)
    feed = {"img": rs.rand(4, 3, 32, 32).astype("float32"),
            "label": rs.randint(0, 10, (4, 1)).astype("int64")}
    evals, stats = {}, {}
    for mode in ("none", "fuse_conv_bn"):
        monkeypatch.setenv("PADDLE_TPU_PASSES", mode)
        scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        evals[mode], stats[mode] = [], []
        for _ in range(2):
            exe.run(main, feed=dict(feed), fetch_list=[loss], scope=scope)
            evals[mode].append(exe.run(test, feed=dict(feed), fetch_list=[pred],
                                       scope=scope)[0])
            stats[mode].append(exe.last_pass_stats)
        exe.run(test, feed=dict(feed), fetch_list=[pred], scope=scope)
        stats[mode].append(exe.last_pass_stats)
    assert all(s["passes"]["fuse_conv_bn"] > 0 for s in stats["fuse_conv_bn"][:2])
    assert stats["fuse_conv_bn"][2] is None
    # the step between the evals moved the outputs well past the gate
    assert np.abs(evals["none"][1] - evals["none"][0]).max() > 1e-3
    for i, (on, off) in enumerate(zip(evals["fuse_conv_bn"], evals["none"])):
        np.testing.assert_allclose(on, off, rtol=1e-5, atol=1e-6, err_msg=f"eval {i}")


def test_profiler_counters_present():
    main, startup, loss = _guarded(tfluid, _regression)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": np.ones((2, 8), np.float32), "y": np.ones((2, 1), np.float32)},
            fetch_list=[loss], scope=scope)
    c = tprofiler.counters()
    for name in ("pass_manager_us", "pass_copy_prop_ops_removed", "pass_dce_us"):
        assert name in c, name
    assert c["program_ops_before"] >= c["program_ops_after"] > 0


def test_unfetched_loss_runs_its_forward_in_its_grad_op():
    """dce drops the forward op of an unfetched loss, as in the JAX
    package; its __auto_grad__ then runs that forward once (the port's
    grad op would otherwise read an unbound output), and the step equals
    the one that fetched the loss."""
    states = []
    for fetch in (True, False):
        main, startup, loss = _guarded(tfluid, _regression)
        scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        feed = {"x": np.random.RandomState(1).randn(4, 8).astype(np.float32),
                "y": np.ones((4, 1), np.float32)}
        exe.run(main, feed=feed, fetch_list=[loss] if fetch else [], scope=scope)
        assert exe.recomputed_forwards == []
        assert exe.deferred_forwards == ([] if fetch else ["mean"])
        states.append({v.name: to_numpy(scope.get(v.name)) for v in main.list_vars()
                       if v.persistable})
    for n in states[0]:
        assert np.array_equal(states[0][n], states[1][n]), n


# -- layout_opt -----------------------------------------------------------------


def _resnet18_steps(monkeypatch, passes, state, feed):
    """One ResNet-18 step (32x32, b 4, Momentum) from `state` ->
    (loss, persistables, the executor)."""
    if passes is None:
        monkeypatch.delenv("PADDLE_TPU_PASSES", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_PASSES", passes)
    main, startup, (_, loss) = _guarded(
        tfluid, lambda f: _resnet(f, depth=18, b=4, hw=32, classes=10))
    main.random_seed = startup.random_seed = 3
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    if state is not None:
        tfluid.io.set_persistables_from_numpy(scope, state, "cpu")
    (lv,) = exe.run(main, feed=dict(feed), fetch_list=[loss], scope=scope)
    return float(lv[0]), {v.name: to_numpy(scope.get(v.name)) for v in main.list_vars()
                          if v.persistable and scope.has(v.name)}, exe, main


def test_layout_opt_resnet18_steps_from_one_state(monkeypatch):
    """Three ResNet-18 steps, each from the state the unpassed run reached:
    NHWC (layout_opt) with fused momentum against the authored NCHW program,
    at the ResNet gates of tests/test_torch_resnet.py."""
    rs = np.random.RandomState(0)
    feed = {"img": rs.rand(4, 3, 32, 32).astype("float32"),
            "label": rs.randint(0, 10, (4, 1)).astype("int64")}
    state = None
    for step in range(3):
        l_off, s_off, _, _ = _resnet18_steps(monkeypatch, "none", state, feed)
        l_on, s_on, exe, main = _resnet18_steps(monkeypatch, None, state, feed)
        assert exe.recomputed_forwards == []
        np.testing.assert_allclose(l_on, l_off, rtol=RN_LOSS_RTOL, atol=0, err_msg=f"{step}")
        for n in s_off:
            scale = max(float(np.abs(s_off[n]).max()), 1e-30)
            assert float(np.abs(s_on[n] - s_off[n]).max()) <= RN_STATE_TOL * scale, (step, n)
        state = s_off
    block = exe._passed_program(main, feed, [], tfluid.global_scope()).global_block()
    assert all(op.attr("data_format") == "NHWC" for op in block.ops if op.type == "conv2d")
    assert all(op.attr("data_layout") == "NHWC" for op in block.ops
               if op.type in ("batch_norm", "batch_norm_grad"))


def _conv_block(fluid, train, fetch_conv=False, channel_bias=False):
    img = fluid.layers.data("img", [2, 3, 8, 8], append_batch_size=False)
    conv = fluid.layers.conv2d(img, 4, 3, padding=1, bias_attr=False)
    h = fluid.layers.batch_norm(conv, act="relu")
    if channel_bias:  # a [C] bias on axis 1
        bias = fluid.default_main_program().global_block().create_parameter(
            "cbias", [4], "float32")
        h = fluid.layers.elementwise_add(h, bias, axis=1)
    pool = fluid.layers.pool2d(h, pool_size=2, pool_type="max", pool_stride=2)
    loss = fluid.layers.mean(pool)
    if train:
        fluid.optimizer.SGD(0.1).minimize(loss)
    return [conv, loss] if fetch_conv else [pool, loss]


@pytest.mark.parametrize("train", [True, False])
def test_layout_opt_keeps_fetched_intermediate_nchw(train, monkeypatch):
    """A fetched conv activation keeps its authored NCHW layout (the conv
    writes NHWC under a fresh name and a transpose writes it back). In
    training the conv's __auto_grad__ follows the rename (fwd_outputs), so
    it finds the conv's graph and re-runs nothing; values within the
    single-op gates of passes off."""
    feed = {"img": np.random.RandomState(0).rand(2, 3, 8, 8).astype("float32")}
    runs = {}
    for mode in ("none", "layout_opt"):
        monkeypatch.setenv("PADDLE_TPU_PASSES", mode)
        main, startup, fetch = _guarded(tfluid, lambda f: _conv_block(f, train, True))
        main.random_seed = startup.random_seed = 1
        scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        runs[mode] = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
                      for _ in range(2)]
        assert exe.recomputed_forwards == []
        block = exe._passed_program(main, feed, [v.name for v in fetch], scope).global_block()
    conv = next(op for op in block.ops if op.type == "conv2d")
    assert conv.attr("data_format") == "NHWC" and conv.output("Output")[0] != fetch[0].name
    if train:
        twin = next(op for op in block.ops if op.type == "__auto_grad__"
                    and op.attr("fwd_type") == "conv2d")
        assert twin.attr("fwd_outputs") == conv.outputs
    for off, on in zip(runs["none"], runs["layout_opt"]):
        assert on[0].shape == (2, 4, 8, 8)
        for a, b in zip(off, on):
            np.testing.assert_allclose(b, a, **TOL)


def test_layout_opt_inference_channel_bias_axis(monkeypatch):
    """In an inference program a [C] bias on axis 1 converts with the
    region, its axis rewritten to 3; in training it stays NCHW."""
    feed = {"img": np.random.RandomState(2).rand(2, 3, 8, 8).astype("float32")}
    main, startup, fetch = _guarded(tfluid, lambda f: _conv_block(f, False, channel_bias=True))
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    tfluid.io.set_persistables_from_numpy(scope, {"cbias": np.arange(4, dtype=np.float32)},
                                          "cpu")
    outs = {}
    for mode in ("none", "layout_opt"):
        monkeypatch.setenv("PADDLE_TPU_PASSES", mode)
        outs[mode] = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    block = exe._passed_program(main, feed, [v.name for v in fetch], scope).global_block()
    add = next(op for op in block.ops if op.type == "elementwise_add")
    assert add.attr("axis") == 3 and add.input("X")[0] in {
        n for op in block.ops if op.type == "batch_norm" for n in op.output("Y")} | {
        n for op in block.ops if op.type == "relu" for n in op.output("Out")}
    assert _types(block).count("transpose2") == 2  # the image in, the pool out
    for a, b in zip(outs["none"], outs["layout_opt"]):
        np.testing.assert_allclose(b, a, **TOL)
    _, tblock, _ = apply_program_passes(
        _guarded(tfluid, lambda f: _conv_block(f, True, channel_bias=True))[0], ("img",),
        ("mean_0.tmp_0",))
    assert next(op for op in tblock.ops if op.type == "elementwise_add").attr("axis") == 1


@pytest.mark.parametrize("axis", [(0, 2, 3, 1), (0, 3, 1, 2)])
def test_boundary_transpose_and_grad_match_jax(axis):
    """transpose2 at the two boundary permutations layout_opt inserts, and
    its grad, against the JAX package's."""
    from test_torch_bert_training import _data, _run_op_case, _with_grads

    shape = [2, 3, 4, 5]
    out_shape = [shape[a] for a in axis]

    def build(fluid):
        x = _data(fluid, "x", shape)
        return _with_grads(fluid, fluid.layers.transpose(x, list(axis)), [x])

    rs = np.random.RandomState(4)
    jax_out, port_out = _run_op_case(build, {
        "x": rs.randn(*shape).astype(np.float32), "g": rs.randn(*out_shape).astype(np.float32)})
    for j, t in zip(jax_out, port_out):
        assert np.array_equal(t, j)


def test_layout_opt_stats_and_counters():
    main, _, (_, loss) = _guarded(tfluid, lambda f: _resnet(f, depth=18, b=2, hw=32,
                                                            classes=10))
    p2, b2, _ = apply_program_passes(main, ("img", "label"), (loss.name,))
    lo = p2._layout_opt_stats
    assert (lo["removed"] - lo["inserted"]) / (lo["removed"] + lo["remaining"]) >= 0.8, lo
    assert lo["inserted"] == 3 and lo["converted_ops"] > 0
    c = tprofiler.counters()
    assert c["pass_layout_opt_transposes_removed"] > 0
    assert c["transpose_ops_before"] > c["transpose_ops_after"] == 3
    for op in b2.ops:
        if op.type in ("conv2d", "pool2d"):
            assert op.attr("data_format") == "NHWC", op
        if op.type == "batch_norm":
            assert op.attr("data_layout") == "NHWC", op


# -- fuse_conv_bn ---------------------------------------------------------------


def _eval_runs(monkeypatch, modes):
    """ResNet-18's eval clone (32x32, b 2) from one startup state, served
    through the Executor under each pass mode -> {mode: (probs, block)}."""
    main, startup, (pred, _) = _guarded(
        tfluid, lambda f: _resnet(f, depth=18, b=2, hw=32, classes=10, train=False))
    test = main.clone(for_test=True)
    state_scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=state_scope)
    # non-trivial running statistics, so the fold does work
    rs = np.random.RandomState(9)
    for v in test.list_vars():
        if v.persistable and v.name.endswith((".mean", ".var")):
            t = to_numpy(state_scope.get(v.name))
            state_scope.set(v.name, torch.from_numpy(
                (rs.rand(*t.shape) * 0.5 + (0.75 if v.name.endswith(".var") else -0.25))
                .astype(np.float32)))
    feed = {"img": rs.rand(2, 3, 32, 32).astype("float32"),
            "label": rs.randint(0, 10, (2, 1)).astype("int64")}
    out = {}
    for mode in modes:
        monkeypatch.setenv("PADDLE_TPU_PASSES", mode)
        scope = tfluid.Scope()
        for v in test.list_vars():
            if v.persistable and state_scope.has(v.name):
                scope.set(v.name, state_scope.get(v.name).clone())
        exe = tfluid.Executor(tfluid.CPUPlace())
        (probs,) = exe.run(test, feed=feed, fetch_list=[pred], scope=scope)
        out[mode] = (probs, exe._passed_program(test, feed, [pred.name], scope).global_block(),
                     scope)
    return out


def test_fuse_conv_bn_inference_within_tolerance(monkeypatch):
    runs = _eval_runs(monkeypatch, ["none", "fuse_conv_bn", "all"])
    off = runs["none"][0]
    for mode in ("fuse_conv_bn", "all"):
        np.testing.assert_allclose(runs[mode][0], off, rtol=1e-5, atol=1e-6, err_msg=mode)


def test_fuse_conv_bn_rewrites_the_graph(monkeypatch):
    runs = _eval_runs(monkeypatch, ["fuse_conv_bn"])
    _, block, scope = runs["fuse_conv_bn"]
    assert "batch_norm" not in _types(block)
    convs = [op for op in block.ops if op.type == "conv2d"]
    assert all(op.input("Bias") for op in convs)
    assert any(op.attr("fused_act") == "relu" for op in convs)
    wf = convs[0].input("Filter")[0]
    assert wf.endswith("@bnfold.w") and isinstance(scope.get(wf), torch.Tensor)


def test_fuse_conv_bn_never_fires_on_training(monkeypatch):
    main, startup, (_, loss) = _guarded(
        tfluid, lambda f: _resnet(f, depth=18, b=2, hw=32, classes=10))
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    monkeypatch.setenv("PADDLE_TPU_PASSES", "fuse_conv_bn")
    _, b2, stats = apply_program_passes(main, ("img", "label"), (loss.name,), scope=scope)
    assert stats["passes"]["fuse_conv_bn"] == 0 and "batch_norm" in _types(b2)


def test_predictor_folds_the_export(tmp_path):
    """AnalysisPredictor runs the export through the Executor with its
    scope, so fuse_conv_bn folds every batch norm of a ResNet-18 export,
    and its predictions match the unpassed program's; switch_ir_optim is
    stored as the JAX Config stores it."""
    from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor

    main, startup, (pred, _) = _guarded(
        tfluid, lambda f: _resnet(f, depth=18, b=2, hw=32, classes=10))
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(str(tmp_path), ["img"], [pred], exe,
                                       main_program=main.clone(for_test=True))
    config = AnalysisConfig(str(tmp_path))
    config.disable_gpu()
    assert config.ir_optim()
    config.switch_ir_optim(False)
    assert not config.ir_optim()
    predictor = create_paddle_predictor(config)
    feed = {"img": np.random.RandomState(3).rand(2, 3, 32, 32).astype("float32")}
    (probs,) = predictor.run(dict(feed))
    stats = predictor._exe.last_pass_stats
    block = predictor._exe._passed_program(predictor.program(), feed,
                                           predictor.get_output_names(),
                                           predictor._scope).global_block()
    assert stats["passes"]["fuse_conv_bn"] > 0 and "batch_norm" not in _types(block)
    (want,) = exe.run(main.clone(for_test=True), feed=feed, fetch_list=[pred], scope=scope)
    np.testing.assert_allclose(probs, want, rtol=1e-5, atol=1e-6)


# -- optimizer_overlap -----------------------------------------------------------


def test_optimizer_overlap_groups_before_last_grad_and_bitwise(monkeypatch):
    from paddle_tpu_torch.framework import core_op_role

    def build(fluid):
        x = fluid.layers.data("x", [16])
        h = x
        for i in range(4):
            h = fluid.layers.fc(h, 16, act="relu", name=f"stack_{i}")
        loss = fluid.layers.mean(h)
        fluid.optimizer.Adam(1e-3).minimize(loss)
        return loss

    losses = {}
    for mode in ("off", "on"):
        if mode == "on":
            monkeypatch.setenv("PADDLE_TPU_OPTIMIZER_OVERLAP", "1")
        else:
            monkeypatch.delenv("PADDLE_TPU_OPTIMIZER_OVERLAP", raising=False)
        main, startup, loss = _guarded(tfluid, build)
        startup.random_seed = 2
        before = tprofiler.counters().get("optimizer_overlap_groups", 0)
        _, blk, _ = apply_program_passes(main, ("x",), (loss.name,))
        n_waves = _types(blk).count("fused_adam")
        if mode == "on":
            last_bwd = max(i for i, op in enumerate(blk.ops)
                           if op.attr("op_role", 0) & core_op_role.Backward
                           and op.type != "fused_adam")
            early = sum(1 for i, op in enumerate(blk.ops)
                        if op.type == "fused_adam" and i < last_bwd)
            assert n_waves >= 2 and early >= 2
            assert tprofiler.counters()["optimizer_overlap_groups"] >= before + 2
        else:
            assert n_waves == 1
        scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        xv = np.random.RandomState(3).randn(2, 16).astype("float32")
        losses[mode] = [exe.run(main, feed={"x": xv}, fetch_list=[loss], scope=scope)[0]
                        for _ in range(3)]
        assert exe.recomputed_forwards == []
    assert np.array_equal(losses["off"], losses["on"])
