"""The fluid surface the port lacked against the JAX package's (ROADMAP
Queue 3, items 1-4): each test makes the same calls on both packages and
compares what they give.

1. `Executor.run(..., use_program_cache=...)` and `Executor.close()`.
2. `Scope`'s parent chain, `var`, `find_var` with its tensor views,
   `new_scope`, `drop_kids`, `delete` and `local_names`.
3. `AnalysisConfig(model_dir, params_file)`, `set_model`, the recorded
   deployment knobs, `AnalysisPredictor.get_input_tensor /
   get_output_tensor / clone` and `create_predictor`.
4. `Block.has_var / prepend_op`, `Operator.set_attr`,
   `Program.fingerprint`, `Variable.numel`, `name_scope`, `cpu_places`
   and `cuda_pinned_places`.
"""

import numpy as np
import pytest

import paddle_tpu_torch as tfluid


def _jfluid():
    import paddle_tpu

    return paddle_tpu


def _fc_program(fluid, opt=True):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 32, act="relu", param_attr=fluid.initializer.Constant(0.05))
        pred = fluid.layers.fc(h, 1, param_attr=fluid.initializer.Constant(0.1))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        if opt:
            fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss, pred


def _batches(n=3, b=8):
    rng = np.random.RandomState(3)
    w = rng.randn(16, 1).astype("float32")
    return [(xv, xv @ w) for xv in (rng.randn(b, 16).astype("float32") for _ in range(n))]


# -- 1. Executor ------------------------------------------------------------------


def test_executor_use_program_cache_and_close_match_jax():
    # per run: use_program_cache, close() before it, whether the port's
    # passes ran (False: found in the cache)
    flags = [True, True, False, True, True]
    close_before = {3}
    ran = [True, False, True, True, False]
    losses = {}
    for tag, fluid in (("jax", _jfluid()), ("torch", tfluid)):
        main, startup, loss, _ = _fc_program(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        out = []
        for i, (xv, yv) in enumerate(_batches(len(flags))):
            if i in close_before:
                exe.close()
                if tag == "torch":
                    assert len(exe._pass_cache) == 0
            n = len(exe._pass_cache) if tag == "torch" else 0
            (lv,) = exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss], scope=scope,
                            use_program_cache=flags[i])
            out.append(float(np.asarray(lv).reshape(-1)[0]))
            if tag == "torch":
                assert (exe.last_pass_stats is not None) == ran[i], i
                if not flags[i]:  # nothing kept
                    assert len(exe._pass_cache) == n
        losses[tag] = out
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5, atol=1e-6)


# -- 2. Scope ---------------------------------------------------------------------


def _scope_calls(fluid):
    out = {}
    root = fluid.Scope()
    root.set("w", np.arange(6, dtype="float32").reshape(2, 3))
    kid = root.new_scope()
    kid.set("b", np.ones(3, "float32"))
    out["kid_sees_parent"] = (kid.has("w"), np.asarray(kid.get("w")).tolist())
    out["parent_sees_kid"] = root.has("b")
    out["kid_local"] = sorted(kid.local_names())
    with pytest.raises(KeyError, match="not found"):
        root.get("b")
    out["find_missing"] = root.find_var("nope") is None
    view = kid.find_var("w")
    out["view_name"] = view.name
    out["view_array"] = np.asarray(view.get_tensor()).tolist()
    out["view_shape"] = view.get_tensor().shape()
    out["view_value"] = np.asarray(view.get_value()).tolist()
    view.get_tensor().set(np.zeros((2, 3), "float32"))
    out["after_set_kid"] = np.asarray(kid.get("w")).tolist()
    out["after_set_root"] = np.asarray(root.get("w")).tolist()
    v = root.var("fresh")
    out["var_entry"] = (v.name, root.has("fresh"), root.get("fresh"))
    root.delete("fresh")
    root.delete("never")
    out["after_delete"] = sorted(root.local_names())
    root.drop_kids()
    out["kid_after_drop"] = kid.has("w")
    return out


def test_scope_fluid_surface_matches_jax():
    assert _scope_calls(tfluid) == _scope_calls(_jfluid())


# -- 3. Inference -----------------------------------------------------------------


def test_inference_config_and_predictor_surface_match_jax(tmp_path):
    jfluid = _jfluid()
    main, startup, loss, pred = _fc_program(jfluid, opt=False)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(str(tmp_path), ["x"], [pred], exe, main_program=main)
    xv = _batches(1)[0][0]
    got = {}
    from paddle_tpu import inference as jinf
    from paddle_tpu_torch import inference as tinf

    for tag, inf in (("jax", jinf), ("torch", tinf)):
        cfg = inf.AnalysisConfig(str(tmp_path), "params")
        cfg.set_model(str(tmp_path), "weights")
        cfg.disable_gpu()
        cfg.enable_memory_optim()
        cfg.enable_mkldnn()
        cfg.enable_tensorrt_engine(1 << 20, 1)
        cfg.set_cpu_math_library_num_threads(4)
        cfg.enable_profile()
        cfg.switch_use_feed_fetch_ops(False)
        cfg.switch_specify_input_names(True)
        cfg.switch_ir_optim(False)
        rec = (cfg.model_dir(), cfg._params_file, cfg._memory_optim, cfg._cpu_math_threads,
               cfg._enable_profile, cfg.ir_optim(), cfg.use_gpu())
        pred_ = inf.create_predictor(cfg)
        h = pred_.get_input_tensor("x")
        h.copy_from_cpu(xv)
        pred_.zero_copy_run()
        out = pred_.get_output_tensor(pred_.get_output_names()[0]).copy_to_cpu()
        twin = pred_.clone()
        assert twin is not pred_ and twin._scope is not pred_._scope
        (again,) = twin.run({"x": xv})
        got[tag] = (rec, out, again, pred_.get_input_names())
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][3] == got["jax"][3] == ["x"]
    np.testing.assert_allclose(got["torch"][1], got["jax"][1], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["torch"][2], got["torch"][1])
    assert tinf.create_predictor is tinf.create_paddle_predictor


# -- 4. IR ------------------------------------------------------------------------


def _ir_calls(fluid):
    from importlib import import_module

    framework = import_module(fluid.__name__ + ".framework")
    out = {}
    main, startup, loss, pred = _fc_program(fluid, opt=False)
    block = main.global_block()
    out["has"] = (block.has_var("x"), block.has_var(loss.name), block.has_var("nope"))
    out["numel"] = (block.var("x").numel(), block.var("fc_0.w_0").numel(),
                    framework.Variable(block, "noshape", shape=None).numel())
    fp0 = main.fingerprint()
    out["fp_stable"] = fp0 == main.fingerprint()
    op = block.ops[0]
    op.set_attr("probe", 7)
    out["set_attr"] = op.attr("probe")
    fp1 = main.fingerprint()
    out["fp_moves"] = fp1 != fp0
    n = len(block.ops)
    block.create_var(name="c0", shape=[1], dtype="float32")
    first = block.prepend_op("fill_constant", {}, {"Out": ["c0"]},
                             {"shape": [1], "value": 1.0, "dtype": "float32"})
    out["prepend"] = (block.ops[0] is first, len(block.ops) == n + 1, first.type)
    with framework.name_scope("enc"):
        with framework.name_scope("layer0"):
            out["name_scope"] = list(framework._name_scope_stack.stack)
    out["name_scope_after"] = list(framework._name_scope_stack.stack)
    out["cpu_places"] = [type(p).__name__ for p in framework.cpu_places(3)]
    out["pinned"] = [type(p).__name__ for p in framework.cuda_pinned_places()]
    return out, fp0, fp1


def test_ir_surface_matches_jax(monkeypatch):
    monkeypatch.setenv("CPU_NUM", "2")
    t, tfp0, tfp1 = _ir_calls(tfluid)
    j, jfp0, jfp1 = _ir_calls(_jfluid())
    assert t == j
    from paddle_tpu_torch import framework as tfw

    assert len(tfw.cpu_places()) == 2
    # the Programs serialize alike, so their structural hashes agree
    assert (tfp0, tfp1) == (jfp0, jfp1)
