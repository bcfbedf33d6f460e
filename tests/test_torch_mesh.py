"""The port's mesh and CompiledProgram on one process, held against the JAX
package (paddle_tpu/parallel/mesh.py, paddle_tpu/compiler.py,
tests/test_mesh.py):

- the axis vocabulary, `canonicalize_spec`, the manifest form of a spec,
  `mesh_signature`, the mesh counters and the IR analysis
  (`zero1_accumulators`, `pipe_shardable_state`) on the same Program equal
  the JAX functions' results;
- the 1x1x1 mesh (no process group) against `Executor.run`, train and
  eval, bit for bit; the port's CompiledProgram(places=1) against the JAX
  one within tests/test_mesh.py's tolerances;
- what waits for later items raises naming it; the zero1 flag lives on the
  handle; the dygraph JIT bridge's key carries the mesh signature; a
  snapshot under the mesh records it as the JAX package does.

The multi-rank paths (2 gloo ranks) are in tests/test_torch_data_parallel.py.
"""

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.parallel import mesh as tmesh


def _jax():
    import jax

    import paddle_tpu
    from paddle_tpu.parallel import mesh as jmesh

    return jax, paddle_tpu, jmesh


@pytest.fixture(autouse=True)
def _no_mesh_left():
    """Meshes are process-wide: leave both packages' current mesh as found."""
    old = tmesh.current_mesh()
    jmesh = _jax()[2]
    jold = jmesh.current_mesh()
    yield
    tmesh.set_current_mesh(old)
    jmesh.set_current_mesh(jold)


def _build(fluid, main, startup, lr=1e-2, opt="adam"):
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 32, act="relu", param_attr=fluid.initializer.Constant(0.05))
        pred = fluid.layers.fc(h, 1, param_attr=fluid.initializer.Constant(0.1))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        if opt == "adam":
            fluid.optimizer.Adam(lr).minimize(loss)
        elif opt == "momentum":
            fluid.optimizer.Momentum(lr, 0.9).minimize(loss)
        elif opt == "lamb":
            fluid.optimizer.Lamb(lr).minimize(loss)
        else:
            fluid.optimizer.SGD(lr).minimize(loss)
    return loss, pred


def _batches(n=6, b=16):
    rng = np.random.RandomState(3)
    w_true = rng.randn(16, 1).astype("float32")
    return [(xv, xv @ w_true) for xv in (rng.randn(b, 16).astype("float32") for _ in range(n))]


# -- vocabulary, specs, signature, counters, IR analysis --------------------------


def test_axis_vocabulary_and_specs_match_jax():
    _, _, jmesh = _jax()
    from jax.sharding import PartitionSpec as JP

    assert tmesh.AXES == jmesh.AXES
    for name in ("dp", "data", "batch", "tp", "mp", "sp", "ep", "model", "pp", "stage",
                 "pipe", None):
        assert tmesh.canonical_axis(name) == jmesh.canonical_axis(name), name
    with pytest.raises(ValueError, match="unknown mesh axis"):
        tmesh.canonical_axis("bogus")
    specs = [("dp", "tp", "sp", None), (("dp", "pp"), "tp"), (), ("ep",), (None, "model")]
    for parts in specs:
        t, j = tmesh.canonicalize_spec(tmesh.P(*parts)), jmesh.canonicalize_spec(JP(*parts))
        assert tuple(t) == tuple(j) and str(t) == str(j), parts
        assert tmesh.spec_to_manifest(tmesh.P(*parts)) == jmesh.spec_to_manifest(JP(*parts))
        m = jmesh.spec_to_manifest(JP(*parts))
        assert tuple(tmesh.spec_from_manifest(m)) == tuple(jmesh.spec_from_manifest(m))
    assert tuple(tmesh.canonicalize_spec(None)) == tuple(jmesh.canonicalize_spec(None))
    assert tmesh.smaller_mesh_shapes(8) == jmesh.smaller_mesh_shapes(8)
    assert tmesh.axis_sizes({"batch": 2}) == jmesh.axis_sizes({"batch": 2})


def test_mesh_signature_and_counters_match_jax():
    jax, jfluid, jmesh = _jax()
    from jax.sharding import PartitionSpec as JP

    jm = jmesh.build_mesh(batch=1, model=1, pipe=1, devices=jax.devices()[:1])
    jc = {k: v for k, v in jfluid.profiler.counters().items() if k.startswith("mesh_")}
    tm = tmesh.build_mesh()
    tc = {k: v for k, v in tfluid.profiler.counters().items() if k.startswith("mesh_")}
    assert tm.device_mesh is None and dict(tm.shape) == dict(jm.shape)
    assert tc == jc
    assert tmesh.current_mesh() is tm
    assert tmesh.axis_sizes(tm) == jmesh.axis_sizes(jm)
    for specs in (None, {"w": ("tp", None)}, {"w": (None, "model"), "b": ("dp",)}):
        t = tmesh.mesh_signature(tm, specs and {k: tmesh.P(*v) for k, v in specs.items()})
        j = jmesh.mesh_signature(jm, specs and {k: JP(*v) for k, v in specs.items()})
        assert t == j, specs
    assert tmesh.mesh_signature(None) == jmesh.mesh_signature(None) == ("nomesh",)
    s1 = tmesh.mesh_signature(tm, {"w": tmesh.P(None, "tp")})
    assert s1 != tmesh.mesh_signature(tm, {"w": tmesh.P("tp", None)})
    assert s1 == tmesh.mesh_signature(tm, {"w": tmesh.P(None, "model")})


@pytest.mark.parametrize("opt", ["adam", "momentum", "lamb", "sgd"])
def test_ir_analysis_matches_jax(opt):
    _, jfluid, jmesh = _jax()
    got = {}
    for tag, fluid, mod in (("jax", jfluid, jmesh), ("torch", tfluid, tmesh)):
        main, startup = fluid.Program(), fluid.Program()
        _build(fluid, main, startup, opt=opt)
        block = main.global_block()
        state = sorted(v.name for v in main.list_vars() if v.persistable)
        got[tag] = {
            axis: {n: tuple(s) for n, s in mod.zero1_accumulators(block, state, axis).items()}
            for axis in (1, 2, 8, 3)
        } | {
            f"pipe{axis}": {n: tuple(s) for n, s in
                            mod.pipe_shardable_state(block, state, axis).items()}
            for axis in (2, 4)
        }
    assert got["torch"] == got["jax"]
    if opt in ("adam", "lamb", "momentum"):
        assert got["torch"][2], "the fc weights' accumulators shard on a batch of 2"


def test_degrade_rule_matches_jax():
    _, _, jmesh = _jax()
    from torch.distributed.tensor import Replicate, Shard

    tm = tmesh.build_mesh()
    placements, fell = tmesh.sharding_with_degrade(tm, tmesh.P("batch", None), (16, 4))
    assert placements == (Shard(0), Replicate(), Replicate()) and fell == []
    assert tmesh.named_sharding(tm, None, (3,)) == (Replicate(),) * 3
    assert tuple(tmesh.spec_of_placements(placements)) == ("batch",)
    assert tuple(tmesh.spec_of_placements((Replicate(), Shard(1), Shard(1)))) == (
        None, ("model", "pipe"))
    # a batch of 1 divides every dim: nothing degrades on the unit mesh
    assert tmesh.sharding_with_degrade(tm, tmesh.P("dp"), (7,))[1] == []

    class _Fake:  # a 2-wide batch axis, for the rule alone
        axis_names = tmesh.AXES
        shape = {"batch": 2, "model": 1, "pipe": 1}

    t = tmesh.sharding_with_degrade(_Fake(), tmesh.P("batch"), (7,))
    j = jmesh.sharding_with_degrade(
        jmesh.build_mesh(batch=2), jmesh.canonicalize_spec(("batch",)), (7,))
    assert t[1] == j[1] == [(0, ("batch",), 7, 2)]
    assert t[0] == (Replicate(),) * 3


# -- the 1x1x1 mesh against Executor.run ------------------------------------------


@pytest.mark.parametrize("places", [None, 1, [tfluid.CPUPlace()]])
def test_unit_mesh_bitwise_equal_train(places):
    batches = _batches()
    exe = tfluid.Executor(tfluid.CPUPlace())
    out = {}
    for mode in ("single", "mesh"):
        main, startup = tfluid.Program(), tfluid.Program()
        loss, pred = _build(tfluid, main, startup)
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        prog = main
        if mode == "mesh":
            prog = tfluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name, places=places)
            assert dict(prog._get_mesh().shape) == {"batch": 1, "model": 1, "pipe": 1}
            assert prog._get_mesh().device_mesh is None
        out[mode] = ([exe.run(prog, feed={"x": xv, "y": yv}, fetch_list=[loss, pred],
                              scope=scope) for xv, yv in batches], scope, main)
    for a, b in zip(out["single"][0], out["mesh"][0]):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    for v in out["single"][2].list_vars():
        if v.persistable and out["single"][1].has(v.name):
            np.testing.assert_array_equal(
                tfluid.scope.to_numpy(out["single"][1].get(v.name)),
                tfluid.scope.to_numpy(out["mesh"][1].get(v.name)))


def test_unit_mesh_bitwise_equal_eval():
    batches = _batches(n=2)
    results = {}
    for mode in ("single", "mesh"):
        exe = tfluid.Executor(tfluid.CPUPlace())
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
            x = tfluid.layers.data("x", [16])
            y = tfluid.layers.data("y", [1])
            h = tfluid.layers.fc(x, 32, act="relu")
            h = tfluid.layers.dropout(h, 0.3)
            pred = tfluid.layers.fc(h, 1)
            loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
            test_prog = main.clone(for_test=True)
        main.random_seed = startup.random_seed = 9
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        prog = test_prog
        if mode == "mesh":
            prog = tfluid.CompiledProgram(test_prog).with_data_parallel(
                loss_name=loss.name, places=1)
        results[mode] = [exe.run(prog, feed={"x": xv, "y": yv}, fetch_list=[loss, pred],
                                 scope=scope) for xv, yv in batches]
    for a, b in zip(results["single"], results["mesh"]):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def test_unit_mesh_dropout_draws_executor_run_masks():
    """The seed counter advances after each dispatch on the mesh path as
    in Executor.run: the same masks step by step, bit for bit."""
    exe_out = {}
    for mode in ("single", "mesh"):
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = startup.random_seed = 4
        with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
            x = tfluid.layers.data("x", [16])
            h = tfluid.layers.dropout(tfluid.layers.fc(x, 32), 0.5)
            loss = tfluid.layers.mean(h)
            tfluid.optimizer.SGD(0.1).minimize(loss)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        prog = main if mode == "single" else tfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        exe_out[mode] = [exe.run(prog, feed={"x": xv}, fetch_list=[h], scope=scope)[0]
                         for xv, _ in _batches(3, 4)]
        assert exe._seed_counter == 4
    for a, b in zip(exe_out["single"], exe_out["mesh"]):
        np.testing.assert_array_equal(a, b)


def test_compiled_program_matches_jax_places_1():
    """The port's CompiledProgram against the JAX one on one device, at
    tests/test_mesh.py's tolerances: losses, predictions and parameters."""
    _, jfluid, _ = _jax()
    batches = _batches(n=4)
    got = {}
    for tag, fluid in (("jax", jfluid), ("torch", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        loss, pred = _build(fluid, main, startup, opt="adam")
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        compiled = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name,
                                                                  places=1)
        with fluid.scope_guard(scope):
            exe.run(startup)
            outs = [exe.run(compiled, feed={"x": xv, "y": yv}, fetch_list=[loss, pred])
                    for xv, yv in batches]
        got[tag] = ([np.asarray(o[0]) for o in outs], [np.asarray(o[1]) for o in outs],
                    {p.name: np.asarray(tfluid.scope.to_numpy(scope.get(p.name)))
                     for p in main.all_parameters()})
    for a, b in zip(got["torch"][0], got["jax"][0]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(got["torch"][1], got["jax"][1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for n in got["jax"][2]:
        np.testing.assert_allclose(got["torch"][2][n], got["jax"][2][n], rtol=1e-5, atol=1e-6)


# -- what waits for later items; the handle's flags; the caches --------------------


def test_later_items_raise_and_knobs_match_jax():
    _, jfluid, _ = _jax()
    # a model axis runs tensor parallelism now (tests/test_torch_tensor_parallel.py):
    # without a process group it needs one, as a batch axis does
    with pytest.raises(ValueError, match="process group"):
        tmesh.build_mesh(batch=1, model=2)
    with pytest.raises(NotImplementedError, match="item 9d"):
        tmesh.build_mesh(batch=1, pipe=2)
    with pytest.raises(ValueError, match="process group"):
        tmesh.build_mesh(batch=2)
    main, startup = tfluid.Program(), tfluid.Program()
    loss, _ = _build(tfluid, main, startup)
    cp = tfluid.CompiledProgram(main)
    with pytest.raises(NotImplementedError, match="item 9d"):
        cp.with_pipeline(loss_name=loss.name, num_stages=2)
    # item 12 is ported: run_repeated of a CompiledProgram checks its steps
    # as the JAX one does (tests/test_torch_run_repeated.py runs it)
    with pytest.raises(ValueError, match="steps must be >= 1"):
        tfluid.Executor(tfluid.CPUPlace()).run_repeated(cp, fetch_list=[loss], steps=0)
    bs = tfluid.BuildStrategy()
    # the autoshard planner is ported: auto_shard is a plain knob
    # (tests/test_torch_autoshard.py runs it)
    bs.auto_shard = True
    assert bs.auto_shard is True
    bs.auto_shard = False
    jbs = jfluid.BuildStrategy()
    t_knobs = {k: v for k, v in vars(bs).items()} | {"auto_shard": bs.auto_shard}
    assert t_knobs == vars(jbs)
    for cls in ("ReduceStrategy", "GradientScaleStrategy"):
        assert ({k: v for k, v in vars(getattr(tfluid.BuildStrategy, cls)).items()
                 if not k.startswith("_")}
                == {k: v for k, v in vars(getattr(jfluid.BuildStrategy, cls)).items()
                    if not k.startswith("_")})
    assert vars(tfluid.ExecutionStrategy()) == vars(jfluid.ExecutionStrategy())
    with pytest.raises(TypeError, match="expects a Program"):
        tfluid.CompiledProgram("main")
    assert cp.with_inference_optimize(None) is cp


def test_zero1_flag_lives_on_the_handle():
    main, startup = tfluid.Program(), tfluid.Program()
    loss, _ = _build(tfluid, main, startup)
    z = tfluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name, zero1=True)
    plain = tfluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    assert z._zero1 is True and plain._zero1 is False and not hasattr(main, "_zero1")
    # a batch of 1 shards nothing: zero1 on the unit mesh is the plain run
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    xv, yv = _batches(1)[0]
    exe.run(z, feed={"x": xv, "y": yv}, fetch_list=[loss], scope=scope)
    assert not any(hasattr(scope.get(n), "placements") for n in scope.local_names())
    # the pass cache keys the zero1 flag and the mesh signature apart
    exe.run(plain, feed={"x": xv, "y": yv}, fetch_list=[loss], scope=scope)
    keys = [k[-1] for k in exe._pass_cache]
    assert ((( ("batch", 1), ("model", 1), ("pipe", 1)),), True) in keys
    assert ((( ("batch", 1), ("model", 1), ("pipe", 1)),), False) in keys


def test_compile_distributed_and_api_surface():
    _, jfluid, _ = _jax()
    from jax.sharding import PartitionSpec as JP

    from paddle_tpu.parallel import api as japi
    from paddle_tpu_torch.parallel import api as tapi

    main, startup = tfluid.Program(), tfluid.Program()
    loss, pred = _build(tfluid, main, startup)
    jmain, jstartup = jfluid.Program(), jfluid.Program()
    _build(jfluid, jmain, jstartup)
    tapi.shard_parameter(main, "fc_0.w_0", tmesh.P("dp", None))
    japi.shard_parameter(jmain, "fc_0.w_0", JP("dp", None))
    assert {k: tuple(v) for k, v in tapi.sharding_specs(main).items()} == \
        {k: tuple(v) for k, v in japi.sharding_specs(jmain).items()}
    mesh = tapi.make_mesh()
    assert tapi.get_mesh() is mesh and dict(mesh.shape) == {"batch": 1, "model": 1, "pipe": 1}
    assert vars(tapi.DistributedStrategy()) == vars(japi.DistributedStrategy())
    assert dict(tapi.DistributedStrategy().build_mesh().shape)["batch"] == 1
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    plan = tapi.compile_distributed(exe, main, mesh, [("x", (16, 16), "float32"),
                                                      ("y", (16, 1), "float32")],
                                    [loss.name, pred.name], scope)
    assert plan.batch_fetch == {pred.name} and plan.fetch_names == [loss.name, pred.name]
    assert not plan.active and plan.ranks == 1
    # a pred fetch averages nothing: the parameter grads meet before their readers
    grads = sorted(n for names in plan.reduce_at.values() for n in names)
    assert grads == sorted(p.name + "@GRAD" for p in main.all_parameters())
    # a feed split over 'model' waits for item 9d
    with pytest.raises(NotImplementedError, match="9d"):
        tapi.compile_distributed(exe, main, mesh, [], [], scope, batch_axes=("batch", "tp"))


def test_jit_cache_key_carries_the_mesh_signature():
    from paddle_tpu_torch import dygraph as TD

    with TD.guard(tfluid.CPUPlace()):
        lin = TD.Linear(4, 2)
        fn = TD.to_compiled(lin)
        x = np.ones((3, 4), "float32")
        fn(TD.to_variable(x))
        fn(TD.to_variable(x))
        info = fn.cache_info()
        assert (info["hits"], info["misses"]) == (1, 1), info
        tmesh.build_mesh()  # a new current mesh: a new key
        fn(TD.to_variable(x))
        info = fn.cache_info()
        assert info["misses"] == 2, info


def test_train_from_dataset_takes_a_compiled_program(tmp_path):
    """Executor.train_from_dataset over a CompiledProgram: the mesh step on
    each staged batch, bit-equal to the plain program's run."""
    rng = np.random.RandomState(0)
    lines = []
    for _ in range(12):
        xs = rng.randn(16).round(3)
        lines.append("16 " + " ".join(str(v) for v in xs) + f" 1 {xs.sum():.3f}")
    path = tmp_path / "part-0"
    path.write_text("\n".join(lines) + "\n")
    out = {}
    for mode in ("plain", "mesh"):
        main, startup = tfluid.Program(), tfluid.Program()
        loss, _ = _build(tfluid, main, startup, opt="sgd", lr=1e-3)
        block = main.global_block()
        ds = tfluid.DatasetFactory().create_dataset("InMemoryDataset")
        ds.set_use_var([block.var("x"), block.var("y")])
        ds.set_batch_size(4)
        ds.set_filelist([str(path)])
        ds.load_into_memory()
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        prog = main if mode == "plain" else tfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        last = exe.train_from_dataset(prog, ds, scope=scope, fetch_list=[loss])
        out[mode] = (last[0], tfluid.scope.to_numpy(scope.get("fc_0.w_0")))
    np.testing.assert_array_equal(out["plain"][0], out["mesh"][0])
    np.testing.assert_array_equal(out["plain"][1], out["mesh"][1])


def test_snapshot_under_the_mesh_records_it_as_jax(tmp_path):
    jax, jfluid, jmesh = _jax()
    from paddle_tpu.resilience import snapshot as jsnap
    from paddle_tpu_torch.resilience import snapshot as tsnap

    arrays = {"w": np.arange(6, dtype="float32").reshape(2, 3)}
    jmesh.build_mesh(batch=1, model=1, pipe=1, devices=jax.devices()[:1])
    tmesh.build_mesh()
    jp = jsnap.write_snapshot(str(tmp_path / "jax"), 3, arrays, extra={"k": 1})
    tp = tsnap.write_snapshot(str(tmp_path / "torch"), 3, arrays, extra={"k": 1})
    for f in ("MANIFEST.json", "state.bin"):
        assert (tmp_path / "jax" / jp.split("/")[-1] / f).read_bytes() == \
            (tmp_path / "torch" / tp.split("/")[-1] / f).read_bytes(), f
    assert tsnap.read_manifest(tp)["mesh"] == {"batch": 1, "model": 1, "pipe": 1}
    # restore_or_initialize(mesh=...): the startup, then the snapshot, whole
    from paddle_tpu_torch import resilience as tres

    main, startup = tfluid.Program(), tfluid.Program()
    _build(tfluid, main, startup)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    w = {"fc_0.w_0": np.full((16, 32), 0.25, "float32")}
    tsnap.write_snapshot(str(tmp_path / "ckpt"), 5, w, specs={"fc_0.w_0": ["batch"]})
    mgr = tres.CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    assert mgr.restore_or_initialize(exe, main, startup, scope=scope,
                                     mesh=tmesh.current_mesh()) == 5
    np.testing.assert_array_equal(tfluid.scope.to_numpy(scope.get("fc_0.w_0")), w["fc_0.w_0"])
    assert scope.has("fc_1.w_0") and not hasattr(scope.get("fc_0.w_0"), "placements")
    tmesh.set_current_mesh(None)
    assert "mesh" not in tsnap.read_manifest(
        tsnap.write_snapshot(str(tmp_path / "none"), 1, arrays))
