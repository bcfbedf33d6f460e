"""The port's mesh on 2 gloo ranks, held against the JAX package's batch-2
mesh on its 8-device virtual CPU mesh (tests/conftest.py), at
tests/test_mesh.py's tolerances (rtol 1e-5, atol 1e-6).

The ranks are this file run as a script (`python
tests/test_torch_data_parallel.py --worker RANK WORLD STORE DIR`, with
DP_TEST_TCP_PORT set), two subprocesses joined by a `file://` store, each
timed out after 120 s; one
launch runs every case, and its results are shared by the tests of this
file (across xdist workers too, under a file lock). The parent writes each
case's starting state (the JAX package's startup, copied by name) and
feeds; rank r feeds rows [8r, 8r + 8) of each 16-row batch. Cases:

- fc, mean and Adam; a conv, batch_norm and mean model; a
  GradientClipByGlobalNorm program; a program with dropout: 3 steps,
  losses, the gathered predictions and every persistable against the JAX
  CompiledProgram(places=2);
- ZeRO-1 (`zero1=True`): the same, each Adam moment of fc_0.w_0 a
  Shard(0) DTensor of 8 of its 16 rows on each rank, parameters whole;
- a ZeRO-1 snapshot: written on 2 ranks, its manifest's specs the JAX
  package's `spec_to_manifest(P('batch'))`; restored on 2 ranks (sharded
  again, the next step bit-equal to the uninterrupted one), on 1 rank
  (whole) and by the JAX package onto its batch-2 mesh (sharded);
- dygraph `DataParallel` on 2 ranks (scale_loss, apply_collective_grads)
  in the gloo group `prepare_context` starts from the PADDLE_TRAINER_*
  contract (tcp on 127.0.0.1), against one rank on the whole batch, in
  both packages;
- attention dropout (the fused_multihead_attention op, whose kernels hash
  a (batch, head) index) on 2 ranks against the port on the whole batch;
- `repeated`: the dropout case's program, `Executor.run_repeated` of the
  CompiledProgram for 3 steps of one batch against the JAX batch-2 mesh's
  `run_repeated`, and against 3 `run()` calls on the rank bit for bit
  (asserted in tests/test_torch_run_repeated.py).
"""

import fcntl
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
CASES = ("fc_adam", "conv_bn", "clip", "dropout", "zero1")
STEPS, BATCH, WORLD = 3, 16, 2
RTOL, ATOL = 1e-5, 1e-6


def build(fluid, case):
    """The case's (main, startup, loss, pred) in `fluid` (either package)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        y = fluid.layers.data("y", [1])
        if case == "conv_bn":
            x = fluid.layers.data("x", [3, 8, 8])
            h = fluid.layers.conv2d(x, 4, 3, padding=1, bias_attr=False)
            h = fluid.layers.batch_norm(h, act="relu")
        else:
            x = fluid.layers.data("x", [16])
            h = fluid.layers.fc(x, 32, act="relu")
            if case == "dropout":
                h = fluid.layers.dropout(h, 0.3)
        pred = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        clip = fluid.clip.GradientClipByGlobalNorm(0.05) if case == "clip" else None
        fluid.optimizer.Adam(1e-2, grad_clip=clip).minimize(loss)
    return main, startup, loss, pred


def feeds(case):
    rng = np.random.RandomState(11)
    shape = (BATCH, 3, 8, 8) if case == "conv_bn" else (BATCH, 16)
    return [(rng.randn(*shape).astype("float32"), rng.randn(BATCH, 1).astype("float32"))
            for _ in range(STEPS + 1)]


def attention(fluid, p=0.5):
    """Attention with dropout `p` over [b, 8, 2, 4] (bshd): the port's
    kernel path (its plain version on the CPU)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8, 2, 4])
        out = fluid.layers.fused_multihead_attention(x, x, x, attn_dropout=p,
                                                     layout="bshd")
    return main, startup, out


def mlp(D):
    class MLP(D.Layer):
        def __init__(self):
            super().__init__("mlp")
            self.fc1 = D.Linear(16, 32, act="relu")
            self.fc2 = D.Linear(32, 1)

        def forward(self, x):
            return self.fc2(self.fc1(x))

    return MLP()


# -- the ranks ---------------------------------------------------------------------


def _worker(rank, world, store, out, tcp_port):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import resilience
    from paddle_tpu_torch.resilience import snapshot
    from paddle_tpu_torch.scope import to_numpy

    out = Path(out)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    rows = slice(rank * BATCH // world, (rank + 1) * BATCH // world)
    report = {}
    for case in CASES:
        main, startup, loss, pred = build(fluid, case)
        init = np.load(out / f"{case}_init.npz")
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        for n in init.files:
            scope.set(n, init[n])
        compiled = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, zero1=case == "zero1")
        losses, preds = [], []
        batches = feeds(case)
        for xv, yv in batches[:STEPS]:
            lv, pv = exe.run(compiled, feed={"x": xv[rows], "y": yv[rows]},
                             fetch_list=[loss, pred], scope=scope)
            losses.append(lv)
            preds.append(pv)
        state = {v.name: to_numpy(scope.get(v.name)) for v in main.list_vars()
                 if v.persistable and scope.has(v.name) and scope.get(v.name) is not None}
        mesh = compiled._get_mesh()
        rec = {"mesh": dict(mesh.shape), "rank": mesh.local_rank()}
        if case == "zero1":
            local = {}
            for n in sorted(scope.local_names()):
                v = scope.get(n)
                if hasattr(v, "placements"):
                    local[n] = [repr(p) for p in v.placements] + [list(v.to_local().shape)]
            rec["dtensors"] = local
            rec["param_types"] = sorted({type(scope.get(p.name)).__name__
                                         for p in main.all_parameters()})
            # snapshot on both ranks (each its own root), then restore on the
            # mesh into a fresh scope and take one more step on each
            mgr = resilience.CheckpointManager(str(out / f"ckpt_r{rank}"), keep=2)
            mgr.save(STEPS, program=main, scope=scope, executor=exe)
            mgr.drain()
            exe2 = fluid.Executor(fluid.CPUPlace())
            fresh = fluid.Scope()
            exe2.run(startup, scope=fresh)
            rec["restored_step"] = mgr.restore(program=main, scope=fresh, executor=exe2,
                                               mesh=mesh)
            rec["restored_dtensors"] = sorted(
                n for n in fresh.local_names() if hasattr(fresh.get(n), "placements"))
            rec["restored_equal"] = all(
                np.array_equal(to_numpy(fresh.get(n)), state[n]) for n in state)
            xv, yv = batches[STEPS]
            nxt = [ex.run(compiled, feed={"x": xv[rows], "y": yv[rows]}, fetch_list=[loss],
                          scope=sc)[0] for ex, sc in ((exe, scope), (exe2, fresh))]
            rec["resumed_bitwise"] = bool(np.array_equal(nxt[0], nxt[1]))
            mgr.close()
            # a plain handle on the ZeRO-1 scope gathers the moments whole at
            # dispatch; the step equals the ZeRO-1 one on the restored scope
            plain = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
            xv, yv = batches[0]
            l_plain = exe.run(plain, feed={"x": xv[rows], "y": yv[rows]}, fetch_list=[loss],
                              scope=scope)[0]
            l_zero1 = exe2.run(compiled, feed={"x": xv[rows], "y": yv[rows]},
                               fetch_list=[loss], scope=fresh)[0]
            rec["reshard_whole"] = not any(hasattr(scope.get(n), "placements")
                                           for n in scope.local_names())
            rec["reshard_bitwise"] = bool(np.array_equal(l_plain, l_zero1)) and all(
                np.array_equal(to_numpy(scope.get(n)), to_numpy(fresh.get(n))) for n in state)
            # a manifest written on a batch-4 mesh: the var whose recorded
            # axis still divides it shards, the other degrades, both counted
            root = out / f"degrade_r{rank}"
            snapshot.write_snapshot(
                str(root), 1, {"odd": np.arange(7, dtype="float32"),
                               "even": np.arange(8, dtype="float32")},
                specs={"odd": ["batch"], "even": ["batch"]},
                mesh_shape={"batch": 4, "model": 1, "pipe": 1})
            sc = fluid.Scope()
            resilience.CheckpointManager(str(root), async_save=False).restore(scope=sc,
                                                                              mesh=mesh)
            even = sc.get("even")
            rec["degrade"] = {
                "odd": [type(sc.get("odd")).__name__, to_numpy(sc.get("odd")).tolist()],
                "even": [type(even).__name__, even.to_local().tolist()],
                "counters": {k: fluid.profiler.counters()[k]
                             for k in ("restore_degraded_vars", "restore_resharded_vars")}}
        report[case] = rec
        np.savez(out / f"{case}_r{rank}.npz", losses=np.stack(losses), preds=np.stack(preds),
                 **{"state/" + k: v for k, v in state.items()})
    # run_repeated over the mesh, against as many run() calls on the rank
    main, startup, loss, pred = build(fluid, "dropout")
    init = np.load(out / "repeated_init.npz")
    xv, yv = feeds("dropout")[0]
    feed = {"x": xv[rows], "y": yv[rows]}
    arms = {}
    for arm in ("runs", "repeated"):
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        for n in init.files:
            scope.set(n, init[n])
        compiled = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
        if arm == "runs":
            fetched = [exe.run(compiled, feed=dict(feed), fetch_list=[loss, pred], scope=scope)
                       for _ in range(STEPS)]
            lv, pv = (np.stack(f) for f in zip(*fetched))
        else:
            lv, pv = exe.run_repeated(compiled, feed=dict(feed), fetch_list=[loss, pred],
                                      steps=STEPS, scope=scope)
        state = {v.name: to_numpy(scope.get(v.name)) for v in main.list_vars()
                 if v.persistable and scope.has(v.name) and scope.get(v.name) is not None}
        arms[arm] = (lv, pv, state, exe._seed_counter)
    (rl, rp, rs_, rc), (ql, qp, qs, qc) = arms["runs"], arms["repeated"]
    report["repeated"] = {
        "mesh": dict(compiled._get_mesh().shape), "seed_counter": qc,
        "bitwise_to_runs": bool(np.array_equal(rl, ql) and np.array_equal(rp, qp)
                                and rc == qc and sorted(rs_) == sorted(qs)
                                and all(np.array_equal(rs_[n], qs[n]) for n in qs))}
    np.savez(out / f"repeated_r{rank}.npz", losses=ql, preds=qp,
             **{"state/" + k: v for k, v in qs.items()})
    # dygraph DataParallel: the half batch a rank, scale_loss,
    # apply_collective_grads, in the process group prepare_context starts
    # from the PADDLE_* contract (a gloo group over tcp://127.0.0.1:port)
    from paddle_tpu_torch import dygraph as TD

    dist.destroy_process_group()
    os.environ["PADDLE_TRAINERS_NUM"] = str(world)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINER_ENDPOINTS"] = ",".join(
        f"127.0.0.1:{port}" for port in (tcp_port, tcp_port + 1))
    dy = np.load(out / "dygraph_init.npz")
    with TD.guard(fluid.CPUPlace()):
        env = TD.prepare_context()
        backend = dist.get_backend()
        model = mlp(TD)
        model.set_dict({k: dy[k] for k in dy.files if not k.startswith("feed/")})
        dp = TD.DataParallel(model)
        x, y = dy["feed/x"][rows], dy["feed/y"][rows]
        loss = ((dp(TD.to_variable(x)) - TD.to_variable(y)) ** 2).mean()
        dp.scale_loss(loss).backward()
        dp.apply_collective_grads()
        grads = {n: p.gradient() for n, p in model.named_parameters()}
    report["dygraph"] = {"nranks": env.nranks, "backend": backend}
    np.savez(out / f"dygraph_r{rank}.npz", **grads)
    # attention dropout: this rank's rows of the global mask
    main, startup, att = attention(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    compiled = fluid.CompiledProgram(main).with_data_parallel()
    xa = np.load(out / "attn_feed.npy")
    (got,) = exe.run(compiled, feed={"x": xa[rows]}, fetch_list=[att], scope=scope)
    np.save(out / f"attn_r{rank}.npy", got)
    (out / f"report_r{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()


# -- the parent: JAX references, the launch ----------------------------------------


def _jax_case(case, out):
    """The case's starting state and feeds on disk; its 3 steps on the JAX
    batch-2 mesh -> (losses, preds, state)."""
    import paddle_tpu as jfluid

    main, startup, loss, pred = build(jfluid, case)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {v.name: np.asarray(scope.get(v.name)) for v in main.list_vars()
                if v.persistable and scope.has(v.name) and scope.get(v.name) is not None}
        np.savez(out / f"{case}_init.npz", **init)
        compiled = jfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=WORLD, zero1=case == "zero1")
        assert dict(compiled._get_mesh().shape) == {"batch": 2, "model": 1, "pipe": 1}
        losses, preds = [], []
        for xv, yv in feeds(case)[:STEPS]:
            lv, pv = exe.run(compiled, feed={"x": xv, "y": yv}, fetch_list=[loss, pred])
            losses.append(np.asarray(lv))
            preds.append(np.asarray(pv))
        state = {n: np.asarray(scope.get(n)) for n in init}
    return np.stack(losses), np.stack(preds), state


def _jax_repeated(out):
    """The dropout case's program from its JAX startup (written to disk),
    run_repeated of STEPS steps of one batch on the JAX batch-2 mesh ->
    (stacked losses, stacked preds, state)."""
    import paddle_tpu as jfluid

    main, startup, loss, pred = build(jfluid, "dropout")
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {v.name: np.asarray(scope.get(v.name)) for v in main.list_vars()
                if v.persistable and scope.has(v.name) and scope.get(v.name) is not None}
        np.savez(out / "repeated_init.npz", **init)
        compiled = jfluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name,
                                                                   places=WORLD)
        xv, yv = feeds("dropout")[0]
        lv, pv = exe.run_repeated(compiled, feed={"x": xv, "y": yv}, fetch_list=[loss, pred],
                                  steps=STEPS)
        state = {n: np.asarray(scope.get(n)) for n in init}
    return np.asarray(lv), np.asarray(pv), state


def _dygraph_refs(out):
    """Seeded MLP weights and a batch on disk; the whole batch's grads on
    one rank in each package."""
    import paddle_tpu as jfluid
    from paddle_tpu import dygraph as JD

    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch import dygraph as TD

    rs = np.random.RandomState(5)
    x = rs.randn(BATCH, 16).astype("float32")
    y = rs.randn(BATCH, 1).astype("float32")
    grads = {}
    weights = None
    for tag, fl, D in (("torch", tfluid, TD), ("jax", jfluid, JD)):
        with D.guard(fl.CPUPlace()):
            model = mlp(D)
            if weights is None:
                weights = {k: rs.randn(*np.shape(v)).astype("float32") * 0.3
                           for k, v in model.state_dict().items()}
            model.set_dict(weights)
            loss = ((model(D.to_variable(x)) - D.to_variable(y)) ** 2).mean()
            loss.backward()
            grads[tag] = {n: np.asarray(p.gradient()) for n, p in model.named_parameters()}
    np.savez(out / "dygraph_init.npz", **weights, **{"feed/x": x, "feed/y": y})
    return grads


def _attention_ref(out):
    """The attention program on the whole batch in one process, the port's,
    with dropout and without."""
    import paddle_tpu_torch as tfluid

    xa = np.random.RandomState(8).randn(BATCH, 8, 2, 4).astype("float32")
    np.save(out / "attn_feed.npy", xa)
    got = []
    for p in (0.5, 0.0):
        main, startup, att = attention(tfluid, p)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        got.append(exe.run(main, feed={"x": xa}, fetch_list=[att], scope=scope)[0])
    return got


def _launch(out):
    from paddle_tpu.parallel import mesh as jmesh

    old = jmesh.current_mesh()
    try:
        refs = {case: _jax_case(case, out) for case in CASES}
        refs["repeated"] = _jax_repeated(out)
    finally:
        jmesh.set_current_mesh(old)
    refs["dygraph"] = _dygraph_refs(out)
    refs["attn"] = _attention_ref(out)
    store = out / "store"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    with socket.socket() as sock:  # a free port for prepare_context's rendezvous
        sock.bind(("127.0.0.1", 0))
        env["DP_TEST_TCP_PORT"] = str(sock.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), str(WORLD),
                               str(store), str(out)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = []
    for r in range(WORLD):
        rep = json.loads((out / f"report_r{r}.json").read_text())
        arrays = {case: dict(np.load(out / f"{case}_r{r}.npz")) for case in CASES}
        arrays["dygraph"] = dict(np.load(out / f"dygraph_r{r}.npz"))
        arrays["attn"] = np.load(out / f"attn_r{r}.npy")
        arrays["repeated"] = dict(np.load(out / f"repeated_r{r}.npz"))
        ranks.append((rep, arrays))
    return refs, ranks


@pytest.fixture(scope="session")
def launched(tmp_path_factory):
    """One launch for the session: under xdist the first worker to get
    here runs it in the session's shared temp dir, the others wait on the
    lock and read its results."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        out = tmp_path_factory.mktemp("torch_dp")
        return _launch(out) + (out,)
    shared = tmp_path_factory.getbasetemp().parent / "torch_dp"
    shared.mkdir(exist_ok=True)
    with open(shared / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            done = shared / "done"
            if done.exists():  # written by this session's first worker
                return pickle.loads(done.read_bytes()) + (shared,)
            result = _launch(shared)
            done.write_bytes(pickle.dumps(result))
            return result + (shared,)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


# -- the tests ---------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_match_the_jax_batch2_mesh(launched, case):
    refs, ranks, _ = launched
    j_losses, j_preds, j_state = refs[case]
    for rep, arrays in ranks:
        assert rep[case]["mesh"] == {"batch": 2, "model": 1, "pipe": 1}
        got = arrays[case]
        # the loss fetch is the group's mean: the global mean on every rank
        np.testing.assert_allclose(got["losses"].reshape(j_losses.shape), j_losses,
                                   rtol=RTOL, atol=ATOL)
        # the batch-leading fetch is gathered: all 16 rows on every rank
        assert got["preds"].shape == j_preds.shape == (STEPS, BATCH, 1)
        np.testing.assert_allclose(got["preds"], j_preds, rtol=RTOL, atol=ATOL)
        for n, ref in j_state.items():
            np.testing.assert_allclose(got["state/" + n], ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case}: {n}")
    assert sorted(rep[case]["rank"] for rep, _ in ranks) == [0, 1]


def test_zero1_moments_are_row_shards(launched):
    _, ranks, _ = launched
    for rep, _ in ranks:
        d = rep["zero1"]["dtensors"]
        for m in ("fc_0.w_0_moment1_0", "fc_0.w_0_moment2_0"):
            assert d[m] == ["Shard(dim=0)", "Replicate()", "Replicate()", [8, 32]], d
        # every Adam moment of a param whose dim 0 divides 2, and nothing else
        assert sorted(d) == sorted(f"{p}_moment{k}_0" for p in ("fc_0.w_0", "fc_0.w_1",
                                                               "fc_1.w_0")
                                   for k in (1, 2))
        assert rep["zero1"]["param_types"] == ["Tensor"]


def test_zero1_snapshot_restores_on_two_ranks_one_rank_and_jax(launched):
    import jax
    from jax.sharding import PartitionSpec as JP

    import paddle_tpu as jfluid
    from paddle_tpu import resilience as jres
    from paddle_tpu.parallel import mesh as jmesh

    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch import resilience as tres
    from paddle_tpu_torch.resilience import snapshot as tsnap
    from paddle_tpu_torch.scope import to_numpy

    _, ranks, out = launched
    for rep, _ in ranks:
        z = rep["zero1"]
        assert z["restored_step"] == STEPS and z["restored_equal"] and z["resumed_bitwise"]
        # a plain handle on the sharded scope reshards it whole at dispatch
        assert z["reshard_whole"] and z["reshard_bitwise"]
        assert z["restored_dtensors"] == sorted(z["dtensors"])
    root = out / "ckpt_r0"
    manifest = tsnap.read_manifest(tsnap.list_snapshots(str(root))[0][1])
    specs = {n: e["spec"] for n, e in manifest["vars"].items() if "spec" in e}
    assert specs == {n: jmesh.spec_to_manifest(JP("batch"))
                     for n in ranks[0][0]["zero1"]["dtensors"]}
    assert manifest["mesh"] == {"batch": 2, "model": 1, "pipe": 1}
    final = ranks[0][1]["zero1"]
    # one rank, no mesh: every var whole
    main, startup, _, _ = build(tfluid, "zero1")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    assert tres.CheckpointManager(str(root), async_save=False).restore(
        program=main, scope=scope, executor=exe) == STEPS
    for n in specs:
        assert not hasattr(scope.get(n), "placements")
        np.testing.assert_array_equal(to_numpy(scope.get(n)), final["state/" + n])
    # the JAX package reads the port's snapshot onto its batch-2 mesh, sharded
    jmain, jstartup, _, _ = build(jfluid, "zero1")
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    old = jmesh.current_mesh()
    try:
        target = jmesh.build_mesh(batch=2, devices=jax.devices()[:2])
        with jfluid.scope_guard(jscope):
            jexe.run(jstartup)
        assert jres.CheckpointManager(str(root), async_save=False).restore(
            program=jmain, scope=jscope, executor=jexe, mesh=target) == STEPS
        for n in specs:
            v = jscope.get(n)
            assert tuple(v.sharding.spec)[:1] == ("batch",), n
            np.testing.assert_array_equal(np.asarray(v), final["state/" + n])
    finally:
        jmesh.set_current_mesh(old)


def test_restore_on_another_mesh_shards_or_degrades_loudly(launched):
    """A manifest from a batch-4 mesh restored onto the batch-2 one: the
    8-row var lands as this rank's 4 rows, the 7-row one whole (its axis no
    longer divides it); the counters as the JAX package keeps them: one
    var degraded, the two with a recorded spec re-placed."""
    _, ranks, _ = launched
    for rep, _ in ranks:
        d = rep["zero1"]["degrade"]
        assert d["odd"] == ["ndarray", list(range(7))]
        assert d["even"][0] == "DTensor" and len(d["even"][1]) == 4
        assert d["counters"] == {"restore_degraded_vars": 1, "restore_resharded_vars": 2}
    assert sorted(rep["zero1"]["degrade"]["even"][1][0] for rep, _ in ranks) == [0.0, 4.0]


def test_dygraph_data_parallel_two_ranks_match_one(launched):
    refs, ranks, _ = launched
    one_rank = refs["dygraph"]
    for name, ref in one_rank["torch"].items():
        np.testing.assert_allclose(ref, one_rank["jax"][name], rtol=RTOL, atol=ATOL)
    for rep, arrays in ranks:
        assert rep["dygraph"] == {"nranks": WORLD, "backend": "gloo"}
        for name, ref in one_rank["torch"].items():
            np.testing.assert_allclose(arrays["dygraph"][name], ref, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def test_attention_dropout_draws_the_global_mask_rows(launched):
    """Rank r's attention dropout keeps what one process keeps on rows
    [8r, 8r + 8) of the whole batch: its seed is shifted by its first
    row's (batch, head) index."""
    refs, ranks, _ = launched
    ref, undropped = refs["attn"]
    assert np.abs(ref - undropped).max() > 0.1  # the mask drops
    for _, arrays in ranks:
        assert arrays["attn"].shape == ref.shape == (BATCH, 8, 2, 4)
        np.testing.assert_allclose(arrays["attn"], ref, rtol=RTOL, atol=ATOL)


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
                int(os.environ["DP_TEST_TCP_PORT"]))
    else:
        sys.exit("usage: DP_TEST_TCP_PORT=port test_torch_data_parallel.py --worker RANK "
                 "WORLD STORE DIR")
