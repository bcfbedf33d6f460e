"""The port's resilience/ held against the JAX package's on the CPU.

- Format: a snapshot written by either package's `write_snapshot` loads
  in the other's `load_snapshot` byte-equal (the same arrays give the same
  `state.bin`, and manifests equal but for `mesh`); torn files, a
  same-size corruption (caught by the deep crc32) and retention behave as
  in the JAX package.
- The async engine commits, counts, and fails loudly (a sticky flush
  error, from a bad value or an ENOSPC at `snapshot.flush.write`).
- Static resume: the JAX package trains BERT-tiny 2 steps under `attach`
  and `track_reader`; the port's `restore_or_initialize` from that
  directory, then step 3, gives JAX's step-3 loss within rtol 1e-5 (the
  seed counter rides the manifest, so the threefry dropout keys match;
  fp32 sums over a few thousand terms, as the other BERT-tiny parity tests
  hold them). A port-to-port resume is bit-equal to an uninterrupted port
  run.
- Dygraph: the manager round-trips dygraph state with the JAX one, both
  ways (values exact, the next step within 1e-6).
- NanGuard: one poisoned scenario in both packages, equal counters and
  rollback step, persistables within 1e-5 and bit-equal to the rollback
  snapshot; the poisoned autosave is skipped and deleted.
- Preemption: `final_save` drains and commits.
- Executor wiring: an `executor.dispatch` failure leaves the seed counter
  where it was (in both packages), and the heartbeat carries the tick and
  the manager's step; the dygraph JIT heartbeats.

The `gpu` test holds the engine's stream contract on the card: the copy
waits for the step that wrote a tensor, and a tensor dropped after submit
keeps its block until the copy has read it."""

import json
import os
import shutil
import signal
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch import reader as trdr
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.resilience import snapshot as tsnap
from paddle_tpu_torch.scope import to_numpy


def _jax():
    import paddle_tpu as jfluid
    from paddle_tpu import resilience as jres

    return jfluid, jres


def _arrays():
    rs = np.random.RandomState(0)
    return {
        "fc_0.w_0": rs.randn(4, 3).astype("float32"),
        "fc_0.b_0": rs.randn(3).astype("float32"),
        "counter": np.asarray([7], "int32"),
        "ids": rs.randint(0, 9, (2, 5)).astype("int64"),
        "scalar": np.asarray(2.5, "float64"),
        "half": rs.randn(3, 2).astype("float16"),
    }


# -- format -----------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshot_written_by_one_package_loads_in_the_other(tmp_path, writer):
    _, jres = _jax()
    arrays = _arrays()
    extra = {"seed_counter": 5, "reader_cursors": {"train": {"epoch": 0, "batch": 3}}}
    paths = {}
    for tag, mod in (("jax", jres.snapshot), ("torch", tsnap)):
        paths[tag] = mod.write_snapshot(str(tmp_path / tag), 4, arrays, extra=extra)
    # the same arrays give the same data stream, byte for byte
    data = {t: open(os.path.join(p, "state.bin"), "rb").read() for t, p in paths.items()}
    assert data["jax"] == data["torch"]
    man = {t: json.load(open(os.path.join(p, "MANIFEST.json"))) for t, p in paths.items()}
    man["jax"].pop("mesh", None)
    assert man["jax"] == man["torch"]
    reader = tsnap if writer == "jax" else jres.snapshot
    got, m = reader.load_snapshot(paths[writer])
    assert m["step"] == 4 and m["extra"] == extra
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k
    assert reader.validate_snapshot(paths[writer], deep=True)["data_bytes"] == len(data[writer])


def _damage(kind, root, mod):
    """Three snapshots at steps 0-2, the newest damaged by `kind`."""
    for s in range(3):
        mod.write_snapshot(root, s, {"w": np.full(64, s, np.float32),
                                     "v": np.arange(16, dtype=np.float32) * s})
    newest = mod.snapshot_dir(root, 2)
    fp = os.path.join(newest, "state.bin")
    if kind == "torn":
        with open(fp, "r+b") as f:
            f.truncate(os.path.getsize(fp) // 2)
    elif kind == "corrupt_same_size":
        raw = bytearray(open(fp, "rb").read())
        raw[-5] ^= 0xFF
        open(fp, "wb").write(bytes(raw))
    elif kind == "no_manifest":
        os.remove(os.path.join(newest, "MANIFEST.json"))
    elif kind == "tmp_debris":
        shutil.copytree(newest, mod.snapshot_dir(root, 3) + "@tmp")


@pytest.mark.parametrize("kind", ["torn", "corrupt_same_size", "no_manifest", "tmp_debris"])
def test_discovery_of_damaged_snapshots_matches_jax(tmp_path, kind):
    jfluid, jres = _jax()
    got = {}
    for tag, res, mod in (("jax", jres, jres.snapshot), ("torch", tres, tsnap)):
        root = str(tmp_path / tag)
        _damage(kind, root, mod)
        mgr = res.CheckpointManager(root, async_save=False)
        restored = mgr.restore(scope=(jfluid if tag == "jax" else tfluid).Scope())
        errors = []
        for _, path in mod.list_snapshots(root):
            for deep in (False, True):
                try:
                    mod.validate_snapshot(path, deep=deep)
                except mod.SnapshotError:
                    errors.append((os.path.basename(path), deep))
        got[tag] = (mgr.all_steps(), mgr.latest_step(), mgr.latest_step(deep=True), restored,
                    errors)
    assert got["torch"] == got["jax"]
    want_latest = {"torn": 1, "corrupt_same_size": 2, "no_manifest": 1, "tmp_debris": 2}[kind]
    assert got["torch"][1] == want_latest
    if kind == "corrupt_same_size":
        # only the deep check and the load see it; restore falls back
        assert got["torch"][2] == 1 and got["torch"][3] == 1


def test_retention_and_overwrite_match_jax(tmp_path):
    _, jres = _jax()
    got = {}
    for tag, mod in (("jax", jres.snapshot), ("torch", tsnap)):
        root = str(tmp_path / tag)
        for s in range(5):
            mod.write_snapshot(root, s, {"w": np.full(4, s, np.float32)}, keep=3)
        mod.write_snapshot(root, 4, {"w": np.full(4, 9, np.float32)}, keep=3)
        arrays, _ = mod.load_snapshot(mod.snapshot_dir(root, 4))
        got[tag] = ([s for s, _ in mod.list_snapshots(root)], sorted(os.listdir(root)),
                    arrays["w"].tolist())
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [4, 3, 2] and got["torch"][2] == [9.0] * 4


def test_atomic_writers_publish_and_count(tmp_path):
    before = tprofiler.counters().get("ckpt_bytes", 0)
    path = str(tmp_path / "a.npy")
    n = tres.atomic_write_array(path, torch.arange(6, dtype=torch.int64))
    assert np.load(path).tolist() == list(range(6))
    assert tres.atomic_write_bytes(str(tmp_path / "b"), b"xyz") == 3
    assert tprofiler.counters()["ckpt_bytes"] - before == n + 3
    assert sorted(os.listdir(tmp_path)) == ["a.npy", "b"]  # no temp debris


# -- the engine ---------------------------------------------------------------


def test_async_engine_commits_and_counts(tmp_path):
    c0 = tprofiler.counters()
    eng = tres.AsyncSnapshotEngine(str(tmp_path), keep=3)
    for s in range(4):
        eng.submit(s, {"w": torch.full((16,), float(s)), "b": np.full(2, s, np.float32),
                       "h": torch.full((3,), float(s), dtype=torch.bfloat16)})
    eng.drain()
    assert eng.last_committed[0] == 3
    assert [s for s, _ in tres.list_snapshots(str(tmp_path))] == [3, 2, 1]
    c1 = tprofiler.counters()
    assert c1["ckpt_snapshots_committed"] - c0.get("ckpt_snapshots_committed", 0) == 4
    assert c1["ckpt_bytes"] > c0.get("ckpt_bytes", 0)
    assert "ckpt_save_ms" in c1 and "ckpt_async_overlap_ms" in c1
    assert len(eng.submit_ms) == 4 and eng.copy_ms == []  # host values: no copy stream
    arrays, _ = tres.load_snapshot(tres.list_snapshots(str(tmp_path))[0][1])
    assert arrays["w"].tolist() == [3.0] * 16
    assert arrays["h"].dtype == np.float32 and arrays["h"].tolist() == [3.0] * 3
    eng.close()


def test_engine_writes_what_write_snapshot_writes(tmp_path):
    """The engine's slot image and write_snapshot's stream: the same
    state.bin bytes and manifest for the same values, across two layouts."""
    for layout in range(2):
        arrays = {k: (torch.from_numpy(v) if layout else v) for k, v in _arrays().items()}
        if layout:
            arrays["extra_var"] = torch.arange(5, dtype=torch.int64)
        eng = tres.AsyncSnapshotEngine(str(tmp_path / f"eng{layout}"), keep=3)
        for step in (1, 2):  # the second reuses the slot's image
            eng.submit(step, arrays, extra={"seed_counter": step})
        eng.drain()
        eng.close()
        for step in (1, 2):
            ref = tsnap.write_snapshot(str(tmp_path / f"ref{layout}"), step, arrays,
                                       extra={"seed_counter": step})
            got = tsnap.snapshot_dir(str(tmp_path / f"eng{layout}"), step)
            for f in ("state.bin", "MANIFEST.json"):
                assert open(os.path.join(got, f), "rb").read() == \
                    open(os.path.join(ref, f), "rb").read(), (layout, step, f)


def test_async_engine_failure_is_loud_and_sticky(tmp_path):
    eng = tres.AsyncSnapshotEngine(str(tmp_path), keep=3)
    eng.submit(0, {"w": np.ones(2, np.float32)})
    eng.drain()
    # an object array cannot be saved without pickle: the flush fails
    eng.submit(1, {"bad": np.array([object()], dtype=object)})
    with pytest.raises(tres.SnapshotError, match="flush failed"):
        eng.drain()
    # a disk filling up mid-flush: the previous commit stays restorable
    plan = tfaults.FaultPlan(seed=1).add("snapshot.flush.write", raises="OSError",
                                         err="ENOSPC", nth=1)
    with tfaults.active(plan):
        eng.submit(2, {"w": np.full(2, 2, np.float32)})
        with pytest.raises(tres.SnapshotError, match="flush failed"):
            eng.drain()
    assert plan.fired.get("snapshot.flush.write") == 1
    assert [s for s, _ in tres.list_snapshots(str(tmp_path))] == [0]
    eng.submit(3, {"w": np.full(2, 3, np.float32)})  # usable after reporting
    eng.drain()
    assert eng.last_committed[0] == 3
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(4, {"w": np.ones(1, np.float32)})


# -- static resume ------------------------------------------------------------

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)
B, S, P = 2, 32, 5
FEEDS = ["src_ids", "sent_ids", "pos_ids", "input_mask", "mask_label", "mask_weight",
         "mask_pos"]


def _bert_rows():
    for i in range(40):
        rs = np.random.RandomState(300 + i)
        n = rs.randint(S // 2, S + 1)
        yield (rs.randint(0, TINY["vocab_size"], S).astype("int64"),
               rs.randint(0, 2, S).astype("int64"), np.arange(S, dtype="int64"),
               (np.arange(S) < n).astype("float32"),
               rs.randint(0, TINY["vocab_size"], P).astype("int64"), np.ones(P, "float32"),
               rs.choice(S, P, replace=False).astype("int64"))


def _bert(fluid, bert, rdr, place=None):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        h = bert.build_bert_pretrain(bert.BertConfig(**TINY), B, S, mlm_only=True,
                                     max_preds=P)
        fluid.optimizer.Adam(1e-3).minimize(h["loss"])
    loader = rdr.DataLoader.from_generator([main.global_block().var(n) for n in FEEDS])
    loader.set_sample_generator(_bert_rows, B, shuffle_buf=8, shuffle_seed=3, places=place)
    return main, startup, h["loss"], loader


def _train(fluid, exe, main, loss, loader, scope, n):
    out, it = [], iter(loader)
    for _ in range(n):
        feed = next(it)
        out.append(float(np.asarray(to_numpy(exe.run(main, feed=feed, fetch_list=[loss],
                                                     scope=scope)[0])).reshape(-1)[0]))
    return out


def test_port_resumes_a_jax_bert_run(tmp_path, monkeypatch):
    """JAX: 2 steps under attach + track_reader, then its step 3. The port
    restores the JAX directory and runs step 3: the same loss within rtol
    1e-5."""
    jfluid, jres = _jax()
    from paddle_tpu import reader as jrdr
    from paddle_tpu.models import bert as jbert

    from paddle_tpu_torch.models import bert as tbert

    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_SHORT_ATTN", "bshd")
    root = str(tmp_path / "ckpt")
    main, startup, loss, loader = _bert(jfluid, jbert, jrdr)
    # the JAX restore_or_initialize runs the startup program in the global
    # scope: train there
    scope, exe = jfluid.global_scope(), jfluid.Executor(jfluid.CPUPlace())
    mgr = jres.CheckpointManager(root, save_interval=1, keep=5)
    mgr.track_reader(loader, "train")
    assert mgr.restore_or_initialize(exe, main, startup) == -1
    mgr.attach(main)
    it = iter(loader)
    jl = []
    for _ in range(3):
        feed = next(it)
        jl.append(float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                           scope=scope)[0]).reshape(-1)[0]))
        if len(jl) == 2:
            mgr.drain()
            shutil.copytree(root, str(tmp_path / "after2"))
    mgr.close()
    assert [s for s, _ in jres.list_snapshots(str(tmp_path / "after2"))] == [1, 0]

    main_t, startup_t, loss_t, loader_t = _bert(tfluid, tbert, trdr, tfluid.CPUPlace())
    scope_t, exe_t = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    mgr_t = tres.CheckpointManager(str(tmp_path / "after2"), save_interval=1, keep=5)
    mgr_t.track_reader(loader_t, "train")
    assert mgr_t.restore_or_initialize(exe_t, main_t, startup_t, scope=scope_t) == 1
    assert exe_t._seed_counter == exe._seed_counter - 1  # JAX ran one more step
    assert loader_t.state_dict()["batch"] == 2
    # restored values take the IR dtype on the executor's device
    for v in main_t.list_vars():
        if v.persistable and scope_t.has(v.name):
            t = scope_t.get(v.name)
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu", v.name
    tl = _train(tfluid, exe_t, main_t, loss_t, loader_t, scope_t, 1)
    np.testing.assert_allclose(tl, jl[2:], rtol=1e-5, atol=0)
    mgr_t.close()


def test_port_resume_bit_equal_to_an_uninterrupted_port_run(tmp_path):
    from paddle_tpu_torch.models import bert as tbert

    def run(root, n, keep_upto=None):
        main, startup, loss, loader = _bert(tfluid, tbert, trdr, tfluid.CPUPlace())
        scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        mgr = tres.CheckpointManager(root, save_interval=1, keep=10)
        mgr.track_reader(loader, "train")
        start = mgr.restore_or_initialize(exe, main, startup, scope=scope)
        mgr.attach(main)
        out = _train(tfluid, exe, main, loss, loader, scope, n)
        mgr.drain()
        mgr.close()
        state = {v.name: to_numpy(scope.get(v.name)) for v in main.list_vars()
                 if v.persistable and scope.has(v.name)}
        return start, out, state

    root = str(tmp_path / "run")
    start, full, state_full = run(root, 5)
    assert start == -1 and all(np.isfinite(full))
    for s, path in tres.list_snapshots(root):
        if s > 1:
            shutil.rmtree(path)  # the moral SIGKILL after step 2
    start, resumed, state_resumed = run(root, 3)
    assert start == 1
    assert resumed == full[2:]
    assert sorted(state_resumed) == sorted(state_full)
    for n, a in state_full.items():
        assert np.array_equal(a, state_resumed[n]), n


def test_restore_mismatch_strict_and_mesh(tmp_path):
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [4])
        tfluid.layers.fc(x, 3)
    w = main.global_block().all_parameters()[0].name
    mgr = tres.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(0, state={w: np.zeros((5, 3), np.float32), "stranger": np.zeros(1, np.float32)})
    scope = tfluid.Scope()
    with pytest.raises(tres.SnapshotError, match="snapshot shape"):
        mgr.restore(program=main, scope=scope)
    assert not scope.has(w)  # nothing landed
    mgr.save(1, state={w: np.zeros((4, 3), np.float32), "stranger": np.zeros(1, np.float32)})
    with pytest.raises(tres.SnapshotError, match="not a program persistable"):
        mgr.restore(program=main, scope=scope, strict=True)
    with pytest.raises(ValueError, match="requires program"):
        mgr.restore(strict=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        mgr.restore(program=main, scope=scope, mesh=object())
    assert mgr.restore(program=main, scope=scope) == 1
    assert to_numpy(scope.get(w)).shape == (4, 3)


def test_accumulator_names_match_jax():
    jfluid, _ = _jax()
    got = {}
    for tag, fluid in (("jax", jfluid), ("torch", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [4])
            loss = fluid.layers.mean(fluid.layers.fc(fluid.layers.fc(x, 8), 1))
            opt = fluid.optimizer.Adam(1e-2)
            opt.minimize(loss)
        got[tag] = opt.accumulator_names()
        persist = {v.name for v in main.list_vars() if v.persistable}
        assert set(got[tag]) <= persist
    assert got["torch"] == got["jax"] and len(got["torch"]) == 4 * 4


# -- dygraph ------------------------------------------------------------------


def _dy_model(fluid, D, state=None):
    """A Linear(4, 3) under Adam from `state` (or seeded weights)."""
    layer = D.Linear(4, 3)
    if state is None:
        wr = np.random.RandomState(2)
        state = {k: wr.randn(*v.shape).astype(v.dtype) for k, v in layer.state_dict().items()}
    layer.set_dict(state)
    return layer, fluid.optimizer.Adam(0.01, parameter_list=layer.parameters())


def _dy_train(layer, opt, D, seed):
    x = D.to_variable(np.random.RandomState(seed).randn(5, 4).astype("float32"))
    loss = (layer(x) ** 2).mean()
    loss.backward()
    opt.minimize(loss)
    layer.clear_gradients()
    return float(loss.numpy())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_dygraph_state_round_trips_with_jax(tmp_path, writer):
    """The writer trains 2 Adam steps and snapshots through its manager;
    the other package restores it, and both take a third step."""
    jfluid, jres = _jax()
    from paddle_tpu import dygraph as JD

    from paddle_tpu_torch import dygraph as TD

    pk = {"jax": (jfluid, JD, jres), "torch": (tfluid, TD, tres)}
    wf, WD, wres = pk[writer]
    rf, RD, rres = pk["torch" if writer == "jax" else "jax"]
    with wf.dygraph.guard(wf.CPUPlace()):
        layer, opt = _dy_model(wf, WD)
        for seed in (4, 5):
            _dy_train(layer, opt, WD, seed)
        mgr = wres.CheckpointManager(str(tmp_path), keep=2)
        mgr.save_dygraph(2, layer.state_dict(), opt.state_dict())
        mgr.drain()
        saved_layer, saved_opt = layer.state_dict(), opt.state_dict()
        next_w = _dy_train(layer, opt, WD, 6)
    with rf.dygraph.guard(rf.CPUPlace()):
        layer, opt = _dy_model(rf, RD)
        assert rres.CheckpointManager(str(tmp_path)).restore_or_initialize_dygraph(
            layer, opt) == 2
        got_layer, got_opt = layer.state_dict(), opt.state_dict()
        next_r = _dy_train(layer, opt, RD, 6)
    assert sorted(got_layer) == sorted(saved_layer)
    for k, v in saved_layer.items():
        assert np.array_equal(np.asarray(got_layer[k]), np.asarray(v)), k
    assert sorted(got_opt) == sorted(saved_opt)
    for k, v in saved_opt.items():
        np.testing.assert_array_equal(np.asarray(got_opt[k]).reshape(-1),
                                      np.asarray(v).reshape(-1), err_msg=k)
    np.testing.assert_allclose(next_r, next_w, rtol=1e-6)


# -- NanGuard -------------------------------------------------------------------


def _mlp(fluid, guard_cls, mgr):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8, 4], append_batch_size=False)
        y = fluid.layers.fc(fluid.layers.fc(x, 16, act="relu"), 1)
        loss = fluid.layers.mean(y * y)
        guard = guard_cls(manager=mgr, max_consecutive=2)
        guard.decorate(fluid.optimizer.SGD(0.1)).minimize(loss)
    return main, startup, loss, guard


def _mlp_feed(step):
    return {"x": np.random.RandomState(100 + step).rand(8, 4).astype("float32")}


def test_nan_guard_skip_and_rollback_match_jax(tmp_path):
    """Steps 0, 1 good (autosaved); then the weights are poisoned, step 2's
    autosave captures them before check() sees the bad loss, step 3 is bad
    too: the rollback skips (and deletes) snapshot 2 and lands on 1."""
    jfluid, jres = _jax()
    from paddle_tpu import profiler as jprofiler

    got, state0 = {}, None
    for tag, fluid, res, prof in (("jax", jfluid, jres, jprofiler),
                                  ("torch", tfluid, tres, tprofiler)):
        root = str(tmp_path / tag)
        mgr = res.CheckpointManager(root, save_interval=1, keep=10, async_save=False)
        main, startup, loss, guard = _mlp(fluid, res.NanGuard, mgr)
        scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in main.list_vars() if v.persistable and scope.has(v.name))
        if state0 is None:
            state0 = {n: np.asarray(scope.get(n)) for n in names}
        else:
            tfluid.io.set_persistables_from_numpy(scope, state0, "cpu")
        mgr.attach(main)
        c0 = prof.counters()
        checks = []
        for step in range(4):
            if step == 2:
                w = main.global_block().all_parameters()[0].name
                scope.set(w, scope.get(w) * float("nan"))
            lv, fi = exe.run(main, feed=_mlp_feed(step), fetch_list=[loss, guard.found_inf_name],
                             scope=scope)
            checks.append(guard.check(values=lv, found_inf=fi, program=main, scope=scope,
                                      executor=exe))
        c1 = prof.counters()
        state = {n: np.asarray(to_numpy(scope.get(n))) for n in names}
        snap, _ = res.load_snapshot(res.snapshot.snapshot_dir(root, 1))
        got[tag] = dict(
            checks=checks, skipped=c1["nan_steps_skipped"] - c0.get("nan_steps_skipped", 0),
            rollbacks=c1["nan_rollbacks"] - c0.get("nan_rollbacks", 0),
            resume=c1["resume_step"], steps=[s for s, _ in res.list_snapshots(root)],
            suspended=mgr._autosave_suspended, state=state, snap=snap)
    j, t = got["jax"], got["torch"]
    for k in ("checks", "skipped", "rollbacks", "resume", "steps", "suspended"):
        assert t[k] == j[k], k
    assert t["checks"] == [True, True, False, False]
    assert (t["skipped"], t["rollbacks"], t["resume"]) == (2, 1, 1)
    assert t["steps"] == [1, 0]  # the poisoned autosave of step 2 is gone
    for n in j["state"]:
        np.testing.assert_allclose(t["state"][n], j["state"][n], rtol=1e-5, atol=1e-5,
                                   err_msg=n)
        assert np.array_equal(t["state"][n], t["snap"][n].astype(t["state"][n].dtype)), n


def test_nan_guard_passes_amp_through_and_raises_without_snapshot(tmp_path):
    from paddle_tpu_torch.contrib import mixed_precision as mp

    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [4])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 1))
        amp = mp.decorate(tfluid.optimizer.SGD(0.1), amp_dtype="float16",
                          use_dynamic_loss_scaling=True)
        guard = tres.NanGuard()
        assert guard.decorate(amp) is amp
        amp.minimize(loss)
    assert guard.found_inf_name == amp._found_inf_var.name
    empty = tres.NanGuard(tres.CheckpointManager(str(tmp_path / "e"), async_save=False), 1)
    with pytest.raises(RuntimeError, match="snapshot to roll back"):
        empty.check(values=[np.float32(np.nan)])


# -- preemption ---------------------------------------------------------------


def test_preemption_final_save_drains_and_commits(tmp_path):
    mgr = tres.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(0, state={"w": torch.zeros(4)})
    prev = signal.getsignal(signal.SIGTERM)
    with tres.PreemptionHandler(mgr) as pre:
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(200):
            if pre.preempted:
                break
            time.sleep(0.01)
        assert pre.preempted and pre.signal_received == signal.SIGTERM
        path = pre.final_save(1, state={"w": torch.ones(4)})
    assert path == tsnap.snapshot_dir(str(tmp_path), 1)
    assert signal.getsignal(signal.SIGTERM) is prev
    assert mgr.latest_step(deep=True) == 1 and mgr.all_steps() == [1, 0]
    mgr.close()
    with pytest.raises(RuntimeError, match="no CheckpointManager"):
        tres.PreemptionHandler().final_save(2, state={"w": np.ones(1)})


# -- executor wiring -------------------------------------------------------------


def _drop_mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8, 4], append_batch_size=False)
        h = fluid.layers.dropout(fluid.layers.fc(x, 16, act="relu"), dropout_prob=0.3)
        y = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(y * y)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_dispatch_failure_keeps_the_seed_counter_like_jax():
    """A step that fails at `executor.dispatch` leaves the seed counter
    where it was: its retry draws the dropout key, and gives the loss, of a
    clean executor's first step."""
    jfluid, jres = _jax()
    got = {}
    for tag, fluid, faults in (("jax", jfluid, jres.faults), ("torch", tfluid, tfaults)):
        main, startup, loss = _drop_mlp(fluid)
        losses = []
        for fail in (True, False):
            scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
            plan = faults.FaultPlan(seed=3).add("executor.dispatch", raises="RuntimeError",
                                                nth=2 if fail else 10**6)
            with faults.active(plan):
                exe.run(startup, scope=scope)
                counters = [exe._seed_counter]
                if fail:
                    with pytest.raises(RuntimeError):
                        exe.run(main, feed=_mlp_feed(0), fetch_list=[loss], scope=scope)
                    counters.append(exe._seed_counter)
                (lv,) = exe.run(main, feed=_mlp_feed(0), fetch_list=[loss], scope=scope)
            losses.append(float(np.asarray(to_numpy(lv)).reshape(-1)[0]))
            if fail:
                got[tag] = counters + [exe._seed_counter, plan.fired.get("executor.dispatch")]
        assert losses[0] == losses[1], tag
    assert got["torch"] == got["jax"] == [1, 1, 2, 1]


def test_heartbeat_tick_step_and_dygraph_jit(tmp_path, monkeypatch):
    hb = tmp_path / "hb.json"
    monkeypatch.setenv("PADDLE_TPU_PROGRESS_FILE", str(hb))
    main, startup, loss = _drop_mlp(tfluid)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    assert json.loads(hb.read_text())["tick"] == 1 and "step" not in json.loads(hb.read_text())
    mgr = tres.CheckpointManager(str(tmp_path / "ck"), save_interval=100).attach(main)
    for s in range(3):
        exe.run(main, feed=_mlp_feed(s), fetch_list=[loss], scope=scope)
    data = json.loads(hb.read_text())
    assert data["tick"] == 4 and data["step"] == 2 and data["pid"] == os.getpid()
    mgr.drain()
    assert mgr._auto_step == 3 and mgr.all_steps() == [0]  # cadence 100
    mgr.detach(main)
    mgr.close()
    # a lost heartbeat is not a crash
    plan = tfaults.FaultPlan(seed=1).add("trainer.heartbeat", raises="OSError", nth=1)
    with tfaults.active(plan):
        exe.run(main, feed=_mlp_feed(3), fetch_list=[loss], scope=scope)
    assert json.loads(hb.read_text())["tick"] == 4
    hb.unlink()
    from paddle_tpu_torch import dygraph as TD
    from paddle_tpu_torch.dygraph.jit import TracedLayer

    with TD.guard(tfluid.CPUPlace()):
        layer = TD.Linear(4, 2)
        _, traced = TracedLayer.trace(layer, [TD.to_variable(np.ones((2, 4), "float32"))])
        for _ in range(2):
            traced([TD.to_variable(np.ones((2, 4), "float32"))])
    data = json.loads(hb.read_text())
    assert data["tick"] >= 2 and "step" not in data


# -- on the card ------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_engine_copy_waits_for_the_step_and_keeps_the_block(tmp_path):
    """Each round: a step behind a long device-side hold writes `t`; submit
    snapshots it, the caller drops it and a new tensor of the same size is
    filled on the compute stream. Without the event wait the copy reads `t`
    before the step wrote it; without record_stream the allocator hands
    `t`'s block to the fill before the copy has read it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_resilience.py` on the card")
    dev = torch.device("cuda", 0)
    eng = tres.AsyncSnapshotEngine(str(tmp_path), keep=8)
    base = torch.arange(1 << 22, device=dev, dtype=torch.float32)
    for r in range(6):
        torch.cuda._sleep(50_000_000)
        t = base + float(r)  # the step
        eng.submit(r, {"t": t, "c": torch.full((3,), r, dtype=torch.int64, device=dev)})
        del t
        torch.full((1 << 22,), -1.0, device=dev)  # may take t's block
    eng.drain()
    assert len(eng.copy_ms) == 6 and all(ms > 0 for ms in eng.copy_ms)
    want = base.cpu().numpy()
    for r in range(6):
        arrays, _ = tres.load_snapshot(tsnap.snapshot_dir(str(tmp_path), r))
        assert np.array_equal(arrays["t"], want + r), r
        assert arrays["c"].dtype == np.int64 and arrays["c"].tolist() == [r] * 3
    eng.close()
