"""The port's TrainSupervisor, launcher and shrink policy, on the CPU.

- Pure decisions against the JAX package: `shrink_candidates`,
  `build_world`, `best_shrink_world` over a plan table,
  `placement_env_value` / `placement_from_env`, and each rank's env keys.
- The launcher CLI (`python -m paddle_tpu_torch.distributed.launch`): the
  first nonzero exit code in order of death, survivors killed, SIGTERM
  fanned out.
- Supervision drills against a stdlib-only simulated trainer that obeys
  the progress-file contract: crash-respawn, the hang watchdog, the
  coordinated kill, the max-restarts breaker, a stop request, host loss
  with and without shrink, budget exhaustion. Workers see no `JAX_*`
  variable. A marker is asserted only where its write cannot race the
  coordinated kill (the rank that reached the chaos step, or an attempt
  that ran to its end), and each test takes ports of its own.
- Exact resume under SIGKILL: this file's worker mode (`python
  tests/test_torch_trainer_fleet.py --worker DIR`) trains a dropout MLP on
  the port from a DataLoader under `restore_or_initialize`, `track_reader`
  and `attach`; under the port supervisor with `fleet.kill_trainer:nth=7`
  the union of its step logs is bit-equal to an uninterrupted port run,
  whose losses are within rtol 1e-5 of the same MLP run in-process by the
  JAX package from the same initial state (fp32 sums over a few dozen
  terms)."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import zlib

import numpy as np

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(TESTS_DIR)

# -- the simulated trainer -------------------------------------------------------

# the workers' marker write: whole or absent, as a SIGKILL may land mid-write
PUT = """\
import os

def put(path, text):
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)
"""

SIM = PUT + """\
import json, signal, sys, time
att = int(os.environ.get("PADDLE_TPU_TRAINER_ATTEMPT", "0"))
rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
pf = os.environ.get("PADDLE_TPU_PROGRESS_FILE")
wd, mode = sys.argv[1], sys.argv[2]

def on_term(signum, frame):
    put(os.path.join(wd, f"term.{rank}.{att}"), "1")
    sys.exit(0)

# the handler first, then the pid file: it doubles as "ready to drain"
signal.signal(signal.SIGTERM, on_term)
put(os.path.join(wd, f"env.{rank}.{att}"), json.dumps(sorted(
    k for k in os.environ if k.startswith("JAX_") or os.environ[k] and k == "PADDLE_TPU_FAULTS")))
put(os.path.join(wd, f"world.{rank}.{att}"), os.environ.get("PADDLE_TPU_ELASTIC_WORLD", "?") + "/"
    + os.environ.get("PADDLE_TPU_BASE_WORLD", "?"))
put(os.path.join(wd, f"pid.{rank}.{att}"), str(os.getpid()))
if mode == "fail":
    sys.exit(2)
state = os.path.join(wd, f"state.{rank}")
start = int(open(state).read()) + 1 if os.path.exists(state) else 0
steps = int(os.environ.get("SIM_STEPS", "10"))
dt = float(os.environ.get("SIM_DT", "0.05"))
for step in range(start, steps):
    if pf:
        tmp = pf + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "tick": step + 1, "pid": os.getpid()}, f)
        os.replace(tmp, pf)
    put(state, str(step))
    if mode in ("crash", "crashmate") and att == 0 and rank == 0 and step == 4:
        sys.exit(7)
    if mode == "hang" and att == 0 and rank == 0 and step == 3:
        time.sleep(600)
    if mode == "crashmate" and att == 0 and rank == 1 and step == 2:
        time.sleep(600)
    time.sleep(dt)
print("DONE", flush=True)
"""


def _sim(tmp_path):
    path = str(tmp_path / "sim.py")
    with open(path, "w") as f:
        f.write(SIM)
    return path


def _markers(tmp_path, prefix):
    """{(rank, attempt): text} of the sim's `prefix` markers (each written
    whole by a rename, so a kill leaves it whole or absent)."""
    out = {}
    for n in os.listdir(tmp_path):
        parts = n.split(".")
        if parts[0] == prefix and len(parts) == 3:
            out[(int(parts[1]), int(parts[2]))] = (tmp_path / n).read_text()
    return out


def _pids(tmp_path):
    out = {}
    for key, text in _markers(tmp_path, "pid").items():
        out[key] = int(text)
    return out


def _alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def _assert_no_orphans(tmp_path):
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        alive = [(k, p) for k, p in _pids(tmp_path).items() if _alive(p)]
        if not alive:
            return
        time.sleep(0.05)
    raise AssertionError(f"orphan worker processes survived: {alive}")


def _sup(tmp_path, argv, **kw):
    from paddle_tpu_torch.resilience.trainer_fleet import TrainSupervisor

    kw.setdefault("device", "cpu")
    kw.setdefault("hang_timeout_s", 8.0)
    kw.setdefault("start_timeout_s", 30.0)
    kw.setdefault("min_uptime_s", 0.05)
    kw.setdefault("respawn_base_delay_s", 0.01)
    kw.setdefault("respawn_max_delay_s", 0.05)
    kw.setdefault("workdir", str(tmp_path / "supwd"))
    return TrainSupervisor(argv, **kw)


def _run(sup):
    try:
        return sup.run()
    finally:
        sup.close()


# -- pure decisions ------------------------------------------------------------------


def test_shrink_policy_and_world_match_jax(tmp_path, monkeypatch):
    from paddle_tpu.autoshard import elastic as jel
    from paddle_tpu.distributed import launch as jl

    from paddle_tpu_torch.autoshard import elastic as tel
    from paddle_tpu_torch.distributed import launch as tl

    for w in range(1, 13):
        assert tl.shrink_candidates(w) == jl.shrink_candidates(w)
    assert tl.shrink_candidates(8) == [4, 2, 1] and tl.shrink_candidates(7) == [1]
    for args in (("127.0.0.1", 6170, 1), ("10.0.0.1,10.0.0.2", 7000, 3)):
        assert tl.build_world(*args) == jl.build_world(*args)
    world = tl.build_world("h1,h2", 7100, 2)[1]
    assert tl.worker_env(3, world, "0,1", base_env={"A": "1"}, extra={"B": "2"}) == \
        jl.worker_env(3, world, "0,1", base_env={"A": "1"}, extra={"B": "2"})
    table = {"plans": {
        "4": {"world": 4, "mesh": {"batch": 4}, "config": "dp4", "specs": {"w": [None]},
              "cost": {"feasible": True, "score": 2.0}},
        "2": {"world": 2, "mesh": {"batch": 2}, "config": "dp2", "specs": {},
              "cost": {"feasible": True, "score": 2.0}},
        "1": {"world": 1, "cost": {"feasible": False, "score": 0.1}},
        "x": {"world": 0}}}
    path = tmp_path / "plans.json"
    path.write_text(json.dumps(table))
    assert tel.load_plan_table(str(path)) == jel.load_plan_table(str(path))
    assert tel.load_plan_table(table) == jel.load_plan_table(table) == {
        4: table["plans"]["4"], 2: table["plans"]["2"], 1: table["plans"]["1"]}
    plans = tel.load_plan_table(table)
    for cands, mw in (([4, 2, 1], 1), ([2, 1], 1), ([1], 1), ([4, 2, 1], 3), ([], 1)):
        assert tel.best_shrink_world(plans, cands, mw) == jel.best_shrink_world(plans, cands, mw)
        assert tel.best_shrink_world({}, cands, mw) == jel.best_shrink_world({}, cands, mw)
    assert tel.best_shrink_world(plans, [4, 2, 1])[0] == 4  # a tie goes to the larger
    value = tel.placement_env_value(plans[4])
    assert value == jel.placement_env_value(plans[4])
    monkeypatch.setenv(tel.PLACEMENT_ENV, value)
    assert tel.placement_from_env() == jel.placement_from_env() == json.loads(value)
    assert tel.PLACEMENT_ENV == jel.PLACEMENT_ENV


def test_per_rank_env_and_next_world_match_jax(tmp_path):
    from paddle_tpu.resilience.trainer_fleet import TrainSupervisor as JSup

    kw = dict(nproc_per_node=4, started_port=7170, workdir=str(tmp_path / "wd"),
              extra_env={"X": "1"}, worker_faults={0: "seed=1;trainer.step:nth=3"},
              allow_shrink=True, min_world=2)
    sups = {"jax": JSup(["t.py"], **kw), "torch": _sup(tmp_path, ["t.py"], **kw)}
    envs = {t: [s._per_rank_env(a)(r) for a in (0, 1) for r in range(4)]
            for t, s in sups.items()}
    assert envs["torch"] == envs["jax"]
    assert envs["torch"][0]["PADDLE_TPU_FAULTS"] == "seed=1;trainer.step:nth=3"
    assert envs["torch"][4]["PADDLE_TPU_FAULTS"] == ""  # attempt 1: no plan
    for s in sups.values():
        s._shrink_to(*s._next_world()[:1], "test")
    assert sups["torch"].world == sups["jax"].world and len(sups["torch"].world) == 2
    assert sups["torch"]._next_world() == sups["jax"]._next_world() == (None, None)
    assert sups["torch"].stats()["world_size"] == sups["jax"].stats()["world_size"] == 2
    assert sups["torch"]._base_env() == {k: v for k, v in os.environ.items()
                                         if not k.startswith("JAX_")}


# -- the launcher CLI -------------------------------------------------------------------


def test_launch_cli_first_death_wins_and_sigterm_fans_out(tmp_path):
    crash = tmp_path / "crash.py"
    crash.write_text(
        PUT + "import sys, time\n"
        "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "put(f'{sys.argv[1]}/pid.{rank}.0', str(os.getpid()))\n"
        "if rank == 1:\n"
        "    time.sleep(0.3); sys.exit(3)\n"
        "time.sleep(600)\n")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
                           "--nproc_per_node=2", "--started_port=7210", str(crash),
                           str(tmp_path)], env=env, timeout=120)
    assert proc.returncode == 3 and time.monotonic() - t0 < 60
    _assert_no_orphans(tmp_path)

    drain = tmp_path / "drain.py"
    drain.write_text(
        PUT + "import signal, sys, time\n"
        "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "wd = sys.argv[1]\n"
        "def t(s, f):\n"
        "    put(f'{wd}/term.{rank}.1', '1')\n"
        "    sys.exit(0)\n"
        "signal.signal(signal.SIGTERM, t)\n"
        "put(f'{wd}/pid.{rank}.1', str(os.getpid()))\n"
        "time.sleep(600)\n")
    proc = subprocess.Popen([sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
                             "--nproc_per_node=2", "--started_port=7220", str(drain),
                             str(tmp_path)], env=env)
    deadline = time.monotonic() + 60
    while len([k for k in _pids(tmp_path) if k[1] == 1]) < 2:
        assert time.monotonic() < deadline, "ranks never spawned"
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 0
    assert set(_markers(tmp_path, "term")) == {(0, 1), (1, 1)}
    _assert_no_orphans(tmp_path)


def test_wait_group_first_nonzero_in_death_order(tmp_path):
    from paddle_tpu_torch.distributed.launch import spawn_workers, wait_group

    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys, time\n"
        "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "time.sleep(0.2 if rank == 1 else 5.0)\n"
        "sys.exit(9 if rank == 1 else 4)\n")
    procs = spawn_workers([str(script)], ["h:1", "h:2"], 0, 2)
    try:
        assert wait_group(procs, kill_grace_s=1.0) == 9
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# -- supervision drills ------------------------------------------------------------------


def test_crash_respawn_resumes_and_workers_see_no_jax_env(tmp_path, monkeypatch):
    # imported before the variable is set: the module installs a plan from
    # PADDLE_TPU_FAULTS at import, and this one is for the workers to shed
    from paddle_tpu_torch.resilience import trainer_fleet  # noqa: F401

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("PADDLE_TPU_FAULTS", "seed=1;fleet.kill_trainer:raises=FaultError:nth=1000")
    sup = _sup(tmp_path, [_sim(tmp_path), str(tmp_path), "crash"], started_port=7230)
    assert _run(sup) == 0
    stats = sup.stats()
    c = stats["counters"]
    assert stats["restarts"] == 1
    assert c["trainer_crashes"] == 1 and c["trainer_restarts"] == 1
    assert c["trainer_resume_step"] >= 4 and c["train_mttr_ms"] >= 0
    # both attempts ran to their own end (a crash, then done): their
    # env markers cannot race a kill
    envs = _markers(tmp_path, "env")
    assert envs[(0, 0)] == envs[(0, 1)] == "[]"
    _assert_no_orphans(tmp_path)


def test_watchdog_detects_a_hang_within_its_deadline(tmp_path):
    sup = _sup(tmp_path, [_sim(tmp_path), str(tmp_path), "hang"], hang_timeout_s=1.0,
               started_port=7240)
    t0 = time.monotonic()
    assert _run(sup) == 0
    c = sup.stats()["counters"]
    assert c["trainer_hangs_detected"] == 1 and c["trainer_restarts"] == 1
    assert time.monotonic() - t0 < 15
    _assert_no_orphans(tmp_path)


def test_coordinated_kill_of_a_wedged_survivor(tmp_path):
    sup = _sup(tmp_path, [_sim(tmp_path), str(tmp_path), "crashmate"], nproc_per_node=2,
               started_port=7250, extra_env={"SIM_STEPS": "6"})
    t0 = time.monotonic()
    assert _run(sup) == 0
    c = sup.stats()["counters"]
    assert c["trainer_crashes"] == 1 and c["trainer_restarts"] == 1
    assert time.monotonic() - t0 < 30
    _assert_no_orphans(tmp_path)


def test_max_restarts_and_fast_crash_breaker(tmp_path):
    sup = _sup(tmp_path, [_sim(tmp_path), str(tmp_path), "fail"], max_restarts=3,
               breaker_threshold=2, started_port=7260)
    assert _run(sup) == 2
    assert sup.stats()["restarts"] == 3
    assert sup.respawn_breaker.open
    _assert_no_orphans(tmp_path)


def test_chaos_kill_at_a_pinned_step_fires_once(tmp_path):
    from paddle_tpu_torch.resilience import faults

    plan = faults.FaultPlan(seed=7).add("fleet.kill_trainer", raises="FaultError", nth=6)
    with faults.active(plan):
        sup = _sup(tmp_path, [_sim(tmp_path), str(tmp_path), "full"], started_port=7270,
                   extra_env={"SIM_STEPS": "20", "SIM_DT": "0.08"})
        assert _run(sup) == 0
    c = sup.stats()["counters"]
    assert c["trainer_chaos_kills"] == 1 and plan.fired.get("fleet.kill_trainer") == 1
    assert c["trainer_crashes"] == 1 and c["trainer_restarts"] == 1
    assert c["trainer_resume_step"] >= 6
    _assert_no_orphans(tmp_path)


def test_stop_request_drains_without_respawn(tmp_path):
    sup = _sup(tmp_path, [_sim(tmp_path), str(tmp_path), "full"], term_grace_s=10.0,
               started_port=7280, extra_env={"SIM_STEPS": "1000", "SIM_DT": "0.05"})

    def stop_when_ready():
        deadline = time.monotonic() + 60
        while not _pids(tmp_path) and time.monotonic() < deadline:
            time.sleep(0.02)
        sup.request_stop()

    threading.Thread(target=stop_when_ready, daemon=True).start()
    assert _run(sup) == 0
    assert sup.stats()["restarts"] == 0
    assert set(_markers(tmp_path, "term")) == {(0, 0)}
    _assert_no_orphans(tmp_path)


def test_host_loss_shrinks_the_world(tmp_path):
    from paddle_tpu_torch.resilience import faults

    plan = faults.FaultPlan(seed=7).add("fleet.kill_host", raises="FaultError", nth=3)
    with faults.active(plan):
        sup = _sup(tmp_path, [_sim(tmp_path), str(tmp_path), "full"], nproc_per_node=2,
                   started_port=7290, allow_shrink=True,
                   extra_env={"SIM_STEPS": "20", "SIM_DT": "0.08"})
        assert _run(sup) == 0
    stats = sup.stats()
    c = stats["counters"]
    assert plan.fired.get("fleet.kill_host") == 1
    assert c["trainer_host_losses"] == 1 and c["trainer_shrinks"] == 1
    assert c["trainer_world_size"] == 1 and c["mesh_shrink_mttr_ms"] >= 0
    assert stats["world_size"] == 1 and stats["base_world"] == 2 and stats["restarts"] == 1
    worlds = _markers(tmp_path, "world")
    # attempt 0: the rank that reached step 3 wrote its marker first; its
    # sibling's may have lost the race to the kill, but any that landed
    # shows the full width
    assert {m for (_, att), m in worlds.items() if att == 0} == {"2/2"}
    assert worlds[(0, 1)] == "1/2"  # the shrunk attempt ran to its end
    assert (1, 1) not in worlds  # rank 1 was not respawned
    _assert_no_orphans(tmp_path)


def test_host_loss_without_shrink_respawns_at_full_width(tmp_path):
    from paddle_tpu_torch.resilience import faults

    plan = faults.FaultPlan(seed=7).add("fleet.kill_host", raises="FaultError", nth=3)
    with faults.active(plan):
        sup = _sup(tmp_path, [_sim(tmp_path), str(tmp_path), "full"], nproc_per_node=2,
                   started_port=7300, extra_env={"SIM_STEPS": "20", "SIM_DT": "0.08"})
        assert _run(sup) == 0
    stats = sup.stats()
    c = stats["counters"]
    assert c["trainer_host_losses"] == 1 and "trainer_shrinks" not in c
    assert stats["world_size"] == 2
    worlds = _markers(tmp_path, "world")
    # attempt 1 finished with both ranks exiting 0: both wrote theirs
    assert worlds[(0, 1)] == worlds[(1, 1)] == "2/2"
    _assert_no_orphans(tmp_path)


def test_budget_exhaustion_shrinks_then_gives_up(tmp_path):
    sup = _sup(tmp_path, [_sim(tmp_path), str(tmp_path), "fail"], nproc_per_node=2,
               started_port=7310, max_restarts=2, allow_shrink=True, breaker_threshold=100)
    assert _run(sup) == 2
    stats = sup.stats()
    assert stats["counters"]["trainer_shrinks"] == 1
    assert stats["world_size"] == 1 and stats["restarts"] == 4
    worlds = _markers(tmp_path, "world")
    for (rank, att), marker in worlds.items():
        assert marker == ("2/2" if att <= 2 else "1/2"), (rank, att, marker)
    # the single-rank attempts after the shrink have no sibling to race
    assert worlds[(0, 3)] == worlds[(0, 4)] == "1/2"
    _assert_no_orphans(tmp_path)


# -- exact resume under SIGKILL -------------------------------------------------------

EPOCHS, N_SAMPLES, BATCH = 3, 48, 8  # 6 batches an epoch, 18 steps


def _samples():
    for i in range(N_SAMPLES):
        rs = np.random.RandomState(1000 + i)
        x = rs.rand(6).astype("float32")
        yield x, np.asarray([x.sum() * 0.5], dtype="float32")


def _mlp_job(fluid, rdr, place):
    """The dropout MLP, its Adam program and its DataLoader (a seeded
    per-epoch shuffle) -> (main, startup, loss, loader)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [6])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.dropout(fluid.layers.fc(x, 16, act="relu"), dropout_prob=0.3)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(fluid.layers.fc(h, 1), y))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    loader = rdr.DataLoader.from_generator([x, y], capacity=4)
    loader.set_sample_generator(_samples, batch_size=BATCH, drop_last=True, shuffle_buf=16,
                                shuffle_seed=11, places=place)
    return main, startup, loss, loader


def _epochs(loader, start_epoch, run_step):
    """Each batch from the loader's cursor on -> [(epoch, batch, crc,
    run_step(feed, epoch, batch, crc))]; crc is the crc32 of the batch's x."""
    out = []
    for epoch in range(start_epoch, EPOCHS):
        for feed in loader():
            idx = loader.state_dict()["batch"] - 1
            x = feed["x"]
            x = x.numpy() if hasattr(x, "numpy") else np.asarray(x)
            crc = zlib.crc32(x.tobytes()) & 0xFFFFFFFF
            out.append((epoch, idx, crc, run_step(feed, epoch, idx, crc)))
    return out


def _worker(workdir):
    """The supervised worker: resume from the newest valid snapshot (or
    the initial state in ELASTIC_INIT), then one JSON line a step."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, REPO_ROOT)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import reader as rdr
    from paddle_tpu_torch import resilience

    attempt = int(os.environ.get("PADDLE_TPU_TRAINER_ATTEMPT", "0"))
    main, startup, loss, loader = _mlp_job(fluid, rdr, fluid.CPUPlace())
    exe = fluid.Executor(fluid.CPUPlace())
    mgr = resilience.CheckpointManager(os.path.join(workdir, "ckpt"), save_interval=1,
                                       keep=10)
    mgr.track_reader(loader, "train")
    restored = mgr.restore_or_initialize(exe, main, startup)
    if restored == -1:
        with np.load(os.environ["ELASTIC_INIT"]) as z:
            fluid.io.set_persistables_from_numpy(fluid.global_scope(),
                                                 {k: z[k] for k in z.files}, "cpu")
    mgr.attach(main)
    print(json.dumps({"resumed_from": restored, "cursor": loader.state_dict()}), flush=True)
    step_dt = float(os.environ.get("ELASTIC_STEP_DT", "0.05"))
    with open(os.environ["ELASTIC_RESULT"], "a") as result:
        def run_step(feed, epoch, batch, crc):
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
            value = float(np.asarray(lv).reshape(-1)[0])
            result.write(json.dumps({"attempt": attempt, "epoch": epoch, "batch": batch,
                                     "crc": crc, "loss": value}) + "\n")
            result.flush()
            time.sleep(step_dt)  # steps no shorter than the supervisor's poll
            return value

        _epochs(loader, loader.state_dict()["epoch"], run_step)
    mgr.drain()
    print("WORKER_DONE", flush=True)


def _read_jsonl(path):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.endswith("}"):  # a SIGKILL may tear the last line
                out.append(json.loads(line))
    return out


def test_sigkilled_port_trainer_resumes_bit_equal(tmp_path):
    import paddle_tpu as jfluid
    from paddle_tpu import reader as jrdr

    from paddle_tpu_torch.resilience import faults

    # the JAX package's run, in process, from its own startup state
    main, startup, loss, loader = _mlp_job(jfluid, jrdr, None)
    scope, exe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = {v.name: np.asarray(scope.get(v.name)) for v in main.list_vars()
            if v.persistable and scope.has(v.name)}
    np.savez(tmp_path / "init.npz", **init)
    jax_log = _epochs(loader, 0, lambda feed, *_: float(np.asarray(exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope)[0]).reshape(-1)[0]))
    assert len(jax_log) == EPOCHS * N_SAMPLES // BATCH

    env = {"ELASTIC_INIT": str(tmp_path / "init.npz"), "PYTHONPATH": REPO_ROOT}
    full = tmp_path / "full.jsonl"
    subprocess.run([sys.executable, __file__, "--worker", str(tmp_path / "full_wd")],
                   env=dict(os.environ, ELASTIC_RESULT=str(full), **env), check=True,
                   timeout=300, capture_output=True)
    chaos = tmp_path / "chaos.jsonl"
    plan = faults.FaultPlan(seed=7).add("fleet.kill_trainer", raises="FaultError", nth=7)
    with faults.active(plan):
        sup = _sup(tmp_path, [__file__, "--worker", str(tmp_path / "chaos_wd")],
                   hang_timeout_s=60.0, start_timeout_s=120.0, min_uptime_s=0.2,
                   started_port=7320, log_dir=str(tmp_path / "logs"),
                   extra_env=dict(env, ELASTIC_RESULT=str(chaos)))
        assert _run(sup) == 0
    stats = sup.stats()
    assert stats["counters"]["trainer_chaos_kills"] == 1
    assert 1 <= stats["restarts"] <= 2
    assert stats["counters"]["train_mttr_ms"] > 0
    assert stats["counters"]["trainer_resume_step"] > 0
    for r in stats["ranks"]:
        assert not r["alive"] and not _alive(r["pid"])

    def keyed(rows):
        return {(r["epoch"], r["batch"]): (r["crc"], r["loss"]) for r in rows}

    full_rows, chaos_rows = _read_jsonl(full), _read_jsonl(chaos)
    fm = keyed(full_rows)
    assert len(fm) == len(full_rows) == len(jax_log)
    assert {r["attempt"] for r in chaos_rows} == {0, 1}
    assert [r for r in chaos_rows if fm.get((r["epoch"], r["batch"])) != (r["crc"], r["loss"])
            ] == []
    assert set(keyed(chaos_rows)) == set(fm)
    # the port's uninterrupted run against the JAX package's
    assert [(e, b, c) for e, b, c, _ in jax_log] == [
        (r["epoch"], r["batch"], r["crc"]) for r in full_rows]
    np.testing.assert_allclose([r["loss"] for r in full_rows], [v for *_, v in jax_log],
                               rtol=1e-5)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2])
