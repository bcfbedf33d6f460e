"""The port's serving fleet (paddle_tpu_torch/inference/fleet.py) on the CPU,
in-process and without a worker: each in-process case of
tests/test_fleet_serving.py and tests/test_mixed_fleet.py runs on both
packages' fleets, with every observation (picks, health payloads, counter
snapshots, plans, Retry-After hints) compared. The pure divert table is
held against the JAX one on a hypothesis-drawn grid of class summaries,
and the worker spawn command and environment name the port's server, the
card by default, and no JAX variable.

Nothing here spawns a worker: the subprocess fleets are
tests/test_torch_fleet_serving.py."""

import socket
import sys
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu_torch.inference import fleet as tfleet
from paddle_tpu_torch.resilience import faults as tfaults


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    from paddle_tpu.resilience import faults as jfaults

    tfaults.clear()
    jfaults.clear()
    yield
    tfaults.clear()
    jfaults.clear()


def _packages():
    """(name, fleet module, faults module) of each package."""
    from paddle_tpu.inference import fleet as jfleet
    from paddle_tpu.resilience import faults as jfaults

    return (("jax", jfleet, jfaults), ("port", tfleet, tfaults))


def _on_both(scenario, tmp_path):
    """Run `scenario(fleet module, faults module, tmp dir) -> observations`
    on both packages; the port's observations must equal the JAX ones."""
    seen = {}
    for name, fl, fa in _packages():
        d = tmp_path / name
        d.mkdir()
        seen[name] = scenario(fl, fa, d)
    assert seen["port"] == seen["jax"]
    return seen["port"]


# -- tests/test_fleet_serving.py:114 -----------------------------------------------


def _pick_and_lifecycle(fl, fa, tmp_path):
    obs = []
    sup = fl.FleetSupervisor(str(tmp_path / "model"), replicas=3)
    router = fl.FleetRouter(sup, port=0)
    try:
        r0, r1, r2 = sup.replicas
        assert router._pick(set()) is None  # nothing live yet
        with sup._lock:
            for r in (r0, r1, r2):
                sup._set_status(r, "live")
        assert sup.health()["live"] == 3
        # least-inflight, lowest-index tie-break; the pick claims the slot
        r0.inflight = 1
        rep = router._pick(set())
        assert rep is r1 and r1.inflight == 1 and r1.routed == 1
        obs.append(("pick", rep.idx, r1.inflight, r1.routed))
        router._release(r1)
        # failover exclusion: already-tried indices never re-picked
        assert router._pick({0, 1, 2}) is None
        # non-live is never picked, whatever the inflight ordering
        with sup._lock:
            sup._set_status(r1, "draining")
            sup._set_status(r2, "dead")
        r0.inflight = 99
        rep = router._pick(set())
        assert rep is r0
        router._release(r0)
        h = sup.health()
        assert (h["live"], h["draining"], h["dead"]) == (1, 1, 1)
        assert h["status"] == "degraded"
        obs.append(("health", {k: v for k, v in h.items() if k != "replica_status"},
                    [{k: v for k, v in r.items() if k != "pid"} for r in h["replica_status"]]))
        # a breaker-open live replica: not pickable until its probe is due
        while not r0.route_breaker.record_failure():
            pass
        assert router._pick(set()) is None
        r0.route_breaker.record_success()
        assert router._pick(set()) is r0
        router._release(r0)
        # the lifecycle history is bounded
        with sup._lock:
            for _ in range(600):
                sup._set_status(r2, "starting")
                sup._set_status(r2, "dead")
        assert len(r2.history) <= 512
        assert r2.history[-2:] == ["starting", "dead"]
        obs.append(("history", [list(r.history) for r in sup.replicas]))
    finally:
        router.close()
        sup.stop()
    return obs


def test_router_pick_and_lifecycle_invariants_in_process(tmp_path):
    obs = _on_both(_pick_and_lifecycle, tmp_path)
    assert obs[0] == ("pick", 1, 1, 1)


# -- tests/test_mixed_fleet.py:113 and :183, the pure table ---------------------------


def _cls(live=1, depth=0, ewma=None, cap=16):
    return {"live": live, "depth": depth, "ewma_ms": ewma, "capacity": cap}


def _decision_table(fl, fa, tmp_path):
    dd = fl.divert_decision
    hot = _cls(live=2, depth=26, ewma=50.0, cap=32)
    idle = _cls(live=1, depth=0, ewma=200.0, cap=16)
    cool = _cls(live=2, depth=8, ewma=50.0, cap=32)
    flooded = _cls(live=2, depth=32, ewma=50.0, cap=32)
    sat_of = _cls(live=1, depth=16, ewma=200.0, cap=16)
    got = [
        dd(_cls(live=2, ewma=50.0), _cls(live=1, ewma=200.0)),
        dd(_cls(live=1, depth=10, ewma=100.0), _cls(live=1, depth=0, ewma=50.0),
           remaining_ms=200),
        dd(_cls(live=1, depth=10, ewma=100.0), _cls(live=1, depth=10, ewma=500.0),
           remaining_ms=200),
        dd(_cls(live=1, depth=10, ewma=100.0), _cls(live=1, depth=0, ewma=None),
           remaining_ms=200),
        dd(_cls(live=1, depth=10, ewma=100.0), _cls(live=0), remaining_ms=200),
        dd(_cls(live=1, depth=2, ewma=50.0), _cls(live=1, ewma=50.0), remaining_ms=5000),
        dd(hot, idle, bulk=True), dd(hot, idle, bulk=False), dd(cool, idle, bulk=True),
        dd(flooded, sat_of, bulk=True), dd(flooded, idle, bulk=True),
        dd(flooded, _cls(live=0), bulk=True),
        dd(_cls(live=0), idle), dd(_cls(live=0), idle, bulk=True),
        dd(_cls(live=0), _cls(live=0)), dd(_cls(live=1, ewma=50.0), idle),
    ]
    assert got == [
        ("primary", None), ("overflow", "deadline"), ("primary", None),
        ("overflow", "deadline"), ("primary", None), ("primary", None),
        ("overflow", "brownout"), ("primary", None), ("primary", None),
        ("shed", "brownout_shed"), ("overflow", "brownout"), ("shed", "brownout_shed"),
        ("overflow", "tier_loss"), ("overflow", "tier_loss"), ("shed", "unavailable"),
        ("primary", None)]
    return got


def _helpers(fl, fa, tmp_path):
    got = [
        fl.class_eta_ms(_cls(live=2, depth=10, ewma=100.0)),
        fl.class_eta_ms(_cls(live=2, depth=10, ewma=None)),
        fl.class_eta_ms(_cls(live=1, depth=0, ewma=0)),
        fl.class_utilization(_cls(depth=8, cap=32)),
        fl.class_utilization(_cls(depth=8, cap=0)),
    ]
    assert got == [(10 / 2 + 1) * 100.0, None, None, 0.25, 0.0]
    return got


def test_divert_decision_table(tmp_path):
    _on_both(_decision_table, tmp_path)


def test_class_eta_and_utilization_helpers(tmp_path):
    _on_both(_helpers, tmp_path)


_summary = st.fixed_dictionaries({
    "live": st.integers(0, 3), "depth": st.integers(-2, 40),
    "ewma_ms": st.one_of(st.none(), st.just(0.0), st.floats(0.01, 500.0)),
    "capacity": st.integers(0, 64)})


@settings(max_examples=300, deadline=None)
@given(primary=_summary, overflow=_summary,
       remaining_ms=st.one_of(st.none(), st.floats(0.0, 3000.0)), bulk=st.booleans(),
       steer=st.floats(0.0, 1.0), shed=st.floats(0.0, 2.0))
def test_divert_decision_matches_jax_on_a_grid(primary, overflow, remaining_ms, bulk,
                                               steer, shed):
    from paddle_tpu.inference import fleet as jfleet

    kw = dict(remaining_ms=remaining_ms, bulk=bulk, steer_watermark=steer,
              shed_watermark=shed)
    assert tfleet.divert_decision(primary, overflow, **kw) == \
        jfleet.divert_decision(primary, overflow, **kw)
    for c in (primary, overflow):
        assert tfleet.class_eta_ms(c) == jfleet.class_eta_ms(c)
        assert tfleet.class_utilization(c) == jfleet.class_utilization(c)


# -- tests/test_mixed_fleet.py:213-412, in-process class routing -----------------------


def _mixed_sup(fl, tmp_path, classes=("tpu", "tpu", "cpu-int8"), **kw):
    return fl.FleetSupervisor(str(tmp_path / "model"), backend_classes=list(classes), **kw)


def _go_live(sup, port=1):
    with sup._lock:
        for r in sup.replicas:
            sup._set_status(r, "live")
            r.port = port
            # the stats TTL parked far ahead: the test controls the view
            r.stats_at = time.monotonic() + 3600.0


def _backend_class_config(fl, fa, tmp_path):
    sup = _mixed_sup(fl, tmp_path)
    try:
        assert sup.n == 3
        classes = [r.backend_class for r in sup.replicas]
        _go_live(sup)
        h = sup.health()
        assert h["backend_classes"] == {"tpu": {"replicas": 2, "live": 2},
                                        "cpu-int8": {"replicas": 1, "live": 1}}
        row0 = h["replica_status"][0]["backend_class"]
    finally:
        sup.stop()
    legacy = fl.FleetSupervisor(str(tmp_path / "model"), replicas=2)
    try:
        lh = legacy.health()
        assert "backend_classes" not in lh and "backend_class" not in lh["replica_status"][0]
    finally:
        legacy.stop()
    with pytest.raises(ValueError):
        fl.FleetSupervisor(str(tmp_path / "model"), backend_classes=["tpu", "cpu-int8"],
                           roles=["unified"])
    return classes, h["backend_classes"], row0, sorted(lh)


def test_supervisor_backend_class_config_and_health(tmp_path):
    _on_both(_backend_class_config, tmp_path)


def _scrape_failure(fl, fa, tmp_path):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_port = s.getsockname()[1]
    s.close()
    sup = _mixed_sup(fl, tmp_path)
    router = fl.FleetRouter(sup, port=0)
    try:
        _go_live(sup, port=dead_port)
        rep = sup.replicas[0]
        for _ in range(10):  # well past the breaker threshold of 3
            with sup._lock:
                rep.stats_at = 0.0
            router._refresh_stats(rep)
        assert not rep.route_breaker.open
        picked = router._pick(set())
        assert picked is rep
        router._release(picked)
        with sup._lock:
            for r in sup.replicas:
                r.stats_at = 0.0
        summary = router._class_summary()
        assert not any(r.route_breaker.open for r in sup.replicas)
    finally:
        router.close()
        sup.stop()
    return picked.idx, summary


def test_router_scrape_failure_never_charges_breaker(tmp_path):
    _on_both(_scrape_failure, tmp_path)


def _class_tiers(fl, fa, tmp_path):
    sup = _mixed_sup(fl, tmp_path)
    router = fl.FleetRouter(sup, port=0)
    picks = []
    try:
        _go_live(sup)
        for exclude, classes in ((set(), (("tpu",), ("cpu-int8",))),
                                 (set(), (("cpu-int8",), ("tpu",))),
                                 ({0, 1}, (("tpu",), ("cpu-int8",)))):
            rep = router._pick(exclude, classes=classes)
            picks.append((rep.idx, rep.backend_class))
            router._release(rep)
        with sup._lock:
            sup._set_status(sup.replicas[2], "dead")
        assert router._pick({0, 1}, classes=(("tpu",), ("cpu-int8",))) is None
    finally:
        router.close()
        sup.stop()
    assert picks == [(0, "tpu"), (2, "cpu-int8"), (2, "cpu-int8")]
    return picks


def test_pick_class_tiers_and_fallback(tmp_path):
    _on_both(_class_tiers, tmp_path)


def _class_plan(fl, fa, tmp_path):
    class H:
        headers = {}

    obs = []
    sup = _mixed_sup(fl, tmp_path)
    router = fl.FleetRouter(sup, port=0)
    try:
        _go_live(sup)
        obs.append(router._class_plan(H(), None))
        assert obs[-1][1] is None and obs[-1][0][0] == ("tpu",)
        assert not router._eval_degraded()
        with sup._lock:
            sup._set_status(sup.replicas[0], "dead")
            sup._set_status(sup.replicas[1], "dead")
        obs.append(router._class_plan(H(), None))
        assert obs[-1] == ((("cpu-int8", "tpu"),), "tier_loss") and router._degraded
        obs.append(sup.counters.snapshot())
        assert obs[-1]["fleet_tier_losses"] == 1 and obs[-1]["fleet_degraded"] == 1
        # a breaker-open primary is as lost as a dead one
        with sup._lock:
            sup._set_status(sup.replicas[0], "live")
        for _ in range(5):
            sup.replicas[0].route_breaker.record_failure()
        obs.append(router._class_plan(H(), None))
        assert obs[-1][1] == "tier_loss"
        # recovery: the plan flips back, the gauge clears
        sup.replicas[0].route_breaker.record_success()
        obs.append(router._class_plan(H(), None))
        assert obs[-1][1] is None and not router._eval_degraded()
        obs.append(sup.counters.snapshot())
        assert obs[-1]["fleet_tier_losses"] == 1 and obs[-1]["fleet_degraded"] == 0
        # chaos: a FaultError at the decision forces the overflow class
        fa.install(fa.FaultPlan(seed=5).add("fleet.divert", raises=fa.FaultError, nth=1))
        obs.append(router._class_plan(H(), None))
        assert obs[-1][1] == "chaos" and obs[-1][0][0] == ("cpu-int8",)
        obs.append(sup.counters.snapshot())
        assert obs[-1]["fleet_diverts.chaos"] == 1
    finally:
        fa.clear()
        router.close()
        sup.stop()
    return obs


def test_class_plan_degraded_transitions_and_chaos_divert(tmp_path):
    _on_both(_class_plan, tmp_path)


def _retry_after(fl, fa, tmp_path):
    hints = []
    sup = _mixed_sup(fl, tmp_path, classes=("tpu", "cpu-int8"))
    router = fl.FleetRouter(sup, port=0)
    try:
        _go_live(sup)
        with sup._lock:
            sup.replicas[0].queue_depth, sup.replicas[0].dispatch_ms_ewma = 40, 1000.0
            sup.replicas[0].max_queue = 64
            sup.replicas[1].queue_depth, sup.replicas[1].dispatch_ms_ewma = 4, 500.0
            sup.replicas[1].max_queue = 16
        hints.append(router._retry_after_hint())
        with sup._lock:
            sup._set_status(sup.replicas[1], "dead")
        hints.append(router._retry_after_hint())
        with sup._lock:
            sup._set_status(sup.replicas[1], "live")
            sup.replicas[1].dispatch_ms_ewma = None
        hints.append(router._retry_after_hint())
    finally:
        router.close()
        sup.stop()
    legacy = fl.FleetSupervisor(str(tmp_path / "model"), replicas=2)
    r2 = fl.FleetRouter(legacy, port=0)
    try:
        with legacy._lock:
            for r in legacy.replicas:
                legacy._set_status(r, "live")
        hints.append(r2._retry_after_hint())
    finally:
        r2.close()
        legacy.stop()
    assert hints == [3, 30, 1, 1]
    return hints


def test_retry_after_hint_uses_best_class(tmp_path):
    _on_both(_retry_after, tmp_path)


def test_bucket_table_per_class_overlay():
    from paddle_tpu.inference.server import load_bucket_table as jload

    from paddle_tpu_torch.inference.server import load_bucket_table as tload

    base = tload()
    assert base["default"] == [1, 2, 4, 8, 16, 32, 64]
    assert tload(backend_class="cpu-int8")["default"] == [1, 2, 4, 8]
    assert tload(backend_class="no-such-class")["default"] == base["default"]
    for cls in (None, "cpu-int8", "no-such-class", "gpu", "gpu-overflow"):
        assert tload(backend_class=cls) == jload(backend_class=cls), cls


# -- the worker spawn: command and environment -----------------------------------------


class _Captured(Exception):
    pass


def _spawn_command(fl, monkeypatch, **kw):
    """The command and environment the supervisor hands Popen for slot 0
    (no process starts: the stand-in raises)."""
    seen = {}

    def fake_popen(cmd, **popen_kw):
        seen["cmd"], seen["env"], seen["cwd"] = list(cmd), dict(popen_kw["env"]), popen_kw["cwd"]
        raise _Captured

    sup = fl.FleetSupervisor("MODEL", **kw)
    try:
        with monkeypatch.context() as m, pytest.raises(_Captured):
            m.setattr(fl.subprocess, "Popen", fake_popen)
            sup._spawn(sup.replicas[0])
        assert sup.replicas[0].history == ["starting", "dead"]
        return [c.replace(sup._dir, "<dir>") for c in seen["cmd"]], seen["env"], seen["cwd"]
    finally:
        sup.stop()


@pytest.mark.parametrize("kw", [
    {},
    {"replicas": 3, "server_args": ["--max-queue", "8", "--batch-window-ms", "10"]},
    {"roles": ["prefill", "decode"], "registry": "reg.json"},
    {"backend_classes": ["gpu", "gpu", "gpu-overflow"], "server_args": ["--no-warmup"]},
], ids=["legacy", "server-args", "roles-registry", "classes"])
def test_spawn_command_names_the_port_server(monkeypatch, kw):
    from paddle_tpu.inference import fleet as jfleet

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("PADDLE_TPU_FAULTS", "seed=3;server.predict:raises=RuntimeError:nth=9")
    tcmd, tenv, tcwd = _spawn_command(tfleet, monkeypatch, worker_device="cpu", **kw)
    jcmd, _, jcwd = _spawn_command(jfleet, monkeypatch, worker_device="cpu", **kw)
    # the JAX command with the port's server module in place of its own
    assert tcmd[:3] == [sys.executable, "-m", "paddle_tpu_torch.inference.server"]
    assert jcmd[2] == "paddle_tpu.inference.server"
    assert tcmd[3:] == jcmd[3:] and tcwd == jcwd
    assert not any(c.startswith("paddle_tpu.") for c in tcmd)
    # the env: the repo on the path, the caller's fault spec, no JAX variable
    assert [k for k in tenv if k.startswith("JAX_")] == []
    assert tenv["PYTHONPATH"].split(":")[0] == tcwd
    assert tenv["PADDLE_TPU_FAULTS"] == "seed=3;server.predict:raises=RuntimeError:nth=9"


def test_workers_run_on_the_card_by_default(monkeypatch):
    cmd, _, _ = _spawn_command(tfleet, monkeypatch)
    assert cmd[cmd.index("--device") + 1] == "cuda"
    with pytest.raises(ValueError, match="worker_device"):
        tfleet.FleetSupervisor("MODEL", worker_device="tpu")


def test_card_fleet_builds_the_kernels_once_before_any_spawn(monkeypatch):
    """worker_device="cuda": the supervisor checks for the card and builds
    every kernel in its own process before the first spawn; a build
    failure raises and spawns nothing (no CPU fallback)."""
    from paddle_tpu_torch.ops.kernels import _build

    order = []
    monkeypatch.setattr(tfleet.FleetSupervisor, "_prebuild_kernels",
                        staticmethod(lambda: order.append("build")))

    def fake_popen(cmd, **kw):
        order.append("spawn")
        raise _Captured

    monkeypatch.setattr(tfleet.subprocess, "Popen", fake_popen)
    sup = tfleet.FleetSupervisor("MODEL", replicas=2)
    with pytest.raises(RuntimeError, match="fleet start failed"):
        sup.start()
    assert order == ["build", "spawn", "spawn"]

    def no_nvcc():
        raise FileNotFoundError("nvcc not found")

    monkeypatch.undo()
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(_build, "build_all", no_nvcc)
    spawned = []
    monkeypatch.setattr(tfleet.subprocess, "Popen", lambda *a, **k: spawned.append(a))
    sup = tfleet.FleetSupervisor("MODEL", replicas=2)
    with pytest.raises(FileNotFoundError, match="nvcc"):
        sup.start()
    assert spawned == [] and all(r.history == [] for r in sup.replicas)
    # the cpu fleet builds nothing
    monkeypatch.setattr(tfleet.subprocess, "Popen", fake_popen)
    order.clear()
    sup = tfleet.FleetSupervisor("MODEL", replicas=1, worker_device="cpu")
    with pytest.raises(RuntimeError, match="fleet start failed"):
        sup.start()
    assert order == ["spawn"]


def test_main_is_the_jax_cli(monkeypatch):
    """The CLI takes the JAX flags; its parsed values reach ServingFleet as
    the JAX main hands them (the device aside)."""
    from paddle_tpu.inference import fleet as jfleet

    argv = ["--model-dir", "M", "--replicas", "3", "--max-queue", "8",
            "--batch-window-ms", "10", "--backend-classes", "a,a,b",
            "--router-max-inflight", "32", "--drain-timeout", "12", "--device", "cpu"]
    seen = {}

    class Stop(Exception):
        pass

    for name, mod in (("jax", jfleet), ("port", tfleet)):
        def fake(model_dir, name=name, **kw):
            seen[name] = (model_dir, kw)
            raise Stop

        monkeypatch.setattr(mod, "ServingFleet", fake)
        monkeypatch.setattr(mod.signal, "signal", lambda *a: None)
        with pytest.raises(Stop):
            mod.main(argv)
    assert seen["port"] == seen["jax"]
    assert seen["port"][1]["worker_device"] == "cpu"
    # without --device the port's workers run on the card
    with pytest.raises(Stop):
        tfleet.main(["--model-dir", "M"])
    assert seen["port"][1]["worker_device"] == "cuda"
    with pytest.raises(SystemExit):
        tfleet.main(["--model-dir", "M", "--device", "tpu"])
