"""The port's serving fleet with real worker processes on the CPU: each
drill of tests/test_fleet_serving.py, tests/test_mixed_fleet.py and the
fleet drills of tests/test_disagg_serving.py and
tests/test_multimodel_serving.py, against `paddle_tpu_torch.inference.
fleet` with `worker_device="cpu"` workers of a tiny model.

The model is saved by the JAX package (fc 16 relu, fc 3 softmax, its
persistables perturbed from a seed, as tests/test_torch_registry.py
builds its bundles) and served by the port's workers from that export, so
both packages read the same persistables. Every reply through the fleet
is bit-equal to the port's in-process predictor on the export and within
rtol 1e-5 / atol 1e-7 of the JAX predictor's (fp32 sums of a few dozen
products, the serving parity gate); a /generate reply is bit-equal to the
port's in-process DecodeService and its tokens equal the JAX model's
greedy tokens, logits within rtol 1e-5 / atol 1e-6 (the JAX decode gate).

Four drills run in tier-1: healthz, routing and draining exclusion (with
an injected reply loss that fails over, and the router's deadlines); a
SIGKILL mid-request that fails over bit for bit and respawns; a rolling
restart of three replicas under load with zero hard errors; and a
role-split /generate bit-equal to a unified replica. The other drills are
marked slow, as in the JAX files. Synchronisation is by fault `hold`
file barriers, counters and replica history; every wait has its own
bound (`_wait_until`, `ready_timeout_s`, each join and urlopen)."""

import io
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu_torch import profiler
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.inference.decode_model import (
    DecodeService, ToyDecodeModel, make_toy_decode_weights, save_decode_weights)
from paddle_tpu_torch.inference.fleet import ServingFleet
from paddle_tpu_torch.resilience import faults
from test_torch_registry import _jax_greedy  # the JAX toy model's greedy stream

BATCH, IN_DIM, OUT_DIM = 4, 6, 3
REPLY_TOL = dict(rtol=1e-5, atol=1e-7)
DECODE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread_no_plan():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.clear()
    yield
    faults.clear()
    torch.set_num_threads(threads)


def _jax_bundle(d, seed):
    """The JAX package's tiny model, its float persistables moved by a
    seeded uniform(-0.5, 0.5) (its initializers ignore numpy's seed), saved
    with the JAX save_inference_model."""
    import paddle_tpu as fluid
    import paddle_tpu.framework as framework
    import paddle_tpu.scope as scope_mod

    old_main = framework.switch_main_program(framework.Program())
    old_startup = framework.switch_startup_program(framework.Program())
    try:
        sc = scope_mod.Scope()
        with scope_mod.scope_guard(sc):
            img = fluid.layers.data("img", [IN_DIM])
            fc = fluid.layers.fc(img, 16, act="relu")
            pred = fluid.layers.fc(fc, OUT_DIM, act="softmax")
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(fluid.default_startup_program())
            rng = np.random.RandomState(seed)
            blk = fluid.default_main_program().global_block()
            for vname, v in list(blk.vars.items()):
                if getattr(v, "persistable", False) and sc.has(vname):
                    arr = np.asarray(sc.get(vname))
                    if arr.dtype.kind == "f":
                        sc.set(vname, (arr + rng.uniform(-0.5, 0.5, arr.shape)).astype(arr.dtype))
            fluid.io.save_inference_model(d, ["img"], [pred], exe)
    finally:
        framework.switch_main_program(old_main)
        framework.switch_startup_program(old_startup)
    return d


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """`a` the served model, `b` a registry's alt v1, `c` its hot-swap
    candidate; and the toy decode weights."""
    root = tmp_path_factory.mktemp("fleet")
    dirs = tuple(_jax_bundle(str(root / n), seed) for n, seed in (("a", 0), ("b", 1), ("c", 2)))
    wpath = str(root / "decode_weights.npz")
    save_decode_weights(wpath, make_toy_decode_weights(seed=7))
    return dirs, wpath


def _x(seed=3, batch=BATCH):
    return np.random.RandomState(seed).rand(batch, IN_DIM).astype("float32")


def _refs(model_dir, xv):
    """(the port's in-process reply, the JAX predictor's) for one feed."""
    from paddle_tpu.inference import AnalysisConfig as JConfig
    from paddle_tpu.inference import create_paddle_predictor as jcreate

    config = AnalysisConfig(model_dir)
    config.disable_gpu()
    port = np.asarray(create_paddle_predictor(config).run({"img": xv})[0])
    jax = np.asarray(jcreate(JConfig(model_dir=model_dir)).run({"img": xv})[0])
    return port, jax


def _check(body, refs):
    """A fleet reply: bit-equal to the port's predictor, near the JAX one."""
    z = np.load(io.BytesIO(body))
    out = z[z.files[0]]
    assert out.tobytes() == refs[0].tobytes()
    np.testing.assert_allclose(out, refs[1], **REPLY_TOL)


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _post(base, path, body, timeout=120, headers=None):
    req = urllib.request.Request(base + path, data=body, method="POST",
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _healthz(base):
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_until(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.02)


def _fleet(model_dir, n, **kw):
    kw.setdefault("ready_timeout_s", 120)
    kw.setdefault("min_uptime_s", 0.5)
    kw.setdefault("drain_timeout_s", 20)
    return ServingFleet(model_dir, replicas=n, worker_device="cpu", **kw)


def _counter(name):
    return profiler.counters().get(name, 0)


# -- tier-1 drills -------------------------------------------------------------------


def test_fleet_healthz_routing_and_draining_exclusion(bundles):
    """Two CPU workers: the fleet /healthz is ok with 2 live unified
    replicas, a routed reply is bit-equal to the port's predictor (and
    near the JAX one), a draining replica gets no request, an injected
    reply loss at fleet.route.recv fails over, the router answers a bad
    and an expired deadline itself, and each worker's /healthz carries
    its kernel launch counts (all 0 on the CPU)."""
    (da, _, _), _ = bundles
    xv = _x()
    refs = _refs(da, xv)
    body = _npz(img=xv)
    with _fleet(da, 2) as fleet:
        code, h = _healthz(fleet.base_url)
        assert code == 200 and h["status"] == "ok"
        assert h["replicas"] == 2 and h["live"] == 2
        assert {r["status"] for r in h["replica_status"]} == {"live"}
        assert all(r["pid"] and r["port"] for r in h["replica_status"])
        assert {r["role"] for r in h["replica_status"]} == {"unified"}
        assert "roles" not in h and "role_counters" not in h
        for r in h["replica_status"]:
            _, wh = _healthz(f"http://127.0.0.1:{r['port']}")
            assert wh["device"] == "cpu" and wh["pid"] == r["pid"]
            assert set(wh["kernel_launches"]) >= {"mha_short_fwd", "layer_norm_bwd"}
            assert set(wh["kernel_launches"].values()) == {0}
            assert "kernel_launches" not in wh["counters"]

        code, data = _post(fleet.base_url, "/predict", body)
        assert code == 200
        _check(data, refs)

        sup = fleet.supervisor
        rep0, rep1 = sup.replicas
        with sup._lock:
            sup._set_status(rep0, "draining")
        routed0 = rep0.routed
        for _ in range(4):
            code, data = _post(fleet.base_url, "/predict", body)
            assert code == 200
            _check(data, refs)
        assert rep0.routed == routed0 and rep1.routed >= 4
        assert any(fleet.router._pool.values())  # keep-alive connections pooled
        code, h = _healthz(fleet.base_url)
        assert code == 200 and h["status"] == "degraded"
        assert h["draining"] == 1 and h["live"] == 1
        with sup._lock:
            sup._set_status(rep0, "live")
        assert _healthz(fleet.base_url)[1]["status"] == "ok"

        faults.install(faults.FaultPlan(seed=5).add(
            "fleet.route.recv", raises=faults.FaultError, nth=1))
        f0 = _counter("fleet_failovers")
        code, data = _post(fleet.base_url, "/predict", body)
        assert code == 200
        _check(data, refs)
        assert _counter("fleet_failovers") == f0 + 1
        faults.clear()

        assert _post(fleet.base_url, "/predict", body,
                     headers={"X-Deadline-Ms": "soon"})[0] == 400
        assert _post(fleet.base_url, "/predict", body,
                     headers={"X-Deadline-Ms": "0.001"})[0] == 504
        code, data = _post(fleet.base_url, "/predict", body,
                           headers={"X-Deadline-Ms": "60000"})
        assert code == 200
        _check(data, refs)


def test_sigkill_mid_request_fails_over_bitwise(bundles, tmp_path):
    """A worker SIGKILLed while the request is parked inside it (a hold
    barrier in the workers' fault spec; the router's seeded
    fleet.kill_replica rule fires after the send): the same client request
    completes on the other replica, bit-equal, and the killed slot goes
    dead -> starting -> live."""
    (da, _, _), _ = bundles
    xv = _x()
    refs = _refs(da, xv)
    gate = str(tmp_path / "kill-gate")
    fleet = _fleet(da, 2, extra_env={"PADDLE_TPU_FAULTS": f"server.predict:hold={gate}:nth=1"})
    with fleet:
        faults.install(faults.FaultPlan(seed=23).add(
            "fleet.kill_replica", raises=faults.FaultError, nth=1))
        c0 = _counter("fleet_chaos_kills")
        f0 = _counter("fleet_failovers")
        res = {}
        t = threading.Thread(target=lambda: res.update(r=_post(fleet.base_url, "/predict",
                                                               _npz(img=xv))), daemon=True)
        t.start()
        _wait_until(lambda: _counter("fleet_chaos_kills") == c0 + 1, "the chaos kill")
        open(gate, "w").close()  # release the failover replica
        t.join(timeout=120)
        assert not t.is_alive()
        code, data = res["r"]
        assert code == 200
        _check(data, refs)
        assert _counter("fleet_failovers") >= f0 + 1
        # the monitor polls every 50 ms: the reply can come back first
        _wait_until(lambda: any("dead" in r.history for r in fleet.supervisor.replicas),
                    "the monitor to see the death")
        killed = [r for r in fleet.supervisor.replicas if "dead" in r.history]
        assert len(killed) == 1
        _wait_until(lambda: killed[0].restarts >= 1 and killed[0].status == "live",
                    "the killed replica's respawn", timeout=120)
        assert killed[0].history[-3:] == ["dead", "starting", "live"]
        code, h = _healthz(fleet.base_url)
        assert code == 200 and h["live"] == 2


def test_rolling_restart_under_load_zero_errors(bundles):
    """Three workers rolled one at a time while four clients load the
    router: every reply a 200 bit-equal to the port's predictor (at worst
    a clean 503 shed, under 2% of the replies), every replica a fresh pid,
    each slot's lifecycle live -> draining -> dead -> starting -> live."""
    (da, _, _), _ = bundles
    xv = _x()
    refs = _refs(da, xv)
    body = _npz(img=xv)
    with _fleet(da, 3) as fleet:
        pids_before = [r.pid for r in fleet.supervisor.replicas]
        stop, results, lock = threading.Event(), [], threading.Lock()

        def loader():
            while not stop.is_set():
                try:
                    r = _post(fleet.base_url, "/predict", body, timeout=60)
                except OSError as e:  # a hard error, counted below
                    r = (type(e).__name__, b"")
                with lock:
                    results.append(r)

        threads = [threading.Thread(target=loader, daemon=True) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            _wait_until(lambda: len(results) > 8, "the load to ramp")
            assert fleet.rolling_restart() == [0, 1, 2]
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        codes = [c for c, _ in results]
        assert [c for c in codes if c not in (200, 503)] == []
        assert codes.count(200) > 50
        assert codes.count(503) * 50 < len(codes)
        for c, data in results:
            if c == 503:
                assert "error" in json.loads(data)
            else:
                _check(data, refs)
        pids_after = [r.pid for r in fleet.supervisor.replicas]
        assert all(a != b for a, b in zip(pids_after, pids_before))
        code, h = _healthz(fleet.base_url)
        assert code == 200 and h["status"] == "ok" and h["live"] == 3
        for r in fleet.supervisor.replicas:
            assert r.history[-4:] == ["draining", "dead", "starting", "live"]


PROMPTS = [([1, 2, 3, 4], 6), ([5, 6], 4), ([7, 8, 9, 1, 2, 3], 5)]


def _gen_fleet(model_dir, wpath, roles=None, replicas=1, **kw):
    server_args = ["--decode-weights", wpath, "--kv-profile", "smoke",
                   "--max-queue", "16", "--drain-timeout", "10"]
    return _fleet(model_dir, replicas, roles=roles, server_args=server_args, **kw)


def test_disagg_fleet_smoke_and_role_healthz(bundles):
    """One prefill and one decode worker serve /generate bit-equal to a
    unified single-worker fleet and to the port's in-process DecodeService,
    tokens equal to the JAX model's; /healthz carries the roles, per-role
    counters aggregate, the handoff counters move, /predict routes to the
    prefill tier."""
    (da, _, _), wpath = bundles
    weights = make_toy_decode_weights(seed=7)
    svc = DecodeService(ToyDecodeModel(weights, device="cpu"))
    try:
        local = [svc.generate(np.asarray(t, np.int32), mn) for t, mn in PROMPTS]
    finally:
        svc.close()
    for (toks, mn), (lt, ll) in zip(PROMPTS, local):
        jt, jl = _jax_greedy(weights, toks, mn)
        assert lt.tolist() == jt.tolist()
        np.testing.assert_allclose(ll, jl, **DECODE_TOL)
    uni = []
    with _gen_fleet(da, wpath) as fleet:
        hz = _healthz(fleet.base_url)[1]
        assert "roles" not in hz and all(r["role"] == "unified" for r in hz["replica_status"])
        for (toks, mn), (lt, ll) in zip(PROMPTS, local):
            st, data = _post(fleet.base_url, "/generate",
                             _npz(tokens=np.asarray(toks, np.int32), max_new=np.int32(mn)))
            assert st == 200, data[:200]
            z = np.load(io.BytesIO(data))
            assert z["tokens"].tolist() == lt.tolist() and z["logits"].tobytes() == ll.tobytes()
            uni.append((z["tokens"].copy(), z["logits"].copy()))

    with _gen_fleet(da, wpath, roles=["prefill", "decode"]) as fleet:
        hz = _healthz(fleet.base_url)[1]
        assert hz["roles"] == {"prefill": {"replicas": 1, "live": 1},
                               "decode": {"replicas": 1, "live": 1}}
        decode_rep = [r for r in hz["replica_status"] if r["role"] == "decode"][0]
        assert decode_rep.get("kv_free_pages") is None  # no scrape yet
        for i, (toks, mn) in enumerate(PROMPTS):
            st, data = _post(fleet.base_url, "/generate",
                             _npz(tokens=np.asarray(toks, np.int32), max_new=np.int32(mn)))
            assert st == 200, data[:200]
            z = np.load(io.BytesIO(data))
            np.testing.assert_array_equal(z["tokens"], uni[i][0])
            assert z["logits"].tobytes() == uni[i][1].tobytes()
        # role_counters is a scrape cached for 1 s: wait out the first one
        _wait_until(lambda: _healthz(fleet.base_url)[1]["role_counters"]["prefill"].get(
            "serve_prefill_requests", 0) >= 3, "the role counters' next scrape", timeout=10)
        rc = _healthz(fleet.base_url)[1]["role_counters"]
        assert rc["prefill"]["serve_prefill_requests"] >= 3
        assert rc["decode"]["serve_decode_requests"] >= 3
        wc = fleet.supervisor.worker_counters()
        assert wc["kv_slot_acquires"] >= 3
        assert "kv_pages_in_use" in wc and "kv_page_allocs" in wc
        cs = fleet.supervisor.counters.snapshot()
        assert cs["fleet_handoffs"] >= 3 and "fleet_handoff_ms" in cs
        assert cs["fleet_prefill_ms_ewma"] >= 0 and cs["fleet_decode_ms_ewma"] >= 0
        xv = _x()
        st, data = _post(fleet.base_url, "/predict", _npz(img=xv))
        assert st == 200
        _check(data, _refs(da, xv))
        dec = [r for r in fleet.supervisor.replicas if r.role == "decode"][0]
        pre = [r for r in fleet.supervisor.replicas if r.role == "prefill"][0]
        assert dec.routed >= 3 and pre.routed >= 4


# -- the slow drills ------------------------------------------------------------------


@pytest.mark.slow
def test_crash_respawn_backoff_and_spawn_fault(bundles):
    """SIGKILL the only worker; the first respawn fails at fleet.spawn, the
    backoff retry heals the fleet; meanwhile the router sheds cleanly."""
    (da, _, _), _ = bundles
    xv = _x()
    with _fleet(da, 1) as fleet:
        rep = fleet.supervisor.replicas[0]
        faults.install(faults.FaultPlan(seed=7).add("fleet.spawn", raises=RuntimeError, nth=1))
        c0 = _counter("fleet_respawn_failures")
        os.kill(rep.pid, signal.SIGKILL)
        _wait_until(lambda: "dead" in rep.history, "crash detection")
        code, data = _post(fleet.base_url, "/predict", _npz(img=xv), timeout=30)
        if code == 503:
            assert json.loads(data)["error"] == "FleetUnavailable"
        _wait_until(lambda: rep.restarts >= 1 and rep.status == "live",
                    "respawn after the failed attempt", timeout=120)
        assert _counter("fleet_respawn_failures") == c0 + 1
        assert _counter("fleet_replica_deaths") >= 1
        assert rep.history.count("starting") >= 3
        code, data = _post(fleet.base_url, "/predict", _npz(img=xv))
        assert code == 200
        _check(data, _refs(da, xv))


@pytest.mark.slow
def test_fleet_chaos_smoke_kill_under_load(bundles):
    """The JAX chaos smoke's fleet half: a seed-pinned spec SIGKILLs a
    worker at the fourth routed request while three clients load the
    router: zero non-503 errors, every 200 bit-equal, the fleet heals.
    (The JAX smoke also partitions a parameter-server table, which the
    port does not have yet: ROADMAP Queue 1 item 10.)"""
    (da, _, _), _ = bundles
    xv = _x()
    refs = _refs(da, xv)
    body = _npz(img=xv)
    with _fleet(da, 3) as fleet:
        plan = faults.install(faults.FaultPlan.from_spec(
            "seed=23;fleet.kill_replica:raises=FaultError:nth=4"))
        results, lock = [], threading.Lock()

        def loader():
            for _ in range(10):
                r = _post(fleet.base_url, "/predict", body)
                with lock:
                    results.append(r)

        threads = [threading.Thread(target=loader, daemon=True) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert plan.fired.get("fleet.kill_replica", 0) == 1
        codes = [c for c, _ in results]
        assert [c for c in codes if c not in (200, 503)] == []
        assert codes.count(200) >= 25
        for c, data in results:
            if c == 200:
                _check(data, refs)
        _wait_until(lambda: _healthz(fleet.base_url)[1]["live"] == 3,
                    "the fleet to heal", timeout=120)


@pytest.mark.slow
def test_replica_sigkill_mid_coalesced_batch_fails_over_bitwise(bundles, tmp_path):
    """Workers coalesce (500 ms window); a hold parks each worker's first
    merged dispatch; a seeded router rule SIGKILLs worker 0 mid-batch and
    every member fails over on its own, each reply equal to its own
    batch-of-1 reference."""
    (da, _, _), _ = bundles
    gate = str(tmp_path / "batch-kill-gate")
    xs = [_x(seed=70 + i) for i in range(5)]
    refs = [_refs(da, x) for x in xs]
    fleet = _fleet(da, 2, server_args=["--batch-window-ms", "500", "--max-queue", "32"],
                   extra_env={"PADDLE_TPU_FAULTS": f"server.batch.dispatch:hold={gate}:nth=1"})
    with fleet:
        res = {}

        def call(i):
            res[i] = _post(fleet.base_url, "/predict", _npz(img=xs[i]))

        threads = [threading.Thread(target=call, args=(i,), daemon=True) for i in range(4)]
        for t in threads:
            t.start()

        def worker_depths():
            out = []
            for rep in fleet.supervisor.replicas:
                try:
                    out.append(_healthz(f"http://127.0.0.1:{rep.port}")[1].get("queue_depth", 0))
                except OSError:
                    out.append(-1)
            return out

        _wait_until(lambda: worker_depths() == [2, 2], "members to spread 2/2")
        faults.install(faults.FaultPlan.from_spec(
            "seed=31;fleet.kill_replica:raises=FaultError:nth=1"))
        c0 = _counter("fleet_chaos_kills")
        trigger = threading.Thread(target=call, args=(4,), daemon=True)
        trigger.start()
        _wait_until(lambda: _counter("fleet_chaos_kills") == c0 + 1, "the chaos kill")
        faults.clear()
        open(gate, "w").close()
        for t in threads + [trigger]:
            t.join(timeout=180)
        for i in range(5):
            code, data = res[i]
            assert code == 200, (i, code, data[:200])
            _check(data, refs[i])
        assert _counter("fleet_failovers") >= 1
        _wait_until(lambda: _healthz(fleet.base_url)[1].get("live") == 2,
                    "the fleet to heal", timeout=120)
        wc = fleet.supervisor.worker_counters()
        assert wc.get("serve_batches", 0) >= 1 and wc.get("serve_batch_members", 0) >= 2


def _mixed_fleet(model_dir, classes, router_kwargs=None, **kw):
    return _fleet(model_dir, len(classes), backend_classes=list(classes),
                  router_kwargs=router_kwargs or {}, **kw)


@pytest.mark.slow
def test_tier_loss_sigkill_whole_primary_class_degrades_and_recovers(bundles):
    """fleet.tier_loss SIGKILLs both primary-class workers under load: zero
    non-503 errors, degraded replies from the overflow class bit-equal,
    degraded flips on and back off after the respawns."""
    (da, _, _), _ = bundles
    xv = _x(seed=7)
    refs = _refs(da, xv)
    body = _npz(img=xv)
    with _mixed_fleet(da, ["gpu", "gpu", "gpu-overflow"]) as fleet:
        base, sup = fleet.base_url, fleet.supervisor
        code, data = _post(base, "/predict", body)
        assert code == 200
        _check(data, refs)
        h = _healthz(base)[1]
        assert h["backend_classes"]["gpu"]["live"] == 2 and h["degraded"] is False
        assert (h["primary_class"], h["overflow_class"]) == ("gpu", "gpu-overflow")
        faults.install(faults.FaultPlan(seed=23).add(
            "fleet.tier_loss", raises=faults.FaultError, nth=1))
        stop, results = threading.Event(), []

        def loader():
            while not stop.is_set():
                try:
                    results.append(_post(base, "/predict", body, timeout=60))
                except Exception as e:  # noqa: BLE001 — a hard error
                    results.append((type(e).__name__, None))

        threads = [threading.Thread(target=loader) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            _wait_until(lambda: sup.counters.snapshot().get("fleet_chaos_kills", 0) >= 2,
                        "both primary-class workers SIGKILLed")
            _wait_until(lambda: _healthz(base)[1].get("degraded") is True, "degraded")
            _wait_until(lambda: _healthz(base)[1].get("degraded") is False,
                        "recovery from degraded", timeout=120)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert [r for r in results if not isinstance(r[0], int) or r[0] not in (200, 503)] == []
        ok = [d for c, d in results if c == 200]
        assert ok
        for d in ok:
            _check(d, refs)
        snap = sup.counters.snapshot()
        assert snap.get("fleet_tier_losses", 0) >= 1
        assert snap.get("fleet_diverts.tier_loss", 0) >= 1
        assert snap.get("fleet_degraded", 1) == 0
        # degraded clears with the first primary back; wait for the second
        _wait_until(lambda: _healthz(base)[1]["backend_classes"]["gpu"]["live"] == 2,
                    "both primary-class respawns", timeout=120)
        h = _healthz(base)[1]
        assert h["backend_classes"]["gpu"]["live"] == 2 and h["degraded"] is False


@pytest.mark.slow
def test_brownout_steers_bulk_keeps_gold(bundles, tmp_path):
    """Steer watermark 0: every bulk request steers to the overflow class,
    gold keeps the primary; routed counts and brownout counters show it."""
    (da, _, _), _ = bundles
    xv = _x(seed=7)
    refs = _refs(da, xv)
    body = _npz(img=xv)
    manifest = tmp_path / "model_registry.json"
    manifest.write_text(json.dumps({
        "default": "main", "default_version": "v1", "models": [],
        "qos": {"classes": {"gold": {"weight": 8, "deadline_ms": 0}, "bulk": {"weight": 1}},
                "tenants": {"t-gold": "gold"}, "default_class": "bulk"}}))
    with _mixed_fleet(da, ["gpu", "gpu-overflow"], registry=str(manifest),
                      router_kwargs={"brownout_steer": 0.0, "brownout_shed": 2.0}) as fleet:
        for tenant in ("t-gold",) * 5 + ("t-batch",) * 5:
            code, data = _post(fleet.base_url, "/predict", body, headers={"X-Tenant": tenant})
            assert code == 200
            _check(data, refs)
        h = _healthz(fleet.base_url)[1]
        routed = {r["backend_class"]: r["routed"] for r in h["replica_status"]}
        assert routed == {"gpu": 5, "gpu-overflow": 5}
        snap = fleet.supervisor.counters.snapshot()
        assert snap["fleet_brownout_steered"] == 5 and snap["fleet_diverts.brownout"] == 5
        assert snap["fleet_diverts"] == 5 and snap.get("fleet_brownout_sheds", 0) == 0
        assert h["degraded"] is False


@pytest.mark.slow
def test_prefill_sigkill_mid_handoff_fails_over_bitwise(bundles, tmp_path):
    """A prefill worker SIGKILLed while parked mid-prefill: the same
    /generate completes on the other prefill worker bit for bit; then the
    decode leg of the drill on a fleet with two decode workers."""
    (da, _, _), wpath = bundles
    toks, mn = [1, 2, 3, 4], 6
    gen = _npz(tokens=np.asarray(toks, np.int32), max_new=np.int32(mn))
    with _gen_fleet(da, wpath) as fleet:
        st, data = _post(fleet.base_url, "/generate", gen)
        assert st == 200
        ref = np.load(io.BytesIO(data))
        ref_tokens, ref_logits = ref["tokens"].copy(), ref["logits"].copy()
    for roles, site, kill in ((["prefill", "prefill", "decode"], "server.prefill",
                               "serve.handoff.send"),
                              (["prefill", "decode", "decode"], "server.decode",
                               "serve.handoff.recv")):
        gate = str(tmp_path / f"{site}-gate")
        with _gen_fleet(da, wpath, roles=roles,
                        extra_env={"PADDLE_TPU_FAULTS": f"{site}:hold={gate}:nth=2"}) as fleet:
            st, _ = _post(fleet.base_url, "/generate", gen)
            assert st == 200
            faults.install(faults.FaultPlan(seed=23).add(kill, raises=faults.FaultError, nth=1))
            c0, f0 = _counter("fleet_chaos_kills"), _counter("fleet_failovers")
            st, data = _post(fleet.base_url, "/generate", gen)
            faults.clear()
            assert st == 200, data[:300]
            z = np.load(io.BytesIO(data))
            np.testing.assert_array_equal(z["tokens"], ref_tokens)
            assert z["logits"].tobytes() == ref_logits.tobytes()
            assert _counter("fleet_chaos_kills") == c0 + 1
            assert _counter("fleet_failovers") == f0 + 1
            _wait_until(lambda: any("dead" in r.history for r in fleet.supervisor.replicas),
                        "the monitor to see the death")
            dead = [r for r in fleet.supervisor.replicas if "dead" in r.history]
            assert len(dead) == 1 and dead[0].role == site.split(".")[1]


def _registry_manifest(path, db):
    path.write_text(json.dumps({
        "default": "main", "default_version": "v1",
        "models": [{"name": "alt", "version": "v1", "bundle_dir": db}],
        "qos": {"classes": {"gold": {"weight": 8, "deadline_ms": 0}, "bulk": {"weight": 1}},
                "tenants": {"t-gold": "gold"}, "default_class": "bulk"}}))
    return str(path)


@pytest.mark.slow
def test_multimodel_fleet_hotswap_under_load(bundles, tmp_path):
    """A fleet-wide deploy of alt while four clients load both models:
    zero non-503 errors, every alt reply the old or the new version's
    bits, main untouched, the fleet on the new version after."""
    (da, db, dc), _ = bundles
    manifest = _registry_manifest(tmp_path / "model_registry.json", db)
    xv = _x()
    body = _npz(img=xv)
    alt = {"X-Model": "alt"}
    with _fleet(da, 2, registry=manifest,
                server_args=["--max-queue", "16", "--drain-timeout", "10"]) as fleet:
        base = fleet.base_url
        code, old_ref = _post(base, "/predict", body, headers=alt)
        assert code == 200
        _check(old_ref, _refs(db, xv))
        code, main_ref = _post(base, "/predict", body)
        assert code == 200
        _check(main_ref, _refs(da, xv))
        stop, replies, errors, lock = threading.Event(), [], [], threading.Lock()

        def hammer(i):
            while not stop.is_set():
                code, data = _post(base, "/predict", body, headers=alt if i % 2 else None,
                                   timeout=60)
                with lock:
                    if code == 200:
                        replies.append(("alt" if i % 2 else "main", data))
                    elif code != 503:
                        errors.append((code, data[:200]))

        threads = [threading.Thread(target=hammer, args=(i,), daemon=True) for i in range(4)]
        for t in threads:
            t.start()
        try:
            _wait_until(lambda: len(replies) > 8, "the load to ramp")
            code, data = _post(base, "/admin/deploy", json.dumps(
                {"name": "alt", "version": "v2", "bundle_dir": dc, "tolerance": None}).encode(),
                headers={"Content-Type": "application/json"})
            assert code == 200, data
            assert json.loads(data)["version"] == "v2"
            n = len(replies)
            _wait_until(lambda: len(replies) > n + 8, "post-cutover traffic")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert errors == []
        code, new_ref = _post(base, "/predict", body, headers=alt)
        assert code == 200 and new_ref != old_ref
        _check(new_ref, _refs(dc, xv))
        assert all(b in (old_ref, new_ref) for m, b in replies if m == "alt")
        assert all(b == main_ref for m, b in replies if m == "main")
        health = _healthz(base)[1]
        assert health["models"]["alt"]["versions"] == ["v2"]
        assert health["models"]["main"]["replicas"] == 2
        assert fleet.supervisor.worker_counters().get("model.alt.serve_requests", 0) > 0
        assert fleet.supervisor.counters.snapshot()["fleet_deploys"] == 1


@pytest.mark.slow
def test_multimodel_fleet_sigkill_mid_cutover_old_stays_authoritative(bundles, tmp_path):
    """A worker SIGKILLed while its deploy is parked at registry.cutover:
    the fleet deploy fails, the slot respawns from the manifest, and the
    old version serves everywhere, bit for bit."""
    (da, db, dc), _ = bundles
    manifest = _registry_manifest(tmp_path / "model_registry.json", db)
    barrier = str(tmp_path / "never-released")
    xv = _x()
    body = _npz(img=xv)
    with _fleet(da, 2, registry=manifest,
                server_args=["--max-queue", "16", "--drain-timeout", "10"],
                extra_env={"PADDLE_TPU_FAULTS": f"seed=7;registry.cutover:hold={barrier}:nth=1"}
                ) as fleet:
        base, sup = fleet.base_url, fleet.supervisor
        code, old_ref = _post(base, "/predict", body, headers={"X-Model": "alt"})
        assert code == 200
        result = {}

        def run_deploy():
            try:
                result["out"] = sup.deploy("alt", "v2", bundle_dir=dc, tolerance=None,
                                           deploy_timeout_s=120)
            except Exception as e:  # noqa: BLE001 — the expected path
                result["err"] = e

        t = threading.Thread(target=run_deploy, daemon=True)
        t.start()
        with sup._lock:
            port, pid = sup.replicas[0].port, sup.replicas[0].pid
        _wait_until(lambda: _healthz(f"http://127.0.0.1:{port}")[1]["counters"].get(
            "serve_deploys", 0) >= 1, "the worker's deploy to start")
        time.sleep(1.0)  # the warm finishes; the hold pins the cutover
        os.kill(pid, signal.SIGKILL)
        t.join(timeout=180)
        assert not t.is_alive() and "err" in result, result
        assert sup.counters.snapshot()["fleet_deploy_failures"] == 1
        _wait_until(lambda: sup.health()["live"] == sup.n, "the fleet to heal", timeout=120)
        for _ in range(4):
            code, data = _post(base, "/predict", body, headers={"X-Model": "alt"})
            assert code == 200 and data == old_ref
        assert sup.health()["models"]["alt"]["versions"] == ["v1"]
