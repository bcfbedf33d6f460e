"""The port's resilience pieces (paddle_tpu_torch/resilience/) on the CPU,
held against the JAX package's: `FaultPlan` parses the specs of
tests/test_faults.py into the same rules and fires the same patterns
(nth / every / times, seeded prob, corrupt, truncate, globs, the
PADDLE_TPU_FAULTS hook); `CircuitBreaker`, `backoff_delays`,
`retry_call` and `PreemptionHandler` behave as the JAX ones;
`snapshot.pack_stream` writes the same bytes; `profiler.CounterSet`
rolls its counters up. The `gpu` test (`python -m pytest -m gpu
--noconftest tests/test_torch_faults.py` on the card) trips and recovers
the breaker of a server on the card through the `server.dispatch` site,
inside the predictor lock."""

import io
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import profiler
from paddle_tpu_torch.resilience import (
    CircuitBreaker, PreemptionHandler, backoff_delays, faults, retry_call)
from paddle_tpu_torch.resilience.snapshot import FORMAT_VERSION, pack_stream

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear()
    yield
    faults.clear()


def _both():
    """The two packages' fault modules, each with no plan installed."""
    from paddle_tpu.resilience import faults as jfaults

    jfaults.clear()
    return {"port": faults, "jax": jfaults}


def _pattern(mod, site, n):
    out = []
    for _ in range(n):
        try:
            mod.fault_point(site)
            out.append(0)
        except mod.FaultError:
            out.append(1)
    return out


def test_disabled_sites_are_free():
    assert faults.current_plan() is None
    assert faults.fault_point("anything") is None
    payload = b"payload"
    assert faults.fault_bytes("anything", payload) is payload
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        faults.fault_point("hot.site")
    assert time.perf_counter() - t0 < n * 2.5e-6


def test_nth_every_times_patterns_match_jax():
    seen = {}
    for name, mod in _both().items():
        plan = mod.install(mod.FaultPlan(seed=1)
                           .add("a", raises=mod.FaultError, nth=3)
                           .add("b", raises=mod.FaultError, every=2, times=2))
        seen[name] = (_pattern(mod, "a", 5), _pattern(mod, "b", 8), plan.hits, plan.fired)
        mod.clear()
    assert seen["port"] == seen["jax"]
    assert seen["port"][:2] == ([0, 0, 1, 0, 0], [0, 1, 0, 1, 0, 0, 0, 0])


@pytest.mark.parametrize("seed", [7, 8])
def test_seeded_prob_pattern_matches_jax(seed):
    seen = {}
    for name, mod in _both().items():
        mod.install(mod.FaultPlan(seed=seed).add("s", raises=mod.FaultError, prob=0.5))
        seen[name] = _pattern(mod, "s", 64)
        mod.clear()
    assert seen["port"] == seen["jax"] and 0 < sum(seen["port"]) < 64


def test_corrupt_and_truncate_match_jax():
    seen = {}
    for name, mod in _both().items():
        with mod.active(mod.FaultPlan(seed=9).add("wire", corrupt=2, every=1)):
            c = mod.fault_bytes("wire", b"0123456789")
        with mod.active(mod.FaultPlan().add("wire", truncate=4)):
            t = mod.fault_bytes("wire", b"0123456789")
        seen[name] = (c, t)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] != b"0123456789" and seen["port"][1] == b"0123"


SPECS = [
    "seed=13;snapshot.flush.write:raise=OSError:err=ENOSPC:nth=2;"
    "table.server.handle:delay=0.01:times=1;server.predict:hold=/tmp/gate:prob=0.25",
    "server.predict:raises=RuntimeError:times=3",
    "server.predict:hold=/tmp/a:b/c:nth=1",
    "seed=7;server.predict:raises=RuntimeError:nth=2;table.client.frame:truncate=5:times=1",
    "server.batch.dispatch:raises=FaultError:every=2",
]


@pytest.mark.parametrize("spec", SPECS)
def test_env_spec_parses_like_jax(spec):
    mods = _both()
    port, jax_plan = (mods[k].FaultPlan.from_spec(spec) for k in ("port", "jax"))
    assert port.seed == jax_plan.seed
    assert repr(port.rules) == repr(jax_plan.rules)
    for p, j in zip(port.rules, jax_plan.rules):
        pr = p.raises.__name__ if p.raises else None
        jr = j.raises.__name__ if j.raises else None
        assert pr == jr and p.err == j.err and p.hold == j.hold


@pytest.mark.parametrize("spec", ["site-without-action", "x:raise=NoSuchException",
                                  "x:bogus=1", "=x:nth=1"])
def test_bad_specs_raise_like_jax(spec):
    for mod in _both().values():
        with pytest.raises(ValueError):
            mod.FaultPlan.from_spec(spec)


def test_glob_site_match_and_scoped_active():
    plan = faults.FaultPlan().add("server.*", raises=ConnectionError)
    with faults.active(plan):
        with pytest.raises(ConnectionError):
            faults.fault_point("server.predict")
        faults.fault_point("snapshot.flush.write")
    assert faults.current_plan() is None
    assert plan.hits == {"server.predict": 1, "snapshot.flush.write": 1}


def test_env_hook_installs_the_plan_at_import():
    code = ("from paddle_tpu_torch.resilience import faults\n"
            "p = faults.current_plan()\n"
            "print(p.seed, [r.site for r in p.rules])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               PADDLE_TPU_FAULTS="seed=5;server.predict:raises=RuntimeError:nth=2")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "5 ['server.predict']"


def test_hold_blocks_until_the_path_exists(tmp_path):
    gate = tmp_path / "go"
    import threading

    done = []
    with faults.active(faults.FaultPlan().add("site", hold=str(gate))):
        t = threading.Thread(target=lambda: (faults.fault_point("site"), done.append(1)),
                             daemon=True)
        t.start()
        time.sleep(0.05)
        assert not done
        gate.touch()
        t.join(timeout=30)
    assert done == [1]


# -- preempt.py --------------------------------------------------------------------


def test_circuit_breaker_transitions_match_jax():
    from paddle_tpu.resilience.preempt import CircuitBreaker as JBreaker

    script = ["f", "s", "f", "f", "open?", "probe", "f", "s", "open?", "probe"]
    seen = {}
    for name, cls in (("port", CircuitBreaker), ("jax", JBreaker)):
        b = cls(threshold=2, probe_interval=0)
        out = []
        for act in script:
            out.append({"f": b.record_failure, "s": b.record_success,
                        "open?": lambda: b.open, "probe": b.probe_due}[act]())
        seen[name] = out
    assert seen["port"] == seen["jax"] == [False, False, False, True, True, True, False,
                                           True, False, False]
    b = CircuitBreaker(threshold=1, probe_interval=60.0)
    assert b.record_failure() and not b.probe_due()


def test_backoff_and_retry_call_match_jax():
    from paddle_tpu.resilience.preempt import backoff_delays as jbackoff

    assert list(backoff_delays(5, 0.05, 0.3)) == list(jbackoff(5, 0.05, 0.3))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("down")
        return "up"

    c0 = profiler.counters().get("port_test_retries", 0)
    assert retry_call(flaky, tries=4, base_delay=0.001, counter="port_test_retries") == "up"
    assert len(calls) == 3 and profiler.counters()["port_test_retries"] == c0 + 2
    with pytest.raises(ConnectionError):
        retry_call(lambda: (_ for _ in ()).throw(ConnectionError("x")), tries=2,
                   base_delay=0.001)


def test_preemption_handler_signal_and_final_save():
    seen = []
    before = signal.getsignal(signal.SIGUSR1)
    c0 = profiler.counters().get("preemptions_observed", 0)
    with PreemptionHandler(signals=(signal.SIGUSR1,), on_preempt=seen.append) as pre:
        assert not pre.preempted
        os.kill(os.getpid(), signal.SIGUSR1)
        assert pre.wait(timeout=10)
        assert pre.signal_received == signal.SIGUSR1 and seen == [signal.SIGUSR1]
        # no CheckpointManager in the port yet: final_save raises, as the
        # JAX handler does without one
        with pytest.raises(RuntimeError, match="no CheckpointManager"):
            pre.final_save(1)
    assert signal.getsignal(signal.SIGUSR1) == before
    assert profiler.counters()["preemptions_observed"] == c0 + 1


# -- snapshot.py, profiler.CounterSet ---------------------------------------------


def test_pack_stream_bytes_match_jax():
    from paddle_tpu.resilience import snapshot as jsnap

    arrays = {"w": np.random.RandomState(0).randn(3, 4).astype(np.float32),
              "step": np.int64(7), "b": np.arange(5, dtype=np.int32)}
    outs = {}
    for name, fn in (("port", pack_stream), ("jax", jsnap.pack_stream)):
        buf = io.BytesIO()
        entries, total = fn(buf, arrays)
        outs[name] = (buf.getvalue(), entries, total)
    assert outs["port"] == outs["jax"] and FORMAT_VERSION == jsnap.FORMAT_VERSION
    buf = io.BytesIO()
    pack_stream(buf, {k: torch.as_tensor(v) for k, v in arrays.items()})
    assert buf.getvalue() == outs["jax"][0]


def test_counter_set_rolls_up_into_the_global_names():
    a, b = profiler.CounterSet(), profiler.CounterSet()
    g0 = profiler.counters().get("port_counterset_test", 0)
    a.bump("port_counterset_test")
    b.bump("port_counterset_test", 2)
    a.gauge("port_counterset_gauge", 5)
    assert a.snapshot() == {"port_counterset_test": 1, "port_counterset_gauge": 5}
    assert b.snapshot() == {"port_counterset_test": 2}
    assert profiler.counters()["port_counterset_test"] == g0 + 3
    assert profiler.counters()["port_counterset_gauge"] == 5


# -- on the card -------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_server_breaker_trips_at_dispatch_and_recovers(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_faults.py` on the card")
    import threading
    import urllib.error
    import urllib.request

    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch.inference.server import InferenceServer

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        pred = tfluid.layers.fc(tfluid.layers.data("img", [6]), 3, act="softmax")
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    d = str(tmp_path / "model")
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(d, ["img"], [pred], exe, main_program=main)
    srv = InferenceServer(d, device="cuda", breaker_threshold=2, probe_interval_s=0.05)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    buf = io.BytesIO()
    np.savez(buf, img=np.ones((2, 6), np.float32))

    def post():
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/predict",
                                     data=buf.getvalue(), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    try:
        faults.install(faults.FaultPlan().add("server.dispatch", raises=RuntimeError, times=2))
        assert [post(), post()] == [500, 500]
        assert srv._breaker.open
        deadline = time.monotonic() + 30
        while srv._breaker.open and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not srv._breaker.open and post() == 200
        assert srv.counters()["serve_breaker_recovered"] == 1
    finally:
        srv.shutdown()
        srv.close()
        t.join(timeout=30)
