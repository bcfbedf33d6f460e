"""The port's hardened server (paddle_tpu_torch/inference/server.py) on the
CPU: each behaviour of tests/test_serving_robustness.py as a case against
`InferenceServer(device="cpu")` (shedding, deadlines, 413 / 400 / 411 /
500, the breaker's trip, probe and live trial, the slow-body client,
the admission slot given back as a reply starts and the drain waiting
for that reply's write (the port's own order), per-instance counters, two servers in one process, the atomic
ready-file, the SIGTERM drain under load in a subprocess, coalescing
bitwise, a deadline tighter than the window, one 500 per failed
coalesced dispatch, the derived Retry-After); then parity with the JAX
server on one JAX export (replies within rtol 1e-5), and BERT-tiny
exported with a batch placeholder, coalesced, each reply's rows equal
bit for bit to its batch-of-1 dispatch.

Synchronisation is by fault `hold` file barriers and observable state,
never by bare sleeps; every urlopen, join and wait carries its own
timeout, and the drain test kills its subprocess in a `finally`. torch
runs on one intra-op thread (autouse fixture). The `gpu` test (`python
-m pytest -m gpu --noconftest tests/test_torch_serving.py` on the card)
coalesces BERT-tiny there and holds each reply to its batch-of-1
dispatch as the card's gate says.
"""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import profiler
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.inference.server import (
    InferenceServer, load_bucket_table, load_kv_page_table, write_ready_file)
from paddle_tpu_torch.resilience import faults

ROOT = Path(__file__).resolve().parents[1]
BATCH, IN_DIM, OUT_DIM = 4, 6, 3


@pytest.fixture(autouse=True)
def _one_thread_no_plan():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.clear()
    yield
    faults.clear()
    torch.set_num_threads(threads)


def _fc_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [IN_DIM])
        fc = fluid.layers.fc(img, 16, act="relu")
        pred = fluid.layers.fc(fc, OUT_DIM, act="softmax")
    return main, startup, pred


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The JAX test's tiny model (fc 16 relu, fc 3 softmax), exported by
    the port."""
    d = str(tmp_path_factory.mktemp("served") / "model")
    main, startup, pred = _fc_program(tfluid)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(d, ["img"], [pred], exe, main_program=main)
    return d


class _Server:
    def __init__(self, model_dir, **kw):
        self.srv = InferenceServer(model_dir, device="cpu", port=0, **kw)
        self.base = f"http://127.0.0.1:{self.srv.port}"
        self._t = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self._t.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.close()
        self._t.join(timeout=30)

    def healthz(self):
        return _healthz(self.base)

    def predict(self, arrays=None, headers=None, timeout=60):
        buf = io.BytesIO()
        np.savez(buf, **(arrays if arrays is not None else {"img": _feed()}))
        return _post(self.base, "/predict", buf.getvalue(), headers, timeout)


def _healthz(base):
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(base, path, body, headers=None, timeout=60):
    req = urllib.request.Request(base + path, data=body, method="POST",
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _feed(batch=BATCH, seed=0):
    return np.random.RandomState(seed).rand(batch, IN_DIM).astype("float32")


def _wait_until(cond, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.01)


def _raw_reply(port, request, read_to_eof=False):
    raw = socket.create_connection(("127.0.0.1", port), timeout=10)
    raw.settimeout(10)
    try:
        raw.sendall(request)
        if not read_to_eof:
            return raw.recv(4096)
        chunks = []
        while True:
            part = raw.recv(4096)
            if not part:
                return b"".join(chunks)
            chunks.append(part)
    finally:
        raw.close()


def _reference(model_dir, xv):
    config = AnalysisConfig(model_dir)
    config.disable_gpu()
    return np.asarray(create_paddle_predictor(config).run({"img": xv})[0])


# -- behaviours ----------------------------------------------------------------------


def test_roundtrip_healthz_and_warmup(model_dir):
    with _Server(model_dir) as s:
        # the warmup ran in this instance (the process-wide counter may not
        # move: a warmup under 1 ms adds 0 to it)
        assert "serve_warmup_ms" in s.srv.counters() and s.srv.counters()["serve_warmup_ms"] >= 0
        code, health = s.healthz()
        assert code == 200 and health["status"] == "ok" and health["role"] == "unified"
        assert health["feeds"] == ["img"] and health["device"] == "cpu"
        assert health["queue_depth"] == 0 and health["max_queue"] == 16
        assert not health["breaker_open"] and not health["draining"]
        assert health["batch_window_ms"] == 0 and health["quantized"] is False
        code, _, body = s.predict()
        assert code == 200
        out = np.load(io.BytesIO(body))
        assert out[out.files[0]].shape == (BATCH, OUT_DIM)


def test_shed_on_full_queue(model_dir, tmp_path):
    gate = str(tmp_path / "go")
    faults.install(faults.FaultPlan().add("server.predict", hold=gate))
    with _Server(model_dir, max_queue=1) as s:
        results = {}
        t = threading.Thread(target=lambda: results.update(first=s.predict()), daemon=True)
        t.start()
        _wait_until(lambda: s.srv._inflight == 1, "request admission")
        c0 = profiler.counters().get("serve_shed", 0)
        code, headers, body = s.predict()
        assert code == 503 and json.loads(body)["error"] == "QueueFull"
        assert headers.get("Retry-After") == "1"
        assert profiler.counters()["serve_shed"] == c0 + 1
        open(gate, "w").close()
        t.join(timeout=30)
        assert results["first"][0] == 200


@pytest.mark.parametrize("site,phase", [("server.predict", "before dispatch"),
                                        ("server.reply", "after predict")])
def test_deadline_checked_before_dispatch_and_on_reply(model_dir, tmp_path, site, phase):
    gate = str(tmp_path / f"go-{site}")
    faults.install(faults.FaultPlan().add(site, hold=gate))
    with _Server(model_dir) as s:
        results = {}
        t0 = time.monotonic()
        t = threading.Thread(target=lambda: results.update(
            r=s.predict(headers={"X-Deadline-Ms": "100"})), daemon=True)
        t.start()
        _wait_until(lambda: s.srv._inflight == 1, "request admission")
        _wait_until(lambda: time.monotonic() - t0 > 0.25, "deadline expiry")
        c0 = profiler.counters().get("serve_deadline_exceeded", 0)
        open(gate, "w").close()
        t.join(timeout=30)
        code, _, body = results["r"]
        err = json.loads(body)
        assert code == 504 and err["error"] == "DeadlineExceeded"
        assert phase in err["message"] and err["deadline_ms"] == 100
        assert profiler.counters()["serve_deadline_exceeded"] == c0 + 1


def test_oversized_body_rejected_413(model_dir):
    with _Server(model_dir, max_body_bytes=1024) as s:
        code, _, body = s.predict({"img": np.zeros((64, 64), np.float32)})
        assert code == 413 and json.loads(body)["error"] == "PayloadTooLarge"
        assert s.predict()[0] == 200


def test_client_errors_400_vs_server_errors_500(model_dir):
    with _Server(model_dir, breaker_threshold=100) as s:
        code, _, body = _post(s.base, "/predict", b"this is not an npz")
        assert code == 400 and "error" in json.loads(body)
        code, _, body = s.predict({"bogus": _feed()})
        err = json.loads(body)
        assert code == 400 and err["error"] == "ValueError"
        assert "bogus" in err["message"] and "img" in err["message"]
        code, _, body = _post(s.base, "/predict", b"x", {"X-Deadline-Ms": "soon"})
        assert code == 400 and "X-Deadline-Ms" in json.loads(body)["message"]
        faults.install(faults.FaultPlan().add("server.predict", raises=RuntimeError, nth=1))
        code, _, body = s.predict()
        assert code == 500 and json.loads(body)["error"] == "RuntimeError"
        assert s.predict()[0] == 200


def test_malformed_content_length_400_and_chunked_411(model_dir):
    with _Server(model_dir) as s:
        for value in (b"abc", b"-1"):
            reply = _raw_reply(s.srv.port, b"POST /predict HTTP/1.1\r\nHost: x\r\n"
                               b"Content-Length: " + value + b"\r\n\r\n")
            assert b" 400 " in reply.split(b"\r\n", 1)[0], reply
        reply = _raw_reply(s.srv.port, b"POST /predict HTTP/1.1\r\nHost: x\r\n"
                           b"Transfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n",
                           read_to_eof=True)
        assert b" 411 " in reply.split(b"\r\n", 1)[0] and b"Connection: close" in reply
        assert s.predict()[0] == 200


def test_breaker_trips_healthz_and_recovers_via_probe(model_dir, tmp_path):
    # the probe waits at a barrier until the open breaker's replies are
    # checked: a 30 ms probe could otherwise close it before they are read
    gate = str(tmp_path / "probe-go")
    faults.install(faults.FaultPlan().add("server.predict", raises=RuntimeError, times=2)
                   .add("server.probe", hold=gate))
    with _Server(model_dir, breaker_threshold=2, probe_interval_s=0.03) as s:
        for _ in range(2):
            assert s.predict()[0] == 500
        _wait_until(lambda: s.srv._breaker.open, "breaker trip")
        code, health = s.healthz()
        assert code == 503 and health["status"] == "breaker_open"
        code, headers, body = s.predict()
        assert code == 503 and json.loads(body)["error"] == "BreakerOpen"
        assert headers.get("Retry-After") == "1"
        open(gate, "w").close()
        _wait_until(lambda: not s.srv._breaker.open, "breaker recovery")
        assert s.healthz()[0] == 200 and s.predict()[0] == 200
        c = s.healthz()[1]["counters"]
        assert c["serve_breaker_trips"] == 1 and c["serve_breaker_recovered"] == 1
        assert c["serve_breaker_open"] == 1


def test_breaker_live_trial_recovers_when_probe_cannot(model_dir):
    faults.install(faults.FaultPlan()
                   .add("server.predict", raises=RuntimeError, times=2)
                   .add("server.probe", raises=RuntimeError))
    with _Server(model_dir, warmup=False, breaker_threshold=2, probe_interval_s=0.05) as s:
        assert not s.srv._synthetic_ok
        for _ in range(2):
            assert s.predict()[0] == 500
        _wait_until(lambda: s.srv._breaker.open, "breaker trip")
        assert _post(s.base, "/predict", b"garbage-not-npz")[0] == 400
        _wait_until(lambda: s.predict()[0] == 200, "live-trial breaker recovery")
        assert not s.srv._breaker.open and s.healthz()[0] == 200


def test_breaker_needs_consecutive_failures(model_dir):
    faults.install(faults.FaultPlan().add("server.predict", raises=RuntimeError, every=2))
    with _Server(model_dir, breaker_threshold=2) as s:
        assert [s.predict()[0] for _ in range(6)] == [200, 500, 200, 500, 200, 500]
        assert not s.srv._breaker.open


def test_slow_body_client_cannot_pin_admission_slot(model_dir):
    with _Server(model_dir, max_queue=1, request_timeout_s=0.3) as s:
        raw = socket.create_connection(("127.0.0.1", s.srv.port), timeout=10)
        try:
            raw.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\nContent-Length: 1000\r\n\r\n")
            _wait_until(lambda: s.srv._inflight == 1, "trickling request admission")
            _wait_until(lambda: s.srv._inflight == 0, "slot release")
            assert s.predict()[0] == 200
        finally:
            raw.close()


def test_admission_slot_free_when_reply_arrives(model_dir, monkeypatch):
    """A request gives its slot back as its reply starts, so a client that
    holds its reply holds no slot: at max_queue 1, back-to-back requests on
    fresh connections are never shed, and the count is 0 with no wait, even
    with the slot's release slowed down."""
    with _Server(model_dir, max_queue=1) as s:
        exit_gate = s.srv._exit_gate

        def slow_exit_gate(*a, **kw):
            time.sleep(0.05)  # widens the window a late release would leave
            exit_gate(*a, **kw)

        monkeypatch.setattr(s.srv, "_exit_gate", slow_exit_gate)
        for _ in range(10):
            assert s.predict()[0] == 200
            assert s.srv._inflight == 0


def test_drain_waits_for_a_reply_being_written(model_dir):
    """The drain closes the listener only after a reply that has left the
    admission gate is written (`_replying`)."""
    with _Server(model_dir) as s:
        srv = s.srv
        h = type("Handler", (), {"on_reply": None})()  # the reply is never written
        assert srv._admit(h) is srv
        with srv._slot(h):
            h.on_reply()  # the reply starts
            assert (srv._inflight, srv._replying) == (0, 1)
            srv.begin_drain()
            assert not srv._stopped.wait(0.3)
        _wait_until(srv._stopped.is_set, "the drain to stop the server")
        assert srv._replying == 0


def test_healthz_carries_instance_counters(model_dir):
    with _Server(model_dir) as s:
        for _ in range(3):
            assert s.predict()[0] == 200
        _wait_until(lambda: s.srv._inflight == 0, "inflight drain")
        code, health = s.healthz()
        c = health["counters"]
        assert code == 200 and c["serve_requests"] == 3 and c["serve_warmup_ms"] >= 0
        assert c["inflight"] == 0 and c["uptime_s"] >= 0 and c["serve_queue_depth"] == 0
        assert c["serve_dispatch_ms_ewma"] >= 0 and health["pid"] == os.getpid()


def test_healthz_carries_kernel_launches(model_dir, monkeypatch):
    """A port-only /healthz block: this process's hand-written kernel launch
    counts (ops/kernels LAUNCHES), outside `counters`, so a supervisor in
    another process can read a worker's launches. On the CPU the wrappers
    run their plain versions and launch nothing."""
    from paddle_tpu_torch.ops import kernels

    with _Server(model_dir) as s:
        assert s.predict()[0] == 200
        _, health = s.healthz()
        assert health["kernel_launches"] == kernels.launch_counts()
        assert set(health["kernel_launches"]) == set(kernels.LAUNCHES)
        assert not any(k in health["counters"] for k in kernels.LAUNCHES)
        monkeypatch.setitem(kernels.LAUNCHES, "mha_short_fwd",
                            kernels.LAUNCHES["mha_short_fwd"] + 12)
        _, health = s.healthz()
        assert health["kernel_launches"]["mha_short_fwd"] == kernels.LAUNCHES["mha_short_fwd"]


def test_two_servers_one_process_keep_separate_counters(model_dir, tmp_path):
    gate = str(tmp_path / "sep-go")
    faults.install(faults.FaultPlan().add("server.predict", hold=gate))
    g0 = profiler.counters().get("serve_requests", 0)
    with _Server(model_dir, max_queue=1) as a, _Server(model_dir) as b:
        parked = {}
        t = threading.Thread(target=lambda: parked.update(r=a.predict()), daemon=True)
        t.start()
        _wait_until(lambda: a.srv._inflight == 1, "request admission")
        assert a.predict()[0] == 503
        open(gate, "w").close()
        t.join(timeout=30)
        assert parked["r"][0] == 200
        faults.clear()
        assert b.predict()[0] == 200
        ha, hb = a.healthz()[1]["counters"], b.healthz()[1]["counters"]
        assert ha["serve_requests"] == 2 and ha["serve_shed"] == 1
        assert hb["serve_requests"] == 1 and hb.get("serve_shed", 0) == 0
        assert profiler.counters()["serve_requests"] == g0 + 3


def test_ready_file_written_atomically(model_dir, tmp_path):
    path = str(tmp_path / "ready.json")
    with _Server(model_dir, backend_class="h100") as s:
        payload = write_ready_file(path, s.srv)
        with open(path) as f:
            on_disk = json.load(f)
        assert on_disk == payload
        assert on_disk["port"] == s.srv.port and on_disk["pid"] == os.getpid()
        assert on_disk["warmup_ms"] >= 0 and on_disk["backend_class"] == "h100"
        assert os.listdir(str(tmp_path)) == ["ready.json"]
        assert s.healthz()[1]["backend_class"] == "h100"


def test_no_registry_yet(model_dir, tmp_path):
    """registry= loads a manifest (a file, relative bundle path) and serves
    X-Model; a server without one answers /admin/deploy with a closing 404
    NoRegistry and ignores X-Model, as the JAX server without one does."""
    manifest = tmp_path / "model_registry.json"
    os.symlink(model_dir, tmp_path / "alt_bundle")
    manifest.write_text(json.dumps({"default": "main", "models": [
        {"name": "alt", "version": "v1", "bundle_dir": "alt_bundle"}]}))
    with _Server(model_dir, registry=str(manifest)) as s:
        assert s.srv._registry.names() == ["alt"]
        _, _, ref = s.predict()
        code, _, body = s.predict(headers={"X-Model": "alt"})
        assert code == 200 and body == ref  # the same bundle, the same bits
        assert set(s.healthz()[1]["models"]) == {"main", "alt"}
    with _Server(model_dir) as s:
        code, headers, body = _post(s.base, "/admin/deploy", b'{"name": "m", "version": "2"}')
        assert code == 404 and json.loads(body)["error"] == "NoRegistry"
        assert headers.get("Connection") == "close"
        code, _, body = s.predict(headers={"X-Model": "other"})
        assert code == 200
        assert "models" not in s.healthz()[1]
        assert _post(s.base, "/nowhere", b"")[0] == 404


def test_tables_load_as_the_jax_loaders_do(tmp_path):
    from paddle_tpu.inference import server as jserver

    for kw in ({}, {"backend_class": "cpu-int8"}, {"backend_class": "unknown"}):
        assert load_bucket_table(**kw) == jserver.load_bucket_table(**kw)
    for profile in ("default", "smoke"):
        assert load_kv_page_table(profile=profile) == jserver.load_kv_page_table(
            profile=profile)
    assert load_bucket_table()["default"] == [1, 2, 4, 8, 16, 32, 64]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"default": [4, 2]}))
    with pytest.raises(ValueError, match="ascending"):
        load_bucket_table(str(bad))
    with pytest.raises(ValueError, match="no profile"):
        load_kv_page_table(profile="nope")


# -- SIGTERM drain ---------------------------------------------------------------------


def test_sigterm_drain_under_load(model_dir, tmp_path):
    """N requests parked in flight when SIGTERM lands: /healthz flips to
    503 draining while the listener is open, a new request sheds with
    ServerDraining, every parked request gets a full 200, and the process
    exits 0. The subprocess runs on the CPU, publishes its port through
    the ready-file, and is killed in the finally whatever happens."""
    n_inflight = 4
    gate = str(tmp_path / "drain-gate")
    ready = str(tmp_path / "ready.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               PADDLE_TPU_FAULTS=f"server.predict:hold={gate}")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.inference.server", "--model-dir", model_dir,
         "--device", "cpu", "--max-queue", "8", "--drain-timeout", "120",
         "--ready-file", ready, "--batch-window-ms", "5"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        _wait_until(lambda: os.path.exists(ready) or proc.poll() is not None,
                    "the ready-file", timeout=120)
        assert proc.poll() is None, proc.stdout.read()
        with open(ready) as f:
            info = json.load(f)
        assert info["pid"] == proc.pid
        base = f"http://127.0.0.1:{info['port']}"
        buf = io.BytesIO()
        np.savez(buf, img=_feed(seed=3))
        body = buf.getvalue()
        results = [None] * n_inflight

        def call(i):
            results[i] = _post(base, "/predict", body, timeout=120)

        threads = [threading.Thread(target=call, args=(i,), daemon=True)
                   for i in range(n_inflight)]
        for t in threads:
            t.start()
        _wait_until(lambda: _healthz(base)[1].get("queue_depth") == n_inflight,
                    "all requests in flight", timeout=60)
        proc.send_signal(signal.SIGTERM)
        _wait_until(lambda: _healthz(base)[0] == 503, "healthz to flip 503", timeout=30)
        assert _healthz(base)[1]["status"] == "draining"
        code, _, shed = _post(base, "/predict", body, timeout=30)
        assert code == 503 and json.loads(shed)["error"] == "ServerDraining"
        open(gate, "w").close()
        for t in threads:
            t.join(timeout=120)
        assert proc.wait(timeout=120) == 0
        assert "server drained, exiting" in proc.stdout.read()
        parsed = []
        for r in results:
            assert r is not None and r[0] == 200, r
            z = np.load(io.BytesIO(r[2]))
            parsed.append(z[z.files[0]])
        for p in parsed[1:]:
            np.testing.assert_array_equal(p, parsed[0])
        assert parsed[0].shape == (BATCH, OUT_DIM)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# -- coalescing --------------------------------------------------------------------


def test_coalesce_merges_concurrent_requests_bitwise(model_dir):
    """Concurrent requests ride ONE padded dispatch and each reply equals
    its own batch-of-1 prediction bit for bit; a deadline-tight late
    joiner closes the open batch at once (the window is 60 s)."""
    xs = [np.random.RandomState(40 + i).rand(4, IN_DIM).astype("float32") for i in range(3)]
    refs = [_reference(model_dir, x) for x in xs]
    with _Server(model_dir, max_queue=32, batch_window_ms=60_000) as s:
        assert s.srv._batchable
        res = {}
        threads = [threading.Thread(target=lambda i=i: res.update({i: s.predict(
            {"img": xs[i]})}), daemon=True) for i in range(2)]
        for t in threads:
            t.start()
        _wait_until(lambda: s.srv._coalescer.pending_rows() == 8, "both members to join")
        code, _, body = s.predict({"img": xs[2]}, headers={"X-Deadline-Ms": "5000"})
        assert code == 200
        for t in threads:
            t.join(timeout=60)
        for i, (rc, _, rbody) in enumerate([res[0], res[1], (code, {}, body)]):
            assert rc == 200
            out = np.load(io.BytesIO(rbody))
            assert out[out.files[0]].tobytes() == refs[i].tobytes()
        _, h = s.healthz()
        c = h["counters"]
        assert c["serve_batches"] == 1 and c["serve_batch_members"] == 3
        assert c["serve_batch_padded_rows"] == 4  # 12 rows -> bucket 16
        assert c["serve_coalesce_bypass"] == 1 and c["serve_batch_size_p50"] == 3
        assert c["serve_coalesce_wait_ms"] >= 0 and h["batch_window_ms"] == 60_000


def test_deadline_tighter_than_window_dispatches_solo(model_dir):
    xv = np.random.RandomState(50).rand(4, IN_DIM).astype("float32")
    ref = _reference(model_dir, xv)
    with _Server(model_dir, max_queue=8, batch_window_ms=60_000) as s:
        code, _, body = s.predict({"img": xv}, headers={"X-Deadline-Ms": "10000"})
        assert code == 200
        out = np.load(io.BytesIO(body))
        assert out[out.files[0]].tobytes() == ref.tobytes()
        assert s.srv._coalescer.pending_rows() == 0
        c = s.healthz()[1]["counters"]
        assert c["serve_coalesce_bypass"] == 1 and c["serve_batches"] == 1
        assert c["serve_batch_members"] == 1


def test_coalesced_batch_failure_maps_to_500_once_per_dispatch(model_dir):
    faults.install(faults.FaultPlan().add("server.batch.dispatch", raises=RuntimeError,
                                          nth=1))
    with _Server(model_dir, max_queue=8, batch_window_ms=60_000, breaker_threshold=3) as s:
        res = {}
        threads = [threading.Thread(target=lambda i=i: res.update({i: s.predict()}),
                                    daemon=True) for i in range(2)]
        for t in threads:
            t.start()
        _wait_until(lambda: s.srv._coalescer.pending_rows() == 8, "members to join")
        s.srv._coalescer.flush_all()
        for t in threads:
            t.join(timeout=60)
        for i in range(2):
            code, _, body = res[i]
            assert code == 500 and json.loads(body)["error"] == "RuntimeError"
        assert not s.srv._breaker.open and s.srv._breaker._streak == 1
        faults.clear()
        assert s.predict(headers={"X-Deadline-Ms": "30000"})[0] == 200


def test_retry_after_derived_from_queue_drain_rate(model_dir, tmp_path):
    gate = str(tmp_path / "ra-go")
    faults.install(faults.FaultPlan().add("server.predict", hold=gate))
    with _Server(model_dir, max_queue=1, warmup=False) as s:
        assert s.srv._dispatch_ms_ewma is None
        parked = {}
        t = threading.Thread(target=lambda: parked.update(r=s.predict()), daemon=True)
        t.start()
        _wait_until(lambda: s.srv._inflight == 1, "request admission")
        for ewma, want in ((None, "1"), (5000.0, "5"), (1e9, "30")):
            s.srv._dispatch_ms_ewma = ewma
            code, headers, _ = s.predict()
            assert code == 503 and headers.get("Retry-After") == want
        open(gate, "w").close()
        t.join(timeout=30)
        assert parked["r"][0] == 200
        assert 0 < s.srv._dispatch_ms_ewma < 1e9


def test_coalescer_stress_every_reply_its_own_rows(model_dir):
    """32 client threads, 4 requests each, of 1-3 rows, through a 2 ms
    window with the interpreter switching threads every microsecond:
    every reply equals its own batch-of-1 rows bit for bit, no open batch
    is left behind, and the members add up to the requests."""
    xs = [np.random.RandomState(70 + i).rand(1 + i % 3, IN_DIM).astype("float32")
          for i in range(16)]
    refs = [_reference(model_dir, x) for x in xs]
    bad, done = [], []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _Server(model_dir, max_queue=64, batch_window_ms=2) as s:
            def client(c):
                for r in range(4):
                    i = (c + r) % len(xs)
                    code, _, body = s.predict({"img": xs[i]}, timeout=120)
                    out = np.load(io.BytesIO(body)) if code == 200 else None
                    if out is None or out[out.files[0]].tobytes() != refs[i].tobytes():
                        bad.append((c, r, code))
                    done.append(1)

            threads = [threading.Thread(target=client, args=(c,), daemon=True)
                       for c in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            c = s.srv.counters()
            assert s.srv._coalescer.pending_rows() == 0 and not s.srv._coalescer._open
    finally:
        sys.setswitchinterval(switch)
    assert bad == [] and len(done) == 128
    assert c["serve_batch_members"] == c["serve_requests"] == 128
    assert c["serve_batches"] < 128


def test_static_leading_dim_disables_coalescing_loudly(tmp_path, capsys):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        img = tfluid.layers.data("img", [2, IN_DIM], append_batch_size=False)
        pred = tfluid.layers.fc(img, OUT_DIM)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    d = str(tmp_path / "static")
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(d, ["img"], [pred], exe, main_program=main)
    with _Server(d, batch_window_ms=5) as s:
        assert s.srv._coalescer is None and not s.srv._batchable
        assert "static leading dim" in capsys.readouterr().out
        assert s.healthz()[1]["batch_window_ms"] == 0
        assert s.predict({"img": _feed(batch=2)})[0] == 200


# -- against the JAX server ----------------------------------------------------------


def test_jax_export_served_by_both_servers(tmp_path):
    """One export saved by the JAX package; the same .npz requests
    through the JAX InferenceServer and the port's (solo and coalesced):
    replies within rtol 1e-5, the same fetch names and the same errors."""
    import paddle_tpu as jfluid
    from paddle_tpu.inference.server import InferenceServer as JServer

    main, startup, pred = _fc_program(jfluid)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    d = str(tmp_path / "jax_export")
    with jfluid.scope_guard(scope):
        jfluid.io.save_inference_model(d, ["img"], [pred], exe, main_program=main)
    bodies = []
    for i in range(3):
        buf = io.BytesIO()
        np.savez(buf, img=_feed(batch=1 + i, seed=60 + i))
        bodies.append(buf.getvalue())
    replies = {}
    for name, srv in (("jax", JServer(d, port=0)),
                      ("port", InferenceServer(d, device="cpu")),
                      ("port coalesced", InferenceServer(d, device="cpu", batch_window_ms=5))):
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{srv.port}"
        try:
            replies[name] = [_post(base, "/predict", b) for b in bodies]
            replies[name].append(_post(base, "/predict", b"not an npz"))
            replies[name].append(_healthz(base))
        finally:
            srv.shutdown()
            srv.close()
            t.join(timeout=30)
    for name in ("port", "port coalesced"):
        for (jc, _, jb), (tc, _, tb) in zip(replies["jax"][:3], replies[name][:3]):
            assert jc == tc == 200
            jz, tz = np.load(io.BytesIO(jb)), np.load(io.BytesIO(tb))
            assert jz.files == tz.files
            np.testing.assert_allclose(tz[tz.files[0]], jz[jz.files[0]], rtol=1e-5, atol=0)
        assert replies[name][3][0] == replies["jax"][3][0] == 400
        jh, th = replies["jax"][4][1], replies[name][4][1]
        assert set(jh) - {"counters"} <= set(th)
        assert {k: jh[k] for k in ("feeds", "fetches", "max_queue", "role", "status")} == \
            {k: th[k] for k in ("feeds", "fetches", "max_queue", "role", "status")}


# -- BERT-tiny with a batch placeholder, coalesced ----------------------------------

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)
S = 16


def _bert_export(tmp_path, place):
    from paddle_tpu_torch.models.bert import BertConfig, bert_encoder

    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        ids, sent, pos = (tfluid.layers.data(n, [S], dtype="int64")
                          for n in ("src_ids", "sent_ids", "pos_ids"))
        mask = tfluid.layers.data("input_mask", [S])
        hidden = bert_encoder(ids, sent, pos, mask, BertConfig(**TINY), is_test=True)
    scope = tfluid.Scope()
    exe = tfluid.Executor(place)
    exe.run(startup, scope=scope)
    d = str(tmp_path / "bert")
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(
            d, ["src_ids", "sent_ids", "pos_ids", "input_mask"], [hidden], exe,
            main_program=main)
    return d, hidden.name


def _bert_requests(n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        length = rs.randint(S // 4, S + 1)
        out.append({
            "src_ids": rs.randint(0, TINY["vocab_size"], (1, S)).astype(np.int64),
            "sent_ids": (np.arange(S)[None, :] >= length // 2).astype(np.int64),
            "pos_ids": np.arange(S, dtype=np.int64)[None, :],
            "input_mask": (np.arange(S)[None, :] < length).astype(np.float32),
        })
    return out


def _serve_bert(model_dir, device, requests, window_ms):
    """The requests sent at once to a coalescing server -> (replies, each
    request's batch-of-1 predict on the same server, the counters, and
    each merged dispatch's feeds with a second dispatch of them)."""
    srv = InferenceServer(model_dir, device=device, batch_window_ms=window_ms, max_queue=64)
    merged = []
    predict = srv.predict

    def spy(feeds, _deadline=None):
        if len(feeds["src_ids"]) > 1:
            merged.append(feeds)
        return predict(feeds, _deadline)

    srv.predict = spy
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        assert srv._batchable
        replies = [None] * len(requests)

        def call(i):
            buf = io.BytesIO()
            np.savez(buf, **requests[i])
            replies[i] = _post(base, "/predict", buf.getvalue(), timeout=120)

        threads = [threading.Thread(target=call, args=(i,), daemon=True)
                   for i in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        solo = [predict(r) for r in requests]
        return replies, solo, srv.counters(), [(m, predict(m)) for m in merged]
    finally:
        srv.shutdown()
        srv.close()
        t.join(timeout=30)


def test_bert_tiny_batch_placeholder_coalesced_bitwise(tmp_path):
    d, name = _bert_export(tmp_path, tfluid.CPUPlace())
    requests = _bert_requests(8)
    replies, solo, c, _ = _serve_bert(d, "cpu", requests, window_ms=200)
    assert c["serve_batches"] < len(requests) and c["serve_batch_size_p50"] > 1
    for (code, _, body), ref in zip(replies, solo):
        assert code == 200
        out = np.load(io.BytesIO(body))[name]
        assert out.shape == (1, S, TINY["hidden_size"])
        assert out.tobytes() == ref[name].tobytes()


@pytest.mark.gpu
def test_cuda_bert_tiny_coalesced_rows_against_batch_of_one(tmp_path):
    """On the card: every reply equals the same rows of a second dispatch
    of the same merged batch bit for bit, and lies within atol 1e-4 of its
    batch-of-1 dispatch (prints whether it is bit-equal to it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_serving.py` on the card")
    d, name = _bert_export(tmp_path, tfluid.CUDAPlace(0))
    requests = _bert_requests(16, seed=1)
    replies, solo, c, merged = _serve_bert(d, "cuda", requests, window_ms=200)
    assert c["serve_batch_size_p50"] > 1 and merged
    bitwise_solo = 0
    for req, (code, _, body), ref in zip(requests, replies, solo):
        assert code == 200
        out = np.load(io.BytesIO(body))[name]
        np.testing.assert_allclose(out, ref[name], atol=1e-4, rtol=0)
        bitwise_solo += out.tobytes() == ref[name].tobytes()
        rows = [(again[name], j) for feeds, again in merged
                for j in range(len(feeds["src_ids"]))
                if all(np.array_equal(feeds[k][j], req[k][0]) for k in req)]
        if rows:  # a request that rode a merged dispatch
            again, j = rows[0]
            assert out[0].tobytes() == again[j].tobytes()
    print(f"bit-equal to batch-of-1: {bitwise_solo} of {len(requests)}")
