"""The port's model registry (paddle_tpu_torch/inference/registry.py) on the
CPU, each tier-1 case of tests/test_multimodel_serving.py held against the
JAX package's registry: the DRR gate's drain order, QosConfig validation
and classing, X-Model routing and the /healthz `models` block, the
per-model Retry-After, hot-swap deploys (drift gate, chaos-site aborts,
counters), and two decode models on one paged KV pool.

The bundles are saved by the JAX package as that file builds them (fc 16
relu, fc 3 softmax, weights perturbed from a seed) and served by both
servers on the CPU. Tolerances: a port reply against the JAX reply for the
same request within rtol 1e-5 / atol 1e-7 (fp32 sums of a few dozen
products, the serving parity test's gate); the deploy gate's drift value
within 1e-6 of the JAX value (it is printed to four decimals of a percent);
decode logits within rtol 1e-5 / atol 1e-6 (the JAX decode gate) and the
greedy tokens equal. The port's own default path is byte-identical to a
registry-less port server, and each model's tokens on the shared pool are
bit-equal to that model alone, as the JAX test pins its own."""

import io
import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import registry as treg
from paddle_tpu_torch.inference.decode_model import (
    DecodeService, ToyDecodeModel, make_toy_decode_weights, save_decode_weights)
from paddle_tpu_torch.inference.server import InferenceServer
from paddle_tpu_torch.resilience import faults as tfaults

BATCH, IN_DIM, OUT_DIM = 4, 6, 3
REPLY_TOL = dict(rtol=1e-5, atol=1e-7)
DECODE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread_no_plan():
    from paddle_tpu.resilience import faults as jfaults

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tfaults.clear()
    jfaults.clear()
    yield
    tfaults.clear()
    jfaults.clear()
    torch.set_num_threads(threads)


def _build_bundle(d, seed):
    """tests/test_multimodel_serving.py's bundle, saved by the JAX package:
    the initializers ignore numpy's seed, so the weights are made distinct
    by perturbing the persistables after the startup program ran."""
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
    """`a` is the default model, `b` the registered alt v1, `c` the
    hot-swap candidate."""
    root = tmp_path_factory.mktemp("multimodel")
    return tuple(_build_bundle(str(root / n), seed)
                 for n, seed in (("a", 0), ("b", 1), ("c", 2)))


def _feed(batch=BATCH, seed=0):
    buf = io.BytesIO()
    np.savez(buf, img=np.random.RandomState(seed).rand(batch, IN_DIM).astype("float32"))
    return buf.getvalue()


class _Server:
    """A server of either package on a thread: `jax=True` the JAX
    package's, else the port's on the CPU."""

    def __init__(self, model_dir, jax=False, **kw):
        if jax:
            from paddle_tpu.inference.server import InferenceServer as JaxServer

            self.srv = JaxServer(model_dir, port=0, **kw)
        else:
            self.srv = InferenceServer(model_dir, device="cpu", port=0, **kw)
        self._t = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self._t.start()
        self.base = f"http://127.0.0.1:{self.srv.port}"

    def post(self, path, body, headers=None, timeout=60):
        req = urllib.request.Request(self.base + path, data=body, method="POST",
                                     headers=dict(headers or {}))
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def predict(self, headers=None, **kw):
        return self.post("/predict", _feed(**kw), headers)

    def healthz(self):
        with urllib.request.urlopen(self.base + "/healthz", timeout=30) as r:
            return json.loads(r.read())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.close()
        self._t.join(timeout=30)


def _wait_until(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.01)


def _settled(srv):
    """Every in-flight count of a server of either package is back at 0.
    The JAX server's handler writes its reply before it leaves the
    admission gate, so a client can hold its reply while the count still
    includes it; the port's leaves the gate as the reply starts."""
    reg = srv._registry
    return srv._inflight == 0 and (reg is None or (
        reg.default_inflight == 0 and all(reg.get(n).inflight == 0 for n in reg.names())))


def _manifest(db, qos=True):
    m = {"default": "main", "default_version": "v1",
         "models": [{"name": "alt", "version": "v1", "bundle_dir": db}]}
    if qos:
        m["qos"] = {"classes": {"gold": {"weight": 8, "deadline_ms": 0},
                                "bulk": {"weight": 1}},
                    "tenants": {"t-gold": "gold"},
                    "default_class": "bulk"}
    return m


def _arrays(body):
    z = np.load(io.BytesIO(body))
    return {k: z[k] for k in z.files}


def _assert_replies_close(tbody, jbody):
    t, j = _arrays(tbody), _arrays(jbody)
    assert sorted(t) == sorted(j)
    for k in t:
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **REPLY_TOL)


# -- the QoS primitives ---------------------------------------------------------


def _drain_order(gate, seq):
    """Hold `gate`, queue one waiter a class of `seq` in that order (each
    queued before the next starts), release -> the classes in grant order."""
    gate.acquire(seq[0])
    order, lock = [], threading.Lock()

    def waiter(cls):
        gate.acquire(cls)
        with lock:
            order.append(cls)
        gate.release()

    threads = []
    for i, cls in enumerate(seq[1:]):
        t = threading.Thread(target=waiter, args=(cls,), daemon=True)
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 10
        while True:
            with gate._cv:
                if sum(len(q) for q in gate._queues.values()) == i + 1:
                    break
            assert time.monotonic() < deadline, "a waiter never queued"
            time.sleep(0.001)
    gate.release()  # starts the DRR hand-off chain
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return order


def test_weighted_deficit_gate_drr_drain_order_is_weight_fair():
    """The JAX test's pattern: 8 bulk + 8 gold behind a held gate (weights
    1:3) drain b,g,g,g: every gold grant within the first 11."""
    gate = treg.WeightedDeficitGate({"bulk": 1.0, "gold": 3.0}, default_class="bulk")
    order = _drain_order(gate, ["bulk"] + ["bulk"] * 8 + ["gold"] * 8)
    assert len(order) == 16
    assert order[:11].count("gold") == 8 and order[:11].count("bulk") == 3
    assert order[11:] == ["bulk"] * 5
    snap = gate.snapshot()
    assert snap["gold"] == 8 and snap["bulk"] == 9  # +1: the holder


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drr_drain_order_matches_jax(seed):
    """One seeded sequence of acquires over three classes (one of them the
    default for an unknown class) through both gates: the same grant order
    and the same grants per class."""
    from paddle_tpu.inference import registry as jreg

    rs = np.random.RandomState(seed)
    weights = {"bulk": 1.0, "silver": 2.5, "gold": 6.0}
    seq = [str(c) for c in rs.choice(["bulk", "silver", "gold", "nobody"], 40)]
    got = {}
    for tag, mod in (("jax", jreg), ("port", treg)):
        gate = mod.WeightedDeficitGate(weights, default_class="silver")
        got[tag] = (_drain_order(gate, seq), gate.snapshot())
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == len(seq) - 1


def test_weighted_deficit_gate_uncontended_is_a_plain_lock():
    gate = treg.WeightedDeficitGate({"x": 1.0})
    for _ in range(3):
        with gate:
            pass
    assert gate.snapshot()["x"] == 3


QOS_CASES = [
    None,
    {},
    {"classes": {"gold": {"weight": 8, "deadline_ms": 250}, "bulk": {"weight": 1}},
     "tenants": {"t1": "gold"}, "default_class": "bulk"},
    {"classes": {"a": {"weight": 2}, "b": {"weight": 2}, "c": None}},
    {"classes": {"only": {"weight": 3, "deadline_ms": 0}}},
    {"classes": {"gold": {}}, "tenants": {"t": "nope"}},
    {"classes": {"gold": {}}, "default_class": "nope"},
]


def _qos_view(mod, raw):
    try:
        q = mod.QosConfig(raw)
    except ValueError as e:
        return ("ValueError", str(e))
    return (q.enabled, q.classes, q.tenants, q.default_class, q.weights(),
            sorted(q.bulk_classes()), [q.class_of(t) for t in ("t1", "stranger", None)],
            [q.deadline_ms(c) for c in ("gold", "bulk", "a", "missing")],
            type(q.make_gate()).__name__)


@pytest.mark.parametrize("raw", QOS_CASES, ids=range(len(QOS_CASES)))
def test_qos_config_validation_and_classing_match_jax(raw):
    from paddle_tpu.inference import registry as jreg

    assert _qos_view(treg, raw) == _qos_view(jreg, raw)


def test_qos_config_validation_and_classing():
    qos = treg.QosConfig(QOS_CASES[2])
    assert qos.enabled and qos.class_of("t1") == "gold"
    assert qos.class_of("stranger") == "bulk" and qos.class_of(None) == "bulk"
    assert qos.deadline_ms("gold") == 250.0 and qos.deadline_ms("bulk") == 0.0
    assert isinstance(qos.make_gate(), treg.WeightedDeficitGate)
    assert not treg.QosConfig(None).enabled
    assert isinstance(treg.QosConfig(None).make_gate(), type(threading.Lock()))
    for bad in QOS_CASES[5:]:
        with pytest.raises(ValueError):
            treg.QosConfig(bad)


def test_load_qos_config_matches_jax(tmp_path, bundles):
    """A manifest file's qos block, and a missing or corrupt file (a
    disabled QosConfig, never a raise)."""
    from paddle_tpu.inference import registry as jreg

    good = tmp_path / "model_registry.json"
    good.write_text(json.dumps(_manifest(bundles[1])))
    corrupt = tmp_path / "corrupt.json"
    corrupt.write_text("{not json")
    for path in (good, corrupt, tmp_path / "missing.json"):
        assert _qos_view_of(treg.load_qos_config(str(path))) == _qos_view_of(
            jreg.load_qos_config(str(path)))
    assert treg.load_qos_config(str(good)).enabled
    assert not treg.load_qos_config(str(corrupt)).enabled


def _qos_view_of(q):
    return (q.enabled, q.classes, q.tenants, q.default_class)


# -- the registry on the wire ------------------------------------------------------


def _model_keys(health):
    return {name: sorted(block) for name, block in health["models"].items()}


def test_registry_routing_healthz_and_default_byte_identity_match_jax(bundles):
    da, db, _ = bundles
    with _Server(da) as bare:
        _, _, ref = bare.predict()
        assert "models" not in bare.healthz()
    replies, health = {}, {}
    for tag in ("jax", "port"):
        with _Server(da, jax=tag == "jax", registry=_manifest(db)) as s:
            replies[tag] = [s.predict(h) for h in (
                None, {"X-Model": "main", "X-Tenant": "t-gold"}, {"X-Model": "alt"},
                {"X-Model": "ghost"})]
            _wait_until(lambda: _settled(s.srv), f"the {tag} server's in-flight counts")
            health[tag] = s.healthz()
    codes = {tag: [r[0] for r in rs] for tag, rs in replies.items()}
    assert codes["port"] == codes["jax"] == [200, 200, 200, 404]
    port = replies["port"]
    # the default model's reply is byte-identical to a registry-less server
    # over the same bundle, with and without naming it
    assert port[0][2] == ref and port[1][2] == ref
    assert port[2][2] != ref
    assert json.loads(port[3][2])["error"] == json.loads(replies["jax"][3][2])["error"] \
        == "NoSuchModel"
    for (_, _, tbody), (_, _, jbody) in zip(port[:3], replies["jax"][:3]):
        _assert_replies_close(tbody, jbody)
    assert _model_keys(health["port"]) == _model_keys(health["jax"])
    tm, jm = health["port"]["models"], health["jax"]["models"]
    assert set(tm) == {"main", "alt"} and tm["main"]["default"] is True
    for name in tm:
        for key in ("version", "default", "max_queue", "inflight", "breaker_open",
                    "batch_window_ms", "generative", "quantized", "qos_grants"):
            assert tm[name].get(key) == jm[name].get(key), (name, key)
        if "counters" in jm[name]:
            assert tm[name]["counters"].get("serve_requests") == \
                jm[name]["counters"].get("serve_requests") == 1
    assert health["port"]["counters"]["serve_requests"] == \
        health["jax"]["counters"]["serve_requests"] == 4


def test_per_model_retry_after_derivation_matches_jax(bundles):
    """Retry-After of a shed is the shed model's depth x its own EWMA, the
    same values as the JAX registry's, and a slow neighbour's EWMA does not
    reach the default model's."""
    da, db, _ = bundles
    cases = [(2000.0, 3), (50000.0, 3), (50000.0, 0), (None, 5), (333.0, 7)]
    got = {}
    for tag in ("jax", "port"):
        with _Server(da, jax=tag == "jax", registry=_manifest(db, qos=False)) as s:
            rt = s.srv._registry.get("alt")
            out = []
            for ewma, depth in cases:
                rt._dispatch_ms_ewma, rt.inflight = ewma, depth
                out.append((rt.retry_after(), s.srv._retry_after(rt)))
            rt.inflight = 0
            with s.srv._ewma_lock:
                s.srv._dispatch_ms_ewma = 1.0
            out.append(s.srv._retry_after())
            got[tag] = out
    assert got["port"] == got["jax"]
    assert got["port"][:4] == [(6, 6), (30, 30), (1, 1), (1, 1)] and got["port"][-1] == 1


def _deploy_sequence(s, dc):
    """The JAX test's deploy drill -> (code, error) of each step, the alt
    replies' bodies (old, then after each step), the drift value of the 409
    and the final health."""
    hdr = {"Content-Type": "application/json"}
    post = lambda body: s.post("/admin/deploy", json.dumps(body).encode(), hdr)  # noqa: E731
    _, _, old = s.predict({"X-Model": "alt"})
    steps, bodies = [], [old]
    ungated = {"name": "alt", "version": "v2", "bundle_dir": dc, "tolerance": None}
    for site in ("registry.load", "registry.cutover"):
        s.faults.install(s.faults.FaultPlan().add(site, raises=RuntimeError, nth=1))
        steps.append(post(ungated)[0])
        s.faults.clear()
        bodies.append(s.predict({"X-Model": "alt"})[2])
    code, _, b = post(dict(ungated, tolerance=0.01))
    steps.append((code, json.loads(b)["error"]))
    drift = float(re.search(r"drifted ([0-9.]+)%", json.loads(b)["message"]).group(1))
    bodies.append(s.predict({"X-Model": "alt"})[2])
    code, _, b = post(ungated)
    steps.append((code, json.loads(b)["status"]))
    bodies.append(s.predict({"X-Model": "alt"})[2])
    steps.append(post({"name": "alt", "version": "v3"})[0])
    bodies.append(s.predict({"X-Model": "alt"})[2])
    steps.append(post({"name": "main", "version": "v9"})[0])
    steps.append(post({"name": "ghost", "version": "v1"})[0])
    return steps, bodies, drift, s.healthz()


def test_deploy_chaos_aborts_drift_gate_cutover_and_counters_match_jax(bundles):
    from paddle_tpu.resilience import faults as jfaults

    da, db, dc = bundles
    got = {}
    for tag, fmod in (("jax", jfaults), ("port", tfaults)):
        with _Server(da, jax=tag == "jax", registry=_manifest(db, qos=False)) as s:
            s.faults = fmod
            got[tag] = _deploy_sequence(s, dc)
    (tsteps, tbodies, tdrift, thealth), (jsteps, jbodies, jdrift, jhealth) = (
        got["port"], got["jax"])
    assert tsteps == jsteps == [500, 500, (409, "ExportToleranceError"), (200, "active"),
                                200, 404, 404]
    assert abs(tdrift - jdrift) <= 1e-4 and tdrift > 1.0  # percent, 4 decimals
    old, new = tbodies[0], tbodies[4]
    assert tbodies[1] == tbodies[2] == tbodies[3] == old  # each abort kept v1
    assert new != old and tbodies[5] == new  # the relabel serves the same bits
    for tb, jb in zip(tbodies, jbodies):
        _assert_replies_close(tb, jb)
    for health in (thealth, jhealth):
        assert health["models"]["alt"]["version"] == "v3"
    for k in ("serve_deploys", "serve_deploy_failures", "serve_deploy_unloads"):
        assert thealth["counters"][k] == jhealth["counters"][k], k
    assert (thealth["counters"]["serve_deploys"], thealth["counters"]["serve_deploy_failures"],
            thealth["counters"]["serve_deploy_unloads"]) == (5, 3, 2)


def test_unloaded_version_drops_its_tensors_and_late_requests_reach_the_live_one(bundles):
    """An unloaded runtime holds no tensor of its predictor; a request that
    resolved it before the flip and is admitted after is served by the live
    version (the port unloads a retired version at once)."""
    da, db, dc = bundles
    with _Server(da, registry=_manifest(db, qos=False)) as s:
        reg = s.srv._registry
        v1 = reg.get("alt")
        assert v1._predictor._scope._values
        reg.deploy("alt", "v2", dc, tolerance=None)
        v2 = reg.get("alt")
        assert v1.retired and not v1._predictor._scope._values and v1.inflight == 0
        assert v2 is not v1 and not v2.retired

        class _H:
            headers = {}

        assert s.srv._admit(_H(), v1) is v2
        assert v2.inflight == 1
        s.srv._exit_gate(v2)
        assert v2.inflight == 0 and s.srv._inflight == 0
        assert s.srv._admit(_H(), None) is s.srv
        assert reg.default_inflight == 1
        s.srv._exit_gate(None)
        assert reg.default_inflight == 0


# -- one KV pool, two decode models -----------------------------------------------

GEOM = dict(vocab=13, num_heads=4, head_dim=8)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9], [10], [2, 11, 3, 5, 7]]
MAX_NEW = 5


def _jax_greedy(weights, prompt, max_new):
    """The JAX model's greedy tokens and logits for one prompt: its prefill
    and its paged step, driven one stream at a time with the step's data
    arguments copied (the JAX batcher hands a numpy array it then bumps in
    place to an async dispatch)."""
    import jax.numpy as jnp

    from paddle_tpu.inference import decode_model as jdm
    from paddle_tpu.inference import kv_cache as jkv

    model = jdm.ToyDecodeModel(weights)
    k, v, length, last = model.prefill(np.asarray(prompt, np.int32))
    cache = jkv.PagedKVCache(8, 8, 2, model.num_heads, model.head_dim, max_streams=2)
    batcher = jkv.PagedDecodeStepBatcher(cache, model.decode_step)
    slot = cache.acquire("s", total_len=length + max_new)
    cache.admit(slot, k, v, length)
    toks, logits, tok = [], [], last
    for _ in range(max_new):
        tokens = np.zeros((cache.max_streams,), np.int32)
        tokens[slot] = tok
        mask = cache.active_mask()
        out, cache.k, cache.v = batcher._fn(
            jnp.array(tokens), cache.k, cache.v, jnp.array(cache.page_table),
            jnp.array(cache.lengths), jnp.array(mask))
        row = np.array(out)[slot]
        cache.lengths[mask] += 1
        tok = int(row.argmax())
        toks.append(tok)
        logits.append(row)
    return np.asarray(toks, np.int32), np.stack(logits)


def test_generate_x_model_rides_the_shared_kv_pool_with_the_jax_tokens(bundles, tmp_path):
    """The default decode model and an alt one (other weights, the same
    geometry) on ONE paged pool, 8 concurrent /generate requests split
    across X-Model: each model's tokens equal the JAX model's greedy tokens,
    logits within the decode gate, bit-equal to the same model alone; the
    pool is idle after."""
    da, db, _ = bundles
    weights = {seed: make_toy_decode_weights(seed=seed, **GEOM) for seed in (7, 11)}
    paths = {seed: save_decode_weights(str(tmp_path / f"w{seed}.npz"), w)
             for seed, w in weights.items()}
    manifest = _manifest(db, qos=False)
    manifest["models"][0]["decode_weights"] = paths[11]
    with _Server(da, decode_weights=paths[7], kv_profile="smoke", registry=manifest) as s:
        rt = s.srv._registry.get("alt")
        assert rt.decode is not None and rt.decode.cache is s.srv._decode.cache
        assert rt.decode.owns_cache is False and s.srv._decode.owns_cache is True
        jobs = [(seed, p) for p in PROMPTS for seed in (7, 11)]
        replies = [None] * len(jobs)

        def send(i):
            seed, prompt = jobs[i]
            buf = io.BytesIO()
            np.savez(buf, tokens=np.asarray(prompt, np.int32), max_new=np.int32(MAX_NEW))
            headers = {"Content-Type": "application/npz"}
            if seed == 11:
                headers["X-Model"] = "alt"
            replies[i] = s.post("/generate", buf.getvalue(), headers)

        threads = [threading.Thread(target=send, args=(i,), daemon=True)
                   for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        c = s.srv._decode.cache.counters.snapshot()
        assert c["kv_pages_in_use"] == 0 and c["kv_decode_streams"] == 0
        assert rt.counters().get("serve_generate_requests", 0) == len(PROMPTS)
    alone = {seed: DecodeService(ToyDecodeModel(w, device="cpu")) for seed, w in weights.items()}
    try:
        for (seed, prompt), (code, _, body) in zip(jobs, replies):
            assert code == 200, body
            got = _arrays(body)
            jt, jl = _jax_greedy(weights[seed], prompt, MAX_NEW)
            assert got["tokens"].tolist() == jt.tolist(), (seed, prompt)
            np.testing.assert_allclose(got["logits"], jl, **DECODE_TOL)
            at, al = alone[seed].generate(np.asarray(prompt, np.int32), MAX_NEW)
            assert np.array_equal(got["tokens"], at) and got["logits"].tobytes() == al.tobytes()
    finally:
        for svc in alone.values():
            svc.close()
    # the two models give other tokens on at least one prompt: the routing
    # really reached the alt weights
    assert any(_arrays(replies[2 * i][2])["tokens"].tolist()
               != _arrays(replies[2 * i + 1][2])["tokens"].tolist() for i in range(len(PROMPTS)))


def test_shared_pool_geometry_mismatch_raises_and_close_keeps_the_pool():
    small = ToyDecodeModel(make_toy_decode_weights(seed=7), device="cpu")
    wide = ToyDecodeModel(make_toy_decode_weights(seed=7, **GEOM), device="cpu")
    owner = DecodeService(wide, num_pages=8, page_len=8, pages_per_seq=2)
    try:
        with pytest.raises(ValueError, match="geometry mismatch"):
            DecodeService(small, cache=owner.cache)
        guest = DecodeService(wide, cache=owner.cache)
        guest.close()
        toks, _ = owner.generate(np.asarray([1, 2], np.int32), 3)
        assert toks.shape == (3,) and owner.cache.free_pages() == 8
    finally:
        owner.close()


def test_registry_cli_posts_deploy(bundles):
    da, db, dc = bundles
    with _Server(da, registry=_manifest(db, qos=False)) as s:
        assert treg.main(["deploy", "--url", s.base, "--name", "alt", "--version", "v2",
                          "--bundle-dir", dc, "--no-drift-gate"]) == 0
        assert s.srv._registry.get("alt").version == "v2"
        assert treg.main(["deploy", "--url", s.base, "--name", "ghost",
                          "--version", "v1"]) == 1


def test_deploys_under_load_lose_no_request(bundles):
    """16 client threads (more than the cores) on alt while four deploys
    swap its version, with a short switch interval: every reply is 200 and
    one of the two versions' bits, and every in-flight count returns to 0
    (a request that resolved a version retired before its admission runs on
    the live one)."""
    import sys

    da, db, dc = bundles
    with _Server(da, registry=_manifest(db, qos=True)) as s:
        _, _, ref_b = s.predict({"X-Model": "alt"})
        s.srv._registry.deploy("alt", "probe", dc, tolerance=None)
        _, _, ref_c = s.predict({"X-Model": "alt"})
        codes, bodies, halt, lock = [], set(), threading.Event(), threading.Lock()

        def client():
            while not halt.is_set():
                code, _, body = s.predict({"X-Model": "alt", "X-Tenant": "t-gold"})
                with lock:
                    codes.append(code)
                    bodies.add(body)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=client, daemon=True) for _ in range(16)]
        try:
            for t in threads:
                t.start()
            for i, d in enumerate((db, dc, db, dc)):
                s.srv._registry.deploy("alt", f"v{i + 2}", d, tolerance=None)
        finally:
            halt.set()
            for t in threads:
                t.join(timeout=60)
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert codes and set(codes) == {200}
        assert bodies <= {ref_b, ref_c}
        reg = s.srv._registry
        _wait_until(lambda: _settled(s.srv), "every in-flight count to reach 0")
        assert s.srv._inflight == 0 and reg.default_inflight == 0
        assert reg.get("alt").inflight == 0 and reg.get("alt").version == "v5"
        assert s.srv.counters()["serve_deploy_unloads"] == 5
