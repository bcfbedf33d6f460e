"""Multi-model serving: a registry of named, versioned predictor bundles
behind ONE InferenceServer, with hot-swap deploys and per-tenant QoS
scheduling; the port of `paddle_tpu/inference/registry.py`.

- **ModelRegistry** loads N `save_inference_model` bundles per replica from
  a manifest (`model_registry.json`), each on the server's device (the card
  unless the server runs on the CPU):

      {"default": "main",             # name the built-in model answers to
       "default_version": "v1",
       "models": [{"name": "alt", "version": "v1",
                   "bundle_dir": "path/to/bundle",
                   "warmup_feeds": null,          # or {feed: {shape, dtype}}
                   "max_queue": 16,
                   "batch_window_ms": 0,          # per-model coalescing
                   "bucket_table": null,          # per-model bucket table
                   "decode_weights": null}],      # enables /generate
       "qos": {"classes": {"gold": {"weight": 8, "deadline_ms": 250},
                           "bulk": {"weight": 1}},
               "tenants": {"tenant-a": "gold"},
               "default_class": "bulk"}}

  `/predict` and `/generate` take an `X-Model` header; a request without
  it (or naming the manifest's `default`) takes the server's built-in path
  byte for byte; an unknown name is a 404 NoSuchModel. Each extra model is
  a ModelRuntime: its own predictor, admission cap, circuit breaker,
  dispatch-ms EWMA (so its own Retry-After), counters and optional
  RequestCoalescer over a per-(model, version) bucket table.

- **Hot-swap deploys**: `deploy(name, version, bundle_dir)` loads and warms
  the new bundle next to the old one, verifies it (finite outputs on a
  seeded probe, and drift against the live version within the int8
  export's gate, max |new - old| / (max |old| + 1e-12) <= tolerance), then
  flips the registry's pointer, drains the old runtime to zero in flight
  and unloads it: its predictor's tensors are dropped at once, so the card
  gets the old version's memory back while the new one serves. An abort
  anywhere before the flip, the chaos sites `registry.load` (before the
  bundle load) and `registry.cutover` (after verify, before the flip)
  included, leaves the old version authoritative.

- **QoS**: `X-Tenant` maps to a class; a class carries a scheduling
  `weight` and a default `deadline_ms` (applied when the client sends no
  X-Deadline-Ms). Dispatch is arbitrated by ONE WeightedDeficitGate shared
  by every model on the replica (deficit round-robin over per-class queues
  at the device boundary): a weight-1 flood on one model cannot starve a
  weight-8 tenant on it or on another, while per-model admission caps and
  breakers keep one wedged model's backlog out of a neighbour's queue.

Decode models named in the manifest share the server's paged KV pool when
their geometry matches it (heads, head width, device): the paged step
writes only its own streams' pages, inactive rows go to the scratch page.

Counters: the server gains serve_deploys / serve_deploy_failures /
serve_deploy_unloads; each ModelRuntime keeps its own serve_* family
(requests, shed, batches, the dispatch EWMA gauge, ...) in the /healthz
`models` block.

Differences from the JAX module: manifests are read as JSON directly, with
no provenance record (the port has no `analysis/artifacts.py` yet, ROADMAP
Queue 1 item 11); int8 bundles are served as fp32 bundles are (their
loading is Queue 1 item 10), and `quantized` is reported from
`quant_meta.json` as there. A retired or refused version is unloaded at
once (the JAX runtime keeps a working predictor until the garbage
collector takes it), so the server admits a request that resolved a
version retired before its admission into the live one.

CLI: `python -m paddle_tpu_torch.inference.registry deploy --url URL
--name N --version V [--bundle-dir D]` posts /admin/deploy to a replica.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import threading
import time
from collections import deque

import numpy as np

from ..resilience.faults import fault_point
from .server import InferenceServer, RequestCoalescer, _load_json_table, load_bucket_table

__all__ = ["ModelRegistry", "ModelRuntime", "QosConfig",
           "WeightedDeficitGate", "DEFAULT_MANIFEST_NAME",
           "load_qos_config", "main"]

#: conventional manifest filename
DEFAULT_MANIFEST_NAME = "model_registry.json"

# request-scoped QoS class, set by the HTTP handler before it enters a
# model's dispatch path and read by the WeightedDeficitGate when the
# predictor gate is contended (a coalescer leader dispatches under its own
# class; members ride the leader's dispatch, the usual continuous-batching
# approximation)
_REQUEST_TLS = threading.local()


def set_request_class(cls):
    _REQUEST_TLS.cls = cls


def clear_request_class():
    _REQUEST_TLS.cls = None


def current_request_class():
    return getattr(_REQUEST_TLS, "cls", None)


class WeightedDeficitGate:
    """Deficit-round-robin mutex: ONE holder at a time, but when contended
    the next holder is picked by DRR over per-class FIFO queues. Each visit
    to a non-empty class adds its weight to a deficit counter and the class
    serves while the deficit affords whole requests (cost 1), so long-run
    grant shares converge to the weight ratio and a low-weight flood cannot
    starve a high-weight class. An uncontended acquire takes the fast path
    (no queueing, no deficit spent): an idle gate behaves like a Lock.

    Context-manager use reads the requester's class from the request-scoped
    thread local (set_request_class), so the gate drops in where a plain
    predictor Lock lives.
    """

    def __init__(self, weights, default_class=None):
        if not weights:
            raise ValueError("WeightedDeficitGate needs >= 1 class")
        self._weights = {str(c): max(float(w), 1e-9) for c, w in weights.items()}
        self._order = sorted(self._weights)
        if default_class is not None and default_class not in self._weights:
            raise ValueError(
                f"default_class {default_class!r} is not a declared "
                f"class (have {self._order})")
        self.default_class = default_class or self._order[0]
        self._cv = threading.Condition()
        self._queues = {c: deque() for c in self._order}
        self._deficit = {c: 0.0 for c in self._order}
        self._ptr = 0
        self._busy = False
        self._grant = None
        self._grants = {c: 0 for c in self._order}

    def acquire(self, cls=None):
        c = cls if cls in self._weights else self.default_class
        with self._cv:
            if not self._busy:
                # invariant: _busy False implies every queue is empty
                # (release always grants when a waiter exists)
                self._busy = True
                self._grants[c] += 1
                return
            me = object()
            self._queues[c].append(me)
            while self._grant is not me:
                self._cv.wait()
            self._grant = None
            self._grants[c] += 1

    def release(self):
        with self._cv:
            nxt = self._pick_locked()
            if nxt is None:
                self._busy = False
            else:
                self._grant = nxt  # _busy stays True: ownership handoff
            self._cv.notify_all()

    def _pick_locked(self):
        """DRR scan: serve the pointed class while its deficit affords a
        request; otherwise credit its weight and advance. An emptied class
        forfeits its unused deficit (credit never accrues while idle)."""
        if not any(self._queues.values()):
            return None
        n = len(self._order)
        while True:
            c = self._order[self._ptr % n]
            q = self._queues[c]
            if not q:
                self._deficit[c] = 0.0
                self._ptr += 1
                continue
            if self._deficit[c] >= 1.0:
                self._deficit[c] -= 1.0
                return q.popleft()
            self._deficit[c] += self._weights[c]
            self._ptr += 1

    def __enter__(self):
        self.acquire(current_request_class())
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def snapshot(self):
        """Grants per class."""
        with self._cv:
            return dict(self._grants)


class QosConfig:
    """The manifest's parsed `qos` block: deadline classes, the tenant ->
    class map and the DRR weights the gate schedules by."""

    def __init__(self, raw=None):
        raw = raw or {}
        self.classes = {}
        for name, spec in (raw.get("classes") or {}).items():
            spec = spec or {}
            self.classes[str(name)] = {
                "weight": float(spec.get("weight", 1.0)),
                "deadline_ms": float(spec.get("deadline_ms", 0) or 0),
            }
        self.tenants = {str(t): str(c) for t, c in (raw.get("tenants") or {}).items()}
        unknown = sorted(set(self.tenants.values()) - set(self.classes))
        if unknown:
            raise ValueError(
                f"qos tenants map to undeclared classes {unknown} "
                f"(declared: {sorted(self.classes)})")
        self.default_class = raw.get("default_class") or (
            sorted(self.classes)[0] if self.classes else None)
        if self.default_class is not None and self.default_class not in self.classes:
            raise ValueError(
                f"qos default_class {self.default_class!r} is not a "
                f"declared class (have {sorted(self.classes)})")

    @property
    def enabled(self):
        return bool(self.classes)

    def class_of(self, tenant):
        if tenant and tenant in self.tenants:
            return self.tenants[tenant]
        return self.default_class

    def deadline_ms(self, cls):
        spec = self.classes.get(cls)
        return spec["deadline_ms"] if spec else 0.0

    def weights(self):
        return {n: c["weight"] for n, c in self.classes.items()}

    def bulk_classes(self):
        """The classes whose weight is below the largest: the tenants a
        fleet's brownout demotes and sheds first. One declared class means
        nobody is bulk."""
        if not self.classes:
            return set()
        top = max(c["weight"] for c in self.classes.values())
        return {n for n, c in self.classes.items() if c["weight"] < top}

    def make_gate(self):
        """A predictor gate: DRR when classes are declared, a plain Lock
        otherwise (the same uncontended cost)."""
        if self.enabled:
            return WeightedDeficitGate(self.weights(), self.default_class)
        return threading.Lock()


def load_qos_config(manifest):
    """The `qos` block of a registry manifest as a QosConfig. Any read or
    parse failure gives a disabled QosConfig: a router's tenant classing is
    an optimisation, never a reason not to route."""
    try:
        return QosConfig((_load_json_table(manifest) or {}).get("qos"))
    except Exception:  # noqa: BLE001 — classing is best-effort
        return QosConfig(None)


def _probe_feed(rt, batch=4, seed=0):
    """Seeded verification feed, as the int8 export probes: floats ~U(0, 1);
    integer and bool feeds zeros (in range for any gather or embedding)."""
    rng = np.random.RandomState(seed)
    blk = rt._predictor.program().global_block()
    feeds = {}
    for name in rt._feed_names:
        try:
            v = blk.var(name)
            shape = [batch if d is None or int(d) <= 0 else int(d) for d in v.shape]
            dt = str(v.dtype)
        except Exception:  # noqa: BLE001 — shape metadata is best-effort
            shape, dt = [batch], "float32"
        if dt.startswith(("int", "uint", "bool")):
            feeds[name] = np.zeros(shape or [batch], dt)
        else:
            feeds[name] = rng.rand(*(shape or [batch])).astype(dt)
    return feeds


class ModelRuntime:
    """One named, versioned bundle behind the server: its own
    AnalysisPredictor on the server's device, admission cap, circuit
    breaker, dispatch-ms EWMA, counters, optional coalescer and optional
    decode service.

    It carries the attributes of InferenceServer that the dispatch
    machinery touches (`_feed_names`, `_fetch_names`, `_predictor`,
    `_lock`, `_breaker`, `_stopped`, `_synthetic_ok`, `_ewma_lock`,
    `_coalescer`, `_batchable`, `_bump`, `_gauge`, `_note_dispatch_ms`,
    `_synthetic_feeds`, `probe_interval_s`), so the server's `predict`,
    batch key, batchability probe, warmup and breaker recovery apply to it
    unbound: the multi-model path cannot drift from the single-model one."""

    def __init__(self, name, version, bundle_dir, *, server,
                 max_queue=16, batch_window_ms=0.0, bucket_table=None,
                 warmup_feeds=None, breaker_threshold=5,
                 probe_interval_s=0.5, qos=None, gate=None,
                 decode_weights=None, shared_kv_cache=None, warmup=True):
        from ..resilience import CircuitBreaker
        from . import AnalysisConfig, create_paddle_predictor

        self.name = str(name)
        self.version = str(version)
        self.bundle_dir = str(bundle_dir)
        self._server = server
        config = AnalysisConfig(self.bundle_dir)
        if server.device == "cpu":
            config.disable_gpu()
        self._predictor = create_paddle_predictor(config)
        self._feed_names = list(self._predictor.get_input_names())
        self._fetch_names = list(self._predictor.get_output_names())
        self.quantized = os.path.exists(os.path.join(self.bundle_dir, "quant_meta.json"))
        self._warmup_spec = dict(warmup_feeds or {})

        # the predictor gate: the registry's replica-wide DRR gate when QoS
        # is configured, else a private Lock; the borrowed predict takes it
        # as `self._lock`
        self.qos = qos if isinstance(qos, QosConfig) else QosConfig(qos)
        self._lock = gate if gate is not None else self.qos.make_gate()

        # admission and drain-rate state. `inflight` and `retired` are
        # guarded by the SERVER's admission condition (one condition for
        # every model keeps the drain precise); the EWMA has its own lock
        self.max_queue = max(int(max_queue), 1)
        self.inflight = 0
        self.retired = False
        self._dispatch_ms_ewma = None
        self._ewma_lock = threading.Lock()
        self.probe_interval_s = float(probe_interval_s)
        self._breaker = CircuitBreaker(breaker_threshold, probe_interval_s)
        self._synthetic_ok = False
        self._stopped = threading.Event()

        # per-model counters: a locked dict, not a CounterSet (the model
        # families must not roll up into the process-wide names the server
        # already feeds)
        self._counters = {}
        self._counters_lock = threading.Lock()

        # per-(model, version) bucket table: the manifest's path, else a
        # bucket_table.json inside the bundle, else the module's table
        self.batch_window_ms = float(batch_window_ms or 0.0)
        self._coalescer = None
        self._batchable = False
        if self.batch_window_ms > 0:
            path = bucket_table
            if path is None:
                cand = os.path.join(self.bundle_dir, "bucket_table.json")
                path = cand if os.path.exists(cand) else None
            table = load_bucket_table(path, signature=self.artifact_signature(
                os.path.basename(path) if path else "bucket_table.json"))
            self._coalescer = RequestCoalescer(self, self.batch_window_ms, table)

        # optional generative path (/generate with X-Model), on the
        # server's paged KV pool when the geometry and device match
        self.decode = None
        if decode_weights:
            from .decode_model import DecodeService, ToyDecodeModel, load_decode_weights

            model = ToyDecodeModel(load_decode_weights(decode_weights), device=server.device)
            cache = None
            if shared_kv_cache is not None and (
                    int(shared_kv_cache.shape[2]), int(shared_kv_cache.shape[3]),
                    shared_kv_cache.device) == (model.num_heads, model.head_dim,
                                                model.device):
                cache = shared_kv_cache
            self.decode = DecodeService(model, cache=cache)

        if warmup:
            self._warmup()
        if self._coalescer is not None:
            self._probe_batchable()

    # the server's single-model implementations, unbound: the attribute
    # contract above makes them apply as they are
    predict = InferenceServer.predict
    _batch_key = InferenceServer._batch_key
    _probe_batchable = InferenceServer._probe_batchable
    _warmup = InferenceServer._warmup
    _probe_loop = InferenceServer._probe_loop
    _note_predict_failure = InferenceServer._note_predict_failure
    _note_predict_success = InferenceServer._note_predict_success
    _note_dispatch_ms = InferenceServer._note_dispatch_ms

    def artifact_signature(self, basename):
        return f"{self.name}@{self.version}:{basename}"

    # -- counters ---------------------------------------------------------
    def _bump(self, name, amount=1):
        with self._counters_lock:
            self._counters[name] = self._counters.get(name, 0) + amount

    def _gauge(self, name, value):
        with self._counters_lock:
            self._counters[name] = value

    def counters(self):
        with self._counters_lock:
            return dict(self._counters)

    # -- dispatch plumbing -------------------------------------------------
    def _synthetic_feeds(self):
        """The manifest's warmup_feeds, else zeros shaped from the feed vars
        (the server's recipe)."""
        base = InferenceServer._synthetic_feeds(self)
        if not self._warmup_spec:
            return base
        feeds = {}
        for n in self._feed_names:
            spec = self._warmup_spec.get(n)
            if not isinstance(spec, dict):
                feeds[n] = base[n]
                continue
            shape = [int(d) for d in (spec.get("shape") or [1])]
            feeds[n] = np.zeros(shape or [1], np.dtype(str(spec.get("dtype", "float32"))))
        return feeds

    def retry_after(self):
        """Retry-After of this model's shed: THIS model's queue depth x THIS
        model's dispatch EWMA, clamped to [1, 30] s, so a slow neighbour
        does not inflate the backoff of this model's clients."""
        with self._ewma_lock:
            ewma = self._dispatch_ms_ewma
        depth = self.inflight
        if not ewma or depth <= 0:
            return 1
        return max(1, min(30, int(math.ceil(depth * ewma / 1000.0))))

    # -- lifecycle --------------------------------------------------------
    def close(self):
        """Stop the probe loop and the decode driver, flush the coalescer,
        and drop the predictor's tensors and the decode service (its model,
        and its pool where it owns one) now: an unloaded version gives its
        device memory back at once."""
        self.retired = True
        self._stopped.set()
        if self._coalescer is not None:
            self._coalescer.flush_all()
        if self.decode is not None:
            self.decode.close()
            self.decode = None
        self._predictor.close()

    def snapshot(self):
        with self._ewma_lock:
            ewma = self._dispatch_ms_ewma
        snap = {
            "version": self.version,
            "bundle_dir": self.bundle_dir,
            "quantized": self.quantized,
            "inflight": self.inflight,
            "max_queue": self.max_queue,
            "breaker_open": self._breaker.open,
            "batch_window_ms": (self.batch_window_ms if self._coalescer is not None else 0),
            "dispatch_ms_ewma": (round(float(ewma), 3) if ewma is not None else None),
            "generative": self.decode is not None,
            "counters": self.counters(),
        }
        if isinstance(self._lock, WeightedDeficitGate):
            # the replica-wide gate's grants per class (shared by every model)
            snap["qos_grants"] = self._lock.snapshot()
        return snap


class ModelRegistry:
    """The server-side model table: resolves X-Model / X-Tenant to
    (ModelRuntime, QoS class), serves the /healthz `models` block, and owns
    the hot-swap deploy (load -> warm -> verify -> atomic cutover -> drain
    -> unload; an abort anywhere before the flip keeps the old version)."""

    def __init__(self, server, manifest, *, warmup=True):
        self._server = server
        if isinstance(manifest, str):
            raw = _load_json_table(manifest)
            base = os.path.dirname(os.path.abspath(manifest))
        else:
            raw = dict(manifest or {})
            base = os.getcwd()
        if not isinstance(raw, dict):
            raise ValueError("model registry manifest must be a JSON "
                             f"object, got {type(raw).__name__}")

        self.default_name = str(raw.get("default") or "default")
        self.default_version = str(raw.get("default_version") or "v0")
        self.qos = QosConfig(raw.get("qos"))
        self._lock = threading.Lock()  # the active-models pointer map
        self._deploy_lock = threading.Lock()  # serialises deploys
        # the built-in model's own admission depth (guarded by the server's
        # admission condition, like every runtime's `inflight`): a
        # neighbour's flood cannot take the default's queue
        self.default_inflight = 0
        # ONE dispatch gate for the replica when QoS is on: the replica
        # drives one device, so per-model gates would leave cross-model
        # order to the OS. It replaces the built-in model's Lock here
        # (inside the server's __init__, before serving starts) and every
        # ModelRuntime receives the same instance
        self.gate = self.qos.make_gate() if self.qos.enabled else None
        if self.gate is not None:
            server._lock = self.gate

        self._models = {}
        for entry in raw.get("models") or []:
            if not isinstance(entry, dict):
                raise ValueError(f"manifest model entry must be an object, got {entry!r}")
            missing = [k for k in ("name", "version", "bundle_dir") if k not in entry]
            if missing:
                raise ValueError(f"manifest model entry missing {missing[0]!r} "
                                 "(need name, version, bundle_dir)")
            name, version = str(entry["name"]), str(entry["version"])
            if name == self.default_name or name in self._models:
                raise ValueError(f"duplicate model name {name!r} in manifest "
                                 f"(default is {self.default_name!r})")
            self._models[name] = self._build_runtime(name, version, entry, base,
                                                     warmup=warmup)

    def _build_runtime(self, name, version, entry, base, warmup=True):
        bundle = str(entry["bundle_dir"])
        if not os.path.isabs(bundle):
            bundle = os.path.join(base, bundle)
        dw = entry.get("decode_weights")
        if dw and not os.path.isabs(dw):
            dw = os.path.join(base, dw)
        srv = self._server
        shared_cache = srv._decode.cache if srv._decode is not None else None
        return ModelRuntime(
            name, version, bundle, server=srv,
            max_queue=int(entry.get("max_queue", srv.max_queue)),
            batch_window_ms=float(entry.get("batch_window_ms", 0) or 0),
            bucket_table=entry.get("bucket_table"),
            warmup_feeds=entry.get("warmup_feeds"),
            breaker_threshold=int(entry.get("breaker_threshold", 5)),
            qos=self.qos,
            gate=self.gate,
            decode_weights=dw,
            shared_kv_cache=shared_cache,
            warmup=warmup,
        )

    # -- request resolution ------------------------------------------------
    def names(self):
        with self._lock:
            return sorted(self._models)

    def get(self, name):
        with self._lock:
            return self._models.get(name)

    def resolve_request(self, headers):
        """(runtime | None, qos_class | None) for one request's headers. A
        None runtime is the server's built-in model (the byte-identical
        default path). An unknown X-Model raises KeyError (the 404)."""
        cls = self.qos.class_of(headers.get("X-Tenant"))
        name = headers.get("X-Model")
        if not name or name == self.default_name:
            return None, cls
        rt = self.get(name)
        if rt is None:
            raise KeyError(f"no such model {name!r} (serving "
                           f"{[self.default_name] + self.names()})")
        return rt, cls

    # -- deploys -----------------------------------------------------------
    def deploy(self, name, version, bundle_dir=None, *, tolerance=0.01, entry=None):
        """Hot-swap `name` to `version` from `bundle_dir` (default: the live
        bundle, under a new label). The new runtime is loaded and warmed
        NEXT TO the old one, which keeps serving; verified on a seeded probe
        (finite outputs, and drift against the old version within
        `tolerance` by the int8 export gate's formula; None skips the drift
        bound); then the pointer flips, and the old runtime is drained to
        zero in flight and unloaded. ANY failure or abort before the flip,
        the registry.load / registry.cutover chaos sites included, leaves
        the old version authoritative and serving."""
        srv = self._server
        with self._deploy_lock:
            name = str(name)
            if name == self.default_name:
                raise KeyError(
                    f"model {name!r} is the built-in default: redeploy it "
                    "with a rolling restart, not a registry hot-swap")
            old = self.get(name)
            if bundle_dir is None:
                if old is None:
                    raise KeyError(
                        f"no such model {name!r} and no bundle_dir given: "
                        "a new model cannot be deployed without its bundle")
                bundle_dir = old.bundle_dir
            srv._bump("serve_deploys")
            rt = None
            try:
                fault_point("registry.load")
                spec = dict(entry or {})
                spec.update(name=name, version=str(version), bundle_dir=str(bundle_dir))
                if old is not None:
                    spec.setdefault("max_queue", old.max_queue)
                    spec.setdefault("batch_window_ms", old.batch_window_ms)
                rt = self._build_runtime(name, str(version), spec, os.getcwd(), warmup=True)
                self._verify(rt, old, tolerance)
                fault_point("registry.cutover")
            except BaseException:
                srv._bump("serve_deploy_failures")
                if rt is not None:  # the candidate's memory goes back at once
                    rt.close()
                raise
            with self._lock:
                self._models[name] = rt
            if old is not None:
                self._drain_and_unload(old)
            return {"name": name, "version": str(version), "bundle_dir": str(bundle_dir)}

    def _verify(self, rt, old, tolerance):
        """The candidate's acceptance probe: finite outputs, and where an
        old version with the same interface is live, drift within the int8
        export's gate (max |new - old| / (max |old| + 1e-12) <= tolerance)."""
        from ..streaming.export_int8 import ExportToleranceError

        feeds = _probe_feed(rt)
        got = rt.predict(feeds)
        for k, v in got.items():
            arr = np.asarray(v)
            if arr.dtype.kind == "f" and not np.all(np.isfinite(arr)):
                raise ValueError(f"deploy verify: candidate {rt.name}@{rt.version} "
                                 f"produced non-finite values in fetch {k!r}")
        if old is None or tolerance is None:
            return
        # feed names must match (the probe and every client key by them);
        # fetches compare by position: a rebuilt bundle's generated temp
        # names may differ where the math does not
        if (old._feed_names != rt._feed_names
                or len(old._fetch_names) != len(rt._fetch_names)):
            raise ValueError(
                f"deploy verify: {rt.name}@{rt.version} changed the model "
                f"interface (feeds {old._feed_names} -> {rt._feed_names}, "
                f"{len(old._fetch_names)} -> {len(rt._fetch_names)} fetches): "
                "drift is incomparable; pass tolerance=None to deploy an "
                "interface change")
        ref = old.predict(feeds)
        drift = 0.0
        for ok, nk in zip(old._fetch_names, rt._fetch_names):
            r = np.asarray(ref[ok], np.float64)
            g = np.asarray(got[nk], np.float64)
            denom = float(np.max(np.abs(r))) + 1e-12
            drift = max(drift, float(np.max(np.abs(g - r))) / denom)
        if drift > float(tolerance):
            raise ExportToleranceError(
                f"deploy verify: {rt.name}@{rt.version} drifted {drift:.4%} "
                f"from the live {old.version} on the probe batch (tolerance "
                f"{float(tolerance):.2%}): old version stays authoritative")

    def _drain_and_unload(self, old):
        """Wait the retired runtime's in-flight count down to zero (bounded
        by the server's drain timeout, SIGTERM's budget), mark it retired
        under the admission condition, so that a request which resolved it
        before the flip is admitted into the live version instead, then
        unload it."""
        srv = self._server
        deadline = time.monotonic() + srv.drain_timeout_s
        with srv._gate:
            while old.inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                srv._gate.wait(min(left, 0.05))
            old.retired = True
        old.close()
        srv._bump("serve_deploy_unloads")

    # -- observability ----------------------------------------------------
    def models_block(self):
        """The /healthz `models` payload: the built-in default and every
        registered runtime, each with version, inflight, EWMA, counters."""
        srv = self._server
        with srv._ewma_lock:
            ewma = srv._dispatch_ms_ewma
        out = {
            self.default_name: {
                "version": self.default_version,
                "bundle_dir": srv._model_dir,
                "quantized": srv._quantized,
                "inflight": self.default_inflight,
                "max_queue": srv.max_queue,
                "breaker_open": srv._breaker.open,
                "batch_window_ms": (srv.batch_window_ms if srv._coalescer is not None else 0),
                "dispatch_ms_ewma": (round(float(ewma), 3) if ewma is not None else None),
                "generative": srv._decode is not None,
                "default": True,
            }
        }
        if self.qos.enabled and isinstance(srv._lock, WeightedDeficitGate):
            out[self.default_name]["qos_grants"] = srv._lock.snapshot()
        with self._lock:
            models = dict(self._models)
        for name, rt in sorted(models.items()):
            out[name] = rt.snapshot()
        return out

    def close(self):
        with self._lock:
            models, self._models = dict(self._models), {}
        for rt in models.values():
            rt.close()


def main(argv=None):
    """Deploy CLI: posts /admin/deploy to a replica."""
    import urllib.error
    import urllib.request

    ap = argparse.ArgumentParser(prog="paddle_tpu_torch.inference.registry",
                                 description="multi-model registry operations")
    sub = ap.add_subparsers(dest="cmd", required=True)
    dp = sub.add_parser("deploy", help="hot-swap a model version on a replica")
    dp.add_argument("--url", required=True,
                    help="base URL of a replica, e.g. http://127.0.0.1:8500")
    dp.add_argument("--name", required=True, help="registered model name")
    dp.add_argument("--version", required=True, help="new version label")
    dp.add_argument("--bundle-dir", default=None,
                    help="bundle directory (default: redeploy the current "
                    "bundle under the new version label)")
    dp.add_argument("--tolerance", type=float, default=0.01,
                    help="max probe drift against the live version (the int8 "
                    "export's gate; default 1%%)")
    dp.add_argument("--no-drift-gate", action="store_true",
                    help="skip the drift bound (an intended change of the "
                    "math); the finite-output probe still runs")
    args = ap.parse_args(argv)

    body = json.dumps({
        "name": args.name,
        "version": args.version,
        "bundle_dir": args.bundle_dir,
        "tolerance": None if args.no_drift_gate else args.tolerance,
    }).encode("utf-8")
    req = urllib.request.Request(args.url.rstrip("/") + "/admin/deploy", data=body,
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            print(r.read().decode("utf-8", "replace"))
            return 0
    except urllib.error.HTTPError as e:
        print(e.read().decode("utf-8", "replace"))
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
