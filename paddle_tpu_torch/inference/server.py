"""Out-of-process inference serving over HTTP: the port of
`paddle_tpu/inference/server.py`.

`python -m paddle_tpu_torch.inference.server --model-dir D` loads a
`save_inference_model` export (either package's) into an
AnalysisPredictor, on the card unless `--device cpu`, and serves:

    POST /predict   body: .npz archive of {feed_name: array}
                    reply: 200 .npz archive of {fetch_name: array}, or a
                    JSON error body {"error": <class>, "message": ...}
                    with 400 (bad npz / wrong feed names), 411 (chunked
                    body), 413 (body over the cap), 503 + Retry-After
                    (queue full, breaker open, or draining), 504
                    (X-Deadline-Ms exceeded), 500 (predictor raise)
    GET  /healthz   200 {"status": "ok", ...} serving normally; 503
                    {"status": "breaker_open" | "draining"} tells a load
                    balancer to stop routing here. Carries queue_depth /
                    max_queue and a `counters` block (this instance's
                    serve_* and kv_* counters, uptime_s, inflight).
    POST /prefill, /decode, /generate   the generative roles (below)
    POST /admin/deploy   body JSON {name, version, bundle_dir?, tolerance?}:
                    hot-swaps one registry model (below). 200 {status:
                    "active"}; 404 NoRegistry (a closing reply) without a
                    registry, 404 NoSuchModel, 400 (bad body), 413, 409
                    ExportToleranceError (drift gate), 500 (load / verify /
                    chaos abort: the old version stays)

Handshake: `--ready-file PATH` writes {"port", "pid", "warmup_ms"} by
temp file + os.replace once the listener is bound and warmup has run.

Continuous batching: with `--batch-window-ms` > 0 the RequestCoalescer
holds admitted /predict requests for a bounded window, buckets them by
their per-feed non-batch shapes, merges each bucket into ONE padded
predictor dispatch (pad rows join the dispatch, never a reply) and fans
the row slices back out. Padded row counts come from
`bucket_table.json` next to this module (the JAX package's table,
copied). A request whose remaining X-Deadline-Ms budget cannot afford
the window never waits it out: it dispatches solo at once, or joins an
open batch and closes it now. Coalescing needs a batch placeholder on
every feed (`layers.data(name, [s])`); an export with a static leading
dim disables it loudly at startup. Row independence: on the CPU each
member's rows equal its batch-of-1 dispatch bit for bit (a test holds
this); on the card see the RequestCoalescer's docstring.

Robustness: at most `max_queue` requests are in flight past admission,
the rest shed with 503 and a Retry-After derived from the queue depth
times the dispatch EWMA (clamped to [1, 30] s); X-Deadline-Ms is checked
before dispatch and before the reply; Content-Length over the cap is a
closing 413 before the body is read; `breaker_threshold` consecutive
predictor failures trip /healthz to 503 and shed /predict until a
background synthetic probe succeeds (or, when synthetic feeds are not
known to work, one live trial per probe interval); one synthetic predict
warms the server at startup; SIGTERM / SIGINT flip /healthz to 503
first, shed new requests, let every in-flight request write its full
reply, then close the listener and exit 0.

Counters (per instance, rolled up into the global profiler names):
serve_requests, serve_shed, serve_deadline_exceeded, serve_breaker_open,
serve_breaker_trips, serve_breaker_recovered, serve_queue_depth (gauge),
serve_warmup_ms, serve_dispatch_ms_ewma (gauge), serve_drains; the
coalescer's serve_batches, serve_batch_members, serve_batch_size_p50
(gauge), serve_coalesce_wait_ms, serve_batch_padded_rows,
serve_coalesce_bypass, serve_bucket_overflow.

Chaos sites (resilience/faults.py): server.predict, server.dispatch,
server.probe, server.reply, server.batch.dispatch, server.prefill,
server.decode.

Generative roles: with `--decode-weights` the server carries the decode
model (decode_model.py) and `--role prefill|decode|unified` picks what it
serves:

    POST /prefill   npz {tokens, max_new} -> one handoff blob
                    (handoff.py: the prompt's chronological K/V rows and
                    cursor) with X-Handoff-Tokens (the final stream
                    length). Stateless: a rerun gives the same bytes.
    POST /decode    handoff blob -> npz {tokens, logits}: admits the
                    history into the paged KV cache and rides the decode
                    driver; 503 + Retry-After when page admission sheds;
                    X-KV-Free-Pages on every reply.
    POST /generate  npz {tokens, max_new} -> npz {tokens, logits}: local
                    prefill, the same decode driver (the unified path a
                    split reply equals bit for bit).

Role counters: serve_prefill_requests / _dispatches / _tokens,
serve_prefill_queued_tokens (gauge), serve_prefill_ms_ewma /
serve_decode_ms_ewma (gauges), serve_decode_requests,
serve_generate_requests; the paged cache's kv_* family is merged into
the /healthz counters block.

Multi-model serving: `--registry model_registry.json` (registry.py) loads
N extra named, versioned bundles on the server's device. `/predict` and
`/generate` take an `X-Model` header (absent or naming the manifest's
default: the byte-identical built-in path; unknown: 404 NoSuchModel), and
`X-Tenant` maps to a QoS class (one deficit-round-robin predictor gate for
every model, and the class's default deadline). Each model has its own
admission queue, circuit breaker, dispatch EWMA (so its own Retry-After),
counters and optional coalescer; decode models share the server's paged KV
pool. `POST /admin/deploy` hot-swaps one model's version, /healthz gains a
`models` block, and the chaos sites `registry.load` / `registry.cutover`
abort deploys. Deploy counters: serve_deploys, serve_deploy_failures,
serve_deploy_unloads. Without a registry X-Model and X-Tenant are ignored
and every reply is what a server without the feature gives.
"""

from __future__ import annotations

import argparse
import io as _bytesio
import json
import math
import os
import signal
import statistics
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import profiler
from ..resilience import CircuitBreaker, PreemptionHandler
from ..resilience.faults import fault_point
from . import AnalysisConfig, PaddleTensor, create_paddle_predictor

__all__ = ["InferenceServer", "JsonHandlerMixin", "RequestCoalescer",
           "load_bucket_table", "load_kv_page_table", "serve",
           "write_ready_file", "main"]

DEFAULT_BUCKET_TABLE = os.path.join(os.path.dirname(__file__),
                                    "bucket_table.json")
DEFAULT_KV_PAGE_TABLE = os.path.join(os.path.dirname(__file__),
                                     "kv_page_table.json")


class _DeadlineExceeded(Exception):
    """The request's X-Deadline-Ms budget ran out."""


class _Listener(ThreadingHTTPServer):
    """The stdlib threading server with a listen backlog sized for a burst
    of concurrent clients: its default of 5 pending connections reset the
    connects of 64 clients arriving at once."""

    request_queue_size = 1024


class JsonHandlerMixin:
    """HTTP plumbing: JSON replies with Retry-After / Connection-close
    handling, Content-Length parsing, exact body reads, quiet logging."""

    # HTTP/1.1 keeps connections alive; every reply sets Content-Length
    protocol_version = "HTTP/1.1"
    # replies go out as several small sends; Nagle would hold the later
    # ones for the peer's delayed ACK on a kept-alive connection
    disable_nagle_algorithm = True

    def log_message(self, *a):
        pass

    def _json(self, code, obj, retry_after=None, close=False):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", str(retry_after))
        if close:
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(body)

    def _content_length(self):
        """The Content-Length, or None after writing a closing 411 / 400
        (chunked bodies are not read; a negative length is refused)."""
        if self.headers.get("Transfer-Encoding"):
            self._json(411, {"error": "LengthRequired",
                             "message": "send Content-Length; chunked "
                                        "bodies are not supported"},
                       close=True)
            return None
        try:
            n = int(self.headers.get("Content-Length", 0) or 0)
        except (TypeError, ValueError):
            n = -1
        if n < 0:
            self._json(400, {"error": "ValueError",
                             "message": "Content-Length must be a "
                                        "non-negative integer"},
                       close=True)
            return None
        return n

    def _read_body(self, n):
        """Exactly n body bytes, or None after writing a closing 400."""
        try:
            body = self.rfile.read(n)
        except OSError as e:
            self._json(400, {"error": type(e).__name__, "message": str(e)},
                       close=True)
            return None
        if len(body) != n:
            self._json(400, {"error": "ValueError",
                             "message": f"body truncated: got {len(body)} of "
                                        f"{n} bytes"},
                       close=True)
            return None
        return body


def _load_json_table(path):
    """A table's (or a registry manifest's) JSON, read directly. The JAX
    loaders read it through `analysis/artifacts.load_artifact`, which also
    records the (backend, signature) provenance of the lookup; the port has
    no analysis package yet (ROADMAP Queue 1 item 11), so it records none."""
    with open(path) as f:
        return json.load(f)


def load_bucket_table(path=None, signature=None, backend_class=None):
    """Load and validate the shape-bucket table: {"default": [sizes...],
    "per_feed": {feed_name: [sizes...]}}. Sizes must be positive
    ascending ints; keys starting with "_" (comments) are ignored.
    `path=None` loads the table next to this module. Errors propagate:
    serving refuses to start on a missing or corrupt table. `signature` is
    the JAX loader's provenance key (the registry passes
    `name@version:<basename>`); with no provenance record to write it to
    (see `_load_json_table`) it is reported on the table as "signature".

    `backend_class` selects an overlay: when the table carries a
    `per_class` entry for the class, its default/per_feed replace the
    top-level ones (buckets tuned for one substrate are wrong for a
    slower overflow replica)."""
    raw = _load_json_table(path or DEFAULT_BUCKET_TABLE)
    if backend_class:
        cls_raw = (raw.get("per_class") or {}).get(str(backend_class))
        if isinstance(cls_raw, dict):
            raw = cls_raw

    def _sizes(val, where):
        sizes = [int(x) for x in val]
        if not sizes or any(s <= 0 for s in sizes) or sizes != sorted(set(sizes)):
            raise ValueError(
                f"bucket table {where}: sizes must be positive ascending "
                f"ints, got {val!r}")
        return sizes

    table = {"default": _sizes(raw.get("default") or [1], "default"),
             "per_feed": {}}
    for name, val in (raw.get("per_feed") or {}).items():
        if not str(name).startswith("_"):
            table["per_feed"][str(name)] = _sizes(val, f"per_feed[{name}]")
    if signature is not None:
        table["signature"] = str(signature)
    return table


def load_kv_page_table(path=None, profile="default"):
    """Load one profile of the page-pool sizing table
    (kv_page_table.json next to this module): {num_pages, page_len,
    pages_per_seq, max_streams, admission_window_ms}, read directly (no
    provenance record; see `_load_json_table`)."""
    raw = _load_json_table(path or DEFAULT_KV_PAGE_TABLE)
    prof = raw.get(profile)
    if not isinstance(prof, dict):
        have = sorted(k for k in raw if not str(k).startswith("_"))
        raise ValueError(
            f"kv page table has no profile {profile!r} (have {have})")
    cfg = {k: int(v) for k, v in prof.items()
           if not str(k).startswith("_")}
    for k in ("num_pages", "page_len", "pages_per_seq"):
        if cfg.get(k, 0) < 1:
            raise ValueError(
                f"kv page table profile {profile!r}: {k} must be a "
                f"positive int, got {cfg.get(k)!r}")
    return cfg


class _BatchMember:
    """One request riding a pending batch: its feeds, row span in the
    merged dispatch, deadline, and (after dispatch) its reply slices."""

    __slots__ = ("feeds", "rows", "offset", "deadline", "enqueued", "outs")

    def __init__(self, feeds, rows, deadline):
        self.feeds = feeds
        self.rows = rows
        self.offset = 0
        self.deadline = deadline
        self.enqueued = time.monotonic()
        self.outs = None


class _PendingBatch:
    """A forming batch for one bucket key. Members append under the
    coalescer's condition; the LEADER (the thread that opened it) waits
    out the window, seals, dispatches once, then releases everyone via
    `done`. `close_now` is the force-flush flag (bucket cap reached, or
    a deadline-tight member joined)."""

    __slots__ = ("key", "members", "rows", "created", "close_now", "done",
                 "error")

    def __init__(self, key):
        self.key = key
        self.members = []
        self.rows = 0
        self.created = time.monotonic()
        self.close_now = False
        self.done = threading.Event()
        self.error = None


class RequestCoalescer:
    """Deadline-aware admission gate that merges validated /predict
    requests into padded bucket-shaped batched dispatches — Fluid's
    batched-predictor economics (one program, one dispatch, many
    samples) applied ACROSS HTTP requests.

    Invariants:
    - a member's reply rows are its own rows of the merged dispatch (pad
      rows are dispatched and discarded). On the CPU they equal the
      batch-of-1 dispatch of its feeds bit for bit, as in the JAX
      package. On the card (an H100, BERT-base fp32 at s 128) they do not
      for a merged dispatch of 2 rows or more: cuBLAS picks other GEMM
      algorithms by the row count, and the rows move by up to ~4e-6 from
      batch-of-1. There the gate is that a reply equals its rows of a
      second dispatch of the same merged batch bit for bit (a dispatch is
      deterministic) and lies within atol 1e-4 of its batch-of-1
      dispatch;
    - a request whose remaining deadline budget cannot afford the
      window never waits: it dispatches solo, or joins an already-open
      batch and forces it to close immediately;
    - one predictor dispatch per sealed batch, one breaker/EWMA sample
      per dispatch (members never multiply-count a single failure).
    """

    # safety margin: a deadline is "tight" when its remaining budget is
    # under window + this slack (the dispatch itself still needs time)
    TIGHT_SLACK_S = 0.005

    def __init__(self, server, window_ms, table):
        self._srv = server
        self.window_s = max(float(window_ms), 0.0) / 1000.0
        self._table = table
        self._cv = threading.Condition()
        self._open = {}  # bucket key -> _PendingBatch (still joinable)
        self._recent_sizes = deque(maxlen=64)
        self._sizes_cache = {}

    # -- bucket table -----------------------------------------------------
    def allowed_sizes(self, key):
        """Padded row counts for this bucket key: the intersection of
        every member feed's per_feed list, else the default list."""
        cached = self._sizes_cache.get(key)
        if cached is not None:
            return cached
        per = self._table.get("per_feed") or {}
        base = None
        for name, _, _ in key:
            sizes = per.get(name)
            if sizes:
                s = set(sizes)
                base = s if base is None else (base & s)
        if base is not None and not base:
            # two per_feed lists with no common size is a CONFIG error:
            # padding from the default list would violate both feeds'
            # declared constraints — fail the request loudly instead
            raise ValueError(
                "bucket table per_feed lists for "
                f"{[n for n, _, _ in key]} have an empty intersection — "
                "fix inference/bucket_table.json")
        sizes = sorted(base) if base else list(self._table["default"])
        self._sizes_cache[key] = sizes
        return sizes

    def pad_target(self, key, rows):
        for s in self.allowed_sizes(key):
            if s >= rows:
                return s
        return rows  # beyond the largest bucket: dispatch exact rows

    def cap(self, key):
        return self.allowed_sizes(key)[-1]

    # -- introspection (tests + drain) ------------------------------------
    def pending_rows(self):
        with self._cv:
            return sum(b.rows for b in self._open.values())

    def flush_all(self):
        """Force every open batch to seal now (drain/shutdown path — a
        leader must not sit out its window while the server is going
        away)."""
        with self._cv:
            for b in self._open.values():
                b.close_now = True
            self._cv.notify_all()

    # -- the gate ---------------------------------------------------------
    def submit(self, key, feeds, rows, deadline):
        """Coalesce-and-dispatch for one validated request. Returns this
        request's {fetch: rows-slice} dict; raises exactly what a solo
        predict would (including _DeadlineExceeded)."""
        srv = self._srv
        now = time.monotonic()
        tight = (deadline is not None
                 and deadline - now < self.window_s + self.TIGHT_SLACK_S)
        if tight:
            srv._bump("serve_coalesce_bypass")
        member = _BatchMember(feeds, rows, deadline)
        leader = False
        with self._cv:
            batch = self._open.get(key)
            if batch is not None and batch.rows + rows > self.cap(key):
                # joining would overflow the largest bucket: seal it and
                # open a fresh batch for this member
                batch.close_now = True
                self._cv.notify_all()
                batch = None
            if batch is not None:
                member.offset = batch.rows
                batch.members.append(member)
                batch.rows += rows
                if tight or batch.rows >= self.cap(key):
                    batch.close_now = True
                    self._cv.notify_all()
            else:
                batch = _PendingBatch(key)
                batch.members.append(member)
                batch.rows = rows
                leader = True
                if (tight or rows >= self.cap(key)
                        or self.window_s <= 0):
                    batch.close_now = True  # dispatch without a window
                else:
                    self._open[key] = batch  # joinable until sealed
        if leader:
            self._lead(batch)
        else:
            # the leader always seals within its window; the timeout is
            # a last-resort liveness bound, not synchronization
            batch.done.wait(timeout=max(self.window_s, 1.0) + 600.0)
        if batch.error is not None:
            raise batch.error
        return member.outs

    def _lead(self, batch):
        # the seal MUST happen under the lock even when close_now was
        # already set: a joiner (or flush_all) may flip close_now
        # between submit() releasing the lock and this running — an
        # unlocked fast-path here would leave the batch in _open after
        # dispatch, and later arrivals would join a zombie batch whose
        # done event already fired (returning outs=None)
        with self._cv:
            end = batch.created + self.window_s
            while not batch.close_now:
                left = end - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            # seal: new arrivals must open a fresh batch (an overflow
            # join may already have replaced the slot)
            if self._open.get(batch.key) is batch:
                del self._open[batch.key]
        try:
            self._dispatch(batch)
        finally:
            batch.done.set()

    def _dispatch(self, batch):
        srv = self._srv
        members = batch.members
        t0 = time.monotonic()
        try:
            fault_point("server.batch.dispatch")
            target = self.pad_target(batch.key, batch.rows)
            merged = {}
            for name, _, _ in batch.key:
                parts = [m.feeds[name] for m in members]
                arr = (parts[0] if len(parts) == 1
                       else np.concatenate(parts, axis=0))
                if target > batch.rows:
                    pad = np.zeros((target - batch.rows,) + arr.shape[1:],
                                   arr.dtype)
                    arr = np.concatenate([arr, pad], axis=0)
                merged[name] = arr
            # the merged dispatch aborts only when even the most patient
            # member's budget is gone; late members still get their own
            # per-request 504 from the post-predict check
            deadlines = [m.deadline for m in members]
            dl = (None if any(d is None for d in deadlines)
                  else max(deadlines))
            outs = srv.predict(merged, _deadline=dl)
            for k, v in outs.items():
                v = np.asarray(v)
                if v.ndim < 1 or v.shape[0] != target:
                    raise RuntimeError(
                        f"fetch {k!r} shape {v.shape} does not follow "
                        f"the batch dim ({target}) — model is not "
                        "batchable; restart with --batch-window-ms 0")
            for m in members:
                m.outs = {
                    k: np.ascontiguousarray(
                        np.asarray(v)[m.offset:m.offset + m.rows])
                    for k, v in outs.items()
                }
        except _DeadlineExceeded as e:
            batch.error = e
            return
        except BaseException as e:  # noqa: BLE001 — members re-raise
            srv._note_predict_failure()  # ONE breaker sample per dispatch
            batch.error = e
            return
        srv._note_predict_success()
        n = len(members)
        srv._bump("serve_batches")
        srv._bump("serve_batch_members", n)
        if target > batch.rows:
            srv._bump("serve_batch_padded_rows", target - batch.rows)
        if target == batch.rows and target > self.cap(batch.key):
            srv._bump("serve_bucket_overflow")
        srv._bump("serve_coalesce_wait_ms",
                  int(sum(t0 - m.enqueued for m in members) * 1000.0))
        srv._gauge("serve_batch_size_p50", self._note_batch_size(n))

    def _note_batch_size(self, n):
        """p50 over recent batch sizes. Leaders of DIFFERENT bucket
        keys dispatch concurrently: the deque append and the median's
        iteration must share the cv, or the median dies mid-iteration
        ("deque mutated during iteration") and 500s a batch whose
        predict already succeeded."""
        with self._cv:
            self._recent_sizes.append(n)
            return int(statistics.median(self._recent_sizes))


class InferenceServer:
    """An AnalysisPredictor behind a hardened HTTP endpoint, on the card
    (`device="cuda"`) unless the caller asks for the CPU."""

    def __init__(self, model_dir, device="cuda", port=0, max_queue=16,
                 default_deadline_ms=0, max_body_bytes=64 << 20,
                 breaker_threshold=5, probe_interval_s=0.5, warmup=True,
                 drain_timeout_s=30.0, request_timeout_s=30.0,
                 batch_window_ms=0.0, bucket_table=None,
                 role="unified", decode_weights=None, kv_profile="default",
                 kv_table=None, kv_config=None, registry=None,
                 backend_class=None):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        self.device = device
        self._model_dir = str(model_dir)
        config = AnalysisConfig(self._model_dir)
        if device == "cpu":
            config.disable_gpu()
        self._predictor = create_paddle_predictor(config)
        self._feed_names = list(self._predictor.get_input_names())
        self._fetch_names = list(self._predictor.get_output_names())
        # an int8 export ships a quant manifest beside __model__.json;
        # /healthz says which face a replica serves
        self._quantized = os.path.exists(
            os.path.join(self._model_dir, "quant_meta.json"))
        self._lock = threading.Lock()  # the predictor is not reentrant

        # per-instance counters (on /healthz), each bump rolled up into
        # the process-global profiler name
        self._counters = profiler.CounterSet()
        self._started_at = time.monotonic()

        self.max_queue = max(int(max_queue), 1)
        self.default_deadline_ms = float(default_deadline_ms or 0)
        self.max_body_bytes = int(max_body_bytes)
        self.probe_interval_s = float(probe_interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        # per-connection socket deadline: a client that sends headers and
        # then trickles (or abandons) its body frees its admission slot
        self.request_timeout_s = float(request_timeout_s)

        # admission state: _gate guards _inflight and _draining; request
        # threads notify on exit so the drain thread waits precisely
        self._gate = threading.Condition()
        self._inflight = 0
        self._draining = False
        self._stopped = threading.Event()

        self._breaker = CircuitBreaker(breaker_threshold, probe_interval_s)
        # set by a successful warmup or probe: while the synthetic feeds
        # are known-good the breaker recovers by background probes only;
        # otherwise by one live trial per probe interval, so it never
        # latches open
        self._synthetic_ok = False

        # the derived Retry-After's drain-rate estimate: EWMA of the
        # predictor's wall ms a dispatch (None until the first dispatch)
        self._dispatch_ms_ewma = None
        self._ewma_lock = threading.Lock()

        # declared substrate class of a mixed fleet; None keeps /healthz
        # and the ready-file as a single-class server writes them
        self.backend_class = str(backend_class) if backend_class else None

        # request coalescing: a window <= 0 keeps request = dispatch
        self.batch_window_ms = float(batch_window_ms or 0.0)
        self._coalescer = None
        self._batchable = False
        if self.batch_window_ms > 0:
            table = (bucket_table if isinstance(bucket_table, dict)
                     else load_bucket_table(bucket_table,
                                            backend_class=self.backend_class))
            self._coalescer = RequestCoalescer(self, self.batch_window_ms, table)

        # generative roles: a prefill replica carries only the stateless
        # projection half; decode and unified replicas also run the paged
        # KV cache and its decode driver. /predict is role-independent.
        self.role = str(role or "unified")
        if self.role not in ("prefill", "decode", "unified"):
            raise ValueError(
                f"role must be prefill|decode|unified, got {self.role!r}")
        self._decode_model = None
        self._decode = None
        self._prefill_queued_tokens = 0
        self._role_ewma = {}
        if decode_weights:
            from .decode_model import DecodeService, ToyDecodeModel, load_decode_weights

            self._decode_model = ToyDecodeModel(
                load_decode_weights(decode_weights), device=device)
            if self.role in ("decode", "unified"):
                cfg = load_kv_page_table(kv_table, profile=kv_profile)
                cfg.update(kv_config or {})
                self._decode = DecodeService(
                    self._decode_model,
                    num_pages=cfg["num_pages"],
                    page_len=cfg["page_len"],
                    pages_per_seq=cfg["pages_per_seq"],
                    max_streams=cfg.get("max_streams"),
                    admission_window_s=cfg.get("admission_window_ms", 0) / 1000.0)
        elif self.role != "unified":
            raise ValueError(
                f"--role {self.role} requires --decode-weights (the "
                "generative model the role split serves)")

        # the model registry (registry.py): extra named, versioned bundles
        # behind X-Model, hot-swap deploys, per-tenant QoS. None keeps every
        # path above byte-identical: the registry only adds behaviour
        self._registry = None
        if registry is not None:
            from .registry import ModelRegistry

            self._registry = (registry if isinstance(registry, ModelRegistry)
                              else ModelRegistry(self, registry, warmup=warmup))

        self._httpd = _Listener(("127.0.0.1", port), self._make_handler())
        self.port = self._httpd.server_address[1]
        if warmup:
            self._warmup()
        if self._coalescer is not None:
            self._probe_batchable()

    # -- counters ---------------------------------------------------------
    def _bump(self, name, amount=1):
        self._counters.bump(name, amount)

    def _gauge(self, name, value):
        self._counters.gauge(name, value)

    def counters(self):
        """This instance's counters, the paged KV cache's kv_* merged in,
        plus uptime_s and inflight: the /healthz `counters` block."""
        snap = self._counters.snapshot()
        if self._decode is not None:
            snap.update(self._decode.cache.counters.snapshot())
        snap["uptime_s"] = round(time.monotonic() - self._started_at, 3)
        snap["inflight"] = self._inflight
        return snap

    def _note_role_ms(self, name, ms):
        """Per-role dispatch EWMA gauges (serve_prefill_ms_ewma /
        serve_decode_ms_ewma), the predictor estimate's 0.7 / 0.3."""
        with self._ewma_lock:
            prev = self._role_ewma.get(name)
            cur = ms if prev is None else 0.7 * prev + 0.3 * ms
            self._role_ewma[name] = cur
        self._gauge(name, int(cur))

    # -- predictor --------------------------------------------------------
    def predict(self, feeds, _deadline=None):
        """{feed_name: array} -> {fetch_name: host array}. `_deadline`
        (monotonic seconds) is checked again after the wait for the
        predictor lock. The outputs are on the host before the lock is
        released (the predictor returns numpy), so no other thread's
        dispatch can overtake their copy."""
        with self._lock:
            if _deadline is not None and time.monotonic() > _deadline:
                raise _DeadlineExceeded(
                    "deadline expired waiting for the predictor "
                    "(before dispatch)")
            ins = [PaddleTensor(np.asarray(feeds[n]), name=n)
                   for n in self._feed_names]
            t0 = time.perf_counter()
            # inside the lock and the EWMA bracket: a delay here models a
            # slow substrate, and the drain-rate estimate reflects it
            fault_point("server.dispatch")
            outs = self._predictor.run(ins)
            self._note_dispatch_ms((time.perf_counter() - t0) * 1000.0)
            return {self._fetch_names[i]: np.asarray(o.data)
                    for i, o in enumerate(outs)}

    def _note_dispatch_ms(self, ms):
        """Feed the EWMA of the predictor's wall ms a dispatch behind the
        derived Retry-After."""
        with self._ewma_lock:
            prev = self._dispatch_ms_ewma
            self._dispatch_ms_ewma = ms if prev is None else 0.7 * prev + 0.3 * ms
        self._gauge("serve_dispatch_ms_ewma", int(self._dispatch_ms_ewma))

    def _retry_after(self, rt=None):
        """Retry-After of a 503 shed: queue depth x the dispatch EWMA,
        clamped to [1, 30] s; 1 s before the first dispatch. Per model: a
        registry runtime `rt` answers from its own queue and EWMA, and with
        a registry the default model's depth leaves its neighbours out."""
        if rt is not None:
            return rt.retry_after()
        with self._ewma_lock:
            ewma = self._dispatch_ms_ewma
        with self._gate:
            depth = (self._registry.default_inflight
                     if self._registry is not None else self._inflight)
        if not ewma or depth <= 0:
            return 1
        return max(1, min(30, int(math.ceil(depth * ewma / 1000.0))))

    # -- coalescing -------------------------------------------------------
    def _batch_key(self, feeds):
        """(bucket key, rows) when this request can join a batched
        dispatch: every feed shares one leading batch dim; the key is the
        per-feed (name, non-batch shape, dtype) tuple. None when the feeds
        are not batchable (dispatch solo)."""
        rows = None
        key = []
        for n in self._feed_names:
            a = feeds[n]
            if a.ndim < 1:
                return None
            if rows is None:
                rows = int(a.shape[0])
            elif int(a.shape[0]) != rows:
                return None
            key.append((n, tuple(a.shape[1:]), str(a.dtype)))
        if not rows:
            return None
        return tuple(key), rows

    def _probe_batchable(self):
        """Coalescing is sound only when every feed var has a batch
        placeholder and every fetch follows the batch dim. One synthetic
        rows=2 probe at startup; a failure disables coalescing loudly
        instead of serving wrong slices."""
        blk = self._predictor.program().global_block()
        try:
            for n in self._feed_names:
                d0 = blk.var(n).shape[0]
                if d0 is not None and int(d0) > 0:
                    raise ValueError(f"feed {n!r} has a static leading dim {d0}")
            feeds2 = {n: np.concatenate([v, v], axis=0)
                      for n, v in self._synthetic_feeds().items()}
            outs = self.predict(feeds2)
            for k, v in outs.items():
                if np.asarray(v).ndim < 1 or np.asarray(v).shape[0] != 2:
                    raise ValueError(f"fetch {k!r} does not follow the batch dim")
            self._batchable = True
        except Exception as e:  # noqa: BLE001 — loud downgrade, not fatal
            self._coalescer = None
            print(f"request coalescing disabled: {type(e).__name__}: {e}",
                  flush=True)

    def _synthetic_feeds(self):
        """Zero feeds shaped from the feed vars (dims <= 0, the batch
        placeholder, become 1): warmup and the breaker's probes."""
        blk = self._predictor.program().global_block()
        feeds = {}
        for n in self._feed_names:
            try:
                v = blk.var(n)
                shape = [1 if d is None or int(d) <= 0 else int(d) for d in v.shape]
                dtype = np.dtype(str(v.dtype))
            except Exception:  # noqa: BLE001 — shape metadata is best-effort
                shape, dtype = [1], np.dtype("float32")
            feeds[n] = np.zeros(shape or [1], dtype)
        return feeds

    def _warmup(self):
        """One synthetic predict, so the first real request does not pay
        the kernel build and the allocator's first growth. A failure is
        loud but not fatal: real traffic may feed shapes that work."""
        t0 = time.perf_counter()
        try:
            self.predict(self._synthetic_feeds())
            self._synthetic_ok = True
        except Exception as e:  # noqa: BLE001
            print(f"warmup predict failed: {type(e).__name__}: {e}", flush=True)
        self._bump("serve_warmup_ms", int((time.perf_counter() - t0) * 1000))

    # -- circuit breaker --------------------------------------------------
    def _note_predict_failure(self):
        if self._breaker.record_failure():
            self._bump("serve_breaker_trips")
            threading.Thread(target=self._probe_loop, daemon=True,
                             name="serve-breaker-probe").start()

    def _note_predict_success(self):
        # any live success closes an open breaker (half-open)
        if self._breaker.record_success():
            self._bump("serve_breaker_recovered")

    def _probe_loop(self):
        """Half-open recovery: a synthetic predict every probe interval;
        the first success closes the breaker. While synthetic feeds are
        known-good live traffic sheds fast; otherwise _admitted_predict
        admits one live trial per probe interval."""
        while not self._stopped.is_set() and self._breaker.open:
            if self._stopped.wait(self.probe_interval_s):
                return
            try:
                fault_point("server.probe")
                self.predict(self._synthetic_feeds())
            except Exception:  # noqa: BLE001 — still broken, keep probing
                continue
            # a monotonic latch (one bool store); a stale read costs at
            # most one extra synthetic probe
            self._synthetic_ok = True
            if self._breaker.record_success():
                self._bump("serve_breaker_recovered")
            return

    # -- graceful drain ---------------------------------------------------
    def begin_drain(self, signum=None):
        """SIGTERM entry: fail /healthz first (a balancer stops routing),
        shed new requests, close the listener once in-flight requests
        have written their replies."""
        with self._gate:
            if self._draining:
                return
            self._draining = True
        self._bump("serve_drains")
        if self._coalescer is not None:
            # admitted members must not sit out a window on the drain clock
            self._coalescer.flush_all()
        threading.Thread(target=self._drain_and_stop, daemon=True,
                         name="serve-drain").start()

    def _drain_and_stop(self):
        deadline = time.monotonic() + self.drain_timeout_s
        with self._gate:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._gate.wait(min(remaining, 0.05))
        self._stopped.set()
        self._httpd.shutdown()

    # -- HTTP layer -------------------------------------------------------
    def _make_handler(self):
        outer = self
        routes = {"/predict": self._handle_predict, "/prefill": self._handle_prefill,
                  "/decode": self._handle_decode, "/generate": self._handle_generate,
                  "/admin/deploy": self._handle_deploy}

        class Handler(JsonHandlerMixin, BaseHTTPRequestHandler):
            # socket deadline for the whole exchange: a trickling client
            # times out and frees its admission slot
            timeout = outer.request_timeout_s

            def do_GET(self):
                if self.path != "/healthz":
                    self.send_error(404)
                    return
                outer._handle_healthz(self)

            def do_POST(self):
                handler = routes.get(self.path)
                if handler is None:
                    self.send_error(404)
                    return
                handler(self)

        return Handler

    def _handle_healthz(self, h):
        status, code = "ok", 200
        if self._breaker.open:
            status, code = "breaker_open", 503
        if self._draining:
            status, code = "draining", 503
        payload = {
            "status": status,
            "role": self.role,
            "device": self.device,
            "feeds": self._feed_names,
            "fetches": self._fetch_names,
            "queue_depth": self._inflight,
            "max_queue": self.max_queue,
            "breaker_open": self._breaker.open,
            "draining": self._draining,
            "pid": os.getpid(),
            "quantized": self._quantized,
            "batch_window_ms": (self.batch_window_ms
                                if self._coalescer is not None else 0),
            "counters": self.counters(),
        }
        if self.backend_class is not None:
            payload["backend_class"] = self.backend_class
        if self._decode is not None:
            c = self._decode.cache
            free = c.free_pages()
            payload["kv"] = {
                "pages_total": c.num_pages,
                "free_pages": free,
                "pages_in_use": c.num_pages - free,
                "page_len": c.page_len,
                "pages_per_seq": c.pages_per_seq,
                "max_len": c.max_len,
                "max_streams": c.max_streams,
                "decode_streams": len(self._decode._jobs),
            }
        if self._decode_model is not None and self.role in ("prefill", "unified"):
            payload["prefill"] = {"queued_tokens": self._prefill_queued_tokens}
        if self._registry is not None:
            payload["models"] = self._registry.models_block()
        h._json(code, payload)

    def _handle_deploy(self, h):
        """POST /admin/deploy {name, version, bundle_dir?, tolerance?}:
        hot-swap one registry model on this replica. tolerance null skips
        the drift bound; any failure leaves the old version authoritative.
        Without a registry: 404 NoRegistry, with the body left unread, so
        the connection closes."""
        if self._registry is None:
            h._json(404, {"error": "NoRegistry",
                          "message": "this replica has no model registry "
                                     "(start with --registry)"}, close=True)
            return
        n = h._content_length()
        if n is None:
            return
        if n > self.max_body_bytes:
            h._json(413, {"error": "PayloadTooLarge",
                          "message": f"body is {n} bytes, cap is "
                                     f"{self.max_body_bytes}"}, close=True)
            return
        body = h._read_body(n)
        if body is None:
            return
        try:
            req = json.loads(body.decode("utf-8") or "{}")
            name = str(req["name"])
            version = str(req["version"])
        except Exception as e:  # noqa: BLE001 — a malformed body is a 400
            h._json(400, {"error": type(e).__name__,
                          "message": f"deploy body must be JSON with name and "
                                     f"version: {e}"}, close=True)
            return
        from ..streaming.export_int8 import ExportToleranceError

        try:
            info = self._registry.deploy(name, version, req.get("bundle_dir"),
                                         tolerance=req.get("tolerance", 0.01))
        except KeyError as e:
            h._json(404, {"error": "NoSuchModel", "message": str(e).strip("'\"")})
            return
        except ExportToleranceError as e:
            h._json(409, {"error": "ExportToleranceError", "message": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — a failed deploy keeps the old version
            h._json(500, {"error": type(e).__name__, "message": str(e)})
            return
        h._json(200, dict(info, status="active"))

    def _resolve_model(self, h):
        """(runtime | None, qos_class | None) for one request, or None after
        writing the 404 for an unknown X-Model. Without a registry the
        headers are ignored: a single-model replica's replies stay as they
        were."""
        if self._registry is None:
            return None, None
        try:
            return self._registry.resolve_request(h.headers)
        except KeyError as e:
            h._json(404, {"error": "NoSuchModel", "message": str(e).strip("'\"")},
                    close=True)
            return None

    def _default_deadline_ms(self, qos_cls):
        """The deadline of a request without X-Deadline-Ms: its QoS class's
        default where one is set, else the server's."""
        if qos_cls is not None and self._registry is not None:
            cls_ms = self._registry.qos.deadline_ms(qos_cls)
            if cls_ms > 0:
                return cls_ms
        return self.default_deadline_ms

    def _handle_predict(self, h):
        self._bump("serve_requests")
        t0 = time.monotonic()
        resolved = self._resolve_model(h)
        if resolved is None:
            return
        rt, qos_cls = resolved
        if rt is not None:
            rt._bump("serve_requests")
        try:
            dl_ms = float(h.headers.get("X-Deadline-Ms",
                                        self._default_deadline_ms(qos_cls)) or 0)
        except (TypeError, ValueError):
            h._json(400, {"error": "ValueError",
                          "message": "X-Deadline-Ms must be a number"}, close=True)
            return
        deadline = t0 + dl_ms / 1000.0 if dl_ms > 0 else None

        # cheap rejections first: none reads the body, so each closes the
        # connection to keep the stream in sync
        n = h._content_length()
        if n is None:
            return
        if n > self.max_body_bytes:
            h._json(413, {"error": "PayloadTooLarge",
                          "message": f"body is {n} bytes, cap is "
                                     f"{self.max_body_bytes}"}, close=True)
            return
        # breaker open and synthetic probing viable: shed fast, recovery
        # is the probe loop's (the live-trial slot, when probing is not
        # viable, is claimed after the body validates). The breaker is per
        # model: a wedged model sheds its own traffic only
        target = rt if rt is not None else self
        if target._breaker.open and target._synthetic_ok:
            self._bump("serve_breaker_open")
            if rt is not None:
                rt._bump("serve_breaker_open")
            h._json(503, {"error": "BreakerOpen",
                          "message": "predictor circuit breaker is open"},
                    retry_after=1, close=True)
            return
        target = self._admit(h, rt)
        if target is None:
            return
        rt = None if target is self else target
        try:
            self._admitted_predict(h, n, deadline, dl_ms, rt=rt, qos_cls=qos_cls)
        finally:
            self._exit_gate(rt)

    def _admitted_predict(self, h, n, deadline, dl_ms, rt=None, qos_cls=None):
        # `target` is the model the request dispatches into: the server
        # itself (the default path) or a registry ModelRuntime with its own
        # predictor, coalescer, breaker and EWMA (registry.py)
        target = rt if rt is not None else self
        # client errors (truncated body, bad archive, wrong feed names)
        # are 400s; a short read closes the connection
        body = h._read_body(n)
        if body is None:
            return
        try:
            payload = np.load(_bytesio.BytesIO(body), allow_pickle=False)
            feeds = {k: payload[k] for k in payload.files}
        except Exception as e:  # noqa: BLE001 — a malformed body is a 400
            h._json(400, {"error": type(e).__name__, "message": str(e)}, close=True)
            return
        unknown = sorted(set(feeds) - set(target._feed_names))
        missing = sorted(set(target._feed_names) - set(feeds))
        if unknown or missing:
            h._json(400, {"error": "ValueError",
                          "message": f"feed mismatch: unknown={unknown} "
                                     f"missing={missing} (expect {target._feed_names})"})
            return

        # half-open live trial (breaker open, synthetic probing not
        # viable): claim the one-per-probe-interval slot only now that the
        # body validated
        if target._breaker.open and not target._breaker.probe_due():
            self._bump("serve_breaker_open")
            if rt is not None:
                rt._bump("serve_breaker_open")
            h._json(503, {"error": "BreakerOpen",
                          "message": "predictor circuit breaker is open"},
                    retry_after=1, close=True)
            return

        # deadline checks bracket the dispatch; a predictor raise is a 500
        # and feeds the breaker. Batchable feeds ride the coalescer (one
        # breaker / EWMA sample per merged dispatch, taken inside it). A
        # QoS class rides a request-scoped thread local into the gate.
        solo = True
        if qos_cls is not None:
            from .registry import set_request_class

            set_request_class(qos_cls)
        try:
            fault_point("server.predict")
            if deadline is not None and time.monotonic() > deadline:
                raise _DeadlineExceeded("deadline expired before dispatch")
            batch_key = (target._batch_key(feeds)
                         if target._coalescer is not None and target._batchable else None)
            if batch_key is not None:
                solo = False
                outs = target._coalescer.submit(batch_key[0], feeds, batch_key[1], deadline)
            else:
                outs = target.predict(feeds, _deadline=deadline)
            fault_point("server.reply")
            if deadline is not None and time.monotonic() > deadline:
                raise _DeadlineExceeded("deadline expired after predict")
        except _DeadlineExceeded as e:
            self._bump("serve_deadline_exceeded")
            if rt is not None:
                rt._bump("serve_deadline_exceeded")
            h._json(504, {"error": "DeadlineExceeded", "message": str(e),
                          "deadline_ms": dl_ms})
            return
        except Exception as e:  # noqa: BLE001 — a predictor failure is a 500
            if solo:
                target._note_predict_failure()
            h._json(500, {"error": type(e).__name__, "message": str(e)})
            return
        finally:
            if qos_cls is not None:
                from .registry import clear_request_class

                clear_request_class()
        if solo:
            target._note_predict_success()
        self._npz_reply(h, outs)

    # -- admission (shared by /predict and the generative endpoints) ------
    def _admit(self, h, rt=None):
        """The admission gate: draining or max_queue shed with the derived
        Retry-After. -> None after the shed reply, else the model admitted
        into: `self` for the built-in one, or a registry runtime, which is
        the live version of `rt` when a deploy retired `rt` after the
        request resolved it (a retired version's predictor is unloaded).
        The caller pairs it with _exit_gate(that runtime) in a finally. The
        shed reply is written after the gate releases, so a client slow to
        read its 503 stalls no one.

        Admission queues are per model: a registry runtime checks its own
        depth against its own cap, and with a registry the default model's
        depth leaves its neighbours out, so one flooded model cannot take
        another's queue. Without a registry the depth and the message are
        the process-wide ones."""
        shed = None
        with self._gate:
            if rt is not None and rt.retired:
                rt = self._registry.get(rt.name) or rt
            if rt is not None:
                depth, cap = rt.inflight, rt.max_queue
            elif self._registry is not None:
                depth, cap = self._registry.default_inflight, self.max_queue
            else:
                depth, cap = self._inflight, self.max_queue
            if self._draining:
                shed = "ServerDraining", "server is draining for shutdown"
            elif depth >= cap:
                shed = ("QueueFull", f"{depth} requests in flight "
                                     f"(max_queue={cap})")
            else:
                self._inflight += 1
                if rt is not None:
                    rt.inflight += 1
                elif self._registry is not None:
                    self._registry.default_inflight += 1
                self._gauge("serve_queue_depth", self._inflight)
        if shed is not None:
            self._bump("serve_shed")
            if rt is not None:
                rt._bump("serve_shed")
            h._json(503, {"error": shed[0], "message": shed[1]},
                    retry_after=self._retry_after(rt), close=True)
            return None
        return self if rt is None else rt

    def _exit_gate(self, rt=None):
        with self._gate:
            self._inflight -= 1
            if rt is not None:
                rt.inflight -= 1
            elif self._registry is not None:
                self._registry.default_inflight -= 1
            self._gauge("serve_queue_depth", self._inflight)
            self._gate.notify_all()

    def _generative_body(self, h, endpoint, roles, rt=None, have=None):
        """The front half of /prefill /decode /generate: role gate,
        Content-Length checks, admission, body read -> (body bytes, the
        runtime admitted into: None for the built-in model) when admitted
        (the caller owns _exit_gate(runtime)), or None (the reply is
        written; the gate was left or never entered). `have` replaces the
        built-in decode model's presence check when the generative weights
        live on a registry runtime."""
        if have is None:
            have = self._decode_model is not None
        if not have or self.role not in roles:
            h._json(404, {"error": "NoSuchEndpoint",
                          "message": f"role {self.role!r} replica serves no "
                                     f"{endpoint} (decode weights "
                                     f"{'loaded' if have else 'absent'})"})
            return None
        n = h._content_length()
        if n is None:
            return None
        if n > self.max_body_bytes:
            h._json(413, {"error": "PayloadTooLarge",
                          "message": f"body is {n} bytes, cap is "
                                     f"{self.max_body_bytes}"}, close=True)
            return None
        target = self._admit(h, rt)
        if target is None:
            return None
        rt = None if target is self else target
        body = h._read_body(n)
        if body is None:
            self._exit_gate(rt)
            return None
        return body, rt

    def _deadline_of(self, h, qos_cls=None):
        try:
            dl_ms = float(h.headers.get("X-Deadline-Ms",
                                        self._default_deadline_ms(qos_cls)) or 0)
        except (TypeError, ValueError):
            return None
        return time.monotonic() + dl_ms / 1000.0 if dl_ms > 0 else None

    @staticmethod
    def _npz_reply(h, arrays, headers=None):
        buf = _bytesio.BytesIO()
        np.savez(buf, **arrays)
        body = buf.getvalue()
        h.send_response(200)
        h.send_header("Content-Type", "application/npz")
        h.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            h.send_header(k, str(v))
        h.end_headers()
        h.wfile.write(body)

    @staticmethod
    def _prompt_of(h, body):
        """npz {tokens, max_new} -> (tokens int32 [n], max_new), or None
        after writing the 400."""
        try:
            payload = np.load(_bytesio.BytesIO(body), allow_pickle=False)
            tokens = np.asarray(payload["tokens"], np.int32).reshape(-1)
            max_new = int(np.asarray(payload["max_new"]).reshape(()))
        except Exception as e:  # noqa: BLE001 — a malformed body is a 400
            h._json(400, {"error": type(e).__name__, "message": str(e)}, close=True)
            return None
        if tokens.size < 1 or max_new < 1:
            h._json(400, {"error": "ValueError",
                          "message": "need >= 1 prompt token and max_new >= 1"})
            return None
        return tokens, max_new

    def _handle_prefill(self, h):
        """npz {tokens, max_new} -> handoff blob. Stateless and pure, so a
        retry on another prefill replica gives the same bytes."""
        self._bump("serve_prefill_requests")
        admitted = self._generative_body(h, "/prefill", ("prefill", "unified"))
        if admitted is None:
            return
        body = admitted[0]
        try:
            prompt = self._prompt_of(h, body)
            if prompt is None:
                return
            tokens, max_new = prompt
            ntok = int(tokens.size)
            with self._gate:
                self._prefill_queued_tokens += ntok
                self._gauge("serve_prefill_queued_tokens", self._prefill_queued_tokens)
            try:
                fault_point("server.prefill")
                t0 = time.perf_counter()
                k_rows, v_rows, length, last = self._decode_model.prefill(tokens)
                ms = (time.perf_counter() - t0) * 1000.0
            except Exception as e:  # noqa: BLE001 — a projection failure is a 500
                h._json(500, {"error": type(e).__name__, "message": str(e)})
                return
            finally:
                with self._gate:
                    self._prefill_queued_tokens -= ntok
                    self._gauge("serve_prefill_queued_tokens",
                                self._prefill_queued_tokens)
            from .handoff import CONTENT_TYPE, pack_handoff

            blob = pack_handoff({"k": k_rows, "v": v_rows},
                                meta={"length": length, "last_token": last,
                                      "max_new": max_new})
            self._bump("serve_prefill_dispatches")
            self._bump("serve_prefill_tokens", ntok)
            self._note_role_ms("serve_prefill_ms_ewma", ms)
            h.send_response(200)
            h.send_header("Content-Type", CONTENT_TYPE)
            h.send_header("Content-Length", str(len(blob)))
            # the final stream length (prompt rows + the withheld token +
            # the new tokens): a scheduler sizes the decode side's page
            # reservation from it without parsing the blob
            h.send_header("X-Handoff-Tokens", str(length + max_new))
            h.end_headers()
            h.wfile.write(blob)
        finally:
            self._exit_gate()

    def _handle_decode(self, h):
        """handoff blob -> npz {tokens, logits}: admit the prefilled
        history into pages and ride the decode driver. An admission shed
        is a 503; a corrupt blob is a 400 (the sender resends its copy)."""
        self._bump("serve_decode_requests")
        admitted = self._generative_body(h, "/decode", ("decode", "unified"))
        if admitted is None:
            return
        body = admitted[0]
        try:
            from .decode_model import DecodeAdmissionError
            from .handoff import HandoffError, unpack_handoff

            try:
                arrays, meta = unpack_handoff(body)
                k_rows, v_rows = arrays["k"], arrays["v"]
                length = int(meta["length"])
                last = int(meta["last_token"])
                max_new = int(meta["max_new"])
            except (HandoffError, KeyError, TypeError, ValueError) as e:
                h._json(400, {"error": type(e).__name__, "message": str(e)}, close=True)
                return
            deadline = self._deadline_of(h)
            fault_point("server.decode")
            t0 = time.perf_counter()
            try:
                toks, logits = self._decode.decode(
                    k_rows, v_rows, length, last, max_new,
                    deadline=deadline, seq_id=meta.get("seq"))
            except DecodeAdmissionError as e:
                self._bump("serve_shed")
                h._json(503, {"error": "KVAdmissionShed", "message": str(e)},
                        retry_after=1)
                return
            except Exception as e:  # noqa: BLE001 — a decode failure is a 500
                h._json(500, {"error": type(e).__name__, "message": str(e)})
                return
            ms = (time.perf_counter() - t0) * 1000.0
            self._note_role_ms("serve_decode_ms_ewma", ms)
            self._npz_reply(h, {"tokens": toks, "logits": logits},
                            headers={"X-Decode-Ms": int(ms),
                                     "X-KV-Free-Pages": self._decode.cache.free_pages()})
        finally:
            self._exit_gate()

    def _handle_generate(self, h):
        """npz {tokens, max_new} -> npz {tokens, logits}: local prefill,
        then the decode driver; the baseline a split reply equals. X-Model
        selects a registry runtime's decode service (its streams ride the
        server's pool when the geometry matches)."""
        self._bump("serve_generate_requests")
        resolved = self._resolve_model(h)
        if resolved is None:
            return
        rt, qos_cls = resolved
        if rt is not None:
            rt._bump("serve_generate_requests")
        admitted = self._generative_body(
            h, "/generate", ("unified",), rt=rt,
            have=None if rt is None else rt.decode is not None)
        if admitted is None:
            return
        body, rt = admitted
        svc = rt.decode if rt is not None else self._decode
        try:
            from .decode_model import DecodeAdmissionError

            prompt = self._prompt_of(h, body)
            if prompt is None:
                return
            tokens, max_new = prompt
            try:
                toks, logits = svc.generate(tokens, max_new,
                                            deadline=self._deadline_of(h, qos_cls))
            except DecodeAdmissionError as e:
                self._bump("serve_shed")
                if rt is not None:
                    rt._bump("serve_shed")
                h._json(503, {"error": "KVAdmissionShed", "message": str(e)},
                        retry_after=1)
                return
            except Exception as e:  # noqa: BLE001 — a generate failure is a 500
                h._json(500, {"error": type(e).__name__, "message": str(e)})
                return
            self._npz_reply(h, {"tokens": toks, "logits": logits},
                            headers={"X-KV-Free-Pages": svc.cache.free_pages()})
        finally:
            self._exit_gate(rt)

    # -- lifecycle --------------------------------------------------------
    def serve_forever(self):
        self._httpd.serve_forever()

    def shutdown(self):
        """Immediate stop (in-process use; SIGTERM goes through
        begin_drain): stop serve_forever from another thread and close
        the listening socket."""
        self._stopped.set()
        if self._coalescer is not None:
            self._coalescer.flush_all()
        self._httpd.shutdown()
        self._httpd.server_close()

    def close(self):
        self._stopped.set()
        if self._registry is not None:
            self._registry.close()
        if self._decode is not None:
            self._decode.close()
        self._httpd.server_close()


def write_ready_file(path, srv):
    """Publish the supervisor handshake atomically (temp file +
    os.replace): bind and warmup are done, the port is real, and a reader
    never sees a torn file."""
    payload = {
        "port": srv.port,
        "pid": os.getpid(),
        "warmup_ms": srv.counters().get("serve_warmup_ms", 0),
    }
    if getattr(srv, "backend_class", None):
        payload["backend_class"] = srv.backend_class
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
    os.replace(tmp, path)
    return payload


def serve(model_dir, port=0, device="cuda", ready_file=None, **server_kwargs):
    """Build the server, drain it on SIGTERM / SIGINT, write the
    ready-file, serve until the drain closes the listener."""
    srv = InferenceServer(model_dir, device=device, port=port, **server_kwargs)
    handler = PreemptionHandler(signals=(signal.SIGTERM, signal.SIGINT),
                                on_preempt=lambda sig: srv.begin_drain(sig))
    with handler:
        if ready_file:
            write_ready_file(ready_file, srv)
        print(f"serving {model_dir} on http://127.0.0.1:{srv.port} ({device})",
              flush=True)
        srv.serve_forever()  # returns once the drain closes the listener
    srv.close()
    print("server drained, exiting", flush=True)
    return srv


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="paddle_tpu_torch out-of-process inference server")
    ap.add_argument("--model-dir", required=True,
                    help="save_inference_model export directory")
    ap.add_argument("--port", type=int, default=0, help="TCP port (0 = auto)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the predictor and the decode model run (cuda "
                    "raises without a card)")
    ap.add_argument("--max-queue", type=int, default=16,
                    help="in-flight request cap; excess sheds with 503")
    ap.add_argument("--deadline-ms", type=float, default=0,
                    help="default per-request deadline when the client sends "
                    "no X-Deadline-Ms (0 = none)")
    ap.add_argument("--max-body-mb", type=float, default=64,
                    help="Content-Length cap in MiB (413 above)")
    ap.add_argument("--breaker-threshold", type=int, default=5,
                    help="consecutive predictor failures that trip the "
                    "circuit breaker")
    ap.add_argument("--probe-interval", type=float, default=0.5,
                    help="seconds between breaker recovery probes")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the startup synthetic predict")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="max seconds to wait for in-flight requests on "
                    "SIGTERM before closing anyway")
    ap.add_argument("--request-timeout", type=float, default=30.0,
                    help="per-connection socket deadline (slow clients time "
                    "out instead of pinning admission slots)")
    ap.add_argument("--ready-file", default=None,
                    help="atomically write {port, pid, warmup_ms} JSON here "
                    "once bound and warm (supervisor handshake)")
    ap.add_argument("--batch-window-ms", type=float, default=2.0,
                    help="request-coalescing window: batchable /predict "
                    "requests wait up to this long to merge into one padded "
                    "bucket-shaped dispatch (deadline-tight requests never "
                    "wait; 0 disables coalescing)")
    ap.add_argument("--bucket-table", default=None,
                    help="shape-bucket table JSON (default: bucket_table.json "
                    "next to this module)")
    ap.add_argument("--role", default="unified",
                    choices=["prefill", "decode", "unified"],
                    help="generative role: prefill serves /prefill (K/V "
                    "projections -> handoff blob), decode serves /decode "
                    "(paged-KV continuous batching), unified serves both "
                    "plus /generate")
    ap.add_argument("--decode-weights", default=None,
                    help="npz of decode weights (decode_model.py); required "
                    "for --role prefill|decode")
    ap.add_argument("--kv-profile", default="default",
                    help="profile of the kv page table (pool geometry of the "
                    "decode and unified roles)")
    ap.add_argument("--kv-table", default=None,
                    help="page-pool sizing table JSON (default: "
                    "kv_page_table.json next to this module)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="override: physical pages in the KV pool")
    ap.add_argument("--kv-page-len", type=int, default=None,
                    help="override: tokens per page")
    ap.add_argument("--kv-pages-per-seq", type=int, default=None,
                    help="override: page-table width (page_len x this = max_len)")
    ap.add_argument("--kv-streams", type=int, default=None,
                    help="override: max concurrent decode streams")
    ap.add_argument("--kv-admission-window-ms", type=float, default=None,
                    help="override: page-admission wait window before a 503")
    ap.add_argument("--registry", default=None,
                    help="model registry manifest JSON (model_registry.json): "
                    "extra named, versioned bundles behind X-Model, hot-swap "
                    "deploys on /admin/deploy, per-tenant QoS")
    ap.add_argument("--backend-class", default=None,
                    help="declared substrate class of a mixed fleet: echoed "
                    "in the ready-file and on /healthz, and selects the "
                    "per_class bucket-table overlay")
    args = ap.parse_args(argv)
    kv_config = {k: v for k, v in {
        "num_pages": args.kv_pages,
        "page_len": args.kv_page_len,
        "pages_per_seq": args.kv_pages_per_seq,
        "max_streams": args.kv_streams,
        "admission_window_ms": args.kv_admission_window_ms,
    }.items() if v is not None}
    serve(
        args.model_dir, port=args.port, device=args.device,
        ready_file=args.ready_file,
        max_queue=args.max_queue,
        default_deadline_ms=args.deadline_ms,
        max_body_bytes=int(args.max_body_mb * (1 << 20)),
        breaker_threshold=args.breaker_threshold,
        probe_interval_s=args.probe_interval,
        warmup=not args.no_warmup,
        drain_timeout_s=args.drain_timeout,
        request_timeout_s=args.request_timeout,
        batch_window_ms=args.batch_window_ms,
        bucket_table=args.bucket_table,
        role=args.role,
        decode_weights=args.decode_weights,
        kv_profile=args.kv_profile,
        kv_table=args.kv_table,
        kv_config=kv_config,
        registry=args.registry,
        backend_class=args.backend_class,
    )


if __name__ == "__main__":
    main()
