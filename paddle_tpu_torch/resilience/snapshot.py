"""Async atomic snapshot engine: the port's copy of
`paddle_tpu/resilience/snapshot.py`, byte for byte its on-disk format, so
a snapshot written by either package loads in the other.

A snapshot is a directory `snapshot-<step:010d>` holding `state.bin`
(every var as an `np.save` record, concatenated in sorted-name order) and
`MANIFEST.json` (step, each var's offset, byte count, dtype, shape and
crc32, the `extra` dict). It is written into `<final>@tmp`, the manifest
last, and published by one `os.replace`; re-saving a step moves the old
directory aside to `@old` first. A SIGKILL at any point leaves the
earlier snapshots whole and at most an `@tmp` directory that discovery
skips. Retention keeps the newest `keep`. As in the JAX package a
manifest records each sharded var's PartitionSpec (`spec`, in
`parallel.mesh.spec_to_manifest`'s form, from a ZeRO-1 DTensor's
placements) and the current mesh's shape (`mesh`), so a restore under a
mesh re-places it sharded. A DTensor is written whole: its all-gather
runs on the caller's thread at save, a collective of every rank of its
mesh, so every rank saves (each into a root of its own).

`AsyncSnapshotEngine.submit` takes the step's values where the step left
them, into a slot: host memory laid out as the snapshot's `state.bin`
image, each record's np.save header written once and room for its data
behind it. Tensors on the card are copied into their records with
`non_blocking=True` on a CUDA stream of the engine's own, which first
waits on an event recorded on the caller's stream after the step; each
source is `record_stream`ed on the copy stream, so the allocator does not
hand its block to a later step before the copy has read it. An event
recorded after the copies is what the flush thread waits on before it
reads a byte; then it checksums and writes the image a record at a time,
in C calls that release the GIL, while the next steps run. Serializing in
Python instead holds the GIL, which the training thread releases and
takes back at every op: a host-bound step ran 1.5x slower beside such a
flush on an H100's host (tools/snapshot_flush_probe.py). Two slots,
allocated (pinned, for card values) at the first snapshots and reused,
hold the snapshot in flight and the queued one; a submit that finds both
taken waits. A flush failure is sticky: it raises on the next `submit` or
`drain`.

Chaos sites: `snapshot.flush.write` (before each record of state.bin) and
`snapshot.commit` (after the manifest, before the publish).
`PADDLE_TPU_CKPT_FSYNC=1` fsyncs files and directories (off by default:
the threat model is process death, which write-then-rename covers);
`PADDLE_TPU_CKPT_TEST_SLEEP_PER_FILE` sleeps after each record, to widen
a test's kill window.

Counters (always on): `ckpt_save_ms`, `ckpt_bytes`, `ckpt_async_overlap_ms`
(flush time the producer did not wait for), `ckpt_snapshots_committed`.
The engine also keeps, per snapshot, the time `submit` blocked
(`submit_ms`) and the copy stream's time (`copy_ms`, CUDA events; empty
for host values).
"""

from __future__ import annotations

import io as _io
import json
import os
import shutil
import threading
import time
import weakref
import zlib

import numpy as np
import torch

from .faults import fault_point

__all__ = [
    "FORMAT_VERSION",
    "SnapshotError",
    "atomic_write_bytes",
    "atomic_write_array",
    "snapshot_dir",
    "snapshot_specs",
    "snapshot_mesh_shape",
    "pack_stream",
    "write_snapshot",
    "read_manifest",
    "list_snapshots",
    "validate_snapshot",
    "load_snapshot",
    "prune_snapshots",
    "AsyncSnapshotEngine",
    "wait_for_copies",
]

MANIFEST = "MANIFEST.json"
DATA_FILE = "state.bin"
SNAPSHOT_PREFIX = "snapshot-"
FORMAT_VERSION = 1

# seconds slept after each record lands inside @tmp, so a crash test can
# kill a writer mid-save
_INJECT_DELAY_ENV = "PADDLE_TPU_CKPT_TEST_SLEEP_PER_FILE"
# opt-in power-loss durability: fsync every file and directory written
_FSYNC_ENV = "PADDLE_TPU_CKPT_FSYNC"


def _fsync_enabled() -> bool:
    return os.environ.get(_FSYNC_ENV) == "1"


def _maybe_fsync(f):
    if _fsync_enabled():
        f.flush()
        os.fsync(f.fileno())


def _maybe_fsync_dir(path):
    if not _fsync_enabled():
        return
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class SnapshotError(RuntimeError):
    """A snapshot is missing, uncommitted, or fails checksum validation."""


def _bump(name, amount=1):
    from .. import profiler

    profiler.bump_counter(name, amount)


def _host(value) -> np.ndarray:
    """A value as a host array (a bfloat16 tensor widens to float32,
    which numpy lacks; restore casts it back to the var's IR dtype; a
    DTensor is gathered whole)."""
    from ..scope import full_value

    value = full_value(value)
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(value)


def atomic_write_bytes(path: str, data: bytes) -> int:
    """Write to a sibling temp file, then `os.replace` it onto `path`:
    readers see the old bytes or the new, never a prefix. Returns the byte
    count, which also lands in `ckpt_bytes`."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        _maybe_fsync(f)
    os.replace(tmp, path)
    _maybe_fsync_dir(os.path.dirname(os.path.abspath(path)))
    _bump("ckpt_bytes", len(data))
    return len(data)


def _array_bytes(arr: np.ndarray) -> bytes:
    buf = _io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def atomic_write_array(path: str, arr) -> int:
    """np.save through the atomic publish."""
    return atomic_write_bytes(path, _array_bytes(_host(arr)))


def snapshot_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{SNAPSHOT_PREFIX}{step:010d}")


def snapshot_specs(arrays: dict) -> dict:
    """Per-var PartitionSpec table (manifest form) from the DTensors among
    `arrays`, taken before they are gathered whole; replicated vars are
    left out."""
    from ..parallel.mesh import spec_of_placements, spec_to_manifest

    out = {}
    for name, v in arrays.items():
        placements = getattr(v, "placements", None)
        if placements is None:
            continue
        m = spec_to_manifest(spec_of_placements(placements))
        if any(e is not None for e in m):
            out[name] = m
    return out


def snapshot_mesh_shape():
    """{'batch': b, 'model': m, 'pipe': p} of the current mesh (or None),
    recorded in every manifest so a restore under another mesh can tell a
    re-placement from a same-mesh restore."""
    from ..parallel.mesh import current_mesh

    mesh = current_mesh()
    if mesh is None:
        return None
    return {a: int(s) for a, s in mesh.shape.items()}


def _gathered(arrays: dict) -> dict:
    """`arrays` with every DTensor gathered whole, on the caller's thread."""
    from ..scope import full_value

    return {k: full_value(v) for k, v in arrays.items()}


def pack_stream(f, arrays: dict, *, fault_site: str = None,
                delay: float = 0.0):
    """Write `arrays` (name -> array-like) to the open binary stream `f`
    as the snapshot data format: sorted-name concatenated np.save records.
    Returns (entries, total): each name's locator {offset, bytes, dtype,
    shape, crc32} and the stream length in bytes. The prefill -> decode KV
    handoff (inference/handoff.py) reuses it.

    `fault_site` names a fault_point fired before each record; `delay`
    flushes and sleeps after each record to widen kill windows."""
    entries = {}
    total = 0
    for name in sorted(arrays):
        arr = _host(arrays[name])
        data = _array_bytes(arr)
        if fault_site:
            fault_point(fault_site)
        f.write(data)
        if delay:
            f.flush()
            time.sleep(delay)
        entries[name] = {
            "offset": total,
            "bytes": len(data),
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
            "crc32": zlib.crc32(data) & 0xFFFFFFFF,
        }
        total += len(data)
    return entries, total


def write_snapshot(root: str, step: int, arrays: dict, extra: dict = None,
                   keep: int = None, specs: dict = None,
                   mesh_shape: dict = None) -> str:
    """Write and commit one snapshot synchronously -> the committed
    directory. `extra` rides in the manifest (the executor's seed counter,
    the readers' cursors). `specs` and `mesh_shape` (by default those of
    `arrays` and of the current mesh) are recorded as the JAX package
    records them."""
    if specs is None:
        specs = snapshot_specs(arrays)
    if mesh_shape is None:
        mesh_shape = snapshot_mesh_shape()
    arrays = _gathered(arrays)
    return _commit(root, step, lambda f, delay: pack_stream(
        f, arrays, fault_site="snapshot.flush.write", delay=delay),
        extra, keep, specs, mesh_shape)


def _commit(root, step, pack, extra=None, keep=None, specs=None, mesh_shape=None):
    """write_snapshot's commit around `pack(f, delay) -> (entries, total)`,
    which writes the data stream."""
    final = snapshot_dir(root, step)
    tmp = final + "@tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    delay = float(os.environ.get(_INJECT_DELAY_ENV, "0") or 0)
    t0 = time.perf_counter()
    with open(os.path.join(tmp, DATA_FILE), "wb") as f:
        entries, total = pack(f, delay)
        _maybe_fsync(f)
    for name, spec in (specs or {}).items():
        if name in entries:
            entries[name]["spec"] = spec
    manifest = {
        "version": FORMAT_VERSION,
        "step": int(step),
        "data_file": DATA_FILE,
        "data_bytes": total,
        "vars": entries,
        "extra": dict(extra or {}),
    }
    if mesh_shape:
        manifest["mesh"] = dict(mesh_shape)
    # the manifest is the validity marker and lands last, in one write
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        f.write(json.dumps(manifest))
        _maybe_fsync(f)
    _maybe_fsync_dir(tmp)
    fault_point("snapshot.commit")
    if os.path.isdir(final):
        # os.replace cannot clobber a non-empty directory: move the old
        # one aside; a crash between the renames loses only this step
        old = final + "@old"
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.rename(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old)
    else:
        os.replace(tmp, final)
    _maybe_fsync_dir(root)
    _bump("ckpt_save_ms", int((time.perf_counter() - t0) * 1000))
    _bump("ckpt_bytes", total)
    _bump("ckpt_snapshots_committed")
    if keep is not None:
        prune_snapshots(root, keep)
    return final


def read_manifest(path: str):
    """The parsed MANIFEST.json of a snapshot directory, or None when it is
    absent, corrupt or from a newer writer."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(m, dict) or "step" not in m or "vars" not in m:
        return None
    if m.get("version", 0) > FORMAT_VERSION:
        return None
    return m


def list_snapshots(root: str):
    """Committed snapshot directories as [(step, path)], newest first;
    `@tmp` / `@old` working directories are never listed."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for n in names:
        if not n.startswith(SNAPSHOT_PREFIX) or "@" in n:
            continue
        try:
            step = int(n[len(SNAPSHOT_PREFIX):])
        except ValueError:
            continue
        out.append((step, os.path.join(root, n)))
    out.sort(reverse=True)
    return out


def validate_snapshot(path: str, deep: bool = False):
    """The manifest parses and the data file has the recorded byte count
    (`deep=True` also checks every var's crc32) -> the manifest, or
    SnapshotError naming what is wrong."""
    m = read_manifest(path)
    if m is None:
        raise SnapshotError(f"{path}: missing/corrupt {MANIFEST}")
    fp = os.path.join(path, m.get("data_file", DATA_FILE))
    try:
        size = os.path.getsize(fp)
    except OSError:
        raise SnapshotError(f"{path}: data file missing")
    if size != m.get("data_bytes", -1):
        raise SnapshotError(
            f"{path}: data file is {size} bytes, manifest says "
            f"{m.get('data_bytes')} (torn write)")
    if deep:
        with open(fp, "rb") as f:
            for name, ent in m["vars"].items():
                f.seek(ent["offset"])
                crc = zlib.crc32(f.read(ent["bytes"])) & 0xFFFFFFFF
                if crc != ent["crc32"]:
                    raise SnapshotError(
                        f"{path}: var {name!r} crc32 {crc:#x} != manifest "
                        f"{ent['crc32']:#x} (bit rot / torn write)")
    return m


def load_snapshot(path: str, names=None):
    """(arrays, manifest), every read checked against its var's crc32: a
    corrupt range raises SnapshotError naming the var. `names` restricts
    which vars load."""
    m = validate_snapshot(path)
    arrays = {}
    want = set(names) if names is not None else None
    fp = os.path.join(path, m.get("data_file", DATA_FILE))
    with open(fp, "rb") as f:
        for name, ent in m["vars"].items():
            if want is not None and name not in want:
                continue
            f.seek(ent["offset"])
            data = f.read(ent["bytes"])
            if (zlib.crc32(data) & 0xFFFFFFFF) != ent["crc32"]:
                raise SnapshotError(
                    f"{path}: var {name!r} fails crc32 (corrupt snapshot)")
            arrays[name] = np.load(_io.BytesIO(data), allow_pickle=False)
    if want is not None:
        missing = want - set(arrays)
        if missing:
            raise SnapshotError(f"{path}: snapshot lacks vars {sorted(missing)}")
    return arrays, m


def prune_snapshots(root: str, keep: int):
    """Delete all but the newest `keep` committed snapshots, with any
    `@tmp` / `@old` debris of the pruned steps."""
    for _, path in list_snapshots(root)[max(int(keep), 1):]:
        shutil.rmtree(path, ignore_errors=True)
        for suffix in ("@tmp", "@old"):
            shutil.rmtree(path + suffix, ignore_errors=True)


_NP_DTYPES = {}


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype not in _NP_DTYPES:
        _NP_DTYPES[dtype] = torch.empty(0, dtype=dtype).numpy().dtype
    return _NP_DTYPES[dtype]


class _Slot:
    """Host memory holding one snapshot's state.bin image: each record's
    np.save header, written once, followed by room for its data, records in
    sorted-name order. Allocated (pinned when the values lie on the card)
    at the first snapshot of a layout and reused while the values keep
    their names, shapes and dtypes: pinning ~1.3 GB takes far longer than
    copying into it. The flush writes and checksums the image a record at
    a time, straight from this memory: no serialization in Python, which
    would hold the GIL that the training thread's every op releases and
    takes back."""

    def __init__(self):
        self.layout = None
        self.image = None  # a uint8 tensor
        self.records = []  # (name, offset, header bytes, data bytes, dtype name, shape)
        self.total = 0

    def fit(self, layout, pinned):
        """`layout`: sorted (name, shape, numpy dtype str)."""
        key = (tuple(layout), pinned)
        if key == self.layout:
            return
        self.image, records, total = None, [], 0
        heads = []
        for name, shape, dt in layout:
            head = _io.BytesIO()
            np.lib.format.write_array_header_1_0(head, {
                "descr": np.lib.format.dtype_to_descr(np.dtype(dt)),
                "fortran_order": False, "shape": tuple(shape)})
            head = head.getvalue()
            n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
            records.append((name, total, len(head), n, str(np.dtype(dt)), list(shape)))
            heads.append(head)
            total += len(head) + n
        self.image = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=pinned)
        view = self.image.numpy()
        for (_, off, hl, *_), head in zip(records, heads):
            view[off:off + hl] = np.frombuffer(head, np.uint8)
        self.records, self.total, self.layout = records, total, key

    def data(self, i):
        """Record i's data bytes, as a uint8 tensor view."""
        _, off, hl, n, _, _ = self.records[i]
        return self.image[off + hl:off + hl + n]

    def pack(self, f, delay=0.0):
        """pack_stream over the image -> (entries, total)."""
        view, entries = self.image.numpy(), {}
        for name, off, hl, n, dt, shape in self.records:
            rec = view[off:off + hl + n]
            fault_point("snapshot.flush.write")
            f.write(rec)
            if delay:
                f.flush()
                time.sleep(delay)
            entries[name] = {"offset": off, "bytes": hl + n, "dtype": dt, "shape": shape,
                             "crc32": zlib.crc32(rec) & 0xFFFFFFFF}
        return entries, self.total


class _Copied:
    """One submitted snapshot: its slot, whose image the copies on the
    engine's stream fill once `done` has fired (`start` and `done` time
    them), or the error its values raised, for the flush to report."""

    def __init__(self, slot, start=None, done=None, error=None):
        self.slot = slot
        self.start = start
        self.done = done
        self.error = error

    def copy_ms(self):
        if self.done is None:
            return None
        return self.start.elapsed_time(self.done)


# every live engine: a static step (Executor.run_repeated) writes the
# scope's state tensors in place, so it waits for their copies first
_ENGINES = weakref.WeakSet()


def wait_for_copies(device):
    """Make `device`'s current stream wait until every engine's copies off
    the card queued so far have read their sources (device-side: the host
    does not wait)."""
    current = torch.cuda.current_stream(device)
    for engine in list(_ENGINES):
        stream = engine._streams.get(torch.device(device))
        if stream is not None:
            current.wait_stream(stream)


class AsyncSnapshotEngine:
    """Background-thread snapshot writer with a one-deep queue.

    `submit(step, arrays)` starts the copies of the step's values off the
    card (see the module docstring) and hands them to the flush thread,
    returning before any byte is written: step N+1 runs while step N's
    snapshot flushes. Two slots, one for the snapshot in flight and one for
    the queued, bound host memory: a submit that finds both taken waits
    until a flush frees one. Flush failures are sticky: they raise on the
    next submit() / drain()."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = int(keep)
        os.makedirs(root, exist_ok=True)
        self._cv = threading.Condition()
        self._pending = None  # (step, _Copied, extra, specs, mesh shape)
        self._busy = False
        self._closed = False
        self._error = None
        self._blocked_s = 0.0  # producer wait time, consumed per flush
        self._last_committed = None
        self._thread = None
        self._free = [_Slot(), _Slot()]
        self._streams = {}  # device -> the engine's copy stream
        _ENGINES.add(self)
        self.submit_ms = []  # per submit: the time it held the caller
        self.copy_ms = []  # per flushed snapshot from the card: its copy's ms

    # -- producer side --------------------------------------------------
    def _copy(self, arrays: dict, slot: _Slot) -> _Copied:
        """Fill `slot` with `arrays`: host values at once, card tensors by
        copies on the engine's stream that start when the caller's stream
        reaches this point."""
        values, layout = {}, []
        for k in sorted(arrays):
            v = arrays[k]
            if isinstance(v, torch.Tensor):
                v = v.detach()
                if v.dtype == torch.bfloat16:  # numpy has no bfloat16
                    v = v.float()
                v = v.contiguous()
                dt = _np_dtype(v.dtype)
            else:
                v = np.asarray(v, order="C")
                dt = v.dtype
                if dt.hasobject:
                    return _Copied(slot, error=ValueError(
                        f"{k!r}: object arrays cannot be saved when allow_pickle=False"))
            values[k] = v
            layout.append((k, tuple(v.shape), dt.str))
        on_card = [k for k, v in values.items() if isinstance(v, torch.Tensor) and v.is_cuda]
        slot.fit(layout, pinned=bool(on_card))
        for i, k in enumerate(values):
            v = values[k]
            if k in on_card or not slot.records[i][3]:
                continue
            host = v.reshape(-1).view(torch.uint8) if isinstance(v, torch.Tensor) else \
                torch.from_numpy(v.reshape(-1).view(np.uint8))
            slot.data(i).copy_(host)
        if not on_card:
            return _Copied(slot)
        device = values[on_card[0]].device
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        stepped = torch.cuda.Event()
        stepped.record(torch.cuda.current_stream(device))
        stream.wait_event(stepped)
        index = {k: i for i, k in enumerate(values)}
        with torch.cuda.stream(stream):
            start.record(stream)
            for k in on_card:
                t = values[k]
                if t.numel():
                    slot.data(index[k]).copy_(t.reshape(-1).view(torch.uint8),
                                              non_blocking=True)
                # the block stays the copy's until the stream passes here
                t.record_stream(stream)
            done.record(stream)
        return _Copied(slot, start, done)

    def _wait(self, busy):
        """Wait (holding the lock) while `busy()`, counting the time as the
        producer's and raising a flush error that lands meanwhile."""
        t0 = time.perf_counter()
        while busy():
            self._cv.wait(0.1)
            self._raise_pending_error()
        self._blocked_s += time.perf_counter() - t0

    def submit(self, step: int, arrays: dict, extra: dict = None):
        t_submit = time.perf_counter()
        # the specs and mesh of THIS submit, before DTensors are gathered
        specs, mesh_shape = snapshot_specs(arrays), snapshot_mesh_shape()
        arrays = _gathered(arrays)
        with self._cv:
            self._raise_pending_error()
            if self._closed:
                raise RuntimeError("AsyncSnapshotEngine is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="ckpt-flush", daemon=True)
                self._thread.start()
            self._wait(lambda: not self._free)
            slot = self._free.pop()
        try:
            copied = self._copy(arrays, slot)
        except BaseException:
            with self._cv:
                self._free.append(slot)
            raise
        with self._cv:
            self._wait(lambda: self._pending is not None)
            self._pending = (int(step), copied, dict(extra or {}), specs, mesh_shape)
            self._cv.notify_all()
        self.submit_ms.append((time.perf_counter() - t_submit) * 1e3)

    def drain(self):
        """Block until every submitted snapshot has committed (or raise the
        deferred flush error)."""
        with self._cv:
            t0 = time.perf_counter()
            while self._pending is not None or self._busy:
                self._cv.wait(0.1)
            self._blocked_s += time.perf_counter() - t0
            self._raise_pending_error()

    def close(self):
        self.drain()
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    @property
    def last_committed(self):
        """(step, path) of the newest snapshot this engine committed."""
        with self._cv:
            return self._last_committed

    def _raise_pending_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise SnapshotError(f"async snapshot flush failed: {err}") from err

    # -- flush thread ----------------------------------------------------
    def _loop(self):
        while True:
            with self._cv:
                while self._pending is None and not self._closed:
                    self._cv.wait(0.2)
                if self._pending is None and self._closed:
                    return
                step, copied, extra, specs, mesh_shape = self._pending
                self._pending = None
                self._busy = True
                blocked_before = self._blocked_s
                self._cv.notify_all()
            t0 = time.perf_counter()
            try:
                if copied.error is not None:
                    raise copied.error
                if copied.done is not None:
                    copied.done.synchronize()
                path = _commit(self.root, step, copied.slot.pack, extra=extra, keep=self.keep,
                               specs=specs, mesh_shape=mesh_shape)
                flush_s = time.perf_counter() - t0
                copy_ms = copied.copy_ms()
                with self._cv:
                    self._last_committed = (step, path)
                    if copy_ms is not None:
                        self.copy_ms.append(copy_ms)
                    # flush time the producer did not spend waiting: the
                    # time the save overlapped training
                    waited = self._blocked_s - blocked_before
                    self._blocked_s = blocked_before
                _bump("ckpt_async_overlap_ms",
                      int(max(flush_s - waited, 0.0) * 1000))
            except BaseException as e:  # noqa: BLE001 — raised on submit/drain
                with self._cv:
                    self._error = e
            finally:
                with self._cv:
                    self._free.append(copied.slot)
                    copied = None
                    self._busy = False
                    self._cv.notify_all()
