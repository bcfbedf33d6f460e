"""DeviceStager: a background staging thread between a batch source and
the training loop (the JAX package's reader/stager.py, on a CUDA copy
stream).

Items pulled from a source iterator go through a `stage` function on a
dedicated thread, which keeps up to `depth` staged batches ahead of the
consumer. Shared by the two input pipelines: `DataLoader.__iter__` with
`use_double_buffer=True`, and `Executor.train_from_dataset` /
`infer_from_dataset`.

`device` says where the staged tensors go:

* None: `stage`'s output is queued as it is (the thread and queue
  contract alone).
* a CPU device: each numpy array in `stage`'s output (in dicts, lists and
  tuples) becomes a CPU tensor.
* a CUDA device: each array becomes a tensor in pinned host memory, and
  the stager thread copies them all with `non_blocking=True` on a
  `torch.cuda.Stream` of its own, created on that thread under
  `torch.cuda.device(device)`, then records a `torch.cuda.Event` after
  the copies. Before the consumer gets a batch, its current stream waits
  on that event, and every staged tensor is marked with
  `record_stream(current stream)`: the tensors were allocated on the copy
  stream, and without the mark the caching allocator could hand a
  tensor's block back to the copy stream, and the next batch's copy
  could overwrite it, while the step still reads it. The copy of batch
  N+1 thus overlaps the step on batch N, and the host conversion runs off
  the consumer thread.

Error and termination contract (the JAX package's): a source or stage
exception is re-raised in the consumer, never swallowed and never turned
into an end of stream; `close()` unblocks and stops the thread whatever
the consumer did (break or exception mid-iteration included), and on the
card waits for the copy stream, so no copy or pinned block is left in
flight. Items are staged strictly in source order. Every staged item
bumps the `reader_staged_batches` counter."""

from __future__ import annotations

import queue as _queue
import threading

import numpy as np
import torch

from .. import profiler

__all__ = ["DeviceStager", "host_tensor"]

_DONE = object()
# how long close() waits for the stager thread before it moves on: the
# thread may sit in a user reader that never returns
_JOIN_S = 10.0


class _StageError:
    def __init__(self, exc):
        self.exc = exc


class _Staged:
    """A batch staged on the card: its value, the event recorded after its
    copies, and the tensors the consumer's stream must be recorded on."""

    def __init__(self, value, event, tensors):
        self.value = value
        self.event = event
        self.tensors = tensors


def host_tensor(value, dtype=None) -> torch.Tensor:
    """A host array as a CPU tensor of `dtype` (a torch dtype), or of its
    own dtype with float64 as float32 (the Executor's feed rule)."""
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(value)))
    want = dtype if dtype is not None else (
        torch.float32 if t.dtype == torch.float64 else t.dtype)
    return t.to(dtype=want)


def _map_leaves(value, fn):
    """`value` with `fn` applied to every array or tensor inside its dicts,
    lists and tuples; other leaves (ints, strings) as they are."""
    if isinstance(value, dict):
        return {k: _map_leaves(v, fn) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_map_leaves(v, fn) for v in value)
    if isinstance(value, (np.ndarray, torch.Tensor)):
        return fn(value)
    return value


class DeviceStager:
    def __init__(self, source, stage, depth: int = 2, device=None,
                 time_copies: bool = False):
        """source: iterable of raw items; stage: item -> staged item, run on
        the stager thread; depth: staged batches kept ahead; device: None,
        or the torch device the arrays of a staged item go to;
        time_copies: on the card, keep a pair of timing events around each
        batch's copies (`copy_ms()`)."""
        self._source = source
        self._stage = stage
        self._device = torch.device(device) if device is not None else None
        self._cuda = self._device is not None and self._device.type == "cuda"
        self._time_copies = bool(time_copies) and self._cuda
        self._copy_events = []
        self._copy_stream = None
        self._q: _queue.Queue = _queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that aborts when the consumer closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except _queue.Full:
                continue
        return False

    def _to_device(self, value):
        """`value`'s arrays as tensors on the stager's device; on the card,
        a _Staged whose copies were issued on the copy stream."""
        value = _map_leaves(value, host_tensor)
        if not self._cuda:
            return value
        # pin every array first, so the timing events bracket the copies
        # alone
        value = _map_leaves(value, lambda t: t if t.is_cuda else t.pin_memory())
        tensors = []

        def copy(t):
            t = t if t.is_cuda else t.to(self._device, non_blocking=True)
            tensors.append(t)
            return t

        with torch.cuda.stream(self._copy_stream):
            start = None
            if self._time_copies:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            value = _map_leaves(value, copy)
            done = torch.cuda.Event(enable_timing=self._time_copies)
            done.record()
        if start is not None:
            self._copy_events.append((start, done))
        return _Staged(value, done, tensors)

    def _run(self):
        try:
            if self._cuda:
                with torch.cuda.device(self._device):
                    self._copy_stream = torch.cuda.Stream(self._device)
            for item in self._source:
                if self._stop.is_set():
                    return
                staged = self._stage(item)
                if self._device is not None:
                    staged = self._to_device(staged)
                profiler.bump_counter("reader_staged_batches")
                if not self._put(staged):
                    return
        except BaseException as exc:  # noqa: BLE001 — via the queue
            self._put(_StageError(exc))
        else:
            self._put(_DONE)

    def _ready(self, item):
        """A staged batch made safe to read on the consumer's stream."""
        current = torch.cuda.current_stream(self._device)
        current.wait_event(item.event)
        for t in item.tensors:
            t.record_stream(current)
        return item.value

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if item is _DONE:
                    return
                if isinstance(item, _StageError):
                    raise item.exc
                if isinstance(item, _Staged):
                    item = self._ready(item)
                yield item
        finally:
            self.close()

    def copy_ms(self):
        """Device milliseconds of each staged batch's copies (time_copies
        on the card), from the events on the copy stream."""
        out = []
        for start, done in self._copy_events:
            done.synchronize()
            out.append(start.elapsed_time(done))
        return out

    def close(self):
        """Stop the stager thread and drop queued items. Safe to call
        repeatedly; called automatically when iteration ends or the
        consumer abandons the iterator. On the card it then waits for the
        copy stream, so no copy is in flight once it returns."""
        self._stop.set()
        self._drain()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=_JOIN_S)
            self._drain()
        if self._copy_stream is not None:
            self._copy_stream.synchronize()

    def _drain(self):
        # a blocked put wakes at once
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass
