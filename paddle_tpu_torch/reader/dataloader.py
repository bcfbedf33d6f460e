"""DataLoader / PyReader: a host producer thread and a device double
buffer (the JAX package's reader/dataloader.py, staging through pinned
memory on a CUDA copy stream).

The loader is a host-side iterator that (a) batches and converts
examples on a background thread, `capacity` batches deep, and (b) with
`use_double_buffer=True` keeps two batches already copied to the device
through the shared `DeviceStager` (reader/stager.py), so the step does not
wait on the host-to-device copy.

- **Place**: the staged tensors go to the device of `places` (the first
  place when it is a list). The default is `CUDAPlace(0)`; `CPUPlace()`
  asks for the CPU. With no card and no CPU place, `iter(loader)` raises
  and names `CPUPlace()`: the loader never stages on the CPU unasked.
  Each staged tensor has its feed var's dtype (int64 stays int64), so
  `Executor.run` uses it as it is, with no second copy. With
  `use_double_buffer=False` the loader yields numpy feed dicts.
- **Cursor**: the loader tracks `(epoch, batch, shuffle_seed)`. `batch`
  is the raw index (position in the epoch's batch stream, counted even
  for batches `on_bad_sample="skip"` dropped) of the next batch to
  yield, bumped when a batch is handed to the consumer, never when the
  producer thread merely prefetched it. `state_dict()` returns the
  cursor; `set_state_dict(cursor)` arms a rewind: the next `__iter__`
  regenerates the epoch stream (same shuffle seed, same order) and skips
  the consumed prefix without converting or staging it, so a resumed run
  gets exactly the batches the uninterrupted run would have.
- **Deterministic shuffle**: `shuffle_buf=K, shuffle_seed=S` on
  `set_sample_generator` applies a buffered shuffle whose RNG is seeded
  per epoch from `(S * 1000003 + epoch) & 0xFFFFFFFF`, reproducible
  across restarts, and the seed rides in the cursor.
- **Bad samples**: `on_bad_sample="skip"` turns a sample that fails feed
  conversion into a logged skip and a bump of the `reader_bad_samples`
  counter (one per dropped sample; whole-batch drops, of raw batches or
  of batches that fail to stack with no single offender, count in
  `reader_bad_batches`). "raise", the default, re-raises.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading

import numpy as np

from ..ops.registry import TORCH_DTYPE
from ..place import CUDAPlace

__all__ = ["DataLoader", "PyReader", "batch"]

_logger = logging.getLogger(__name__)


def batch(reader, batch_size, drop_last=False):
    """Group a sample reader's examples into lists of `batch_size`."""

    def batch_reader():
        b = []
        for e in reader():
            b.append(e)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


class _EndOfEpoch:
    pass


class _ProducerError:
    def __init__(self, exc):
        self.exc = exc


class DataLoader:
    """`DataLoader.from_generator(...)`: iterate to get feed dicts."""

    def __init__(self, feed_list=None, capacity=16, iterable=True,
                 return_list=False, prefetch_to_device=True,
                 on_bad_sample="raise"):
        self._feed_list = feed_list
        self._feeder_cache = None
        self._capacity = capacity
        self._iterable = iterable
        self._return_list = return_list
        self._prefetch = prefetch_to_device
        self._sample_gen = None
        self._batch_gen = None
        self._places = None
        if on_bad_sample not in ("raise", "skip"):
            raise ValueError(
                f"on_bad_sample must be 'raise' or 'skip', got "
                f"{on_bad_sample!r}")
        self._on_bad_sample = on_bad_sample
        # resumable-cursor state: epoch = index of the epoch the NEXT
        # __iter__ serves (or the one in progress), batch = raw index of
        # the next batch to yield within it. shuffle_* configure the
        # loader-owned deterministic shuffle (set_sample_generator).
        self._cursor = {"epoch": 0, "batch": 0}
        self._pending_skip = None  # armed by set_state_dict
        self._shuffle_buf = 0
        self._shuffle_seed = 0
        self._sample_reader = None  # kept for per-epoch shuffle rebuild
        self._batch_size = None
        self._drop_last = True
        # set True to keep CUDA timing events around each staged batch's
        # copies; `last_stager` is the stager of the latest epoch
        self.time_copies = False
        self.last_stager = None

    # -- wiring --------------------------------------------------------
    @staticmethod
    def from_generator(feed_list, capacity=16, use_double_buffer=True,
                       iterable=True, return_list=False,
                       use_multiprocess=False, drop_last=True,
                       on_bad_sample="raise"):
        return DataLoader(feed_list, capacity, iterable, return_list,
                          prefetch_to_device=use_double_buffer,
                          on_bad_sample=on_bad_sample)

    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None, shuffle_buf=0, shuffle_seed=0):
        """Sample-level reader -> batches. With `shuffle_buf > 0` the
        sample stream passes through a buffered shuffle whose RNG seeds
        from `(shuffle_seed, epoch)` — deterministic, and replayed
        exactly by a cursor rewind (reader.shuffle draws from the global
        `random`, which a restart cannot replay)."""
        self._sample_reader = reader
        self._batch_size = int(batch_size)
        self._drop_last = drop_last
        self._shuffle_buf = int(shuffle_buf)
        self._shuffle_seed = int(shuffle_seed)
        self._batch_gen = None  # built per-epoch (seeded shuffle)
        self._places = places
        return self

    def set_sample_list_generator(self, reader, places=None):
        self._batch_gen = reader
        self._sample_reader = None  # re-wiring must actually take effect
        self._places = places
        return self

    def set_batch_generator(self, reader, places=None):
        self._batch_gen = reader
        self._sample_reader = None  # re-wiring must actually take effect
        self._places = places
        self._raw_batches = True
        return self

    @property
    def _feeder(self):
        if self._feeder_cache is None:
            if self._feed_list is None:
                raise RuntimeError(
                    "DataLoader needs feed_list vars before iteration"
                )
            from ..data_feeder import DataFeeder

            self._feeder_cache = DataFeeder(self._feed_list)
        return self._feeder_cache

    # -- resumable cursor ----------------------------------------------
    def state_dict(self):
        """Serializable position of the pipeline: `epoch`, `batch` (raw
        index of the next batch to yield — bumped when a batch is handed
        to the consumer, so a snapshot taken while the training step runs
        records exactly the batches already consumed), and the
        `shuffle_seed` that keys the per-epoch permutation."""
        return {
            "epoch": int(self._cursor["epoch"]),
            "batch": int(self._cursor["batch"]),
            "shuffle_seed": int(self._shuffle_seed),
        }

    def set_state_dict(self, state):
        """Arm a rewind to `state` (a `state_dict()` value): the next
        `__iter__` serves epoch `state["epoch"]` with the first
        `state["batch"]` raw batches fast-forwarded (regenerated but never
        converted or staged), so the resumed stream continues bitwise where
        the snapshot left off."""
        epoch = int(state["epoch"])
        skip = int(state.get("batch", 0))
        if "shuffle_seed" in state:
            self._shuffle_seed = int(state["shuffle_seed"])
        self._cursor = {"epoch": epoch, "batch": skip}
        self._pending_skip = skip
        return self

    # legacy-flavored aliases (the optimizer/layer state_dict vocabulary)
    load_state_dict = set_state_dict

    def _epoch_batches(self, epoch):
        """The batch stream for `epoch`: loader-owned batching (and the
        seeded per-epoch shuffle) when a sample reader was given,
        otherwise the user's batch generator as-is."""
        if self._sample_reader is not None:
            reader = self._sample_reader
            if self._shuffle_buf > 0:
                base = reader
                buf_size = self._shuffle_buf
                # per-epoch RNG: same (seed, epoch) -> same permutation,
                # across processes and restarts (no hash(): int mixing
                # only, immune to PYTHONHASHSEED)
                seed = (self._shuffle_seed * 1000003 + epoch) & 0xFFFFFFFF

                def shuffled(_base=base, _seed=seed):
                    rng = np.random.RandomState(_seed)
                    buf = []
                    for e in _base():
                        buf.append(e)
                        if len(buf) >= buf_size:
                            rng.shuffle(buf)
                            yield from buf
                            buf = []
                    if buf:
                        rng.shuffle(buf)
                        yield from buf

                reader = shuffled
            return batch(reader, self._batch_size,
                         drop_last=self._drop_last)()
        if self._batch_gen is None:
            raise RuntimeError("call set_sample_generator/... first")
        return self._batch_gen()

    def _convert(self, b, raw):
        """Raw batch -> feed dict. Under on_bad_sample='skip' a failing
        conversion drops the offending samples (counted per sample in
        the always-on `reader_bad_samples` counter) instead of killing
        the producer; a batch with zero good samples returns None."""
        names = None
        if raw:
            names = [v.name for v in self._feeder.feed_vars]
        try:
            if raw:
                return {n: np.asarray(a) for n, a in zip(names, b)}
            return self._feeder.feed(b)
        except Exception as exc:  # noqa: BLE001 — classified below
            if self._on_bad_sample != "skip":
                raise
            from .. import profiler

            if raw or not isinstance(b, (list, tuple)):
                # a raw device-batch has no per-sample structure to
                # salvage: drop it whole (its own counter — a raw batch
                # has an unknown sample count, so bumping the per-sample
                # counter would be a made-up number)
                profiler.bump_counter("reader_bad_batches")
                _logger.warning("DataLoader: skipping bad batch (%s: %s)",
                                type(exc).__name__, exc)
                return None
            good, bad = [], 0
            for sample in b:
                try:
                    self._feeder.feed([sample])
                    good.append(sample)
                except Exception as sexc:  # noqa: BLE001 — counted, skipped
                    bad += 1
                    _logger.warning(
                        "DataLoader: skipping bad sample (%s: %s)",
                        type(sexc).__name__, sexc)
            if bad:
                profiler.bump_counter("reader_bad_samples", bad)
            if not good:
                return None
            try:
                return self._feeder.feed(good)
            except Exception as bexc:  # noqa: BLE001 — batch-level fault
                # every sample passed alone but the BATCH still fails
                # (e.g. per-sample shapes that don't stack): there is no
                # offender sample to count — drop the whole batch under
                # its own counter, keep the epoch alive (the skip
                # contract)
                profiler.bump_counter("reader_bad_batches")
                _logger.warning(
                    "DataLoader: skipping batch that fails as a whole "
                    "(%s: %s)", type(bexc).__name__, bexc)
                return None

    # -- iteration -----------------------------------------------------
    def _stage_device(self):
        """The torch device the double buffer stages onto: `places`' (its
        first when a list), CUDAPlace(0) by default; with no card that
        raises, naming CPUPlace()."""
        place = self._places
        if isinstance(place, (list, tuple)):
            place = place[0] if place else None
        return (place if place is not None else CUDAPlace(0)).torch_device()

    def __iter__(self):
        device = self._stage_device() if self._prefetch else None
        return self._iterate(device)

    def _iterate(self, device):
        if self._batch_gen is None and self._sample_reader is None:
            raise RuntimeError("call set_sample_generator/... first")
        raw = getattr(self, "_raw_batches", False)
        epoch = self._cursor["epoch"]
        skip, self._pending_skip = (self._pending_skip or 0), None

        def produce(q):
            try:
                for idx, b in enumerate(self._epoch_batches(epoch)):
                    if idx < skip:
                        # cursor fast-forward: regenerate, never convert
                        # or enqueue — the consumed prefix of the epoch
                        continue
                    feed = self._convert(b, raw)
                    if feed is None:
                        continue  # bad batch skipped; raw idx still burned
                    q.put((idx, feed))
                q.put(_EndOfEpoch)
            except BaseException as exc:  # propagate, don't fake end-of-epoch
                q.put(_ProducerError(exc))

        q = _queue.Queue(maxsize=self._capacity)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()

        def finish_epoch():
            self._cursor["epoch"] = epoch + 1
            self._cursor["batch"] = 0

        if device is None:
            while True:
                item = q.get()
                if item is _EndOfEpoch:
                    finish_epoch()
                    return
                if isinstance(item, _ProducerError):
                    raise item.exc
                idx, feed = item
                # bump BEFORE the yield: by the time the consumer trains
                # on this batch (and any snapshot cadence fires inside
                # that step), the cursor already records it as consumed
                self._cursor["batch"] = idx + 1
                yield feed
            return

        # the device double buffer: the producer converts, the stager
        # copies two batches ahead on its copy stream, and the consumer
        # thread only runs the steps
        from .stager import DeviceStager, host_tensor

        dtypes = {}
        if self._feed_list is not None:
            dtypes = {v.name: TORCH_DTYPE(v.dtype) for v in self._feeder.feed_vars}

        def _source():
            while True:
                item = q.get()
                if item is _EndOfEpoch:
                    return
                if isinstance(item, _ProducerError):
                    raise item.exc
                yield item

        def _to_host(item):
            idx, feed = item
            return idx, {k: host_tensor(v, dtypes.get(k)) for k, v in feed.items()}

        stager = DeviceStager(_source(), _to_host, depth=2, device=device,
                              time_copies=self.time_copies)
        self.last_stager = stager
        try:
            for idx, feed in stager:
                # bump BEFORE the yield — same contract as the numpy path
                # above
                self._cursor["batch"] = idx + 1
                yield feed
            finish_epoch()
        finally:
            stager.close()

    def __call__(self):
        return self.__iter__()


class PyReader(DataLoader):
    """The legacy name, with its decorate_* and start / reset surface."""

    def __init__(self, feed_list=None, capacity=16, use_double_buffer=True,
                 iterable=True, return_list=False, on_bad_sample="raise"):
        super().__init__(feed_list, capacity, iterable, return_list,
                         prefetch_to_device=use_double_buffer,
                         on_bad_sample=on_bad_sample)

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        return self.set_sample_generator(sample_generator, batch_size,
                                         drop_last, places)

    def decorate_sample_list_generator(self, reader, places=None):
        return self.set_sample_list_generator(reader, places)

    def decorate_batch_generator(self, reader, places=None):
        return self.set_batch_generator(reader, places)

    def start(self):
        self._iter = iter(self)

    def reset(self):
        self._iter = None
