"""Dataset / slot data feed (the JAX package's dataset.py):
`DatasetFactory().create_dataset("QueueDataset" | "InMemoryDataset")`.

Files in the MultiSlot text format are parsed by Python on the host into
dense, statically shaped batches: a sparse slot becomes a [batch, width]
int64 array padded with `pad_value`. The batches stream through
`Executor.train_from_dataset`, which stages them onto the card ahead of
each step. The JAX package also has a native C++ parser; this package
has only the Python one, the parser that package falls back to, so the
records are the same. `_native_max_bytes` is kept as a field and read by
nothing.

MultiSlot text format (one sample per line, slots in `set_use_var` order):

    <len_0> v ... v_len0 <len_1> v ... v_len1 ...

int64 values for integer (id) slots, floats for float slots. A short
line leaves its remaining slots padded; a line whose first token is not a
count (a header or a comment) is skipped.
"""

from __future__ import annotations

import random
import subprocess

import numpy as np

__all__ = ["DatasetFactory", "DatasetBase", "QueueDataset", "InMemoryDataset"]


class DatasetFactory:
    """Makes a dataset by class name."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        raise ValueError(f"unknown dataset class {datafeed_class!r}")


class DatasetBase:
    def __init__(self):
        self.batch_size = 1
        self.thread_num = 1
        self.filelist: list[str] = []
        self.use_vars = []
        self.pipe_command = None
        self.pad_value = 0
        self.drop_last = False
        self._rng = random.Random(0)

    # -- config (the Fluid dataset surface) ----------------------------
    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self.thread_num = int(thread_num)

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_use_var(self, var_list):
        self.use_vars = list(var_list)

    def set_pipe_command(self, pipe_command):
        """Shell command each file is piped through before parsing; a
        non-zero exit status raises."""
        self.pipe_command = pipe_command

    def set_hdfs_config(self, fs_name, fs_ugi):  # kept for the API; unused
        self._hdfs = (fs_name, fs_ugi)

    def desc(self):
        return {
            "batch_size": self.batch_size,
            "thread_num": self.thread_num,
            "pipe_command": self.pipe_command,
            "slots": [
                {
                    "name": v.name,
                    "dtype": str(v.dtype),
                    "shape": list(v.shape),
                }
                for v in self.use_vars
            ],
        }

    # -- parsing --------------------------------------------------------
    def _slot_specs(self):
        if not self.use_vars:
            raise RuntimeError("call set_use_var before using the dataset")
        specs = []
        for v in self.use_vars:
            dtype = str(v.dtype)
            shape = [d for d in v.shape if d is not None]
            width = 1
            for d in shape[1:]:
                if d and d > 0:
                    width *= d
            is_int = dtype.startswith("int")
            specs.append((v.name, is_int, width, dtype))
        return specs

    def _iter_lines(self, path):
        if self.pipe_command:
            with open(path, "rb") as src:
                proc = subprocess.Popen(
                    self.pipe_command,
                    shell=True,
                    stdin=src,
                    stdout=subprocess.PIPE,
                    text=True,
                )
                try:
                    yield from proc.stdout
                finally:
                    proc.stdout.close()
                    rc = proc.wait()
            if rc != 0:
                raise RuntimeError(
                    f"pipe_command {self.pipe_command!r} exited with "
                    f"status {rc} on {path}"
                )
        else:
            with open(path) as f:
                yield from f

    # the JAX package's size limit for its native parser, which this
    # package does not have (None = no limit)
    _native_max_bytes: int | None = None

    def _parse_file(self, path, specs):
        """Yield one record per line: list of per-slot numpy arrays (padded /
        truncated to the slot width)."""
        for line in self._iter_lines(path):
            tok = line.split()
            if not tok:
                continue
            rec, i, any_parsed = [], 0, False
            for name, is_int, width, dtype in specs:
                # short/malformed lines leave the remaining slots padded;
                # a line whose first token isn't a count (header/comment)
                # is skipped entirely
                n = 0
                if i < len(tok):
                    try:
                        n = int(tok[i])
                        i += 1
                        any_parsed = True
                    except ValueError:
                        i = len(tok)
                vals = tok[i : i + n]
                i += n
                if is_int:
                    arr = np.full((width,), self.pad_value, dtype="int64")
                    conv = []
                    for t in vals[:width]:
                        try:
                            conv.append(int(t))
                        except ValueError:
                            break
                    arr[: len(conv)] = conv
                else:
                    arr = np.zeros((width,), dtype="float32")
                    conv = []
                    for t in vals[:width]:
                        try:
                            conv.append(float(t))
                        except ValueError:
                            break
                    arr[: len(conv)] = conv
                rec.append(arr)
            if any_parsed:
                yield rec

    def _iter_records(self):
        specs = self._slot_specs()
        for path in self.filelist:
            yield from self._parse_file(path, specs)

    def _batch_records(self, records):
        specs = self._slot_specs()
        buf = []
        for rec in records:
            buf.append(rec)
            if len(buf) == self.batch_size:
                yield self._stack(buf, specs)
                buf = []
        if buf and not self.drop_last:
            yield self._stack(buf, specs)

    @staticmethod
    def _stack(buf, specs):
        feed = {}
        for si, (name, is_int, width, dtype) in enumerate(specs):
            feed[name] = np.stack([r[si] for r in buf]).astype(
                dtype if not is_int else "int64"
            )
        return feed

    def batches(self, num_threads=1):
        """Iterate feed dicts (the batches of Executor.train_from_dataset).
        num_threads > 1 parses file shards concurrently, one thread per
        shard; record order across files is relaxed (the records are the
        same multiset)."""
        if num_threads <= 1 or len(self.filelist) <= 1:
            yield from self._batch_records(self._iter_records())
            return
        import queue as _q
        import threading

        num_threads = min(num_threads, len(self.filelist))
        done_token = object()
        stop = threading.Event()
        q: _q.Queue = _q.Queue(maxsize=4096)
        specs = self._slot_specs()
        shards = [self.filelist[i::num_threads] for i in range(num_threads)]

        def put(item):
            # bounded put that gives up when the consumer abandoned the
            # generator (early break / exception): otherwise workers block
            # on a full queue forever, pinning threads + parsed records
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _q.Full:
                    continue
            return False

        def worker(paths):
            try:
                for path in paths:
                    for rec in self._parse_file(path, specs):
                        if not put(rec):
                            return
            except BaseException as exc:  # propagate, don't drop the shard
                put(("__error__", exc))
            finally:
                put(done_token)

        threads = [
            threading.Thread(target=worker, args=(s,), daemon=True)
            for s in shards
        ]
        for t in threads:
            t.start()

        def gen():
            remaining = len(threads)
            while remaining:
                item = q.get()
                if item is done_token:
                    remaining -= 1
                    continue
                if (isinstance(item, tuple) and len(item) == 2
                        and item[0] == "__error__"):
                    raise item[1]
                yield item

        try:
            yield from self._batch_records(gen())
        finally:
            stop.set()


class QueueDataset(DatasetBase):
    """Streaming dataset: files are read and parsed on the fly per epoch."""

    _native_max_bytes = 256 << 20

    def local_shuffle(self):
        raise RuntimeError(
            "QueueDataset does not support shuffle; use InMemoryDataset"
        )

    def global_shuffle(self, fleet=None):
        raise RuntimeError(
            "QueueDataset does not support shuffle; use InMemoryDataset"
        )


class InMemoryDataset(DatasetBase):
    """Loads all records into host memory and supports shuffle (a global
    shuffle is the local one, `random.Random(0)`, as in the JAX package)."""

    def __init__(self):
        super().__init__()
        self._memory: list | None = None

    def load_into_memory(self):
        self._memory = list(self._iter_records())

    def get_memory_data_size(self, fleet=None):
        return 0 if self._memory is None else len(self._memory)

    def local_shuffle(self):
        if self._memory is None:
            raise RuntimeError("load_into_memory first")
        self._rng.shuffle(self._memory)

    def global_shuffle(self, fleet=None, thread_num=12):
        self.local_shuffle()

    def release_memory(self):
        self._memory = None

    def batches(self, num_threads=1):
        # records already in RAM: thread parallelism applies to the load
        # (load_into_memory), not iteration
        if self._memory is None:
            self.load_into_memory()
        yield from self._batch_records(iter(self._memory))
