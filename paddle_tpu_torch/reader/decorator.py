"""Reader decorators, the JAX package's reader/decorator.py: map_readers,
shuffle, chain, compose, buffered, firstn, cache, xmap_readers and
multiprocess_reader, with the same error contracts (a source or mapper
error is re-raised in the consumer, cache commits only a whole pass,
compose raises ComposeNotAligned on readers of different lengths).

A "reader" is a zero-argument callable returning an iterator of
examples, as in Fluid, so user data code runs unchanged.
"""

from __future__ import annotations

import itertools
import multiprocessing
import queue as _queue
import random as _random
import threading

__all__ = [
    "map_readers",
    "shuffle",
    "chain",
    "compose",
    "ComposeNotAligned",
    "buffered",
    "firstn",
    "cache",
    "xmap_readers",
    "multiprocess_reader",
]


class ComposeNotAligned(ValueError):
    """Raised by compose when its readers have different lengths."""


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return reader


def shuffle(reader, buf_size):
    def shuffled():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf

    return shuffled


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            sentinel = object()
            for items in itertools.zip_longest(*rs, fillvalue=sentinel):
                if any(i is sentinel for i in items):
                    raise ComposeNotAligned(
                        "composed readers have different lengths"
                    )
                yield sum((make_tuple(i) for i in items), ())
        else:
            for items in itertools.zip_longest(*rs):
                yield sum(
                    (make_tuple(i) for i in items if i is not None), ()
                )

    return reader


def buffered(reader, size):
    """Background-thread prefetch buffer of `size` examples."""

    class _End:
        pass

    class _Error:
        def __init__(self, exc):
            self.exc = exc

    def buffered_reader():
        q = _queue.Queue(maxsize=size)

        def fill():
            try:
                for e in reader():
                    q.put(e)
                q.put(_End)
            except BaseException as exc:  # propagate to the consumer
                q.put(_Error(exc))

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            if isinstance(e, _Error):
                raise e.exc
            yield e

    return buffered_reader


def firstn(reader, n):
    def reader_n():
        for i, e in enumerate(reader()):
            if i >= n:
                break
            yield e

    return reader_n


def cache(reader):
    all_data = []
    cached = [False]

    def cached_reader():
        if not cached[0]:
            # only commit a COMPLETE pass — an abandoned iterator must not
            # leave a partial (or, on retry, duplicated) cache behind
            this_pass = []
            for e in reader():
                this_pass.append(e)
                yield e
            all_data[:] = this_pass
            cached[0] = True
        else:
            yield from all_data

    return cached_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with `process_num` worker threads;
    `order` keeps the source order."""

    end = object()

    class _Error:
        def __init__(self, exc):
            self.exc = exc

    def xreader():
        in_q = _queue.Queue(buffer_size)
        out_q = _queue.Queue(buffer_size)

        def feed():
            try:
                for i, e in enumerate(reader()):
                    in_q.put((i, e))
            except BaseException as exc:
                out_q.put(_Error(exc))
            finally:
                for _ in range(process_num):
                    in_q.put(end)

        def work():
            try:
                while True:
                    item = in_q.get()
                    if item is end:
                        return
                    i, e = item
                    out_q.put((i, mapper(e)))
            except BaseException as exc:
                out_q.put(_Error(exc))
            finally:
                out_q.put(end)  # always deliver the sentinel — no deadlock

        threading.Thread(target=feed, daemon=True).start()
        workers = [
            threading.Thread(target=work, daemon=True)
            for _ in range(process_num)
        ]
        for w in workers:
            w.start()

        finished = 0
        if order:
            pending = {}
            next_idx = 0
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                if isinstance(item, _Error):
                    raise item.exc
                i, e = item
                pending[i] = e
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
            for i in sorted(pending):
                yield pending[i]
        else:
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                if isinstance(item, _Error):
                    raise item.exc
                yield item[1]

    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Fan-in several readers from worker processes.

    The workers are forked, never spawned: a reader is usually a closure,
    and `spawn` would have to pickle it, which it cannot. A forked child
    inherits the whole parent, on the card its CUDA context and any
    stager thread too. The child touches neither: it runs the reader,
    which yields host data, puts each example on a multiprocessing queue
    and exits, so no CUDA call is made in it (CUDA does not survive a
    fork). A reader that builds card tensors must not be given here.
    Python 3.12 warns about fork in a process with threads; that warning
    stands for this reason."""

    def mp_reader():
        ctx = multiprocessing.get_context("fork")
        q = ctx.Queue(queue_size)

        def worker(r):
            try:
                for e in r():
                    q.put(e)
            finally:
                q.put(None)  # sentinel always delivered — no deadlock

        procs = [
            ctx.Process(target=worker, args=(r,), daemon=True)
            for r in readers
        ]
        for p in procs:
            p.start()
        finished = 0
        while finished < len(readers):
            e = q.get()
            if e is None:
                finished += 1
            else:
                yield e
        failed = False
        for p in procs:
            p.join()
            failed = failed or p.exitcode not in (0, None)
        if failed:
            raise RuntimeError("a multiprocess_reader worker died; see its "
                               "stderr for the traceback")

    return mp_reader
