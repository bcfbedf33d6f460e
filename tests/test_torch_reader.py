"""The port's reader/ and data_feeder.py, and layers.py_reader, held against
the JAX package on the CPU.

- Each decorator gives what the JAX one gives on the same seeded readers
  (shuffle under the same `random` seed; multiprocess_reader and an
  unordered xmap_readers as multisets), with the error contracts of the
  JAX package's reader tests.
- DataFeeder's arrays are the JAX feeder's, byte for byte.
- The DataLoader stream (staged on CPUPlace() and as numpy feeds;
  shuffled; rewound by the cursor at several points; on_bad_sample skip
  and raise with the same counter deltas) is the JAX loader's stream.
- DeviceStager keeps the source order, re-raises source and stage errors,
  and stops without a hang when the consumer walks away.
- A small fc model trains 5 Adam steps from a DataLoader in both
  packages: losses within rtol 1e-5 (fp32 sums over a few dozen terms).

The `gpu` tests stage on the card and read the staged batches as a step
would: behind device-side holds the host does not wait for, while the
stager copies the next batches (they fail without record_stream: the
allocator hands a dropped batch's block to the next copy), and at once as
each copy is issued (they fail without the event wait); and the
DataLoader's default place stages on the card, byte-equal to its numpy
feeds."""

import random
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch import reader as trdr
from paddle_tpu_torch.data_feeder import DataFeeder as TFeeder
from paddle_tpu_torch.reader.stager import DeviceStager


def _jax():
    import paddle_tpu as jfluid
    from paddle_tpu import reader as jrdr

    return jfluid, jrdr


def _count(n=10):
    def r():
        yield from range(n)

    return r


def _pairs():
    def r():
        rs = np.random.RandomState(5)
        for i in range(7):
            yield rs.randn(3).astype("float32"), i

    return r


DECORATORS = {
    "map_readers": lambda rdr: rdr.map_readers(lambda a, b: a * 2 + b, _count(), _count(8)),
    "shuffle": lambda rdr: rdr.shuffle(_count(23), 5),
    "chain": lambda rdr: rdr.chain(_count(3), _count(4)),
    "compose": lambda rdr: rdr.compose(_count(4), _pairs(), check_alignment=False),
    "compose_aligned": lambda rdr: rdr.compose(_count(7), _pairs()),
    "buffered": lambda rdr: rdr.buffered(_pairs(), 2),
    "firstn": lambda rdr: rdr.firstn(_count(), 4),
    "cache": lambda rdr: rdr.cache(_pairs()),
    "xmap_ordered": lambda rdr: rdr.xmap_readers(lambda x: x * 3, _count(17), 3, 4, order=True),
    "xmap_unordered": lambda rdr: rdr.xmap_readers(lambda x: x * 3, _count(17), 3, 4),
    "batch": lambda rdr: rdr.batch(_count(10), 3),
    "batch_drop_last": lambda rdr: rdr.batch(_count(10), 3, drop_last=True),
}


def _flat(x):
    """A reader's output as plain bytes-comparable values."""
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return tuple(_flat(v) for v in x)
    return x


@pytest.mark.parametrize("name", sorted(DECORATORS))
def test_decorator_matches_jax(name):
    _, jrdr = _jax()
    outs = []
    for rdr in (jrdr, trdr):
        random.seed(11)
        reader = DECORATORS[name](rdr)
        runs = [[_flat(e) for e in reader()] for _ in range(2)]  # cache: the second pass
        outs.append(runs)
    if name == "xmap_unordered":
        outs = [[sorted(r) for r in runs] for runs in outs]
    assert outs[0] == outs[1]
    assert outs[1][0]


def _card_free_reader(k):
    def r():
        # a forked child must not touch the card: it yields host data and
        # reports whether CUDA is up in it
        for i in range(5):
            yield (k, i, torch.cuda.is_initialized())

    return r


def test_multiprocess_reader_matches_jax_and_child_is_card_free():
    _, jrdr = _jax()
    got = {}
    for tag, rdr in (("jax", jrdr), ("torch", trdr)):
        got[tag] = sorted(rdr.multiprocess_reader([_card_free_reader(0),
                                                   _card_free_reader(1)])())
    assert got["jax"] == got["torch"]
    assert len(got["torch"]) == 10 and not any(e[2] for e in got["torch"])


def _bad_reader():
    yield 1
    raise ValueError("boom")


def _bad_mapper(x):
    if x == 3:
        raise RuntimeError("bad sample")
    return x


ERROR_CASES = {
    "buffered": (lambda rdr: rdr.buffered(_bad_reader, 2), ValueError, "boom"),
    "xmap": (lambda rdr: rdr.xmap_readers(_bad_mapper, _count(6), 2, 2), RuntimeError,
             "bad sample"),
    "compose": (lambda rdr: rdr.compose(_count(3), _count(2)), None, None),
}


@pytest.mark.parametrize("name", sorted(ERROR_CASES))
def test_decorator_errors_match_jax(name):
    _, jrdr = _jax()
    make, exc, match = ERROR_CASES[name]
    for rdr in (jrdr, trdr):
        want = rdr.decorator.ComposeNotAligned if exc is None else exc
        with pytest.raises(want, match=match):
            list(make(rdr)())
    assert issubclass(trdr.decorator.ComposeNotAligned, ValueError)
    assert len(list(trdr.compose(_count(3), _count(2), check_alignment=False)())) == 3


def test_cache_commits_only_a_whole_pass():
    for rdr in (_jax()[1], trdr):
        c = rdr.cache(_count(5))
        it = c()
        next(it), next(it)  # abandon after 2
        del it
        assert list(c()) == list(range(5))
        assert list(c()) == list(range(5))  # no duplicates


FEED_SPECS = [("img", [1, 28, 28], "float32"), ("label", [1], "int64"),
              ("ids", [5], "int32"), ("flag", [1], "bool"), ("wide", [3], "float64"),
              ("row", [2, 3], "float32")]


def _feed_vars(fluid, specs=FEED_SPECS):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        vs = [fluid.layers.data(n, shape, dtype=dt) for n, shape, dt in specs]
    return main, vs


def _feed_samples(n=6, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.rand(784).astype("float32"), int(rs.randint(10)),
             rs.randint(0, 50, 5).astype("int64"), bool(rs.rand() < 0.5),
             rs.randn(3), rs.rand(6).astype("float32")) for _ in range(n)]


def test_data_feeder_byte_equal_to_jax():
    jfluid, _ = _jax()
    from paddle_tpu.data_feeder import DataFeeder as JFeeder

    samples = _feed_samples()
    jout = JFeeder(_feed_vars(jfluid)[1]).feed(samples)
    tout = TFeeder(_feed_vars(tfluid)[1]).feed(samples)
    assert list(jout) == list(tout)
    for k in jout:
        assert jout[k].dtype == tout[k].dtype and jout[k].shape == tout[k].shape, k
        assert jout[k].tobytes() == tout[k].tobytes(), k
    assert tout["img"].shape == (6, 1, 28, 28) and tout["label"].dtype == np.int64
    # by name, through the program
    main, _ = _feed_vars(tfluid)
    named = TFeeder(["label", "img"], program=main).feed([(s[1], s[0]) for s in samples])
    assert named["label"].tobytes() == tout["label"].tobytes()
    with pytest.raises(ValueError, match="arity"):
        TFeeder(_feed_vars(tfluid)[1]).feed([(1.0,)])


LOADER_SPECS = [("x", [3], "float32"), ("y", [1], "int64")]


def _loader_samples():
    def r():
        rs = np.random.RandomState(3)
        for i in range(22):
            yield rs.randn(3).astype("float32"), i

    return r


def _loader(fluid, rdr, prefetch, places=None, shuffle=True):
    _, vs = _feed_vars(fluid, LOADER_SPECS)
    loader = rdr.DataLoader.from_generator(vs, capacity=3, use_double_buffer=prefetch)
    loader.set_sample_generator(_loader_samples(), 4, drop_last=False,
                                places=places, shuffle_buf=5 if shuffle else 0,
                                shuffle_seed=7)
    return loader


def _host(feed):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in feed.items()}


def _stream(loader, n=None):
    out = []
    for feed in loader:
        out.append(_host(feed))
        if n is not None and len(out) == n:
            break
    return out


@pytest.mark.parametrize("prefetch", [False, True], ids=["numpy_feeds", "staged_cpu"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["in_order", "shuffled"])
def test_dataloader_stream_matches_jax(prefetch, shuffle):
    jfluid, jrdr = _jax()
    jax_epochs = [_stream(_loader(jfluid, jrdr, False, shuffle=shuffle)) for _ in range(1)]
    tl = _loader(tfluid, trdr, prefetch, places=tfluid.CPUPlace(), shuffle=shuffle)
    jl = _loader(jfluid, jrdr, False, shuffle=shuffle)
    for epoch in range(2):  # the second epoch reseeds the shuffle
        want, got = _stream(jl), _stream(tl)
        if epoch == 0:
            assert [sorted(b) for b in want] == [sorted(b) for b in jax_epochs[0]]
        assert len(got) == len(want) == 6
        for a, b in zip(want, got):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    assert tl.state_dict() == jl.state_dict() == {"epoch": 2, "batch": 0, "shuffle_seed": 7}
    if prefetch:
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in next(iter(tl)).values())


def test_dataloader_staged_jax_prefetch_values_agree():
    """The JAX loader's device stream (int32 with x64 off) holds the same
    values as the port's staged stream (int64 kept)."""
    jfluid, jrdr = _jax()
    want = _stream(_loader(jfluid, jrdr, True))
    got = _stream(_loader(tfluid, trdr, True, places=[tfluid.CPUPlace()]))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert got[0]["y"].dtype == np.int64


@pytest.mark.parametrize("at", [0, 1, 3, 5])
@pytest.mark.parametrize("prefetch", [False, True], ids=["numpy_feeds", "staged_cpu"])
def test_dataloader_cursor_rewind_matches_jax(at, prefetch):
    jfluid, jrdr = _jax()
    full = _stream(_loader(tfluid, trdr, prefetch, places=tfluid.CPUPlace()))
    cursors = {}
    for tag, fluid, rdr in (("jax", jfluid, jrdr), ("torch", tfluid, trdr)):
        first = _loader(fluid, rdr, prefetch if tag == "torch" else False,
                        places=tfluid.CPUPlace() if tag == "torch" else None)
        head = _stream(first, at) if at else []
        cursors[tag] = first.state_dict()
        resumed = _loader(fluid, rdr, prefetch if tag == "torch" else False,
                          places=tfluid.CPUPlace() if tag == "torch" else None)
        resumed.set_state_dict(cursors[tag])
        tail = _stream(resumed)
        got = head + tail
        assert len(got) == len(full)
        for a, b in zip(full, got):
            for k in a:
                assert a[k].tobytes() == b[k].tobytes(), (tag, k)
    assert cursors["jax"] == cursors["torch"] == {"epoch": 0, "batch": at, "shuffle_seed": 7}


def _bad_sample_loader(fluid, rdr, mode, prefetch):
    _, (x,) = _feed_vars(fluid, [("x", [2], "float32")])
    loader = rdr.DataLoader.from_generator([x], capacity=4, on_bad_sample=mode,
                                           use_double_buffer=prefetch)

    def samp():
        for i in range(8):
            if i == 3:
                yield ("garbage",)  # float conversion fails
            elif i == 5:
                yield (np.zeros(3, "float32"),)  # ragged against its batch mate
            else:
                yield (np.full(2, float(i), "float32"),)

    loader.set_sample_generator(samp, batch_size=2, drop_last=False,
                                places=tfluid.CPUPlace() if fluid is tfluid else None)
    return loader


@pytest.mark.parametrize("prefetch", [False, True], ids=["numpy_feeds", "staged_cpu"])
def test_on_bad_sample_skip_and_raise_match_jax(prefetch):
    jfluid, jrdr = _jax()
    from paddle_tpu import profiler as jprofiler

    res = {}
    for tag, fluid, rdr, prof in (("jax", jfluid, jrdr, jprofiler),
                                  ("torch", tfluid, trdr, tprofiler)):
        with pytest.raises(ValueError):
            list(_bad_sample_loader(fluid, rdr, "raise", prefetch if tag == "torch" else False))
        before = prof.counters()
        out = _stream(_bad_sample_loader(fluid, rdr, "skip",
                                         prefetch if tag == "torch" else False))
        after = prof.counters()
        deltas = {k: after.get(k, 0) - before.get(k, 0)
                  for k in ("reader_bad_samples", "reader_bad_batches")}
        res[tag] = ([b["x"].tolist() for b in out], deltas)
    assert res["jax"] == res["torch"]
    # sample 3 dropped alone; the batch of samples 4 and 5 fails only as a
    # whole and is dropped under the batch counter
    assert res["torch"][1] == {"reader_bad_samples": 1, "reader_bad_batches": 1}
    with pytest.raises(ValueError, match="on_bad_sample"):
        trdr.DataLoader(on_bad_sample="ignore")


def test_raw_batches_and_rewiring_match_jax():
    jfluid, jrdr = _jax()
    res = {}
    for tag, fluid, rdr in (("jax", jfluid, jrdr), ("torch", tfluid, trdr)):
        _, (x,) = _feed_vars(fluid, [("x", [2], "float32")])
        loader = rdr.DataLoader.from_generator([x], capacity=4, use_double_buffer=False)
        loader.set_sample_generator(lambda: iter([(np.zeros(2, "float32"),)] * 4), 2)
        n_samples = len(list(loader()))
        loader.set_batch_generator(lambda: iter([[np.ones((3, 2), "float32")]]))
        res[tag] = (n_samples, [b["x"].tobytes() for b in _stream(loader)])
    assert res["jax"] == res["torch"] == (2, [np.ones((3, 2), "float32").tobytes()])
    pr = trdr.PyReader(capacity=4)
    pr.decorate_sample_list_generator(lambda: iter([[(1.0,)]]), places=tfluid.CPUPlace())
    with pytest.raises(RuntimeError, match="feed_list"):
        list(pr)


def test_dataloader_producer_error_propagates():
    for prefetch in (False, True):
        _, (x,) = _feed_vars(tfluid, [("x", [1], "float32")])
        loader = trdr.DataLoader.from_generator([x], capacity=4, use_double_buffer=prefetch)

        def bad_batches():
            yield [(np.zeros(1, "float32"),)]
            raise ValueError("io failed")

        loader.set_sample_list_generator(bad_batches, places=tfluid.CPUPlace())
        with pytest.raises(ValueError, match="io failed"):
            list(iter(loader))


@pytest.mark.parametrize("device", [None, "cpu"])
def test_device_stager_orders_and_propagates_errors(device):
    staged = list(DeviceStager(iter(range(7)), lambda x: x * 10, depth=2, device=device))
    assert staged == [0, 10, 20, 30, 40, 50, 60]

    def bad_source():
        yield 1
        raise RuntimeError("producer died")

    it = iter(DeviceStager(bad_source(), lambda x: x, depth=2, device=device))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer died"):
        next(it)
    with pytest.raises(ZeroDivisionError):
        list(DeviceStager(iter([1]), lambda x: 1 / 0, depth=1, device=device))
    # arrays become tensors on a device; ints and names stay as they are
    before = tprofiler.counters().get("reader_staged_batches", 0)
    out = list(DeviceStager(iter([(0, {"a": np.arange(3.0)})]), lambda x: x, device=device))
    assert tprofiler.counters()["reader_staged_batches"] == before + 1
    idx, feed = out[0]
    assert idx == 0
    if device is None:
        assert isinstance(feed["a"], np.ndarray)
    else:
        assert feed["a"].dtype == torch.float32 and feed["a"].tolist() == [0.0, 1.0, 2.0]


def test_device_stager_consumer_abandon_does_not_hang():
    st = DeviceStager(iter(range(1000)), lambda x: np.full(4, x), depth=2, device="cpu")
    it = iter(st)
    assert next(it).tolist() == [0, 0, 0, 0]
    it.close()  # the consumer walks away mid-stream
    st._thread.join(timeout=5)
    assert not st._thread.is_alive()
    assert threading.active_count() < 50


def _fc_model(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [16])
        label = fluid.layers.data("label", [1], dtype="int64")
        hidden = fluid.layers.fc(img, 12, act="relu")
        pred = fluid.layers.fc(hidden, 4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.Adam(5e-2).minimize(loss)
    return main, startup, [img, label], loss


def _fc_samples():
    rs = np.random.RandomState(9)
    for _ in range(64):
        y = int(rs.randint(4))
        x = rs.randn(16).astype("float32")
        x[y * 4:(y + 1) * 4] += 3.0
        yield x, y


def test_dataloader_trains_fc_like_jax():
    jfluid, jrdr = _jax()
    losses, state = {}, None
    for tag, fluid, rdr in (("jax", jfluid, jrdr), ("torch", tfluid, trdr)):
        main, startup, feeds, loss = _fc_model(fluid)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        if state is None:
            state = {v.name: np.asarray(scope.get(v.name)) for v in main.list_vars()
                     if v.persistable and scope.has(v.name)}
        else:
            tfluid.io.set_persistables_from_numpy(scope, state, "cpu")
        loader = rdr.DataLoader.from_generator(feeds, capacity=4)
        loader.set_sample_generator(_fc_samples, 8, shuffle_buf=16, shuffle_seed=1,
                                    places=tfluid.CPUPlace() if tag == "torch" else None)
        out = []
        for feed in loader:
            out.append(float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                                scope=scope)[0]).reshape(-1)[0]))
            if len(out) == 5:
                break
        losses[tag] = out
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5)
    assert losses["torch"][-1] < losses["torch"][0]


def test_py_reader_shim_matches_jax():
    jfluid, _ = _jax()
    rs = np.random.RandomState(11)
    batches = [(rs.rand(2, 3).astype("float32"), rs.randint(0, 5, (2, 1)).astype("int64"))
               for _ in range(3)]
    got = {}
    for tag, fluid in (("jax", jfluid), ("torch", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            reader = fluid.layers.py_reader(capacity=4, shapes=[[-1, 3], [-1, 1]],
                                            dtypes=["float32", "int64"])
            xv, yv = fluid.layers.read_file(reader)
            reader = fluid.layers.double_buffer(reader)
            out = fluid.layers.reduce_sum(xv)
        if tag == "torch":
            reader.decorate_batch_generator(lambda: iter(batches), places=fluid.CPUPlace())
        else:
            reader.decorate_batch_generator(lambda: iter(batches))
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        vals = []
        with fluid.scope_guard(scope):
            exe.run(startup)
            reader.start()
            for _ in range(3):
                (sv,) = exe.run(main, feed=reader.next_feed(), fetch_list=[out])
                vals.append(float(np.asarray(sv).reshape(-1)[0]))
            reader.reset()
        got[tag] = vals
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-6)
    np.testing.assert_allclose(got["torch"], [b[0].sum() for b in batches], rtol=1e-5)


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_reader.py` on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_stager_batches_survive_the_steps(cuda_device):
    """Steps the host does not wait for: each reads its staged batch behind a
    long device-side hold and drops it at once, while the stager copies the
    next batches. Without record_stream the allocator hands a dropped
    batch's block to the copy stream, and a later copy overwrites it before
    its step has read it."""
    rs = np.random.RandomState(0)
    host = [rs.randn(1 << 22).astype("float32") for _ in range(16)]
    st = DeviceStager(iter(host), lambda a: {"x": a}, depth=2, device=cuda_device,
                      time_copies=True)
    outs = []
    for feed in st:
        assert feed["x"].is_cuda
        torch.cuda._sleep(20_000_000)  # a step that outlasts the next copies
        outs.append(feed["x"] * 1.0)
        del feed
    torch.cuda.synchronize()
    assert len(outs) == 16
    for y, want in zip(outs, host):
        assert np.array_equal(y.cpu().numpy(), want)
    ms = st.copy_ms()
    assert len(ms) == 16 and all(m > 0 for m in ms)


@pytest.mark.gpu
def test_cuda_stager_consumer_waits_for_the_copy(cuda_device):
    """A batch read the moment it is handed over, while its copy may still
    run: the consumer's stream must wait on the copy's event."""
    rs = np.random.RandomState(1)
    host = [rs.randn(1 << 25).astype("float32") for _ in range(8)]

    def slow_source():
        for a in host:
            time.sleep(0.05)  # the stager is never ahead: each copy is fresh
            yield a

    outs = [feed["x"] * 1.0 for feed in DeviceStager(slow_source(), lambda a: {"x": a},
                                                      depth=1, device=cuda_device)]
    torch.cuda.synchronize()
    for y, want in zip(outs, host):
        assert np.array_equal(y.cpu().numpy(), want)


@pytest.mark.gpu
def test_cuda_dataloader_default_place_stages_on_the_card(cuda_device):
    numpy_feeds = _stream(_loader(tfluid, trdr, False))
    staged = []
    for feed in _loader(tfluid, trdr, True):
        assert all(v.device.type == "cuda" for v in feed.values())
        staged.append(_host(feed))
    assert len(staged) == len(numpy_feeds)
    for a, b in zip(numpy_feeds, staged):
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
