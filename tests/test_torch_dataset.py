"""The port's dataset.py, incubate.data_generator, Executor.train_from_dataset
and datasets/, held against the JAX package on the CPU.

The JAX package parses slot files with a native parser when it can; these
tests make it take its Python parser (`paddle_tpu.dataset._native_parser`
returns None), the one the port has, and the records and batches must be
equal array for array: the slot files, short lines and header lines of
the JAX package's CTR tests, pipe_command (and its exit-status error),
threaded shard parsing as a multiset, and shuffle keeping the records.
The data generator writes the same bytes. BERT-tiny (2 layers) trains
through train_from_dataset in both packages: the last loss within rtol
1e-5 (the gate of the BERT-tiny pretraining parity test). Each synthetic
dataset's first 64 samples are byte-equal."""

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import datasets as tdatasets
from paddle_tpu_torch.incubate.data_generator import (
    DataGenerator as TGen,
    MultiSlotDataGenerator as TMultiGen,
)


@pytest.fixture
def jax_python_parser(monkeypatch):
    import paddle_tpu as jfluid
    import paddle_tpu.dataset as jds

    monkeypatch.setattr(jds, "_native_parser", lambda: None)
    return jfluid


def _write_slot_files(tmp_path, n_files=2, lines_per_file=64, seed=0):
    """MultiSlot format: 2 sparse slots (len<=3) + 1 dense slot (2 floats)
    + label slot (1 int)."""
    rng = np.random.RandomState(seed)
    paths = []
    for fi in range(n_files):
        path = tmp_path / f"part-{fi}"
        with open(path, "w") as f:
            for _ in range(lines_per_file):
                parts = []
                for _slot in range(2):
                    n = rng.randint(1, 4)
                    parts.append(str(n))
                    parts.extend(str(i) for i in rng.randint(1, 100, n))
                parts.append("2")
                parts.extend(f"{v:.4f}" for v in rng.rand(2))
                parts.append("1")
                parts.append(str(rng.randint(0, 2)))
                f.write(" ".join(parts) + "\n")
        paths.append(str(path))
    return paths


SLOT_VARS = [("slot0", [3], "int64"), ("slot1", [3], "int64"), ("dense", [2], "float32"),
             ("label", [1], "int64")]


def _dataset(fluid, kind, paths, batch_size, specs=SLOT_VARS, **cfg):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        vs = [fluid.layers.data(n, shape, dtype=dt) for n, shape, dt in specs]
    ds = fluid.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch_size)
    ds.set_filelist(paths)
    ds.set_use_var(vs)
    for k, v in cfg.items():
        getattr(ds, k)(v) if k.startswith("set_") else setattr(ds, k, v)
    return ds


def _assert_batches_equal(a, b):
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert list(x) == list(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            assert x[k].tobytes() == y[k].tobytes(), k


@pytest.mark.parametrize("kind", ["QueueDataset", "InMemoryDataset"])
@pytest.mark.parametrize("batch_size,drop_last", [(16, False), (24, False), (24, True)])
def test_slot_file_batches_equal_jax(kind, batch_size, drop_last, tmp_path,
                                     jax_python_parser):
    jfluid = jax_python_parser
    paths = _write_slot_files(tmp_path)
    got = [list(_dataset(f, kind, paths, batch_size, drop_last=drop_last).batches())
           for f in (jfluid, tfluid)]
    _assert_batches_equal(*got)
    assert len(got[1]) == (128 // batch_size if drop_last else -(-128 // batch_size))
    b = got[1][0]
    assert b["slot0"].dtype == np.int64 and b["dense"].dtype == np.float32
    assert b["label"].shape == (batch_size, 1)


def test_records_equal_jax_and_memory_size(tmp_path, jax_python_parser):
    jfluid = jax_python_parser
    paths = _write_slot_files(tmp_path)
    recs = []
    for f in (jfluid, tfluid):
        ds = _dataset(f, "InMemoryDataset", paths, 16)
        ds.load_into_memory()
        assert ds.get_memory_data_size() == 128
        recs.append(ds._memory)
    for ra, rb in zip(*recs):
        assert [a.tobytes() for a in ra] == [b.tobytes() for b in rb]
    ds = _dataset(tfluid, "QueueDataset", paths, 16)
    with pytest.raises(RuntimeError, match="shuffle"):
        ds.local_shuffle()
    with pytest.raises(RuntimeError, match="shuffle"):
        ds.global_shuffle()
    assert ds.desc()["slots"][0] == {"name": "slot0", "dtype": "int64", "shape": [-1, 3]}
    with pytest.raises(ValueError, match="unknown dataset class"):
        tfluid.DatasetFactory().create_dataset("NoSuchDataset")


LINE_CASES = {
    # slot0 declares 3 ids and the line ends after 2; the next line stays
    # intact
    "short_lines": ("3 11 12\n2 21 22 2 0.125 0.75 1 0\n",
                    [("s0", [3], "int64"), ("d0", [2], "float32"), ("lb", [1], "int64")]),
    "header_lines": ("# header comment\n1 5 1 7\n\n",
                     [("hids", [1], "int64"), ("hval", [1], "int64")]),
    "malformed_values": ("2 4 x 1 0.5\n3 1 2 3 2 0.25 bad\n",
                         [("ids", [3], "int64"), ("val", [2], "float32")]),
}


@pytest.mark.parametrize("case", sorted(LINE_CASES))
def test_python_parser_line_rules_equal_jax(case, tmp_path, jax_python_parser):
    jfluid = jax_python_parser
    text, specs = LINE_CASES[case]
    path = tmp_path / case
    path.write_text(text)
    got = []
    for f in (jfluid, tfluid):
        ds = _dataset(f, "QueueDataset", [str(path)], 2, specs=specs)
        got.append([[a.tobytes() for a in rec]
                    for rec in ds._parse_file(str(path), ds._slot_specs())])
    assert got[0] == got[1] and got[1]
    if case == "short_lines":
        assert got[1][0][0] == np.array([11, 12, 0], "int64").tobytes()
        assert got[1][1][0] == np.array([21, 22, 0], "int64").tobytes()
    if case == "header_lines":
        assert len(got[1]) == 1


def test_pipe_command_equal_jax_and_exit_status_raises(tmp_path, jax_python_parser):
    jfluid = jax_python_parser
    paths = _write_slot_files(tmp_path, n_files=1, lines_per_file=20)
    got = [list(_dataset(f, "QueueDataset", paths, 8,
                         set_pipe_command="sed -n '1,15p'").batches())
           for f in (jfluid, tfluid)]
    _assert_batches_equal(*got)
    assert sum(len(b["label"]) for b in got[1]) == 15
    for f in (jfluid, tfluid):
        ds = _dataset(f, "QueueDataset", paths, 8, set_pipe_command="cat >/dev/null; exit 3")
        with pytest.raises(RuntimeError, match="exited with status 3"):
            list(ds.batches())


def test_threaded_parsing_keeps_the_records(tmp_path, jax_python_parser):
    jfluid = jax_python_parser
    paths = _write_slot_files(tmp_path, n_files=4, lines_per_file=32)

    def collect(fluid, n_threads):
        vals = []
        for feed in _dataset(fluid, "QueueDataset", paths, 8).batches(n_threads):
            vals.extend(zip(feed["slot0"].tolist(), feed["dense"].tolist()))
        return sorted(map(str, vals))

    one = collect(tfluid, 1)
    assert len(one) == 128
    assert collect(tfluid, 3) == one == collect(jfluid, 3) == collect(jfluid, 1)
    # a consumer that walks away does not leave the shard threads blocked
    it = _dataset(tfluid, "QueueDataset", paths, 8).batches(4)
    next(it)
    it.close()


def test_shuffle_keeps_records_and_equals_jax(tmp_path, jax_python_parser):
    jfluid = jax_python_parser
    paths = _write_slot_files(tmp_path, n_files=1)
    got = []
    for f in (jfluid, tfluid):
        ds = _dataset(f, "InMemoryDataset", paths, 64)
        ds.load_into_memory()
        before = np.sort(np.concatenate([b["slot0"].ravel() for b in ds.batches()]))
        ds.local_shuffle()
        shuffled = list(ds.batches())
        after = np.sort(np.concatenate([b["slot0"].ravel() for b in shuffled]))
        np.testing.assert_array_equal(before, after)
        ds.global_shuffle()
        got.append(shuffled + list(ds.batches()))
        ds.release_memory()
        assert ds.get_memory_data_size() == 0
    _assert_batches_equal(*got)  # random.Random(0) in both


def _generators(jax_gen_mod):
    class JGen(jax_gen_mod.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                a, b = line.split()
                yield [("ids", [int(a), int(a) + 1]), ("val", [float(b)])]

            return it

    class TGenImpl(TMultiGen):
        generate_sample = JGen.generate_sample

    return JGen, TGenImpl


def test_data_generator_writes_the_same_bytes(tmp_path, jax_python_parser):
    import paddle_tpu.incubate.data_generator as jgen

    jfluid = jax_python_parser
    raw = tmp_path / "raw.txt"
    raw.write_text("3 0.5\n7 0.25\n11 0.125\n")
    outs = {}
    for tag, cls in zip(("jax", "torch"), _generators(jgen)):
        g = cls()
        g.set_batch(2)
        outs[tag] = g.run_from_files([str(raw)], str(tmp_path / tag))
    assert [open(p, "rb").read() for p in outs["jax"]] == [
        open(p, "rb").read() for p in outs["torch"]]
    got = [list(_dataset(f, "QueueDataset", outs["torch"], 3,
                         specs=[("ids", [2], "int64"), ("val", [1], "float32")]).batches())
           for f in (jfluid, tfluid)]
    _assert_batches_equal(*got)
    np.testing.assert_array_equal(got[1][0]["ids"], [[3, 4], [7, 8], [11, 12]])
    with pytest.raises(NotImplementedError):
        TGen().generate_sample("x")


# BERT-tiny through train_from_dataset: (batch, seq, max_preds) and batches
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)
B, S, P, N_BATCHES = 2, 32, 5, 3
BERT_SLOTS = ["src_ids", "sent_ids", "pos_ids", "input_mask", "mask_label",
              "mask_weight", "mask_pos"]


def _bert_rows(seed=0):
    """N_BATCHES * B samples in the shape of the pretraining feed, one row
    each."""
    rs = np.random.RandomState(seed)
    for _ in range(N_BATCHES * B):
        yield [("src_ids", rs.randint(0, TINY["vocab_size"], S).tolist()),
               ("sent_ids", rs.randint(0, 2, S).tolist()),
               ("pos_ids", list(range(S))),
               ("input_mask", (np.arange(S) < rs.randint(S // 2, S + 1)).astype(float).tolist()),
               ("mask_label", rs.randint(0, TINY["vocab_size"], P).tolist()),
               ("mask_weight", [1.0] * P),
               ("mask_pos", rs.choice(S, P, replace=False).tolist())]


def _bert_train_from_dataset(fluid, bert, path, state=None):
    cfg = bert.BertConfig(**TINY)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        h = bert.build_bert_pretrain(cfg, B, S, mlm_only=True, max_preds=P)
        fluid.optimizer.Adam(1e-3).minimize(h["loss"])
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    if state is None:
        state = {v.name: np.asarray(scope.get(v.name)) for v in main.list_vars()
                 if v.persistable and scope.has(v.name)}
    else:
        tfluid.io.set_persistables_from_numpy(scope, state, "cpu")
    block = main.global_block()
    ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_batch_size(B)
    ds.set_thread(1)
    ds.set_filelist([path])
    ds.set_use_var([block.var(n) for n in BERT_SLOTS])
    ds.load_into_memory()
    outs = [exe.train_from_dataset(main, ds, scope=scope, fetch_list=[h["loss"]])
            for _ in range(2)]
    return state, [float(np.asarray(o[0]).reshape(-1)[0]) for o in outs], scope


def test_bert_tiny_train_from_dataset_like_jax(tmp_path, monkeypatch, jax_python_parser):
    import paddle_tpu.incubate.data_generator as jgen
    from paddle_tpu.models import bert as jbert
    from paddle_tpu_torch.models import bert as tbert

    jfluid = jax_python_parser
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_SHORT_ATTN", "bshd")
    rows = list(_bert_rows())

    class Rows(TMultiGen):
        def generate_sample(self, line):
            return lambda: iter([rows[int(line)]])

    raw = tmp_path / "index.txt"
    raw.write_text("".join(f"{i}\n" for i in range(len(rows))))
    (path,) = Rows().run_from_files([str(raw)], str(tmp_path / "bert"))
    (jpath,) = type("JRows", (jgen.MultiSlotDataGenerator,),
                    {"generate_sample": Rows.generate_sample})().run_from_files(
        [str(raw)], str(tmp_path / "bert_jax"))
    assert open(path, "rb").read() == open(jpath, "rb").read()
    state, jl, _ = _bert_train_from_dataset(jfluid, jbert, path)
    staged = tfluid.profiler.counters().get("reader_staged_batches", 0)
    _, tl, _ = _bert_train_from_dataset(tfluid, tbert, path, state)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    # every batch went through the stager, in both epochs
    assert tfluid.profiler.counters()["reader_staged_batches"] - staged == 2 * N_BATCHES


def test_infer_from_dataset_and_debug_line(tmp_path, capsys):
    paths = _write_slot_files(tmp_path, n_files=1, lines_per_file=16)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        vs = [tfluid.layers.data(n, shape, dtype=dt) for n, shape, dt in SLOT_VARS]
        out = tfluid.layers.reduce_sum(vs[2])
    ds = tfluid.DatasetFactory().create_dataset("QueueDataset")
    ds.set_batch_size(4)
    ds.set_filelist(paths)
    ds.set_use_var(vs)
    exe = tfluid.Executor(tfluid.CPUPlace())
    last = exe.infer_from_dataset(main, ds, fetch_list=[out], debug=True, print_period=2,
                                  fetch_info=["dense_sum"])
    want = list(ds.batches())[-1]["dense"].sum(dtype=np.float32)
    np.testing.assert_allclose(np.asarray(last[0]).reshape(-1)[0], want, rtol=1e-6)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("step 2: dense_sum=") and len(lines) == 2
    with pytest.raises(ValueError, match="dataset is required"):
        exe.train_from_dataset(main, None)


DATASET_READERS = {
    "mnist_train": lambda d: d.mnist.train(n=80),
    "mnist_test": lambda d: d.mnist.test(n=80),
    "cifar_train10": lambda d: d.cifar.train10(n=80),
    "cifar_test100": lambda d: d.cifar.test100(n=80),
    "imdb_train": lambda d: d.imdb.train(n=80),
    "imdb_test": lambda d: d.imdb.test(n=80),
    "movielens_train": lambda d: d.movielens.train(n=80),
    "movielens_test": lambda d: d.movielens.test(n=80),
    "uci_housing_train": lambda d: d.uci_housing.train(),
    "uci_housing_test": lambda d: d.uci_housing.test(),
    "wmt16_train": lambda d: d.wmt16.train(n=80),
    "wmt16_test": lambda d: d.wmt16.test(n=80),
}


def _sample_bytes(x):
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [_sample_bytes(v) for v in x]
    if isinstance(x, np.generic):
        return (x.dtype.str, x.tobytes())
    return (type(x).__name__, x)


@pytest.mark.parametrize("name", sorted(DATASET_READERS))
def test_synthetic_dataset_byte_equal_to_jax(name):
    from paddle_tpu import datasets as jdatasets

    got = []
    for d in (jdatasets, tdatasets):
        samples = []
        for i, s in enumerate(DATASET_READERS[name](d)()):
            if i == 64:
                break
            samples.append(_sample_bytes(s))
        got.append(samples)
    assert len(got[1]) == 64 and got[0] == got[1]


def test_dataset_side_tables_equal_jax():
    from paddle_tpu import datasets as jdatasets

    for d in (jdatasets, tdatasets):
        assert d.imdb.word_dict()["w7"] == 7
    assert jdatasets.wmt16.get_dict("de", 30, reverse=True) == tdatasets.wmt16.get_dict(
        "de", 30, reverse=True)
    assert (jdatasets.movielens.max_user_id(), jdatasets.movielens.max_movie_id(),
            jdatasets.movielens.max_job_id(), jdatasets.movielens.age_table) == (
        tdatasets.movielens.max_user_id(), tdatasets.movielens.max_movie_id(),
        tdatasets.movielens.max_job_id(), tdatasets.movielens.age_table)
