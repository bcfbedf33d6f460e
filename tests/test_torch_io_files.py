"""The port's io single-file paths, held against the JAX package on the CPU.

- `filename=` on save_vars / save_persistables / save_params and their
  loads: one `.npz` at `dirname/filename` (`.npz` appended when missing);
  save_params / load_params take only the Parameters; a round trip in the
  port restores every value bit for bit, dtype included.
- Both directions across packages: the JAX package loads the port's
  `.npz` and its `params_filename=` export, and the port loads the JAX
  package's; every persistable equal (the JAX package writes int64 vars
  as int32, and the port loads them as int64), BERT-tiny's inference
  fetch within rtol 1e-5 / atol 1e-5 (the serving parity gate; the two
  packages' attention paths sum in another order).
- `allow_missing`: without it a load names every missing var; with it
  the present ones load.
- `layers.load` fills a var from a `.npy` into the global scope.
- A bfloat16 value raises rather than being written as float32.
- Loading an `.npz` leaves no file open."""

import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.scope import to_numpy

B, S, P = 2, 32, 5
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)
FEEDS = ["src_ids", "sent_ids", "pos_ids", "input_mask"]


def _jax():
    import paddle_tpu as jfluid
    from paddle_tpu.models import bert as jbert

    return jfluid, jbert


def _pretrain(fluid, bert):
    cfg = bert.BertConfig(**TINY)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        h = bert.build_bert_pretrain(cfg, B, S, mlm_only=True, max_preds=P)
        fluid.optimizer.Adam(1e-3).minimize(h["loss"])
    return main, startup, h


def _encoder(fluid, cfg):
    import importlib

    bert = importlib.import_module(fluid.__name__ + ".models.bert")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids, sent, pos = (fluid.layers.data(n, [B, S], dtype="int64", append_batch_size=False)
                          for n in FEEDS[:3])
        mask = fluid.layers.data("input_mask", [B, S], dtype="float32",
                                 append_batch_size=False)
        hidden = bert.bert_encoder(ids, sent, pos, mask, cfg, is_test=True)
    return main, startup, hidden


def _feed(seed=0, mlm=True):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(S // 2, S + 1, size=B)
    feed = {
        "src_ids": rs.randint(0, TINY["vocab_size"], (B, S)).astype(np.int64),
        "sent_ids": rs.randint(0, 2, (B, S)).astype(np.int64),
        "pos_ids": np.tile(np.arange(S, dtype=np.int64), (B, 1)),
        "input_mask": (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32),
    }
    if mlm:
        feed["mask_label"] = rs.randint(0, TINY["vocab_size"], (B, P)).astype(np.int64)
        feed["mask_weight"] = np.ones((B, P), np.float32)
        feed["mask_pos"] = np.stack([rs.choice(S, P, replace=False)
                                     for _ in range(B)]).astype(np.int64)
    return feed


def _port_trained():
    """The port's BERT-tiny after one Adam step on the CPU."""
    from paddle_tpu_torch.models import bert as tbert

    main, startup, h = _pretrain(tfluid, tbert)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[h["loss"]], scope=scope)
    return main, scope, exe


def _persistables(main, scope, pred=lambda v: v.persistable and not v.is_data):
    return {v.name: to_numpy(scope.get(v.name)) for v in main.list_vars()
            if pred(v) and scope.has(v.name)}


@pytest.mark.parametrize("filename", ["ckpt", "ckpt.npz"])
@pytest.mark.parametrize("what", ["vars", "persistables", "params"])
def test_single_file_round_trip_in_port(what, filename, tmp_path):
    main, scope, exe = _port_trained()
    params = {v.name for v in main.list_vars() if isinstance(v, tfluid.framework.Parameter)}
    want = _persistables(main, scope)
    if what == "params":
        want = {n: a for n, a in want.items() if n in params}
    d = str(tmp_path / "ck")
    with tfluid.scope_guard(scope):
        getattr(tfluid.io, f"save_{what}")(exe, d, main, filename=filename)
    assert os.listdir(d) == ["ckpt.npz"]
    with np.load(os.path.join(d, "ckpt.npz")) as blob:
        assert sorted(blob.files) == sorted(want)
    fresh = tfluid.Scope()
    exe2 = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(fresh):
        getattr(tfluid.io, f"load_{what}")(exe2, d, main, filename=filename)
    assert sorted(n for n in want if fresh.has(n)) == sorted(want)
    for n, a in want.items():
        t = fresh.get(n)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert to_numpy(t).dtype == a.dtype and to_numpy(t).tobytes() == a.tobytes(), n
    # the per-var layout beside it is untouched
    with tfluid.scope_guard(scope):
        tfluid.io.save_persistables(exe, str(tmp_path / "npy"), main)
    assert len(os.listdir(tmp_path / "npy")) == len(_persistables(main, scope))


def test_jax_loads_the_port_single_file(tmp_path):
    jfluid, jbert = _jax()
    main, scope, exe = _port_trained()
    want = _persistables(main, scope)
    d = str(tmp_path / "port_ck")
    with tfluid.scope_guard(scope):
        tfluid.io.save_persistables(exe, d, main, filename="ckpt")
    jmain, jstartup, _ = _pretrain(jfluid, jbert)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jfluid.io.load_persistables(jexe, d, jmain, filename="ckpt")
    got = {n: np.asarray(jscope.get(n)) for n in want}
    for n, a in want.items():
        np.testing.assert_array_equal(got[n], a, err_msg=n)


def test_port_loads_the_jax_single_file(tmp_path):
    jfluid, jbert = _jax()
    from paddle_tpu_torch.models import bert as tbert

    jmain, jstartup, jh = _pretrain(jfluid, jbert)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    d = str(tmp_path / "jax_ck")
    with jfluid.scope_guard(jscope):
        jfluid.io.save_persistables(jexe, d, jmain, filename="ckpt")
        jfluid.io.save_params(jexe, d, jmain, filename="params")
    want = {v.name: np.asarray(jscope.get(v.name)) for v in jmain.list_vars()
            if v.persistable and not v.is_data and jscope.has(v.name)}
    main, _, _ = _pretrain(tfluid, tbert)
    for fname, pred in (("ckpt", None), ("params", "params")):
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(scope):
            if pred:
                tfluid.io.load_params(exe, d, main, filename=fname)
            else:
                tfluid.io.load_persistables(exe, d, main, filename=fname)
        names = [v.name for v in main.list_vars()
                 if (isinstance(v, tfluid.framework.Parameter) if pred
                     else v.persistable and not v.is_data)]
        assert names and all(scope.has(n) for n in names)
        for n in names:
            t = scope.get(n)
            # int64 vars come back int64 from the JAX package's int32
            assert t.dtype == tfluid.ops.registry.TORCH_DTYPE(main.global_block().var(n).dtype)
            np.testing.assert_array_equal(to_numpy(t), want[n], err_msg=n)


def _export_and_predict(src, dst, tmp_path):
    """`src` exports the BERT-tiny encoder with params_filename, `dst`
    loads it -> (the writer's fetch in its own scope, the reader's)."""
    pkgs = {"jax": _jax()[0], "torch": tfluid}
    jfluid, jbert = _jax()
    from paddle_tpu_torch.models.bert import BertConfig

    cfgs = {"jax": jbert.BertConfig(**TINY, fused_qkv=False, attn_layout="bshd"),
            "torch": BertConfig(**TINY)}
    fl = pkgs[src]
    main, startup, hidden = _encoder(fl, cfgs[src])
    scope = fl.Scope()
    exe = fl.Executor(fl.CPUPlace())
    exe.run(startup, scope=scope)
    feed = _feed(mlm=False)
    ref = np.asarray(exe.run(main, feed=dict(feed), fetch_list=[hidden], scope=scope)[0])
    d = str(tmp_path / f"{src}_export")
    with fl.scope_guard(scope):
        fl.io.save_inference_model(d, FEEDS, [hidden], exe, main_program=main,
                                   params_filename="params")
    assert sorted(os.listdir(d)) == ["__model__.json", "params.npz"]
    fl = pkgs[dst]
    exe = fl.Executor(fl.CPUPlace())
    scope = fl.Scope()
    with fl.scope_guard(scope):
        prog, feed_names, fetch_vars = fl.io.load_inference_model(d, exe,
                                                                  params_filename="params")
        out = np.asarray(exe.run(prog, feed=dict(feed), fetch_list=fetch_vars)[0])
    assert feed_names == FEEDS
    return ref, out


@pytest.mark.parametrize("src,dst", [("torch", "jax"), ("jax", "torch"), ("torch", "torch")])
def test_params_filename_export_across_packages(src, dst, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_SHORT_ATTN", "bshd")
    ref, out = _export_and_predict(src, dst, tmp_path)
    if src == dst:
        assert out.tobytes() == ref.tobytes()
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("filename", [None, "ckpt"])
def test_allow_missing_names_the_missing_vars(filename, tmp_path):
    main, scope, exe = _port_trained()
    saved = [v for v in main.list_vars() if v.persistable and not v.is_data][:3]
    d = str(tmp_path / "part")
    with tfluid.scope_guard(scope):
        tfluid.io.save_vars(exe, d, main, vars=saved, filename=filename)
    missing = sorted(n for n in _persistables(main, scope) if n not in {v.name for v in saved})
    fresh = tfluid.Scope()
    with tfluid.scope_guard(fresh):
        with pytest.raises(RuntimeError, match=f"{len(missing)} var\\(s\\) missing") as e:
            tfluid.io.load_persistables(exe, d, main, filename=filename)
        assert all(repr(n) in str(e.value) for n in missing[:16])
        tfluid.io.load_persistables(exe, d, main, filename=filename, allow_missing=True)
    assert sorted(n for n in _persistables(main, scope) if fresh.has(n)) == sorted(
        v.name for v in saved)
    # by name too, with executor None: numpy into the scope
    other = tfluid.Scope()
    with tfluid.scope_guard(other):
        tfluid.io.load_vars(None, d, main, vars=[saved[0].name, "no_such_var"],
                            filename=filename, allow_missing=True)
    assert isinstance(other.get(saved[0].name), np.ndarray) and not other.has("no_such_var")


def test_layers_load_fills_the_global_scope(tmp_path):
    jfluid, _ = _jax()
    w0 = np.random.RandomState(4).rand(3, 2).astype("float32")
    np.save(str(tmp_path / "lw.npy"), w0)
    got = {}
    for tag, fl in (("jax", jfluid), ("torch", tfluid)):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup), fl.unique_name.guard():
            w = fl.layers.create_global_var([3, 2], 0.0, "float32", persistable=True, name="lw")
            out = fl.layers.reduce_sum(w)
        exe = fl.Executor(fl.CPUPlace())
        scope = fl.Scope()
        with fl.scope_guard(scope):
            exe.run(startup)
            fl.layers.load(w, str(tmp_path / "lw"))
            assert isinstance(scope.get("lw"), np.ndarray)
            fl.layers.load(w, str(tmp_path / "lw.npy"), load_as_fp16=True)
            assert scope.get("lw").dtype == np.float16
            fl.layers.load(w, str(tmp_path / "lw"))
            got[tag] = float(np.asarray(exe.run(main, fetch_list=[out])[0]).reshape(-1)[0])
    assert got["torch"] == pytest.approx(got["jax"], rel=1e-6)
    assert got["torch"] == pytest.approx(float(w0.sum()), rel=1e-6)


def test_bfloat16_value_raises(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        tfluid.layers.create_global_var([2], 0.0, "float32", persistable=True, name="half_w")
    scope = tfluid.Scope()
    scope.set("half_w", torch.ones(2, dtype=torch.bfloat16))
    for filename in (None, "ckpt"):
        with tfluid.scope_guard(scope), pytest.raises(TypeError, match="bfloat16"):
            tfluid.io.save_persistables(None, str(tmp_path / "bf"), main, filename=filename)


def test_npz_loads_leave_no_file_open(tmp_path):
    main, scope, exe = _port_trained()
    d = str(tmp_path / "ck")
    with tfluid.scope_guard(scope):
        tfluid.io.save_persistables(exe, d, main, filename="ckpt")
    fds = lambda: len(os.listdir("/proc/self/fd"))  # noqa: E731
    fresh = tfluid.Scope()
    with tfluid.scope_guard(fresh):
        tfluid.io.load_persistables(exe, d, main, filename="ckpt")
        before = fds()
        for _ in range(20):
            tfluid.io.load_persistables(exe, d, main, filename="ckpt")
        assert fds() == before
