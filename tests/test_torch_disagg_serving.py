"""The prefill / decode split in the port on the CPU: the handoff wire
format (paddle_tpu_torch/inference/handoff.py) held against the JAX
package's byte for byte, the DecodeService's split path bit-equal to its
unified path, and the three roles through the port's HTTP server.

torch runs on one intra-op thread here (autouse fixture); every HTTP call,
join and wait is bounded. The `gpu` test (`python -m pytest -m gpu
--noconftest tests/test_torch_disagg_serving.py` on the card) runs the
split against the unified path at BERT-base's attention width there.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.inference.decode_model import (
    DecodeService, ToyDecodeModel, make_toy_decode_weights, save_decode_weights)
from paddle_tpu_torch.inference.handoff import HandoffError, pack_handoff, unpack_handoff
from paddle_tpu_torch.inference.server import InferenceServer
from paddle_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def _one_thread_no_plan():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.clear()
    yield
    faults.clear()
    torch.set_num_threads(threads)


def _jax_handoff():
    from paddle_tpu.inference import handoff

    return handoff


HANDOFF_CASES = {
    "kv": ({"k": np.random.RandomState(0).randn(5, 2, 3).astype("float32"),
            "v": np.random.RandomState(1).randn(5, 2, 3).astype("float32")},
           {"length": 5, "last_token": 9, "max_new": 4}),
    "empty history": ({"k": np.zeros((0, 1, 4), np.float32),
                       "v": np.zeros((0, 1, 4), np.float32)},
                      {"length": 0, "last_token": 3, "max_new": 1, "seq": "req-7"}),
    "mixed dtypes": ({"b": np.arange(6, dtype=np.int64).reshape(2, 3),
                      "a": np.float16([1.5, -2.0])}, None),
}


@pytest.mark.parametrize("case", list(HANDOFF_CASES))
def test_handoff_blob_byte_identical_to_jax_and_cross_unpacks(case):
    arrays, meta = HANDOFF_CASES[case]
    jh = _jax_handoff()
    blob = pack_handoff(arrays, meta)
    assert blob == jh.pack_handoff(arrays, meta)
    assert blob == pack_handoff({n: torch.as_tensor(a) for n, a in arrays.items()}, meta)
    for unpack in (unpack_handoff, jh.unpack_handoff):
        out, m = unpack(blob)
        assert m == dict(meta or {})
        for name, a in arrays.items():
            assert out[name].dtype == a.dtype and out[name].tobytes() == a.tobytes()
    assert (jh.MAGIC, jh.CONTENT_TYPE) == (b"PTKV", "application/x-paddle-handoff")


def test_handoff_rejects_corruption_loudly():
    blob = pack_handoff({"k": np.ones((2, 1, 2), "float32")}, {"length": 2})
    flipped = bytearray(blob)
    flipped[-1] ^= 0xFF  # the payload: a crc mismatch
    bad = [b"XXXX" + blob[4:], blob[:-3], blob[:6], bytes(flipped),
           blob[:8] + b"X" + blob[9:]]  # the manifest no longer parses
    for b in bad:
        with pytest.raises(HandoffError):
            unpack_handoff(b)
        with pytest.raises(_jax_handoff().HandoffError):
            _jax_handoff().unpack_handoff(b)


# -- DecodeService ---------------------------------------------------------------


def _service(**kw):
    kw.setdefault("num_pages", 16)
    kw.setdefault("page_len", 4)
    kw.setdefault("pages_per_seq", 4)
    kw.setdefault("max_streams", 8)
    return DecodeService(ToyDecodeModel(make_toy_decode_weights(), device="cpu"), **kw)


PROMPTS = [([1, 2, 3, 4], 6), ([5, 6], 4), ([7, 8, 9, 1, 2, 3], 5), ([4], 3)]


def test_split_prefill_decode_bitwise_equals_unified():
    """Prefill on one model, the blob through the wire format, decode on
    another service: tokens and logits equal the unified path's bits."""
    unified, dec = _service(), _service()
    pre = ToyDecodeModel(make_toy_decode_weights(), device="cpu")
    try:
        for toks, max_new in PROMPTS:
            u_toks, u_logits = unified.generate(np.asarray(toks, np.int32), max_new)
            k_rows, v_rows, length, last = pre.prefill(np.asarray(toks, np.int32))
            arrays, meta = unpack_handoff(pack_handoff(
                {"k": k_rows, "v": v_rows},
                meta={"length": length, "last_token": last, "max_new": max_new}))
            d_toks, d_logits = dec.decode(arrays["k"], arrays["v"], meta["length"],
                                          meta["last_token"], meta["max_new"])
            assert u_toks.shape == (max_new,) and u_logits.shape == (max_new, 11)
            np.testing.assert_array_equal(d_toks, u_toks)
            assert d_logits.tobytes() == u_logits.tobytes()
    finally:
        unified.close()
        dec.close()


def test_concurrent_streams_bitwise_equal_solo_and_pages_reclaimed():
    svc = _service()
    try:
        free0 = svc.free_pages()
        prompts = [(np.asarray([i + 1, i + 2, i + 3], np.int32), 4 + i % 3)
                   for i in range(6)]
        solo = [svc.generate(t, m) for t, m in prompts]
        results = [None] * len(prompts)

        def run(i):
            results[i] = svc.generate(*prompts[i])

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for i, (toks, logits) in enumerate(results):
            np.testing.assert_array_equal(toks, solo[i][0])
            assert logits.tobytes() == solo[i][1].tobytes()
        assert svc.free_pages() == free0
        c = svc.cache.counters.snapshot()
        assert c["kv_pages_in_use"] == 0 and c["kv_decode_streams"] == 0
        assert c["kv_slot_acquires"] == c["kv_slot_releases"] == 12
    finally:
        svc.close()


def test_decode_admission_shed_and_close():
    svc = _service(num_pages=1, page_len=4, pages_per_seq=2, max_streams=2)
    try:
        from paddle_tpu_torch.inference.decode_model import DecodeAdmissionError

        with pytest.raises(DecodeAdmissionError):
            svc.generate(np.arange(1, 8, dtype=np.int32), 4)  # needs 2 pages of 1
        assert svc.cache.counters.snapshot()["kv_admission_sheds"] == 1
        toks, _ = svc.generate(np.asarray([1, 2], np.int32), 2)
        assert toks.shape == (2,)
    finally:
        svc.close()
    assert not svc._driver.is_alive()


# -- the roles over HTTP ---------------------------------------------------------


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A tiny fc export (every role keeps /predict) and the toy decode
    weights."""
    root = tmp_path_factory.mktemp("disagg")
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        img = tfluid.layers.data("img", [6])
        pred = tfluid.layers.fc(tfluid.layers.fc(img, 16, act="relu"), 3, act="softmax")
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    d = str(root / "model")
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(d, ["img"], [pred], exe, main_program=main)
    wpath = str(root / "decode_weights.npz")
    save_decode_weights(wpath, make_toy_decode_weights(seed=7))
    return d, wpath


class _Role:
    def __init__(self, model_dir, wpath, role, **kw):
        kw.setdefault("kv_profile", "smoke")
        self.srv = InferenceServer(model_dir, device="cpu", decode_weights=wpath, role=role,
                                   **kw)
        self.base = f"http://127.0.0.1:{self.srv.port}"
        self._t = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self._t.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.close()
        self._t.join(timeout=30)

    def post(self, path, body, headers=None):
        req = urllib.request.Request(self.base + path, data=body, method="POST",
                                     headers=dict(headers or {}))
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def healthz(self):
        try:
            with urllib.request.urlopen(self.base + "/healthz", timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())


def _gen_body(tokens, max_new):
    buf = io.BytesIO()
    np.savez(buf, tokens=np.asarray(tokens, np.int32), max_new=np.int32(max_new))
    return buf.getvalue()


def test_split_roles_over_http_bitwise_equal_unified(artifacts):
    """A prefill-role server's blob, forwarded by the client to a
    decode-role server, gives the unified server's /generate reply bit
    for bit; the role gates, headers and counters are the JAX server's."""
    model_dir, wpath = artifacts
    with _Role(model_dir, wpath, "prefill") as pre, \
            _Role(model_dir, wpath, "decode") as dec, \
            _Role(model_dir, wpath, "unified") as uni:
        for toks, max_new in PROMPTS:
            code, _, body = uni.post("/generate", _gen_body(toks, max_new))
            assert code == 200
            u = np.load(io.BytesIO(body))
            code, headers, blob = pre.post("/prefill", _gen_body(toks, max_new))
            assert code == 200 and headers["Content-Type"] == "application/x-paddle-handoff"
            assert int(headers["X-Handoff-Tokens"]) == len(toks) - 1 + max_new
            assert pre.post("/prefill", _gen_body(toks, max_new))[2] == blob  # idempotent
            code, headers, body = dec.post("/decode", blob)
            assert code == 200 and int(headers["X-KV-Free-Pages"]) == 32
            d = np.load(io.BytesIO(body))
            np.testing.assert_array_equal(d["tokens"], u["tokens"])
            assert d["logits"].tobytes() == u["logits"].tobytes()

        # role gates: 404 NoSuchEndpoint off-role
        for srv, path in ((pre, "/decode"), (pre, "/generate"), (dec, "/prefill"),
                          (dec, "/generate")):
            code, _, body = srv.post(path, _gen_body([1, 2], 2))
            assert code == 404 and json.loads(body)["error"] == "NoSuchEndpoint"
        # a corrupt blob is a 400, a bad generate body too
        assert dec.post("/decode", blob[:-3])[0] == 400
        assert uni.post("/generate", b"not an npz")[0] == 400
        assert uni.post("/generate", _gen_body([1], 0))[0] == 400

        _, hp = pre.healthz()
        _, hd = dec.healthz()
        assert hp["role"] == "prefill" and "kv" not in hp
        assert hp["prefill"] == {"queued_tokens": 0}
        assert hp["counters"]["serve_prefill_dispatches"] == 2 * len(PROMPTS)
        assert hd["kv"]["pages_total"] == 32 and hd["kv"]["free_pages"] == 32
        assert hd["kv"]["max_len"] == 64 and hd["kv"]["decode_streams"] == 0
        assert hd["counters"]["serve_decode_requests"] == len(PROMPTS) + 1
        assert hd["counters"]["kv_decode_steps"] >= max(m for _, m in PROMPTS)
        assert hd["counters"]["kv_pages_in_use"] == 0


def test_kv_admission_shed_is_a_503(artifacts):
    model_dir, wpath = artifacts
    with _Role(model_dir, wpath, "unified", kv_config={"num_pages": 1, "page_len": 4,
                                                       "pages_per_seq": 2}) as uni:
        code, headers, body = uni.post("/generate", _gen_body(list(range(1, 8)), 4))
        assert code == 503 and json.loads(body)["error"] == "KVAdmissionShed"
        assert headers["Retry-After"] == "1"
        assert uni.healthz()[1]["counters"]["serve_shed"] == 1


def test_role_without_decode_weights_raises(artifacts):
    model_dir, _ = artifacts
    with pytest.raises(ValueError, match="requires --decode-weights"):
        InferenceServer(model_dir, device="cpu", role="decode")


# -- on the card -----------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_split_bitwise_equals_unified_at_bert_width():
    """BERT-base's attention width (12 heads of 64, vocab 30522) on the
    card: the split path's tokens and logits equal the unified path's
    bit for bit, and the first step's logits lie within 1e-5 of the
    CPU's largest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_disagg_serving.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    weights = make_toy_decode_weights(seed=7, vocab=30522, num_heads=12, head_dim=64)
    rs = np.random.RandomState(2)
    prompts = [(rs.randint(0, 30522, n).astype(np.int32), 8) for n in (9, 17, 33)]
    svcs = {dev: DecodeService(ToyDecodeModel(weights, device=dev), max_streams=8)
            for dev in ("cuda", "cpu")}
    dec = DecodeService(ToyDecodeModel(weights, device="cuda"), max_streams=8)
    pre = ToyDecodeModel(weights, device="cuda")
    try:
        for toks, max_new in prompts:
            u_toks, u_logits = svcs["cuda"].generate(toks, max_new)
            k, v, n, last = pre.prefill(toks)
            d_toks, d_logits = dec.decode(k, v, n, last, max_new)
            np.testing.assert_array_equal(d_toks, u_toks)
            assert d_logits.tobytes() == u_logits.tobytes()
            c_toks, c_logits = svcs["cpu"].generate(toks, max_new)
            # fp32 sums over 768 products in two orders (cuBLAS, MKL)
            assert np.abs(u_logits[0] - c_logits[0]).max() <= 1e-5 * np.abs(c_logits[0]).max()
    finally:
        for s in (*svcs.values(), dec):
            s.close()
