"""The port's attention kernels against the JAX package's Pallas forward
kernels.

On the CPU the port's wrappers run their plain PyTorch versions; those
are held against the Pallas kernel bodies run in interpret mode
(`_short_fwd_bshd`, `_short_fwd_pallas`, `_fwd_pallas`), out and lse,
with the same int32 dropout seed handed to both sides. The `gpu`-marked
tests hold each CUDA kernel against its plain version on the card and
skip without one.

Tolerances: fp32 atol 1e-5 / rtol 1e-5 (summation order only); bf16
atol 2e-2 (about one bf16 ulp of the outputs); fp16 one fp16 ulp of the
outputs' largest magnitude (p rounds to fp16 before P V on both sides,
and may round the other way), lse (float32) at the fp32 gate.

The card has no JAX, so this file imports the JAX package inside the CPU
tests only; on the card run
`python -m pytest -m gpu --noconftest tests/test_torch_kernels.py`."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import LAUNCHES
from paddle_tpu_torch.ops.kernels.flash_attention import (
    NEG_INF, flash_attention, flash_attention_plain)
from paddle_tpu_torch.ops.kernels.mha_short import short_attention, short_attention_plain

SEED = 1234

# (kernel, layout, b, h, sq, sk, d, bias, causal, dtype, dropout)
CASES = [
    ("short", "bshd", 2, 4, 128, 128, 64, True, False, "float32", 0.0),
    ("short", "bhsd", 2, 4, 128, 128, 64, True, False, "float32", 0.0),
    # sq > sk causal: the first 23 rows see no key and must come out 0
    ("short", "bshd", 2, 3, 100, 77, 32, False, True, "float32", 0.0),
    ("short", "bhsd", 1, 2, 64, 77, 64, True, True, "float32", 0.0),
    ("short", "bshd", 2, 4, 128, 128, 64, True, False, "bfloat16", 0.0),
    ("short", "bhsd", 2, 2, 77, 77, 64, False, False, "bfloat16", 0.0),
    ("short", "bshd", 2, 4, 128, 128, 64, True, False, "float32", 0.2),
    ("short", "bhsd", 1, 2, 64, 77, 32, True, True, "float32", 0.2),
    ("short", "bshd", 2, 2, 100, 128, 64, False, True, "bfloat16", 0.2),
    ("flash", "bhsd", 2, 4, 160, 160, 64, True, False, "float32", 0.0),
    # flash causal keeps sq <= sk, so every row has a live key (on a row
    # with none the Pallas value depends on its padding)
    ("flash", "bshd", 2, 2, 64, 77, 64, False, True, "float32", 0.0),
    ("flash", "bhsd", 1, 3, 77, 77, 32, False, False, "float32", 0.0),
    ("flash", "bhsd", 2, 2, 128, 128, 64, True, False, "bfloat16", 0.0),
    ("flash", "bshd", 1, 2, 100, 150, 64, True, True, "bfloat16", 0.0),
    ("flash", "bhsd", 2, 2, 128, 128, 64, True, False, "float32", 0.2),
    ("flash", "bshd", 1, 2, 64, 77, 32, True, True, "bfloat16", 0.2),
    # fp16 (AMP with amp_dtype="float16"): BERT's shape, causal sq > sk
    # with dropout, and the flash kernel bias + causal
    ("short", "bshd", 2, 4, 128, 128, 64, True, False, "float16", 0.0),
    ("short", "bhsd", 1, 2, 100, 77, 32, True, True, "float16", 0.2),
    ("flash", "bhsd", 1, 2, 100, 150, 64, True, True, "float16", 0.0),
]


def _case_id(c):
    return "-".join(str(x) for x in c)


def _inputs(layout, b, h, sq, sk, d, use_bias, seed=0):
    """numpy float32 q, k, v in `layout` and a [b, sk] key bias (0 keep,
    -1e4 drop, BERT's mask values) with key 0 always live."""
    rs = np.random.RandomState(seed)
    qshape = (b, sq, h, d) if layout == "bshd" else (b, h, sq, d)
    kshape = (b, sk, h, d) if layout == "bshd" else (b, h, sk, d)
    q = rs.randn(*qshape).astype(np.float32)
    k = rs.randn(*kshape).astype(np.float32)
    v = rs.randn(*kshape).astype(np.float32)
    bias = None
    if use_bias:
        bias = np.where(rs.rand(b, sk) > 0.25, 0.0, -1e4).astype(np.float32)
        bias[:, 0] = 0.0
    return q, k, v, bias


def _bhsd(x, layout):
    return np.swapaxes(x, 1, 2) if layout == "bshd" else x


def _jax_short(q, k, v, bias, causal, scale, dropout, layout, dtype):
    """The Pallas short forward in interpret mode, padded the way
    short_attention(_bshd) pads -> (out in `layout`, lse [b, h, sq])."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.flash_attention import _ceil_to
    from paddle_tpu.ops.pallas.mha_short import _pick_g, _short_fwd_bshd, _short_fwd_pallas

    jdt = jnp.dtype(dtype)
    seed = jnp.array([SEED], jnp.int32)
    if layout == "bshd":
        b, sq, h, d = q.shape
        sk = k.shape[1]
    else:
        b, h, sq, d = q.shape
        sk = k.shape[2]
    sqp = _ceil_to(max(sq, 8), 8)
    skp = _ceil_to(max(sk, 128), 128)
    biasf = None
    if bias is not None:
        biasf = jnp.pad(jnp.asarray(bias), [(0, 0), (0, skp - sk)],
                        constant_values=NEG_INF)
    if layout == "bshd":
        qj = jnp.pad(jnp.asarray(q, jdt), [(0, 0), (0, sqp - sq), (0, 0), (0, 0)])
        kj, vj = (jnp.pad(jnp.asarray(t, jdt), [(0, 0), (0, skp - sk), (0, 0), (0, 0)])
                  for t in (k, v))
        out, lse = _short_fwd_bshd(qj, kj, vj, biasf, seed, h, h, scale, causal,
                                   sk - sq, dropout, sk)
        return np.asarray(out[:, :sq].astype(jnp.float32)), \
            np.transpose(np.asarray(lse[:, :sq]), (0, 2, 1))
    bh = b * h
    qj = jnp.pad(jnp.asarray(q.reshape(bh, sq, d), jdt), [(0, 0), (0, sqp - sq), (0, 0)])
    kj, vj = (jnp.pad(jnp.asarray(t.reshape(bh, sk, d), jdt), [(0, 0), (0, skp - sk), (0, 0)])
              for t in (k, v))
    if biasf is not None:
        biasf = jnp.broadcast_to(biasf[:, None, :], (b, h, skp)).reshape(bh, skp)
    G = _pick_g(bh, sqp, skp, d)
    out, lse = _short_fwd_pallas(qj, kj, vj, biasf, seed, G, scale, causal,
                                 sk - sq, dropout, sk)
    out = np.asarray(out.astype(jnp.float32)).reshape(b, h, sqp, d)[:, :, :sq]
    return out, np.asarray(lse).reshape(b, h, sqp)[:, :, :sq]


def _jax_flash(q, k, v, bias, causal, scale, dropout, layout, dtype):
    """The Pallas flash forward in interpret mode, padded by the JAX
    package's own _pad_inputs -> (out in `layout`, lse [b, h, sq])."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.flash_attention import _fwd_pallas, _pad_inputs

    jdt = jnp.dtype(dtype)
    qb, kb, vb = (jnp.asarray(_bhsd(t, layout), jdt) for t in (q, k, v))
    b, h, sq, d = qb.shape
    sk = kb.shape[2]
    qf, kf, vf, biasf, bq, bk = _pad_inputs(
        qb, kb, vb, None if bias is None else jnp.asarray(bias), None, None)
    out, lse = _fwd_pallas(qf, kf, vf, biasf, jnp.array([SEED], jnp.int32), h,
                           sm_scale=scale, causal=causal, causal_offset=sk - sq,
                           dropout=dropout, block_q=bq, block_k=bk)
    out = np.asarray(out[:, :sq, :d].astype(jnp.float32)).reshape(b, h, sq, d)
    lse = np.asarray(lse[:, 0, :sq]).reshape(b, h, sq)
    return _bhsd(out, layout), lse


def fp16_ulp(ref):
    """One fp16 ulp (11 significant bits) of the largest finite magnitude
    in `ref`."""
    ref = np.abs(np.asarray(ref, np.float64))
    top = float(ref[np.isfinite(ref)].max(initial=2.0**-14))
    return float(np.exp2(np.floor(np.log2(max(top, 2.0**-14))) - 10))


def _tol(dtype, ref=None):
    """The gate of an output of `dtype` against `ref`; a float32 output
    (lse) of fp16 inputs takes the fp32 gate."""
    if dtype == "float32" or (dtype == "float16" and ref is None):
        return dict(atol=1e-5, rtol=1e-5)
    if dtype == "float16":
        return dict(atol=fp16_ulp(ref), rtol=0)
    return dict(atol=2e-2, rtol=0)


def _torch_inputs(q, k, v, bias, dtype, device="cpu"):
    tdt = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(t).to(device=device, dtype=tdt) for t in (q, k, v))
    bt = None if bias is None else torch.from_numpy(bias).to(device)
    return qt, kt, vt, bt


def _jax_public(kernel, q, k, v, bias, causal, layout, dtype):
    """The JAX package's public entry point for the same call (out only):
    short_attention_bshd, short_attention or flash_attention."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.flash_attention import flash_attention as j_flash
    from paddle_tpu.ops.pallas.mha_short import short_attention as j_short
    from paddle_tpu.ops.pallas.mha_short import short_attention_bshd as j_short_bshd

    jdt = jnp.dtype(dtype)
    jbias = None if bias is None else jnp.asarray(bias)
    if kernel == "short":
        fn = j_short_bshd if layout == "bshd" else j_short
        qj, kj, vj = (jnp.asarray(t, jdt) for t in (q, k, v))
        return np.asarray(fn(qj, kj, vj, bias=jbias, causal=causal).astype(jnp.float32))
    qj, kj, vj = (jnp.asarray(_bhsd(t, layout), jdt) for t in (q, k, v))
    out = j_flash(qj, kj, vj, bias=jbias, causal=causal)
    return _bhsd(np.asarray(out.astype(jnp.float32)), layout)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_matches_pallas_kernel(case, monkeypatch):
    # flash_attention runs its Pallas kernel on the CPU only in interpret mode
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    kernel, layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    q, k, v, bias = _inputs(layout, b, h, sq, sk, d, use_bias)
    scale = 1.0 / np.sqrt(d)
    jax_fn = _jax_short if kernel == "short" else _jax_flash
    ref_out, ref_lse = jax_fn(q, k, v, bias, causal, scale, dropout, layout, dtype)
    port_fn = short_attention if kernel == "short" else flash_attention
    launches = dict(LAUNCHES)
    out, lse = port_fn(*_torch_inputs(q, k, v, bias, dtype), causal=causal,
                       sm_scale=scale, dropout=dropout, seed=SEED, layout=layout)
    assert LAUNCHES == launches  # a CPU tensor never launches a kernel
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), ref_out, **_tol(dtype, ref_out))
    np.testing.assert_allclose(lse.numpy(), ref_lse, **_tol(dtype))
    if dropout == 0.0:  # the public entry points take a threefry key instead
        pub = _jax_public(kernel, q, k, v, bias, causal, layout, dtype)
        np.testing.assert_allclose(out.float().numpy(), pub, **_tol(dtype, pub))


def _attention_op_program(fluid, layout, b, h, sq, sk, d, causal):
    """q, k, v and a [b, sk] key bias into one fused_multihead_attention op
    -> (program, out var)."""
    qs = [b, sq, h, d] if layout == "bshd" else [b, h, sq, d]
    ks = [b, sk, h, d] if layout == "bshd" else [b, h, sk, d]
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()), fluid.unique_name.guard():
        q = fluid.layers.data("q", qs, append_batch_size=False)
        k = fluid.layers.data("k", ks, append_batch_size=False)
        v = fluid.layers.data("v", ks, append_batch_size=False)
        bias = fluid.layers.data("bias", [b, sk], append_batch_size=False)
        out = fluid.layers.fused_multihead_attention(
            q, k, v, key_bias=bias, causal=causal, sm_scale=1.0 / np.sqrt(d),
            is_test=True, layout=layout)
    return prog, out


# (layout, b, h, sq, sk, d, causal): sq, sk <= 512 takes the short kernel,
# longer sequences the flash kernel
OP_CASES = [
    ("bshd", 2, 2, 100, 100, 32, True),
    ("bhsd", 1, 2, 64, 96, 32, False),
    ("bshd", 1, 2, 520, 600, 16, True),
    ("bhsd", 1, 2, 600, 600, 16, False),
]


@pytest.mark.parametrize("case", OP_CASES, ids=_case_id)
def test_op_lowering_matches_jax_op(case, monkeypatch):
    """The port's fused_multihead_attention through its Executor against the
    JAX op through its Executor, with the JAX op forced onto its Pallas
    kernels (short below 512, flash above) in interpret mode."""
    import paddle_tpu as jfluid

    import paddle_tpu_torch as tfluid

    layout, b, h, sq, sk, d, causal = case
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_SHORT_ATTN", "bshd")
    monkeypatch.setenv("PADDLE_TPU_ATTN_DISPATCH", "flash")
    q, k, v, bias = _inputs(layout, b, h, sq, sk, d, True)
    feed = {"q": q, "k": k, "v": v, "bias": bias}
    outs = []
    for fluid in (jfluid, tfluid):
        prog, out = _attention_op_program(fluid, layout, b, h, sq, sk, d, causal)
        exe = fluid.Executor(fluid.CPUPlace())
        outs.append(exe.run(prog, feed=dict(feed), fetch_list=[out],
                            scope=fluid.Scope())[0])
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5, rtol=1e-5)


def test_short_fully_masked_row_gives_zero():
    """Kernel A clamps the row max at NEG_INF / 8, so a row whose keys are
    all masked comes out exactly 0 (mha_short.py:104), as in Pallas."""
    q, k, v, bias = _inputs("bshd", 2, 2, 40, 40, 32, True)
    bias[1, :] = NEG_INF  # batch row 1: every key masked
    scale = 1.0 / np.sqrt(32)
    ref_out, ref_lse = _jax_short(q, k, v, bias, False, scale, 0.0, "bshd", "float32")
    out, lse = short_attention(*_torch_inputs(q, k, v, bias, "float32"),
                               sm_scale=scale, layout="bshd")
    assert torch.count_nonzero(out[1]) == 0
    assert np.count_nonzero(ref_out[1]) == 0
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu "
                    "tests/test_torch_*.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_cuda_kernel_matches_plain(case, cuda_device):
    kernel, layout, b, h, sq, sk, d, use_bias, causal, dtype, dropout = case
    q, k, v, bias = _inputs(layout, b, h, sq, sk, d, use_bias)
    args = _torch_inputs(q, k, v, bias, dtype, cuda_device)
    kw = dict(causal=causal, dropout=dropout, seed=SEED, layout=layout)
    plain_fn = short_attention_plain if kernel == "short" else flash_attention_plain
    wrapper = short_attention if kernel == "short" else flash_attention
    name = "mha_short_fwd" if kernel == "short" else "flash_fwd"
    before = LAUNCHES[name]
    out, lse = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    ref_out, ref_lse = plain_fn(*args, **kw)
    ref_out = ref_out.float().cpu().numpy()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref_out, **_tol(dtype, ref_out))
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("case", OP_CASES, ids=_case_id)
def test_cuda_op_launches_its_kernel(case, cuda_device):
    """On the card the op launches the short kernel up to 512 and the flash
    kernel above, and agrees with the same program on the CPU."""
    import paddle_tpu_torch as tfluid

    layout, b, h, sq, sk, d, causal = case
    q, k, v, bias = _inputs(layout, b, h, sq, sk, d, True)
    feed = {"q": q, "k": k, "v": v, "bias": bias}
    prog, out = _attention_op_program(tfluid, layout, b, h, sq, sk, d, causal)
    name = "mha_short_fwd" if max(sq, sk) <= 512 else "flash_fwd"
    before = dict(LAUNCHES)
    got = tfluid.Executor(tfluid.CUDAPlace(0)).run(prog, feed=dict(feed), fetch_list=[out],
                                                   scope=tfluid.Scope())[0]
    assert {n: LAUNCHES[n] - before[n] for n in LAUNCHES} == {
        n: int(n == name) for n in LAUNCHES}
    ref = tfluid.Executor(tfluid.CPUPlace()).run(prog, feed=dict(feed), fetch_list=[out],
                                                 scope=tfluid.Scope())[0]
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_cuda_short_kernel_refuses_long_sequences(cuda_device):
    q, k, v, _ = _inputs("bhsd", 1, 1, 600, 600, 64, False)
    with pytest.raises(ValueError, match="sq, sk <= 512"):
        short_attention(*_torch_inputs(q, k, v, None, "float32", cuda_device)[:3])


def test_jax_runs_on_cpu():
    import jax

    assert jax.default_backend() == "cpu"
