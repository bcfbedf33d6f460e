"""Ring attention (paddle_tpu_torch/ops/ring_attention.py) against the JAX
package's `ring_attention` (paddle_tpu/ops/pallas/ring_attention.py).

On the CPU the port's ring runs the plain versions of the flash kernels
#3-#5 per chunk pair. Held, out and grads at rtol 1e-5 / atol 1e-6:

- the global form for n in {1, 2, 4}, causal and not, dropout 0 and 0.1,
  in both layouts, with a key bias whose padding (-1e4, BERT's) fills the
  whole last key chunk of one row, against the JAX ring on its CPU
  mirror (`_chunk_fwd_jnp`, the Pallas kernels' hash);
- at n 2, against the JAX ring over its Pallas chunk kernels in interpret
  mode (PADDLE_TPU_PALLAS_INTERPRET=1, as tests/test_ring_attention.py
  runs them);
- the float64 plain version `ring_attention_plain` / `_bwd_plain` against
  the kernels' loop;
- the ring across 2 and 4 gloo ranks (this file run as a script,
  `--worker RANK WORLD STORE DIR`, one launch for the session) bit-equal
  to the one-process global form: out, lse and grads;
- an indivisible sequence raises; the pair seeds wrap as the JAX
  `_mix_seed` does in int32.

On the card (`-m gpu`, skipped without one): the global ring's pairs
launch #3 / #4-#5 (10 pairs a pass for a causal ring of n 4) and agree
with the same loop over the kernels' plain versions at phase 3's gates,
and in fp32 with `ring_attention_plain`.
"""

import fcntl
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import ring_attention as ra

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
B, H, S, D = 2, 2, 32, 8
SEED = 12345


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(n, seed=0, s=S):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(B, H, s, D).astype("float32") for _ in range(4))
    bias = np.where(rng.rand(B, s) < 0.8, 0.0, -1e4).astype("float32")
    bias[:, 0] = 0.0  # the [CLS] key: no causal row without a live key
    bias[0, s - s // max(n, 2):] = -1e4  # the whole last key chunk padded
    return q, k, v, w, bias


def _to(layout, x):
    return x if layout == "bhsd" else np.ascontiguousarray(x.transpose(0, 2, 1, 3))


def _port(q, k, v, w, bias, n, causal, dropout, layout, seed):
    """The port's global ring in `layout` -> numpy bhsd (out, dq, dk, dv)."""
    ts = [torch.tensor(_to(layout, x), requires_grad=True) for x in (q, k, v)]
    out = ra.ring_attention(*ts, axis_size=n, bias=torch.tensor(bias), causal=causal,
                            dropout=dropout, seed=seed, layout=layout)
    (out * torch.tensor(_to(layout, w))).sum().backward()
    return [_to(layout, t.detach().numpy()) for t in [out] + [t.grad for t in ts]]


def _jax(q, k, v, w, bias, n, causal, dropout):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.ring_attention import ring_attention as jring

    key = jax.random.PRNGKey(0)

    def f(q, k, v):
        return jring(q, k, v, "model", axis_size=n, bias=jnp.asarray(bias), causal=causal,
                     dropout=dropout, rng_key=key)

    args = [jnp.asarray(x) for x in (q, k, v)]
    out = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * w), argnums=(0, 1, 2))(*args)
    return [np.asarray(x) for x in (out, *grads)]


@pytest.fixture(scope="module")
def jax_seed():
    """The int32 seed the JAX ring draws from its key (PRNGKey(0)), which
    the port's ring takes."""
    import jax
    import jax.numpy as jnp

    return int(jax.random.randint(jax.random.PRNGKey(0), (1,), 0, np.iinfo(np.int32).max,
                                  jnp.int32)[0])


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_global_ring_matches_jax(jax_seed, n, causal, dropout, layout):
    args = _inputs(n, seed=n)
    got = _port(*args, n, causal, dropout, layout, jax_seed)
    want = _jax(*args, n, causal, dropout)
    for g, w_, name in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w_, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_global_ring_matches_jax_pallas_interpret(jax_seed, monkeypatch, causal):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    args = _inputs(2, seed=7)
    got = _port(*args, 2, causal, 0.1, "bhsd", jax_seed)
    want = _jax(*args, 2, causal, 0.1)
    for g, w_, name in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w_, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_the_kernel_loop(causal, dropout):
    q, k, v, w, bias = (torch.tensor(x) for x in _inputs(4, seed=3))
    kw = dict(causal=causal, dropout=dropout, seed=777, n=4)
    out, lse = ra.ring_attention_fwd(q, k, v, bias, **kw)
    pout, plse = ra.ring_attention_plain(q, k, v, bias, **kw)
    grads = ra.ring_attention_bwd(q, k, v, bias, w, out, lse, **kw)
    pgrads = ra.ring_attention_bwd_plain(q, k, v, bias, w, out, lse, **kw)
    for a, b_ in zip((out, lse) + grads, (pout, plse) + pgrads):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=RTOL, atol=ATOL)


def test_indivisible_sequence_raises():
    q = torch.zeros(1, 2, 30, 8)
    with pytest.raises(ValueError, match="not divisible"):
        ra.ring_attention(q, q, q, axis_size=4)
    with pytest.raises(ValueError, match="not divisible"):
        ra.ring_attention_plain(q, q, q, n=4)


def test_pair_seeds_wrap_as_jax_mix_seed():
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.ring_attention import _mix_seed

    for seed, n in ((0, 4), (2**31 - 1, 4), (123456789, 8), (987, 1)):
        for i in range(n):
            for j in range(n):
                want = int(_mix_seed(jnp.asarray([seed], jnp.int32), jnp.int32(i),
                                     jnp.int32(j), n)[0]) & 0xFFFFFFFF
                assert ra.mix_seed(seed, i, j, n) == want


# -- the ring across gloo ranks ------------------------------------------------------

WORLDS = (2, 4)
# (causal, dropout, layout)
RANK_CASES = [(False, 0.0, "bhsd"), (True, 0.1, "bhsd"), (True, 0.1, "bshd"),
              (False, 0.1, "bshd")]


def _rank_case_inputs(world, ci):
    q, k, v, w, bias = _inputs(world, seed=10 + ci)
    layout = RANK_CASES[ci][2]
    return [_to(layout, x) for x in (q, k, v, w)] + [bias]


def _worker(rank, world, store, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    group = dist.new_group(list(range(world)))
    res = {}
    for ci, (causal, dropout, layout) in enumerate(RANK_CASES):
        q, k, v, w, bias = _rank_case_inputs(world, ci)
        sd = 2 if layout == "bhsd" else 1
        c = q.shape[sd] // world

        def mine(x, dim=sd):
            return torch.tensor(np.ascontiguousarray(np.take(
                x, range(rank * c, rank * c + c), axis=dim)))

        ts = [mine(x).requires_grad_(True) for x in (q, k, v)]
        o = ra.ring_attention(*ts, bias=mine(bias, 1), causal=causal, dropout=dropout,
                              seed=SEED, layout=layout, group=group)
        (o * mine(w)).sum().backward()
        _, lse = ra.ring_attention_fwd(*(t.detach() for t in ts), mine(bias, 1), causal,
                                       None, dropout, SEED, layout=layout, group=group)
        for name, t in zip(("out", "lse", "dq", "dk", "dv"),
                           (o, lse) + tuple(t.grad for t in ts)):
            res[f"{ci}/{name}"] = t.detach().numpy()
    np.savez(Path(out) / f"ring_w{world}_r{rank}.npz", **res)
    dist.destroy_process_group()


def _launch(out):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), str(w),
                               str(out / f"store{w}"), str(out)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for w in WORLDS for r in range(w)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return {(w, r): dict(np.load(out / f"ring_w{w}_r{r}.npz")) for w in WORLDS
            for r in range(w)}


_CACHE = {}


@pytest.fixture(scope="session")
def ranks(tmp_path_factory):
    """The gloo launch's arrays, once a session (shared across xdist
    workers under a file lock)."""
    if "result" in _CACHE:
        return _CACHE["result"]
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        _CACHE["result"] = _launch(tmp_path_factory.mktemp("torch_ring"))
        return _CACHE["result"]
    shared = tmp_path_factory.getbasetemp().parent / "torch_ring"
    shared.mkdir(exist_ok=True)
    with open(shared / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            done = shared / "done"
            if done.exists():
                result = pickle.loads(done.read_bytes())
            else:
                result = _launch(shared)
                done.write_bytes(pickle.dumps(result))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    _CACHE["result"] = result
    return result


@pytest.mark.parametrize("ci", range(len(RANK_CASES)))
@pytest.mark.parametrize("world", WORLDS)
def test_gloo_ring_bit_equal_to_global_form(ranks, world, ci):
    causal, dropout, layout = RANK_CASES[ci]
    q, k, v, w, bias = _rank_case_inputs(world, ci)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = ra.ring_attention(*ts, axis_size=world, bias=torch.tensor(bias), causal=causal,
                          dropout=dropout, seed=SEED, layout=layout)
    (o * torch.tensor(w)).sum().backward()
    _, lse = ra.ring_attention_fwd(*(t.detach() for t in ts), torch.tensor(bias), causal,
                                   None, dropout, SEED, n=world, layout=layout)
    sd = 2 if layout == "bhsd" else 1
    whole = {"out": o, "lse": lse, "dq": ts[0].grad, "dk": ts[1].grad, "dv": ts[2].grad}
    for name, t in whole.items():
        got = np.concatenate([ranks[(world, r)][f"{ci}/{name}"] for r in range(world)],
                             axis=2 if name == "lse" else sd)
        assert np.array_equal(got, t.detach().numpy()), (world, ci, name)


# -- the card --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_ring_attention.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,n", [(1000, 4), (32, 2)])
def test_ring_pairs_on_the_card(cuda_device, s, n, causal, dtype):
    """The global ring's pair launches (b 1, 4 heads: s 1000, n 4, chunks of
    250, not a multiple of the kernels' tile; and BERT-tiny's s 32, n 2,
    chunks of 16), a #3 and a #4-#5 launch a live pair, against the same
    loop over the kernels' plain versions (the ring on CPU copies) at phase
    3's gates (max abs err fp32 1e-4, bf16 2e-2), and in fp32 against
    ring_attention_plain too. In bf16 each pair's output and grads come
    back rounded to bf16 before the float32 merge, as the JAX package's
    Pallas ring rounds them, so the float64 ring_attention_plain, which
    rounds once, is no bf16 reference: at |out| >= 2 the two roundings
    differ by a bf16 ulp, 0.0156, and more."""
    from paddle_tpu_torch.ops import kernels

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, dout = (torch.randn(1, 4, s, 64, generator=gen, device=cuda_device).to(dtype)
                     for _ in range(4))
    bias = torch.zeros(1, s, device=cuda_device)
    bias[:, -s // 5:] = -1e4
    kw = dict(causal=causal, dropout=0.1, seed=99, n=n)
    kernels.reset_launch_counts()
    out, lse = ra.ring_attention_fwd(q, k, v, bias, **kw)
    grads = ra.ring_attention_bwd(q, k, v, bias, dout, out, lse, **kw)
    torch.cuda.synchronize()
    pairs = n * (n + 1) // 2 if causal else n * n
    assert kernels.LAUNCHES["flash_fwd"] == pairs and kernels.LAUNCHES["flash_bwd"] == pairs
    cpu = [t.cpu() for t in (q, k, v, bias, dout)]
    lout, llse = ra.ring_attention_fwd(*cpu[:4], **kw)
    lgrads = ra.ring_attention_bwd(*cpu[:4], cpu[4], out.cpu(), lse.cpu(), **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip((out, lse) + grads, (lout, llse) + lgrads):
        assert float((got.float().cpu() - want.float()).abs().max()) <= tol
    if dtype == torch.float32:
        pout, plse = ra.ring_attention_plain(q, k, v, bias, **kw)
        pgrads = ra.ring_attention_bwd_plain(q, k, v, bias, dout, out, lse, **kw)
        for got, want in zip((out, lse) + grads, (pout, plse) + pgrads):
            assert float((got.float() - want.float()).abs().max()) <= tol


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--worker":
        sys.path.insert(0, str(ROOT))
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        sys.exit("usage: test_torch_ring_attention.py --worker RANK WORLD STORE DIR")
