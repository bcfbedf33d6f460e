"""Mixture of experts (paddle_tpu_torch/parallel/moe.py, the `moe_ffn` op,
`layers.moe`) and the layout plan's expert rule.

On one process, against the JAX package (rtol 1e-5): `moe_ffn`'s output,
aux loss and grads (fp32, and the expert products in bf16 at bf16's
tolerance); tests/test_moe.py on the port (ample capacity routes every
token, a small capacity drops tokens, the grads reach the gate through
the combine weights and the aux loss); and tests/test_moe_layer.py's
model (fc -> moe -> residual -> mse + 0.01 aux, Adam) for 3 steps from
the JAX startup values, carried by name.

On gloo ranks (this file run as a script, `--worker RANK WORLD STORE
DIR`, one launch for the session): the same model on a model axis of 2
(two experts a rank) and of 4 (one), against the port's one-process walk
at losses rtol 1e-5 and parameters atol 1e-5. The ranks sum the partial
combine in another order than the one-device einsum, a difference of a
few ulps; at this size no token's route changes over the 3 steps, so
the walk's gates hold (a changed route would show as a step far past
them; the JAX package's own single-vs-mesh test allows rtol 5e-2 for
that). Each rank holds its E/m experts, a Shard(0) DTensor on `model`,
and the replicated parameters are bit-identical on every rank. Under the
sequence layout (PADDLE_TPU_SP_MODE=ring; `build_attn`: fc, attention,
moe on [2, 16, D]) the ring runs over the ranks' chunks and the experts'
tokens are gathered first; 3 steps against the one-process walk at the
same gates.
"""

import fcntl
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
STEPS = 3
D, E, FF, NB = 16, 4, 32, 32
S_ATTN = 16  # build_attn's sequence: 2 rows of 16 tokens


def _jax_params(seed, d, ff, e):
    from paddle_tpu.parallel.moe import init_moe_params

    return {k: np.asarray(v) for k, v in init_moe_params(seed, d, ff, e).items()}


def _port_moe(params, x, **kw):
    from paddle_tpu_torch.parallel.moe import moe_ffn

    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    y, aux = moe_ffn(p, xt, **kw)
    ((y.float() ** 2).mean() + 0.01 * aux).backward()
    return y, aux, {k: v.grad.numpy() for k, v in p.items()}, xt.grad.numpy()


def _jax_moe(params, x, **kw):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel.moe import moe_ffn

    def loss(p, xv):
        y, aux = moe_ffn(p, xv, **kw)
        return jnp.mean(y.astype(jnp.float32) ** 2) + 0.01 * aux, (y, aux)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    return np.asarray(y), float(aux), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


@pytest.mark.parametrize("cf,k", [(2.0, 2), (0.25, 2), (1.25, 1)])
def test_moe_ffn_matches_jax(cf, k):
    params = _jax_params(3, 8, 16, 4)
    x = np.random.RandomState(3).randn(32, 8).astype("float32")
    y, aux, g, gx = _port_moe(params, x, capacity_factor=cf, k=k)
    jy, jaux, jg, jgx = _jax_moe(params, x, capacity_factor=cf, k=k)
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), jaux, rtol=1e-5)
    for name in params:
        np.testing.assert_allclose(g[name], jg[name], rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(gx, jgx, rtol=1e-5, atol=1e-6)


def test_moe_ffn_bf16_expert_products_match_jax():
    """compute_dtype bf16: the expert einsums in bf16, routing and aux in
    fp32; held at bf16's tolerance (XLA and torch round the bf16 products'
    accumulation differently)."""
    import jax.numpy as jnp

    params = _jax_params(5, 8, 16, 4)
    x = np.random.RandomState(5).randn(32, 8).astype("float32")
    y, aux, _, _ = _port_moe(params, x, capacity_factor=2.0, k=2,
                             compute_dtype=torch.bfloat16)
    jy, jaux, _, _ = _jax_moe(params, x, capacity_factor=2.0, k=2, compute_dtype=jnp.bfloat16)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(float(aux.detach()), jaux, rtol=1e-5)


def test_moe_routes_all_tokens_with_ample_capacity():
    from paddle_tpu_torch.parallel.moe import init_moe_params, moe_ffn

    params = init_moe_params(0, d_model=8, d_ff=16, num_experts=4)
    x = torch.tensor(np.random.RandomState(0).randn(32, 8).astype("float32"))
    y, aux = moe_ffn(params, x, capacity_factor=2.0, k=2)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert float(aux) > 0
    assert float(y.abs().sum()) > 0
    # every token kept: its combine weights sum to 1, so no row is zero
    assert bool((y.abs().sum(-1) > 0).all())


def test_moe_capacity_drops_tokens():
    from paddle_tpu_torch.parallel.moe import init_moe_params, moe_ffn

    params = init_moe_params(1, d_model=4, d_ff=8, num_experts=2)
    x = torch.tensor(np.random.RandomState(1).randn(64, 4).astype("float32"))
    y_small, _ = moe_ffn(params, x, capacity_factor=0.05, k=1)
    y_big, _ = moe_ffn(params, x, capacity_factor=4.0, k=1)
    zeros_small = float((y_small.abs().sum(-1) < 1e-7).float().mean())
    zeros_big = float((y_big.abs().sum(-1) < 1e-7).float().mean())
    assert zeros_small > zeros_big


def test_moe_differentiable_and_balanced_loss_grads():
    params = _jax_params(2, 8, 16, 4)
    x = np.random.RandomState(2).randn(16, 8).astype("float32")
    _, _, g, _ = _port_moe(params, x, capacity_factor=2.0, k=2)
    for name in ("gate", "w1", "w2", "b1", "b2"):
        assert np.isfinite(g[name]).all(), name
    assert np.abs(g["gate"]).max() > 0


def test_moe_shardings_place_the_expert_dim():
    from torch.distributed.tensor import Replicate, Shard

    from paddle_tpu_torch.parallel import build_mesh
    from paddle_tpu_torch.parallel.moe import moe_shardings

    sh = moe_shardings(build_mesh(), "ep")
    assert tuple(sh["gate"]) == (Replicate(),) * 3
    for name in ("w1", "b1", "w2", "b2"):
        assert tuple(sh[name]) == (Replicate(), Shard(0), Replicate())


# -- layers.moe through the Executor ----------------------------------------------


def build(fluid):
    """tests/test_moe_layer.py's model: fc -> moe -> residual, mse + 0.01 aux,
    Adam(1e-2)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [D], dtype="float32")
        y = fluid.layers.data("y", [D], dtype="float32")
        h = fluid.layers.fc(x, D, act="relu", param_attr=fluid.initializer.Constant(0.1))
        m, aux = fluid.layers.moe(h, num_experts=E, d_ff=FF, capacity_factor=2.0, k=2)
        pred = fluid.layers.elementwise_add(h, m)
        mse = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        loss = fluid.layers.elementwise_add(mse, fluid.layers.scale(aux, scale=0.01))
        loss = fluid.layers.reshape(loss, [1])
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


def build_attn(fluid):
    """The sequence layout's expert rule: fc -> attention (bshd, 2 heads,
    one of the ring's Programs) -> moe -> residual, on a fed [2, S_ATTN, D]
    batch, mse + 0.01 aux, Adam(1e-2)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 13
    b = NB // S_ATTN
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [b, S_ATTN, D], dtype="float32", append_batch_size=False)
        y = fluid.layers.data("y", [b, S_ATTN, D], dtype="float32", append_batch_size=False)
        h = fluid.layers.fc(x, D, num_flatten_dims=2)
        heads = fluid.layers.reshape(h, [b, S_ATTN, 2, D // 2])
        a = fluid.layers.reshape(fluid.layers.fused_multihead_attention(
            heads, heads, heads, layout="bshd"), [b, S_ATTN, D])
        m, aux = fluid.layers.moe(a, num_experts=E, d_ff=FF, capacity_factor=2.0, k=2)
        mse = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.elementwise_add(a, m), y))
        loss = fluid.layers.reshape(
            fluid.layers.elementwise_add(mse, fluid.layers.scale(aux, scale=0.01)), [1])
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


def feeds(attn=False):
    rng = np.random.RandomState(7)
    out = []
    for _ in range(STEPS):
        xv = rng.randn(NB, D).astype("float32")
        f = {"x": xv, "y": np.tanh(xv)[:, ::-1].copy()}
        out.append({k: v.reshape(NB // S_ATTN, S_ATTN, D) for k, v in f.items()} if attn
                   else f)
    return out


def _steps(fluid, prog, scope, exe, loss, attn=False):
    return [float(np.asarray(exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0])
                  .reshape(-1)[0]) for f in feeds(attn)]


def _port_walk(init, attn=False):
    """The port's one-process walk from `init` -> (losses, state)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.scope import to_numpy

    main, startup, loss = (build_attn if attn else build)(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    for n, v in init.items():
        scope.set(n, torch.from_numpy(v.copy()))
    losses = _steps(fluid, main, scope, exe, loss, attn)
    return losses, {n: to_numpy(scope.get(n)) for n in init}


def _jax_walk():
    """The JAX package's startup values and its 3 steps -> (init, losses,
    state)."""
    import paddle_tpu as jfluid

    main, startup, loss = build(jfluid)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable
                   and scope.has(v.name) and scope.get(v.name) is not None)
    init = {n: np.asarray(scope.get(n)) for n in names}
    losses = _steps(jfluid, main, scope, exe, loss)
    return init, losses, {n: np.asarray(scope.get(n)) for n in names}


def test_layers_moe_three_steps_match_jax():
    torch.set_num_threads(1)
    init, j_losses, j_state = _jax_walk()
    assert any(n.endswith(".w1") or "moe" in n for n in init)
    losses, state = _port_walk(init)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    for n, want in j_state.items():
        np.testing.assert_allclose(state[n], want, rtol=0, atol=1e-5, err_msg=n)


def test_layers_moe_annotates_the_expert_dim():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import sharding_specs

    main, _, _ = build(fluid)
    specs = sharding_specs(main)
    experts = [op for op in main.global_block().ops if op.type == "moe_ffn"][0]
    for slot in ("W1", "B1", "W2", "B2"):
        assert tuple(specs[experts.input(slot)[0]]) == ("model",)
    assert experts.input("Gate")[0] not in specs


# -- the expert rule on gloo ranks -------------------------------------------------


def _worker(rank, world, store, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.parallel.api import DistributedStrategy
    from paddle_tpu_torch.scope import to_numpy

    out = Path(out)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    init = np.load(out / "init.npz")
    main, startup, loss = build(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    for n in init.files:
        scope.set(n, torch.from_numpy(init[n].copy()))
    st = DistributedStrategy()
    st.tp = world
    cp = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    cp._mesh = mesh = st.build_mesh()
    losses = _steps(fluid, cp, scope, exe, loss)
    names = sorted(init.files)
    local = {n: list(scope.get(n).to_local().shape) for n in names
             if hasattr(scope.get(n), "placements")}
    placements = {n: [repr(p) for p in scope.get(n).placements] for n in local}
    np.savez(out / f"moe_w{world}_r{rank}.npz", **{n: to_numpy(scope.get(n)) for n in names})
    # the sequence layout: the ring's chunks gathered into the experts' tokens
    os.environ["PADDLE_TPU_SP_MODE"] = "ring"
    try:
        ainit = np.load(out / "attn_init.npz")
        amain, astartup, aloss = build_attn(fluid)
        exe, ascope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(astartup, scope=ascope)
        for n in ainit.files:
            ascope.set(n, torch.from_numpy(ainit[n].copy()))
        acp = fluid.CompiledProgram(amain).with_data_parallel(loss_name=aloss.name)
        acp._mesh = mesh
        before = profiler.counters().get("attn_dispatch_ring", 0)
        alosses = _steps(fluid, acp, ascope, exe, aloss, attn=True)
        rings = profiler.counters().get("attn_dispatch_ring", 0) - before
    finally:
        os.environ.pop("PADDLE_TPU_SP_MODE", None)
    np.savez(out / f"attn_w{world}_r{rank}.npz",
             **{n: to_numpy(ascope.get(n)) for n in sorted(ainit.files)})
    (out / f"moe_w{world}_r{rank}.json").write_text(json.dumps({
        "mesh": dict(mesh.shape), "losses": losses, "local": local,
        "placements": placements, "attn_losses": alosses, "attn_rings": rings}))
    dist.destroy_process_group()


def _attn_init():
    """build_attn's startup values on one process, carried to the ranks."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.scope import to_numpy

    main, startup, _ = build_attn(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    return {v.name: to_numpy(scope.get(v.name)) for v in main.list_vars()
            if v.persistable and scope.has(v.name)}


def _launch(out):
    init, _, _ = _jax_walk()
    np.savez(out / "init.npz", **init)
    walk = _port_walk(init)
    ainit = _attn_init()
    np.savez(out / "attn_init.npz", **ainit)
    attn_walk = _port_walk(ainit, attn=True)
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
    ranks = {(w, r): (json.loads((out / f"moe_w{w}_r{r}.json").read_text()),
                      dict(np.load(out / f"moe_w{w}_r{r}.npz")),
                      dict(np.load(out / f"attn_w{w}_r{r}.npz")))
             for w in WORLDS for r in range(w)}
    return walk, ranks, attn_walk


_CACHE = {}


@pytest.fixture(scope="session")
def launched(tmp_path_factory):
    """The gloo launch's results, once a session (shared across xdist
    workers under a file lock)."""
    if "result" in _CACHE:
        return _CACHE["result"]
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        _CACHE["result"] = _launch(tmp_path_factory.mktemp("torch_moe"))
        return _CACHE["result"]
    shared = tmp_path_factory.getbasetemp().parent / "torch_moe"
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


@pytest.mark.parametrize("world", WORLDS)
def test_expert_rule_matches_the_one_process_walk(launched, world):
    (w_losses, w_state), ranks, _ = launched
    for r in range(world):
        rep, state, _ = ranks[(world, r)]
        assert rep["mesh"] == {"batch": 1, "model": world, "pipe": 1}
        np.testing.assert_allclose(rep["losses"], w_losses, rtol=1e-5)
        for n, want in w_state.items():
            np.testing.assert_allclose(state[n], want, rtol=0, atol=1e-5,
                                       err_msg=f"world {world} rank {r}: {n}")


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_experts(launched, world):
    _, ranks, _ = launched
    for r in range(world):
        rep, _, _ = ranks[(world, r)]
        experts = {n: s for n, s in rep["local"].items() if "moe" in n}
        assert len(experts) >= 4, rep["local"]
        for n, shape in experts.items():
            assert shape[0] == E // world, (n, shape)
            assert rep["placements"][n][:2] == ["Replicate()", "Shard(dim=0)"], n
        # the gate, the fc and Adam's moments of both stay replicated
        gate = [n for n in rep["local"] if n.endswith(".w_0") and "moe" in n]
        assert not gate, gate
    base = ranks[(world, 0)][1]
    for r in range(1, world):
        other = ranks[(world, r)][1]
        for n in base:
            if n not in ranks[(world, r)][0]["local"]:
                assert np.array_equal(base[n], other[n]), (world, r, n)


@pytest.mark.parametrize("world", WORLDS)
def test_expert_rule_under_the_sequence_layout(launched, world):
    """PADDLE_TPU_SP_MODE=ring on a model axis of 2 and 4: the attention runs
    the ring over the ranks' sequence chunks (a dispatch a step), the
    experts' tokens are gathered first (capacity and positions count every
    token), and the 3 steps match the one-process walk at the gates above."""
    _, ranks, (a_losses, a_state) = launched
    for r in range(world):
        rep, _, state = ranks[(world, r)]
        assert rep["attn_rings"] == STEPS
        np.testing.assert_allclose(rep["attn_losses"], a_losses, rtol=1e-5)
        for n, want in a_state.items():
            np.testing.assert_allclose(state[n], want, rtol=0, atol=1e-5,
                                       err_msg=f"world {world} rank {r}: {n}")


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        sys.exit("usage: test_torch_moe.py --worker RANK WORLD STORE DIR")
