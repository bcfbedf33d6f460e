"""Ulysses sequence parallelism (paddle_tpu_torch/parallel/ulysses.py) and
the sequence-parallel dispatch of `fused_multihead_attention`
(ops/fused_ops.py `sequence_parallel_mode`).

On gloo ranks (this file run as a script, `--worker RANK WORLD STORE DIR`,
2 and 4 ranks side by side, one launch for the session), each rank
holding its sequence chunk:

- tests/test_ulysses.py on the port: Ulysses equals plain attention
  (the plain short kernel on the whole sequence) without and with a causal
  mask and a key bias, and its grads equal plain attention's; with
  attention dropout it draws the whole launch's mask (the kernels hash the
  global heads), so it equals the whole launch at 1e-6;
- on 2 ranks against the JAX package's `ulysses_attention` on its
  2-device mesh (no dropout: the JAX mesh runs its plain attention on CPU
  devices, whose dropout mask is another), out and grads at rtol 1e-5;
- BERT-tiny eval (tests/test_ulysses.py's
  test_fused_op_ulysses_mode_matches_ring) on a model axis of 2 under
  PADDLE_TPU_SP_MODE=ring and =ulysses: the same loss at rtol 1e-4, and
  each equal to the JAX package's one-device loss at rtol 1e-5.

Single process: indivisible heads raise, and the dispatch rule as a unit
(the auto ring at s >= 4096 on model > 1 only, off, a bad value raises,
an explicit mode with an indivisible sequence raises).
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
B, H, S, D = 2, 4, 32, 8
SEED = 4242
# (causal, bias, dropout, layout)
CASES = [(False, False, 0.0, "bhsd"), (True, True, 0.0, "bhsd"), (True, True, 0.0, "bshd"),
         (False, True, 0.1, "bshd")]


def _qkv(seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, S, D).astype("float32") for _ in range(3))
    bias = np.where(np.random.RandomState(2).rand(B, S) < 0.2, -1e9, 0.0).astype("float32")
    return q, k, v, bias


def _to(layout, x):
    return x if layout == "bhsd" else np.ascontiguousarray(x.transpose(0, 2, 1, 3))


def _bert_feed(cfg_vocab, b, s):
    rs = np.random.RandomState(3)
    return {
        "src_ids": rs.randint(0, cfg_vocab, (b, s)).astype("int64"),
        "sent_ids": rs.randint(0, 2, (b, s)).astype("int64"),
        "pos_ids": np.tile(np.arange(s), (b, 1)).astype("int64"),
        "input_mask": np.ones((b, s), "float32"),
        "mask_label": rs.randint(0, cfg_vocab, (b, s)).astype("int64"),
        "mask_weight": (rs.rand(b, s) < 0.5).astype("float32"),
        "nsp_label": rs.randint(0, 2, (b, 1)).astype("int64"),
    }


def _bert_eval(fluid, b=2, s=32):
    import importlib

    bert = importlib.import_module(fluid.__name__ + ".models.bert")
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        cfg = bert.BertConfig.tiny()
        cfg.use_flash_attention = True
        h = bert.build_bert_pretrain(cfg, b, s, is_test=True)
    return main, startup, h, cfg


# -- the ranks ---------------------------------------------------------------------


def _worker(rank, world, store, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel.api import DistributedStrategy
    from paddle_tpu_torch.parallel.ulysses import ulysses_attention

    out = Path(out)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    group = dist.new_group(list(range(world)))
    res = {}
    q, k, v, bias = _qkv()
    c = S // world
    for ci, (causal, with_bias, dropout, layout) in enumerate(CASES):
        sd = 2 if layout == "bhsd" else 1
        ts = [torch.tensor(np.ascontiguousarray(np.take(_to(layout, x), range(rank * c,
              rank * c + c), axis=sd))).requires_grad_(True) for x in (q, k, v)]
        b_ = torch.tensor(bias[:, rank * c:rank * c + c]) if with_bias else None
        o = ulysses_attention(*ts, group, bias=b_, causal=causal, dropout=dropout, seed=SEED,
                              layout=layout)
        # this rank's share of the whole output's mean(out ** 2)
        ((o.float() ** 2).sum() / (B * H * S * D)).backward()
        for name, t in zip(("out", "dq", "dk", "dv"), (o,) + tuple(t.grad for t in ts)):
            res[f"{ci}/{name}"] = t.detach().numpy()
    try:
        three = torch.zeros(1, 3, 8, 4)
        ulysses_attention(three, three, three, group, layout="bhsd")
        res["indivisible"] = np.asarray("no error")
    except ValueError as e:
        res["indivisible"] = np.asarray(str(e))
    if world == 2:
        init = np.load(out / "bert_init.npz")
        losses = {}
        for mode in ("ring", "ulysses"):
            os.environ["PADDLE_TPU_SP_MODE"] = mode
            main, startup, h, cfg = _bert_eval(fluid)
            exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
            exe.run(startup, scope=scope)
            for n in init.files:
                scope.set(n, torch.from_numpy(init[n].copy()))
            st = DistributedStrategy()
            st.tp = 2
            cp = fluid.CompiledProgram(main).with_data_parallel(loss_name=h["loss"].name)
            cp._mesh = st.build_mesh()
            got = exe.run(cp, feed=_bert_feed(cfg.vocab_size, 2, 32), fetch_list=[h["loss"]],
                          scope=scope)
            losses[mode] = float(np.asarray(got[0]).reshape(-1)[0])
        os.environ.pop("PADDLE_TPU_SP_MODE", None)
        (out / f"bert_r{rank}.json").write_text(json.dumps(losses))
    np.savez(out / f"uly_w{world}_r{rank}.npz", **res)
    dist.destroy_process_group()


# -- the parent --------------------------------------------------------------------


def _jax_refs(out):
    """The JAX package's Ulysses on its 2-device mesh (each case without
    dropout) and BERT-tiny's one-device eval loss, its startup values on
    disk."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    import paddle_tpu as jfluid
    from paddle_tpu.parallel import make_mesh
    from paddle_tpu.parallel.mesh import current_mesh, set_current_mesh
    from paddle_tpu.parallel.ulysses import ulysses_attention as jul

    old = current_mesh()
    refs = {}
    try:
        mesh = make_mesh({"sp": 2}, devices=jax.devices()[:2])
        spec = NamedSharding(mesh, JP(None, None, "model", None))
        q, k, v, bias = _qkv()
        for ci, (causal, with_bias, dropout, layout) in enumerate(CASES):
            if dropout:
                continue
            args = [jax.device_put(jnp.asarray(x), spec) for x in (q, k, v)]

            def f(q, k, v, causal=causal, with_bias=with_bias):
                return jul(q, k, v, "model", axis_size=2, causal=causal, mesh=mesh,
                           bias=jnp.asarray(bias) if with_bias else None)

            o = jax.jit(f)(*args)
            g = jax.jit(jax.grad(lambda *a: jnp.mean(f(*a) ** 2), argnums=(0, 1, 2)))(*args)
            refs[ci] = [np.asarray(x) for x in (o, *g)]
        main, startup, h, cfg = _bert_eval(jfluid)
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        exe.run(startup, scope=scope)
        names = sorted(v_.name for v_ in main.list_vars() if v_.persistable
                       and scope.has(v_.name) and scope.get(v_.name) is not None)
        np.savez(out / "bert_init.npz", **{n: np.asarray(scope.get(n)) for n in names})
        got = exe.run(main, feed=_bert_feed(cfg.vocab_size, 2, 32), fetch_list=[h["loss"]],
                      scope=scope)
        refs["bert"] = float(np.asarray(got[0]).reshape(-1)[0])
    finally:
        set_current_mesh(old)
    return refs


def _launch(out):
    refs = _jax_refs(out)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "PADDLE_TPU_"))}
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
    ranks = {(w, r): dict(np.load(out / f"uly_w{w}_r{r}.npz")) for w in WORLDS
             for r in range(w)}
    bert = [json.loads((out / f"bert_r{r}.json").read_text()) for r in range(2)]
    return refs, ranks, bert


_CACHE = {}


@pytest.fixture(scope="session")
def launched(tmp_path_factory):
    """The gloo launch's results, once a session (shared across xdist
    workers under a file lock)."""
    if "result" in _CACHE:
        return _CACHE["result"]
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        _CACHE["result"] = _launch(tmp_path_factory.mktemp("torch_ulysses"))
        return _CACHE["result"]
    shared = tmp_path_factory.getbasetemp().parent / "torch_ulysses"
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


def _gathered(ranks, world, ci, name, layout):
    sd = 2 if layout == "bhsd" else 1
    return np.concatenate([ranks[(world, r)][f"{ci}/{name}"] for r in range(world)], axis=sd)


def _whole(ci):
    """The case on one process: the plain short kernel on the whole
    sequence, out and grads of mean(out ** 2)."""
    from paddle_tpu_torch.ops.fused_ops import ShortAttention

    causal, with_bias, dropout, layout = CASES[ci]
    q, k, v, bias = _qkv()
    ts = [torch.tensor(_to(layout, x), requires_grad=True) for x in (q, k, v)]
    o = ShortAttention.apply(*ts, torch.tensor(bias) if with_bias else None, causal, None,
                             dropout, SEED, layout)
    (o.float() ** 2).mean().backward()
    return [x.detach().numpy() for x in (o,) + tuple(t.grad for t in ts)]


@pytest.mark.parametrize("ci", range(len(CASES)))
@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_matches_plain_attention(launched, world, ci):
    _, ranks, _ = launched
    layout = CASES[ci][3]
    for name, want in zip(("out", "dq", "dk", "dv"), _whole(ci)):
        np.testing.assert_allclose(_gathered(ranks, world, ci, name, layout), want,
                                   rtol=1e-6, atol=1e-7, err_msg=f"{world} {ci} {name}")


@pytest.mark.parametrize("ci", [i for i, c in enumerate(CASES) if not c[2]])
def test_ulysses_matches_jax_on_two_devices(launched, ci):
    refs, ranks, _ = launched
    layout = CASES[ci][3]
    for name, want in zip(("out", "dq", "dk", "dv"), refs[ci]):
        np.testing.assert_allclose(_to(layout, _gathered(ranks, 2, ci, name, layout)), want,
                                   rtol=1e-5, atol=1e-6, err_msg=f"{ci} {name}")


def test_bert_eval_ulysses_mode_matches_ring(launched):
    refs, _, bert = launched
    for r in range(2):
        np.testing.assert_allclose(bert[r]["ring"], bert[r]["ulysses"], rtol=1e-4)
        np.testing.assert_allclose(bert[r]["ring"], refs["bert"], rtol=1e-5)
        np.testing.assert_allclose(bert[r]["ulysses"], refs["bert"], rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_rejects_indivisible_heads(launched, world):
    """3 heads on a group of 2 or 4 ranks: ValueError on every rank."""
    _, ranks, _ = launched
    for r in range(world):
        assert "divisible" in str(ranks[(world, r)]["indivisible"]), ranks[(world, r)]


@pytest.mark.parametrize("env,sq,model_n,want", [
    ({}, 4096, 2, "ring"),
    ({}, 8192, 4, "ring"),
    ({}, 2048, 2, None),
    ({}, 4096, 1, None),
    ({}, 4098, 4, None),
    ({"PADDLE_TPU_SP_MODE": "off"}, 8192, 2, None),
    ({"PADDLE_TPU_SP_MODE": ""}, 8192, 2, None),
    ({"PADDLE_TPU_SP_MODE": "ring"}, 16, 2, "ring"),
    ({"PADDLE_TPU_SP_MODE": "Ulysses"}, 16, 2, "ulysses"),
    ({"PADDLE_TPU_SP_MODE": "ulysses"}, 17, 1, None),
])
def test_sequence_parallel_dispatch_rule(env, sq, model_n, want):
    from paddle_tpu_torch.ops.fused_ops import RING_MIN_SEQ, sequence_parallel_mode

    assert RING_MIN_SEQ == 4096
    assert sequence_parallel_mode(sq, sq, model_n, env=env) == want


@pytest.mark.parametrize("env,sq", [({"PADDLE_TPU_SP_MODE": "fast"}, 16),
                                    ({"PADDLE_TPU_SP_MODE": "ring"}, 17),
                                    ({"PADDLE_TPU_SP_MODE": "ulysses"}, 4097)])
def test_sequence_parallel_dispatch_rule_raises(env, sq):
    from paddle_tpu_torch.ops.fused_ops import sequence_parallel_mode

    with pytest.raises(ValueError):
        sequence_parallel_mode(sq, sq, 2, env=env)


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        sys.exit("usage: test_torch_ulysses.py --worker RANK WORLD STORE DIR")
