"""Sequence parallelism (the sequence layout of parallel/tensor_parallel.py,
the ring and Ulysses across the model group) on gloo ranks: BERT
pretraining (2 layers, hidden 64, 4 heads, s 16, 4 masked positions a
row, hidden dropout 0.1, Adam), 3 steps from the JAX package's startup
values, carried by name, on 2 ranks (batch 1 x model 2) and on 4 ranks
(batch 2 x model 2).

The ranks are this file run as a script (`python
tests/test_torch_sequence_parallel.py --worker RANK WORLD STORE DIR`),
joined by a `file://` store; the two launches run side by side once for
the session (across xdist workers under a file lock, as
tests/test_torch_tensor_parallel.py shares its launch). Rank r feeds the
rows of its batch coordinate, the whole sequence: the ranks of one model
group feed the same rows, and the plan cuts each rank's chunk.

References, at PERF.md section 2's gates (losses rtol 1e-5, persistables
atol 1e-5):

- "ring" (attention dropout 0.1, PADDLE_TPU_SP_MODE=ring, bshd), and
  "ring_bhsd_padded" (the same in bhsd, row 0's padding filling its whole
  last key chunk): the JAX package's own `DistributedStrategy(tp=2)` mesh
  under the same mode, whose ring draws the pair-seeded masks the port's
  ring draws. Its ring runs the plain-XLA chunk mirror (no
  PADDLE_TPU_PALLAS_INTERPRET): the Pallas chunk kernels hash the same
  masks;
- "ulysses" (attention dropout 0.1, PADDLE_TPU_SP_MODE=ulysses): the JAX
  package's step on the whole batch on one device. The JAX mesh under
  Ulysses runs its plain attention on CPU devices, which draws other
  attention-dropout masks than its kernels; the port's Ulysses hashes the
  global heads, the mask of the one whole launch;
- "ulysses_mesh" (attention dropout 0): the JAX tp=2 mesh under
  PADDLE_TPU_SP_MODE=ulysses itself.

Also: `attn_dispatch_ring` / `attn_dispatch_ulysses` count 2 a step (one
a layer); every parameter is replicated and bit-identical across each
model group; under PADDLE_TPU_SP_MODE=off the same Program runs
Megatron's layout (no dispatch counted); and the plan of a batch of 1
(a stub mesh, no ranks) shards every attention on its sequence dim in
both layouts.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))

import test_torch_tensor_parallel as tp  # noqa: E402

B, S, P, STEPS = tp.B, tp.S, tp.P, tp.STEPS
RTOL, ATOL = 1e-5, 1e-5
# case -> (PADDLE_TPU_SP_MODE, attention dropout, JAX reference: the tp=2 "mesh"
#          under the mode, or the "whole" batch on one device; attention layout;
#          whether row 0's padding fills the whole last key chunk)
CASES = {
    "ring": ("ring", 0.1, "mesh", "bshd", False),
    "ring_bhsd_padded": ("ring", 0.1, "mesh", "bhsd", True),
    "ulysses": ("ulysses", 0.1, "whole", "bshd", False),
    "ulysses_mesh": ("ulysses", 0.0, "mesh", "bshd", False),
}
WORLDS = (2, 4)


def build(fluid, case, b):
    """(main, startup, handles) of `case`: tests/test_torch_tensor_parallel's
    BERT in the case's layout with Adam at its attention dropout."""
    _, attn, _, layout, _ = CASES[case]
    tp.CASES["_sp"] = (layout, "adam", attn, False, "whole")
    try:
        return tp.build(fluid, "_sp", b)
    finally:
        tp.CASES.pop("_sp", None)


def feeds(case):
    """tests/test_torch_tensor_parallel's batches; with the case's padding,
    row 0 pads its whole second half (the last key chunk of a model axis of
    2), BERT's padding at the end."""
    out = tp.feeds()
    if CASES[case][4]:
        for f in out:
            f["input_mask"][0, S // 2:] = 0.0
    return out


def _steps(exe, prog, scope, loss, rows, case):
    return [float(np.asarray(exe.run(prog, feed={k: v[rows] for k, v in f.items()},
                                     fetch_list=[loss], scope=scope)[0]).reshape(-1)[0])
            for f in feeds(case)]


# -- the ranks ---------------------------------------------------------------------


def _worker(rank, world, store, out):
    import torch
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
    b = B // (world // 2)
    brow = rank // 2
    rows = slice(brow * b, brow * b + b)
    report = {}
    for case in list(CASES) + ["off"]:
        mode = CASES[case][0] if case in CASES else "off"
        os.environ["PADDLE_TPU_SP_MODE"] = mode
        main, startup, h = build(fluid, case if case in CASES else "ring", b)
        init = np.load(out / f"{case if case in CASES else 'ring'}_init.npz")
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        for n in init.files:
            scope.set(n, torch.from_numpy(init[n].copy()))
        st = DistributedStrategy()
        st.tp = 2
        compiled = fluid.CompiledProgram(main).with_data_parallel(loss_name=h["loss"].name)
        compiled._mesh = mesh = st.build_mesh()
        before = dict(profiler.counters())
        losses = _steps(exe, compiled, scope, h["loss"], rows, case if case in CASES else "ring")
        after = profiler.counters()
        names = sorted(n for n in init.files if scope.has(n))
        np.savez(out / f"{case}_w{world}_r{rank}.npz",
                 **{n: to_numpy(scope.get(n)) for n in names})
        report[case] = {
            "mesh": dict(mesh.shape), "model_rank": mesh.local_rank("model"),
            "losses": losses,
            "dtensors": sorted(n for n in names if hasattr(scope.get(n), "placements")),
            "dispatch": {k: after.get(k, 0) - before.get(k, 0)
                         for k in ("attn_dispatch_ring", "attn_dispatch_ulysses")}}
    os.environ.pop("PADDLE_TPU_SP_MODE", None)
    dist.destroy_process_group()
    (out / f"report_w{world}_r{rank}.json").write_text(json.dumps(report))


# -- the parent: JAX references, the launch ----------------------------------------


def _jax_case(case, out):
    """The case's JAX startup state on disk; its STEPS steps on the whole
    batch (one device, or the tp=2 mesh under the case's mode) ->
    (losses, state)."""
    import jax

    import paddle_tpu as jfluid
    from paddle_tpu.parallel import DistributedStrategy as JStrategy

    mode, _, ref, layout, _ = CASES[case]
    keys = ("PADDLE_TPU_PALLAS_INTERPRET", "PADDLE_TPU_SHORT_ATTN", "PADDLE_TPU_SP_MODE")
    old = {k: os.environ.get(k) for k in keys}
    os.environ["PADDLE_TPU_SHORT_ATTN"] = layout
    if ref == "whole":
        os.environ["PADDLE_TPU_PALLAS_INTERPRET"] = "1"
    else:
        os.environ.pop("PADDLE_TPU_PALLAS_INTERPRET", None)
        os.environ["PADDLE_TPU_SP_MODE"] = mode
    try:
        main, startup, h = build(jfluid, case, B)
        exe = jfluid.Executor(jfluid.CPUPlace())
        scope = jfluid.Scope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in main.list_vars() if v.persistable
                       and scope.has(v.name) and scope.get(v.name) is not None)
        np.savez(out / f"{case}_init.npz", **{n: np.asarray(scope.get(n)) for n in names})
        prog = main
        if ref == "mesh":
            st = JStrategy()
            st.tp = 2
            prog = jfluid.CompiledProgram(main).with_data_parallel(loss_name=h["loss"].name)
            prog._mesh = st.build_mesh(devices=jax.devices()[:2])
        losses = [float(np.asarray(exe.run(prog, feed=f, fetch_list=[h["loss"]],
                                           scope=scope)[0]).reshape(-1)[0])
                  for f in feeds(case)]
        return losses, {n: np.asarray(scope.get(n)) for n in names}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _launch(out):
    from paddle_tpu.parallel import mesh as jmesh

    old = jmesh.current_mesh()
    try:
        refs = {case: _jax_case(case, out) for case in CASES}
    finally:
        jmesh.set_current_mesh(old)
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
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = {}
    for w in WORLDS:
        for r in range(w):
            rep = json.loads((out / f"report_w{w}_r{r}.json").read_text())
            ranks[(w, r)] = (rep, {case: dict(np.load(out / f"{case}_w{w}_r{r}.npz"))
                                   for case in rep})
    return refs, ranks


_CACHE = {}


@pytest.fixture(scope="session")
def launched(tmp_path_factory):
    """The launch's (refs, ranks), once a session: under xdist the first
    worker to get here runs it in the session's shared temp dir, the
    others wait on the lock and read its results."""
    if "result" in _CACHE:
        return _CACHE["result"]
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        _CACHE["result"] = _launch(tmp_path_factory.mktemp("torch_sp"))
        return _CACHE["result"]
    shared = tmp_path_factory.getbasetemp().parent / "torch_sp"
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


# -- the tests ---------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_bert_sequence_parallel_matches_jax(launched, case, world):
    refs, ranks = launched
    j_losses, j_state = refs[case]
    mode = CASES[case][0]
    for r in range(world):
        rep, arrays = ranks[(world, r)]
        rec = rep[case]
        assert rec["mesh"] == {"batch": world // 2, "model": 2, "pipe": 1}
        assert rec["model_rank"] == r % 2
        assert rec["dispatch"] == {f"attn_dispatch_{m}": (2 * STEPS if m == mode else 0)
                                   for m in ("ring", "ulysses")}, rec["dispatch"]
        np.testing.assert_allclose(rec["losses"], j_losses, rtol=RTOL, atol=0)
        for n, ref in j_state.items():
            np.testing.assert_allclose(arrays[case][n], ref, rtol=0, atol=ATOL,
                                       err_msg=f"{case} world {world}: {n}")
    assert all(np.isfinite(j_losses))


@pytest.mark.parametrize("world", WORLDS)
def test_sequence_layout_replicates_parameters_bit_identically(launched, world):
    """Under the sequence layout no parameter is sharded, and each one (and
    its Adam moments) is bit-identical on every rank of a model group."""
    _, ranks = launched
    for case in CASES:
        for r in range(world):
            assert ranks[(world, r)][0][case]["dtensors"] == []
        for r in range(0, world, 2):
            base, other = ranks[(world, r)][1][case], ranks[(world, r + 1)][1][case]
            for n in base:
                assert np.array_equal(base[n], other[n]), (case, world, r, n)


@pytest.mark.parametrize("world", WORLDS)
def test_sp_mode_off_runs_the_tensor_parallel_layout(launched, world):
    """PADDLE_TPU_SP_MODE=off: the same Program runs Megatron's layout
    (sharded parameters, no sequence-parallel dispatch); its numbers are
    tests/test_torch_tensor_parallel.py's to hold."""
    _, ranks = launched
    for r in range(world):
        rec = ranks[(world, r)][0]["off"]
        assert rec["dispatch"] == {"attn_dispatch_ring": 0, "attn_dispatch_ulysses": 0}
        assert "bert.layer0.attn.q.w_0" in rec["dtensors"]
        assert all(np.isfinite(rec["losses"]))


class _StubMesh:
    """A batch 1 x model 2 mesh without ranks: the plan's inputs only."""

    shape = {"batch": 1, "model": 2, "pipe": 1}

    def group(self, axis):
        return None

    def local_rank(self, axis):
        return 0


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_plan_at_batch_one_shards_attention_on_the_sequence(monkeypatch, layout):
    """A batch of 1 ([1, s, h] reshaped to [1, s, nh, dh]): every attention's
    q / k / v sharded on the sequence dim, the key bias cut from the feed,
    the [CLS] slice and the MLM flatten gathered, the LayerNorm grads'
    Scale / Bias all-reduced, no parameter sharded."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel.tensor_parallel import TensorParallelPlan

    monkeypatch.setenv("PADDLE_TPU_SP_MODE", "ring")
    tp.CASES["_sp1"] = (layout, "adam", 0.1, False, "whole")
    try:
        main, _, h = tp.build(fluid, "_sp1", 1)
    finally:
        tp.CASES.pop("_sp1", None)
    exe = fluid.Executor(fluid.CPUPlace())
    passed = exe._passed_program(main, sorted(tp.feeds()[0]), [h["loss"].name],
                                 fluid.Scope(), None)
    plan = TensorParallelPlan(_StubMesh(), passed)
    assert (plan.sequence, plan.seq_len, plan.state) == ("ring", S, {})
    ops = plan.program.global_block().ops
    sd = 1 if layout == "bshd" else 2
    attn = [op for op in ops if op.type == "fused_multihead_attention"]
    assert len(attn) == 2
    for op in attn:
        assert [plan.dims.get(op.input(x)[0]) for x in ("Q", "K", "V", "KeyBias")] == \
            [sd, sd, sd, 1]
        assert plan.rules[id(op)].kind == "local"
    kinds = {op.type: plan.rules[id(op)].kind for op in ops
             if id(op) in plan.rules and op.type in ("slice", "lookup_table")}
    assert kinds == {"slice": "gather", "lookup_table": "local"}
    # the embedding's and each layer's two: the MLM head's reads gathered rows
    ln = [plan.rules[id(op)] for op in ops if op.type == "layer_norm_grad"
          and id(op) in plan.rules]
    assert len(ln) == 5 and all(len(r.reduce_out) == 2 for r in ln)


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        sys.exit("usage: test_torch_sequence_parallel.py --worker RANK WORLD STORE DIR")
