"""Tensor parallelism (parallel/tensor_parallel.py) on gloo ranks: BERT
pretraining (2 layers, hidden 64, 4 heads, s 16, 4 masked positions a
row, hidden and attention dropout) on 2 ranks (batch 1 x model 2) and on 4
ranks (batch 2 x model 2), 3 steps from the JAX package's startup values,
carried by name.

The ranks are this file run as a script (`python
tests/test_torch_tensor_parallel.py --worker RANK WORLD STORE DIR`), joined
by a `file://` store, each timed out after 240 s; the two launches run
side by side once for the session (across xdist workers under a file
lock, as tests/test_torch_data_parallel.py shares its launch). Rank r
feeds the rows of its batch coordinate: the ranks of one model group feed
the same rows.

References (the JAX side with PADDLE_TPU_PALLAS_INTERPRET=1 and
PADDLE_TPU_SHORT_ATTN set to the layout, as the other BERT parity tests
run it), at PERF.md section 2's gates (losses rtol 1e-5, persistables atol
1e-5):

- with attention dropout (bshd with Adam; bhsd with Lamb and a
  global-norm clip): the JAX package's step on the whole batch. The JAX
  package's own `DistributedStrategy(tp=2)` mesh on its virtual CPU
  devices draws other attention-dropout masks than its one-device step
  (its losses part from it by ~1e-4 after 3 steps; with attention dropout
  0 the two agree), so the global mask is the one-device step's;
- without attention dropout (hidden dropout 0.1, a fused qkv projection,
  whose `split` takes the gather rule, and an untied MLM projection,
  whose vocab-sharded logits are gathered into the loss): the JAX
  `DistributedStrategy(tp=2)` mesh itself.

Also: the replicated parameters stay bit-identical on every rank; the
sharded ones are DTensors of Shard(d) on `model`; a ZeRO-1 + tp snapshot
(4 ranks) restores onto 1 rank and onto a batch 2 x model 1 mesh; and the
shard_propagation pass on a batch-2 mesh gives fetches bit-equal to the
manual placement while planning the Adam moments (tests/test_autoshard.py's
pass test on the port).
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
B, S, P, STEPS = 4, 16, 4, 3
RTOL, ATOL = 1e-5, 1e-5
# case -> (attention layout, optimizer, attention dropout, fused qkv + untied MLM,
#          JAX reference: "whole" batch on one device or the "tp2" mesh)
CASES = {
    "bshd_adam": ("bshd", "adam", 0.1, False, "whole"),
    "bhsd_lamb": ("bhsd", "lamb", 0.1, False, "whole"),
    "gather_tp2": ("bshd", "adam", 0.0, True, "tp2"),
}
WORLDS = (2, 4)


def build(fluid, case, b):
    """(main, startup, handles) of `case` in `fluid` at batch `b`."""
    import importlib

    bert = importlib.import_module(fluid.__name__ + ".models.bert")
    layout, opt, attn, fused, _ = CASES.get(case, CASES["bshd_adam"])
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        cfg = bert.BertConfig(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
                              intermediate_size=128, max_position=32, attn_layout=layout,
                              attention_dropout=attn, fused_qkv=fused,
                              tie_mlm_weights=not fused)
        h = bert.build_bert_pretrain(cfg, b, S, max_preds=P)
        if opt == "adam":
            fluid.optimizer.Adam(1e-3).minimize(h["loss"])
        else:
            fluid.optimizer.Lamb(1e-3, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)
                                 ).minimize(h["loss"])
    return main, startup, h


def feeds():
    """STEPS global batches (every mask weight 1: each rank's mean is the
    global mean's share)."""
    rng = np.random.RandomState(3)
    out = []
    for _ in range(STEPS):
        out.append({
            "src_ids": rng.randint(0, 96, (B, S)).astype("int64"),
            "sent_ids": rng.randint(0, 2, (B, S)).astype("int64"),
            "pos_ids": np.tile(np.arange(S), (B, 1)).astype("int64"),
            "input_mask": (rng.rand(B, S) > 0.1).astype("float32"),
            "mask_label": rng.randint(0, 96, (B, P)).astype("int64"),
            "mask_weight": np.ones((B, P), "float32"),
            "mask_pos": np.stack([rng.choice(S, P, replace=False) for _ in range(B)]
                                 ).astype("int64"),
            "nsp_label": rng.randint(0, 2, (B, 1)).astype("int64"),
        })
    return out


def _autoshard_program(fluid):
    """tests/test_autoshard.py's pass program: fc softmax, cross entropy,
    Adam."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1], dtype="int64")
        pred = fluid.layers.fc(x, 8, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


# -- the ranks ---------------------------------------------------------------------


def _steps(exe, prog, scope, loss, rows, extra_fetch=None):
    """STEPS steps on `rows` of each batch -> (losses, the last step's
    `extra_fetch` or None)."""
    out, extra = [], None
    for f in feeds():
        got = exe.run(prog, feed={k: v[rows] for k, v in f.items()},
                      fetch_list=[loss] + ([extra_fetch] if extra_fetch is not None else []),
                      scope=scope)
        out.append(float(np.asarray(got[0]).reshape(-1)[0]))
        extra = got[1] if extra_fetch is not None else None
    return out, extra


def _worker(rank, world, store, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import profiler, resilience
    from paddle_tpu_torch.parallel import mesh as tmesh
    from paddle_tpu_torch.parallel.api import DistributedStrategy
    from paddle_tpu_torch.scope import full_value, to_numpy

    out = Path(out)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    batch = world // 2
    b = B // batch
    brow = rank // 2
    rows = slice(brow * b, brow * b + b)
    report = {}
    for case in list(CASES) + (["zero1"] if world == 4 else []):
        main, startup, h = build(fluid, case, b)
        init = np.load(out / f"{'bshd_adam' if case == 'zero1' else case}_init.npz")
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        for n in init.files:
            scope.set(n, torch.from_numpy(init[n].copy()))
        st = DistributedStrategy()
        st.tp = 2
        st.zero1 = case == "zero1"
        compiled = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=h["loss"].name, zero1=st.zero1)
        compiled._mesh = mesh = st.build_mesh()
        # the untied MLM projection's logits are vocab-sharded: the fetch
        # gathers them along the vocab dim (and the batch group's rows)
        losses, logits = _steps(exe, compiled, scope, h["loss"], rows,
                                h["logits"] if case == "gather_tp2" else None)
        names = sorted(n for n in init.files if scope.has(n))
        state = {n: to_numpy(scope.get(n)) for n in names}
        placements = {n: [repr(p) for p in scope.get(n).placements]
                      + [list(scope.get(n).to_local().shape)]
                      for n in names if hasattr(scope.get(n), "placements")}
        local = {n: to_numpy(scope.get(n)) for n in names
                 if not hasattr(scope.get(n), "placements")}
        # the c10d gather of scope.full_value against DTensor's own
        dtensors = [scope.get(n) for n in names if hasattr(scope.get(n), "placements")]
        gathers_equal = all(torch.equal(full_value(v), v.full_tensor()) for v in dtensors)
        rec = {"mesh": dict(mesh.shape), "model_rank": mesh.local_rank("model"),
               "batch_rank": mesh.local_rank("batch"), "losses": losses,
               "placements": placements, "full_value_equals_full_tensor": gathers_equal,
               "collective_bytes_estimate": profiler.counters().get(
                   "collective_bytes_estimate")}
        if logits is not None:
            local["fetched_logits"] = np.asarray(logits)
        if case == "zero1":
            mgr = resilience.CheckpointManager(str(out / f"ckpt_r{rank}"), keep=2)
            mgr.save(STEPS, program=main, scope=scope, executor=exe)
            mgr.drain()
            mgr.close()
        report[case] = rec
        np.savez(out / f"{case}_w{world}_r{rank}.npz",
                 **{"state/" + k: v for k, v in state.items()},
                 **{"local/" + k: v for k, v in local.items()})
    if world == 2:
        # the shard_propagation pass on a batch-2 mesh: bit-equal fetches
        # with and without it, the Adam moments planned
        main, startup, loss = _autoshard_program(fluid)
        rng = np.random.RandomState(1)
        xv = rng.rand(8, 16).astype("float32")
        yv = np.random.RandomState(2).randint(0, 8, (8, 1)).astype("int64")
        arms = {}
        for on in (False, True):
            exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
            exe.run(startup, scope=scope)
            bs = fluid.BuildStrategy()
            bs.auto_shard = on
            cp = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name,
                                                               build_strategy=bs)
            got = [exe.run(cp, feed={"x": xv[rank * 4:rank * 4 + 4],
                                     "y": yv[rank * 4:rank * 4 + 4]},
                           fetch_list=[loss.name], scope=scope)[0] for _ in range(3)]
            arms[on] = (got, sorted(n for n in scope.local_names()
                                    if hasattr(scope.get(n), "placements")))
        report["autoshard"] = {
            "bitwise": all(np.array_equal(a, b) for a, b in zip(arms[False][0], arms[True][0])),
            "planned_vars": profiler.counters().get("autoshard_planned_vars", 0),
            "dtensors_off": arms[False][1], "dtensors_on": arms[True][1]}
    dist.destroy_process_group()
    if world == 4 and rank < 2:
        # the ZeRO-1 + tp snapshot restored onto batch 2 x model 1
        dist.init_process_group("gloo", init_method=f"file://{store}.b2", rank=rank,
                                world_size=2)
        main, startup, h = build(fluid, "zero1", B // 2)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        mesh = tmesh.build_mesh(batch=2)
        step = resilience.CheckpointManager(str(out / "ckpt_r0"), async_save=False).restore(
            program=main, scope=scope, executor=exe, mesh=mesh)
        names = sorted(v.name for v in main.list_vars() if v.persistable and scope.has(v.name))
        np.savez(out / f"restored_b2_r{rank}.npz",
                 **{n: to_numpy(scope.get(n)) for n in names})
        report["restored_b2"] = {"step": step, "mesh": dict(mesh.shape)}
        dist.destroy_process_group()
    (out / f"report_w{world}_r{rank}.json").write_text(json.dumps(report))


# -- the parent: JAX references, the launch ----------------------------------------


def _jax_case(case, out):
    """The case's JAX startup state on disk; its STEPS steps on the whole
    batch (one device, or the tp=2 mesh) -> (losses, state)."""
    import jax

    import paddle_tpu as jfluid
    from paddle_tpu.parallel import DistributedStrategy as JStrategy

    layout, _, _, _, ref = CASES[case]
    old = {k: os.environ.get(k) for k in ("PADDLE_TPU_PALLAS_INTERPRET",
                                          "PADDLE_TPU_SHORT_ATTN")}
    os.environ["PADDLE_TPU_PALLAS_INTERPRET"] = "1"
    os.environ["PADDLE_TPU_SHORT_ATTN"] = layout
    try:
        main, startup, h = build(jfluid, case, B)
        exe = jfluid.Executor(jfluid.CPUPlace())
        scope = jfluid.Scope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in main.list_vars() if v.persistable
                       and scope.has(v.name) and scope.get(v.name) is not None)
        init = {n: np.asarray(scope.get(n)) for n in names}
        np.savez(out / f"{case}_init.npz", **init)
        prog = main
        if ref == "tp2":
            st = JStrategy()
            st.tp = 2
            prog = jfluid.CompiledProgram(main).with_data_parallel(loss_name=h["loss"].name)
            prog._mesh = st.build_mesh(devices=jax.devices()[:2])
            assert dict(prog._mesh.shape) == {"batch": 1, "model": 2, "pipe": 1}
        losses = []
        for f in feeds():
            lv, logits = exe.run(prog, feed=f, fetch_list=[h["loss"], h["logits"]], scope=scope)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        state = {n: np.asarray(scope.get(n)) for n in names}
        state["fetched_logits"] = np.asarray(logits)
        return losses, state
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
            arrays = {case: dict(np.load(out / f"{case}_w{w}_r{r}.npz"))
                      for case in rep if case in CASES or case == "zero1"}
            if "restored_b2" in rep:
                arrays["restored_b2"] = dict(np.load(out / f"restored_b2_r{r}.npz"))
            ranks[(w, r)] = (rep, arrays)
    return refs, ranks


_CACHE = {}


def launched_session(tmp_path_factory):
    """The launch's (refs, ranks, out dir), once a session: under xdist the
    first worker to get here runs it in the session's shared temp dir, the
    others wait on the lock and read its results."""
    if "result" in _CACHE:
        return _CACHE["result"]
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        out = tmp_path_factory.mktemp("torch_tp")
        _CACHE["result"] = _launch(out) + (out,)
        return _CACHE["result"]
    shared = tmp_path_factory.getbasetemp().parent / "torch_tp"
    shared.mkdir(exist_ok=True)
    with open(shared / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            done = shared / "done"
            if done.exists():
                result = pickle.loads(done.read_bytes()) + (shared,)
            else:
                result = _launch(shared)
                done.write_bytes(pickle.dumps(result))
                result = result + (shared,)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    _CACHE["result"] = result
    return result


@pytest.fixture(scope="session")
def launched(tmp_path_factory):
    return launched_session(tmp_path_factory)


# -- the tests ---------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_bert_tensor_parallel_matches_jax(launched, case, world):
    refs, ranks, _ = launched
    j_losses, j_state = refs[case]
    for r in range(world):
        rep, arrays = ranks[(world, r)]
        rec = rep[case]
        assert rec["mesh"] == {"batch": world // 2, "model": 2, "pipe": 1}
        assert rec["model_rank"] == r % 2 and rec["batch_rank"] == r // 2
        np.testing.assert_allclose(rec["losses"], j_losses, rtol=RTOL, atol=0)
        got = arrays[case]
        for n, ref in j_state.items():
            if n == "fetched_logits":
                continue
            np.testing.assert_allclose(got["state/" + n], ref, rtol=0, atol=ATOL,
                                       err_msg=f"{case} world {world}: {n}")
        if case == "gather_tp2" and world == 2:
            # the vocab-sharded logits fetched whole along the vocab dim (on
            # batch 2 the program's concrete leading dim takes the mesh's
            # mean rule, not the gather of a -1 batch dim)
            assert got["local/fetched_logits"].shape == j_state["fetched_logits"].shape
            np.testing.assert_allclose(got["local/fetched_logits"], j_state["fetched_logits"],
                                       rtol=RTOL, atol=ATOL)
        # sharded state counts twice in the estimate of a training step
        assert rec["collective_bytes_estimate"] > 0
    assert all(np.isfinite(j_losses))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_parameters_and_replicated_bits(launched, world):
    """Annotated parameters and their Adam moments are Shard(d) DTensors on
    `model` (column-parallel dim 1, row-parallel dim 0); everything else
    is replicated, bit-identical on every rank."""
    _, ranks, _ = launched
    for r in range(world):
        pl = ranks[(world, r)][0]["bshd_adam"]["placements"]
        rep, shard0, shard1 = "Replicate()", "Shard(dim=0)", "Shard(dim=1)"
        for p in ("bert.layer0.attn.q.w_0", "bert.layer1.ffn1.w_0"):
            for n in (p, p + "_moment1_0", p + "_moment2_0"):
                assert pl[n][:3] == [rep, shard1, rep], (n, pl[n])
        assert pl["bert.layer0.ffn1.w_0"][3] == [64, 64]
        assert pl["bert.layer0.attn.out.w_0"][:3] == [rep, shard0, rep]
        assert pl["bert.layer0.attn.q.b_0"][:3] == [rep, shard0, rep]
        assert "bert.layer0.attn.out.b_0" not in pl and "bert.word_emb" not in pl
    for case in CASES:
        base = ranks[(world, 0)][1][case]
        for r in range(1, world):
            other = ranks[(world, r)][1][case]
            for n in (k for k in base if k.startswith("local/")):
                assert np.array_equal(base[n], other[n]), (case, world, r, n)


@pytest.mark.parametrize("world", WORLDS)
def test_full_value_gathers_bit_equal_to_full_tensor(launched, world):
    """scope.full_value's c10d gather (each sharded mesh dim, innermost
    first) gives DTensor.full_tensor's bits for every sharded var, ZeRO-1
    rows on batch under a model split too."""
    _, ranks, _ = launched
    for r in range(world):
        report = ranks[(world, r)][0]
        for case in list(CASES) + (["zero1"] if world == 4 else []):
            assert report[case]["full_value_equals_full_tensor"] is True, (case, world, r)


def test_zero1_with_tp_snapshot_restores_on_one_rank_and_batch2(launched):
    """ZeRO-1 + tp on 4 ranks: a column-parallel moment is Shard(0) on
    batch and Shard(1) on model; a row-parallel one keeps its model chunk
    whole. Its snapshot (the specs in the manifest) restores onto 1 rank
    whole and onto a batch 2 x model 1 mesh, equal to the gathered state."""
    import torch

    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch import resilience as tres
    from paddle_tpu_torch.resilience import snapshot as tsnap
    from paddle_tpu_torch.scope import to_numpy

    refs, ranks, out = launched
    rep0, arrays0 = ranks[(4, 0)]
    pl = rep0["zero1"]["placements"]
    m = "bert.layer0.attn.q.w_0_moment1_0"
    assert pl[m] == ["Shard(dim=0)", "Shard(dim=1)", "Replicate()", [32, 32]], pl[m]
    assert pl["bert.layer0.attn.out.w_0_moment1_0"][:2] == ["Replicate()", "Shard(dim=0)"]
    np.testing.assert_allclose(rep0["zero1"]["losses"], refs["bshd_adam"][0], rtol=RTOL)
    final = arrays0["zero1"]
    manifest = tsnap.read_manifest(tsnap.list_snapshots(str(out / "ckpt_r0"))[0][1])
    specs = {n: e["spec"] for n, e in manifest["vars"].items() if "spec" in e}
    assert specs[m] == ["batch", "model"]
    assert specs["bert.layer0.attn.q.w_0"] == [None, "model"]
    assert manifest["mesh"] == {"batch": 2, "model": 2, "pipe": 1}
    main, startup, _ = build(tfluid, "zero1", B)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    assert tres.CheckpointManager(str(out / "ckpt_r0"), async_save=False).restore(
        program=main, scope=scope, executor=exe) == STEPS
    for n in specs:
        assert isinstance(scope.get(n), torch.Tensor) and not hasattr(scope.get(n),
                                                                       "placements")
        np.testing.assert_array_equal(to_numpy(scope.get(n)), final["state/" + n])
    for r in (0, 1):
        rep, arrays = ranks[(4, r)]
        assert rep["restored_b2"] == {"step": STEPS, "mesh": {"batch": 2, "model": 1,
                                                               "pipe": 1}}
        for n in specs:
            np.testing.assert_array_equal(arrays["restored_b2"][n], final["state/" + n])


def test_autoshard_pass_bitwise_equal_and_plans_moments(launched):
    """tests/test_autoshard.py's pass test on the port's batch-2 mesh."""
    _, ranks, _ = launched
    for r in range(2):
        a = ranks[(2, r)][0]["autoshard"]
        assert a["bitwise"], "autoshard changed the math"
        # the planner sharded the Adam moments (2 a param x 2 params)
        assert a["planned_vars"] >= 4
        assert a["dtensors_off"] == [] and len(a["dtensors_on"]) >= 4


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        sys.exit("usage: test_torch_tensor_parallel.py --worker RANK WORLD STORE DIR")
