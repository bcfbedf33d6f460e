"""`Executor.run_repeated` and `CompiledProgram._run_repeated` of the port
(paddle_tpu_torch/static_step.py) on the CPU, held against the JAX
package's `run_repeated` and against the port's own `run()` calls.

- The JAX package's test_run_repeated_matches_sequential_runs
  (tests/test_executor.py:170-229) ported: fc, dropout 0.3, Adam, 6 steps
  in one call and 3 `run()` + `run_repeated(3)`, the JAX startup state
  carried into the port by name; the stacked losses within rtol 1e-5 and
  every persistable within atol 1e-5 of the JAX `run_repeated` (PERF.md
  section 2's gates).
- The port's `run_repeated` bit-equal to as many of its own `run()` calls,
  the seed counter too: that fc program, 2-layer BERT with hidden and
  attention dropout (bshd: kernels #1 / #7's plain versions; bhsd: #2 /
  #6's) and BERT's full pretraining under bf16 AMP with dynamic loss
  scaling around Lamb with a global-norm clip. On the CPU the static step
  re-runs its lowering with the seed slots (ops/registry.py `SeedSlots`)
  in place of host seeds; the BERT cases check that the slots are there.
- The errors: steps 0, PADDLE_TPU_CHECK_NAN_INF=1, a persistable without a
  value, a main program with an op that draws from a torch.Generator.
- The CheckpointManager's window rule (save_interval 2, a window of 5):
  one snapshot of the final state labelled 4, `_auto_step` 5, the record
  within atol 1e-5 of the JAX package's.
- `_run_repeated` on 2 gloo ranks against the JAX batch-2 mesh's: a case
  of tests/test_torch_data_parallel.py's launch (`repeated`).
- `gpu` (skips without a card): each of kernels #1-#7 launched with its
  seed in device memory bit-equal to the launch with the same word by
  value, and a replayed capture drawing the word written before it.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import resilience
from paddle_tpu_torch.models.bert import BertConfig, build_bert_pretrain
from paddle_tpu_torch.resilience.snapshot import list_snapshots, load_snapshot
from paddle_tpu_torch.scope import to_numpy
from test_torch_data_parallel import launched  # noqa: F401  (the 2-rank launch, shared)

LOSS_RTOL, STATE_ATOL = 1e-5, 1e-5
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)
B, S, P = 2, 32, 5


def _fc_dropout(fluid):
    """tests/test_executor.py:179-189's program, in either package."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8, 4], append_batch_size=False)
        h = fluid.layers.fc(x, 16, act="relu")
        h = fluid.layers.dropout(h, 0.3, dropout_implementation="upscale_in_train")
        loss = fluid.layers.reduce_mean(fluid.layers.square(h))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


FC_FEED = {"x": np.random.RandomState(0).randn(8, 4).astype("float32")}


def _persistables(main, scope):
    return {v.name: np.asarray(to_numpy(scope.get(v.name))) for v in main.list_vars()
            if v.persistable and scope.has(v.name) and scope.get(v.name) is not None}


def _jax_fc(split):
    """The JAX run: startup, `split[0]` run() calls then run_repeated of
    `split[1]` steps -> (start state, losses, end state)."""
    import paddle_tpu as jfluid

    main, startup, loss = _fc_dropout(jfluid)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        state0 = _persistables(main, scope)
        losses = [np.asarray(exe.run(main, feed=dict(FC_FEED), fetch_list=[loss])[0])
                  .reshape(-1) for _ in range(split[0])]
        (stacked,) = exe.run_repeated(main, feed=dict(FC_FEED), fetch_list=[loss],
                                      steps=split[1])
        losses += list(np.asarray(stacked).reshape(split[1], -1))
        return state0, np.concatenate(losses), _persistables(main, scope)


@pytest.mark.parametrize("split", [(0, 6), (3, 3)], ids=["one_call", "interleaved"])
def test_run_repeated_matches_jax_run_repeated(split):
    state0, j_losses, j_state = _jax_fc(split)
    main, startup, loss = _fc_dropout(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    assert sorted(_persistables(main, scope)) == sorted(state0)
    tfluid.io.set_persistables_from_numpy(scope, state0, exe.device)
    losses = [exe.run(main, feed=dict(FC_FEED), fetch_list=[loss], scope=scope)[0].reshape(-1)
              for _ in range(split[0])]
    (stacked,) = exe.run_repeated(main, feed=dict(FC_FEED), fetch_list=[loss],
                                  steps=split[1], scope=scope)
    assert stacked.shape[0] == split[1]
    losses += list(stacked.reshape(split[1], -1))
    np.testing.assert_allclose(np.concatenate(losses), j_losses, rtol=LOSS_RTOL, atol=0)
    got = _persistables(main, scope)
    for n, ref in j_state.items():
        np.testing.assert_allclose(got[n], ref, atol=STATE_ATOL, rtol=0, err_msg=n)
    assert exe._seed_counter == 1 + sum(split)


# -- the port against its own run() ---------------------------------------------------


def _bert(layout, full=False):
    """2-layer BERT with dropout 0.1 on hidden states and attention: the
    masked-LM cell under Adam, or (`full`) both heads under bf16 AMP with
    dynamic loss scaling around Lamb with a global-norm clip."""
    cfg = BertConfig(**TINY, attn_layout=layout)
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 5
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        if full:
            from paddle_tpu_torch.contrib import mixed_precision

            loss = build_bert_pretrain(cfg, B, S, mlm_only=False, max_preds=None)["loss"]
            opt = tfluid.optimizer.Lamb(1e-3, lamb_weight_decay=0.01,
                                        grad_clip=tfluid.clip.GradientClipByGlobalNorm(1.0))
            mixed_precision.decorate(opt, use_dynamic_loss_scaling=True).minimize(loss)
        else:
            loss = build_bert_pretrain(cfg, B, S, mlm_only=True, max_preds=P)["loss"]
            tfluid.optimizer.Adam(1e-3).minimize(loss)
    rs = np.random.RandomState(1)
    feed = {
        "src_ids": rs.randint(0, cfg.vocab_size, (B, S)).astype("int64"),
        "sent_ids": rs.randint(0, 2, (B, S)).astype("int64"),
        "pos_ids": np.tile(np.arange(S), (B, 1)).astype("int64"),
        "input_mask": (np.arange(S)[None, :] < rs.randint(S // 2, S + 1, (B, 1)))
        .astype("float32"),
    }
    if full:
        feed.update(mask_label=rs.randint(0, cfg.vocab_size, (B, S)).astype("int64"),
                    mask_weight=(rs.rand(B, S) < 0.15).astype("float32"),
                    nsp_label=rs.randint(0, 2, (B, 1)).astype("int64"))
    else:
        feed.update(mask_label=rs.randint(0, cfg.vocab_size, (B, P)).astype("int64"),
                    mask_weight=np.ones((B, P), "float32"),
                    mask_pos=np.stack([rs.choice(S, P, replace=False)
                                       for _ in range(B)]).astype("int64"))
    return main, startup, loss, feed


PROGRAMS = {
    "fc_dropout": lambda: _fc_dropout(tfluid) + (FC_FEED,),
    "bert_bshd": lambda: _bert("bshd"),
    "bert_bhsd": lambda: _bert("bhsd"),
    "bert_full_amp_lamb": lambda: _bert("bhsd", full=True),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_run_repeated_bit_equal_to_runs(name):
    """Two runs from one state: 4 run() calls; and 1 run() + run_repeated(2)
    + run_repeated(1) (a second call of the cached static step). Every
    loss, every persistable and the seed counter bit-equal."""
    main, startup, loss, feed = PROGRAMS[name]()
    exe0, scope0 = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe0.run(startup, scope=scope0)
    state0 = _persistables(main, scope0)
    arms = []
    for repeated in (False, True):
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe._seed_counter = exe0._seed_counter
        tfluid.io.set_persistables_from_numpy(scope, state0, exe.device)
        if repeated:
            losses = [exe.run(main, feed=dict(feed), fetch_list=[loss], scope=scope)[0]]
            for steps in (2, 1):
                (stacked,) = exe.run_repeated(main, feed=dict(feed), fetch_list=[loss],
                                              steps=steps, scope=scope)
                assert stacked.shape == (steps,) + losses[0].shape
                losses += list(stacked)
            step = exe.last_static_step
            kinds = {spec[0] for spec in step.slots.specs}
            assert step.graph is None  # the CPU re-runs the lowering
            if name.startswith("bert"):
                assert kinds == {"attn", "dropout"}, kinds
                # one attention slot a layer; the dropouts' slots shared by
                # each forward and its grad
                assert sum(spec[0] == "attn" for spec in step.slots.specs) == 2
        else:
            losses = [exe.run(main, feed=dict(feed), fetch_list=[loss], scope=scope)[0]
                      for _ in range(4)]
        arms.append((np.stack(losses), _persistables(main, scope), exe._seed_counter))
    (l0, s0, c0), (l1, s1, c1) = arms
    assert np.array_equal(l0, l1), (l0, l1)
    assert c0 == c1
    assert sorted(s0) == sorted(s1)
    for n in s0:
        assert np.array_equal(s0[n], s1[n]), n
    assert len(set(l0.reshape(-1).tolist())) > 1  # the steps trained


def test_seed_slots_draw_the_walks_words():
    """The slot words of a run key are the walk's host seeds: the
    attention kernels' int32 seed (with a mesh shift) and the dropout
    op's murmur word; an unknown draw after freeze raises."""
    from paddle_tpu_torch.ops import prng
    from paddle_tpu_torch.ops.registry import LoweringContext, SeedSlots, int32_words

    run_key = prng.fold_in(prng.key(42), 3)
    walk = LoweringContext(rng_key=run_key)
    slots = SeedSlots("cpu", run_key)
    static = LoweringContext()
    static.seed_slots = slots
    shift = 3 * 0xC2B2AE35
    draws = [("attn", "att_out", shift), ("dropout", "drop_out", 0)]
    first = [static.attention_seed("att_out", shift), static.dropout_seed("drop_out")]
    assert [int(t) & 0xFFFFFFFF for t in first] == [
        walk.attention_seed("att_out", shift), walk.dropout_seed("drop_out")]
    slots.freeze()
    slots.table.copy_(torch.tensor(int32_words(slots.words(run_key)), dtype=torch.int32))
    again = [static.attention_seed("att_out", shift), static.dropout_seed("drop_out")]
    assert [int(a) & 0xFFFFFFFF for a in again] == [int(t) & 0xFFFFFFFF for t in first]
    assert [s[0] for s in slots.specs] == [d[0] for d in draws]
    with pytest.raises(RuntimeError, match="did not make"):
        static.dropout_seed("other")
    with pytest.raises(RuntimeError, match="host key"):
        static.rng_for("att_out")


# -- the errors ------------------------------------------------------------------------


def test_run_repeated_errors(monkeypatch):
    main, startup, loss = _fc_dropout(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with pytest.raises(RuntimeError, match="startup program"):
        exe.run_repeated(main, feed=dict(FC_FEED), fetch_list=[loss], steps=2, scope=scope)
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="steps must be >= 1"):
        exe.run_repeated(main, feed=dict(FC_FEED), fetch_list=[loss], steps=0, scope=scope)
    monkeypatch.setenv("PADDLE_TPU_CHECK_NAN_INF", "1")
    with pytest.raises(RuntimeError, match="PADDLE_TPU_CHECK_NAN_INF"):
        exe.run_repeated(main, feed=dict(FC_FEED), fetch_list=[loss], steps=2, scope=scope)
    monkeypatch.delenv("PADDLE_TPU_CHECK_NAN_INF")
    assert exe._seed_counter == 1  # nothing ran
    # a main program that draws from the run's torch.Generator
    gmain, gstartup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(gmain, gstartup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [8, 4], append_batch_size=False)
        noise = gmain.global_block().create_var(name="noise", shape=(8, 4), dtype="float32")
        gmain.global_block().append_op(type="uniform_random", outputs={"Out": [noise]},
                                       attrs={"shape": [8, 4], "min": -1.0, "max": 1.0})
        out = tfluid.layers.elementwise_add(x, noise)
    gexe = tfluid.Executor(tfluid.CPUPlace())
    gexe.run(gmain, feed=dict(FC_FEED), fetch_list=[out], scope=tfluid.Scope())  # the walk
    with pytest.raises(RuntimeError, match="'uniform_random' draws from a torch.Generator"):
        gexe.run_repeated(gmain, feed=dict(FC_FEED), fetch_list=[out], steps=2,
                          scope=tfluid.Scope())
    assert gexe._seed_counter == 1


def test_cache_close_and_no_program_cache():
    main, startup, loss = _fc_dropout(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run_repeated(main, feed=dict(FC_FEED), fetch_list=[loss], steps=2, scope=scope)
    first = exe.last_static_step
    exe.run_repeated(main, feed=dict(FC_FEED), fetch_list=[loss], steps=2, scope=scope)
    assert exe.last_static_step is first and len(exe._static_steps) == 1
    # the scope holds the step's own state tensors
    assert all(scope.get(n) is t for n, t in first.state.items())
    exe.run_repeated(main, feed=dict(FC_FEED), fetch_list=[loss], steps=1, scope=scope,
                     use_program_cache=False)
    assert exe.last_static_step is not first and len(exe._static_steps) == 0
    exe.close()
    assert not exe._static_steps and exe.last_static_step is None


# -- the checkpoint window ------------------------------------------------------------


def _mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8, 4], append_batch_size=False)
        loss = fluid.layers.reduce_mean(fluid.layers.square(fluid.layers.fc(x, 8)))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_checkpoint_window_matches_jax(tmp_path):
    """tests/test_resilience.py:237-252's rule in both packages: a window of
    5 at save_interval 2 leaves one snapshot, of the final state, labelled
    4, and _auto_step 5."""
    import paddle_tpu as jfluid
    from paddle_tpu.resilience import CheckpointManager as JManager
    from paddle_tpu.resilience.snapshot import list_snapshots as j_list

    results = {}
    for tag, fluid, manager, lister in (("jax", jfluid, JManager, j_list),
                                        ("torch", tfluid, resilience.CheckpointManager,
                                         list_snapshots)):
        main, startup, loss = _mlp(fluid)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        if tag == "jax":
            with fluid.scope_guard(scope):
                exe.run(startup)
                state0 = _persistables(main, scope)
        else:
            exe.run(startup, scope=scope)
            fluid.io.set_persistables_from_numpy(scope, state0, exe.device)
        root = str(tmp_path / tag)
        mgr = manager(root, save_interval=2, keep=10, async_save=False)
        mgr.attach(main)
        kw = {} if tag == "jax" else {"scope": scope}
        if tag == "jax":
            with fluid.scope_guard(scope):
                exe.run_repeated(main, feed=dict(FC_FEED), fetch_list=[loss], steps=5)
        else:
            exe.run_repeated(main, feed=dict(FC_FEED), fetch_list=[loss], steps=5, **kw)
        snaps = lister(root)
        arrays, _ = load_snapshot(snaps[-1][1])
        results[tag] = ([s for s, _ in snaps], mgr._auto_step, arrays,
                        _persistables(main, scope))
    j_steps, j_auto, j_arrays, _ = results["jax"]
    t_steps, t_auto, t_arrays, t_state = results["torch"]
    assert t_steps == j_steps == [4] and t_auto == j_auto == 5
    assert sorted(t_arrays) == sorted(j_arrays)
    for n in j_arrays:
        np.testing.assert_allclose(t_arrays[n], j_arrays[n], atol=STATE_ATOL, rtol=0,
                                   err_msg=n)
        np.testing.assert_array_equal(t_arrays[n], t_state[n])  # the final state


# -- the mesh on 2 gloo ranks -----------------------------------------------------------


def test_run_repeated_two_ranks_match_the_jax_batch2_mesh(launched):
    import test_torch_data_parallel as dp

    refs, ranks, _ = launched
    j_losses, j_preds, j_state = refs["repeated"]
    for rep, arrays in ranks:
        got = arrays["repeated"]
        assert rep["repeated"]["mesh"] == {"batch": 2, "model": 1, "pipe": 1}
        assert rep["repeated"]["seed_counter"] == 1 + dp.STEPS
        np.testing.assert_allclose(got["losses"].reshape(j_losses.shape), j_losses,
                                   rtol=dp.RTOL, atol=dp.ATOL)
        assert got["preds"].shape == j_preds.shape == (dp.STEPS, dp.BATCH, 1)
        np.testing.assert_allclose(got["preds"], j_preds, rtol=dp.RTOL, atol=dp.ATOL)
        for n, ref in j_state.items():
            np.testing.assert_allclose(got["state/" + n], ref, rtol=dp.RTOL, atol=dp.ATOL,
                                       err_msg=n)
        # the same window as run() calls on the rank, bit for bit
        assert rep["repeated"]["bitwise_to_runs"]



# -- on the card --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu --noconftest "
                    "tests/test_torch_run_repeated.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# kernel, layout, b h sq sk d, causal, dtype
SEED_CASES = [
    ("mha_short_fwd", "bshd", (2, 4, 128, 128, 64), False, torch.float32),  # 1
    ("mha_short_fwd", "bhsd", (2, 4, 128, 128, 64), False, torch.bfloat16),  # 2
    ("flash_fwd", "bhsd", (1, 2, 600, 600, 64), True, torch.float32),  # 3
    ("flash_bwd", "bhsd", (1, 2, 600, 600, 64), True, torch.float32),  # 4, 5
    ("mha_short_bwd", "bhsd", (2, 4, 128, 128, 64), False, torch.bfloat16),  # 6
    ("mha_short_bwd", "bshd", (2, 4, 100, 77, 64), True, torch.float32),  # 7
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SEED_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[4]}")
def test_pointer_seed_launch_equals_by_value(case, cuda_device):
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        attention_delta, flash_attention, flash_attention_bwd)
    from paddle_tpu_torch.ops.kernels.mha_short import short_attention, short_attention_bwd

    name, layout, (b, h, sq, sk, d), causal, dtype = case
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    qs = (b, sq, h, d) if layout == "bshd" else (b, h, sq, d)
    ks = (b, sk, h, d) if layout == "bshd" else (b, h, sk, d)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(dtype)
               for s in (qs, ks, ks))
    dout = (0.25 * torch.randn(qs, generator=gen, device=cuda_device)).to(dtype)
    fwd, bwd = ((short_attention, short_attention_bwd) if name.startswith("mha_short")
                else (flash_attention, flash_attention_bwd))
    word = 0xDEADBEEF
    slot = torch.tensor(word - (1 << 32), dtype=torch.int32, device=cuda_device)
    kw = dict(causal=causal, dropout=0.1, layout=layout)

    def launch(seed):
        out, lse = fwd(q, k, v, seed=seed, **kw)
        if name.endswith("fwd"):
            return out, lse
        return bwd(q, k, v, None, dout, lse, attention_delta(out, dout, layout), seed=seed,
                   **kw)

    by_value, by_pointer = launch(word), launch(slot)
    torch.cuda.synchronize()
    for a, c in zip(by_value, by_pointer):
        assert torch.equal(a, c)
    # a captured launch reads the word written before each replay
    static = torch.zeros((), dtype=torch.int32, device=cuda_device)
    launch(static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = launch(static)
    for w in (word, 12345):
        static.fill_(w - (1 << 32) if w >= 1 << 31 else w)
        graph.replay()
        torch.cuda.synchronize()
        for a, c in zip(launch(w), captured):
            assert torch.equal(a, c), w
