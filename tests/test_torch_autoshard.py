"""The port's autoshard planner (paddle_tpu_torch/autoshard/,
analysis/) against the JAX package's, device-free: tests/test_autoshard.py's
planner tests on Programs the port builds (BERT-tiny MLM, s 32, 4 masked
positions, Adam: the JAX package's bench "bert"; BERT-base pretraining at
b 8, s 128), with the JAX package's TPU v5e topology passed explicitly
(its defaults; the port's are an H100 node's). For the same Program and
topology both packages choose the same plan: the mesh shape and the spec
manifests equal, the costs within 1e-9 relative.

The pass tests: the cache-signature flip and the no-op without a mesh here;
bit-equal fetches with the pass on and off, with the Adam moments planned,
on a 2-rank gloo mesh in tests/test_torch_tensor_parallel.py
(`test_autoshard_pass_bitwise_equal_and_plans_moments`).
"""

import json
import os

import pytest

from paddle_tpu_torch import analysis
from paddle_tpu_torch.autoshard import (
    CostModel,
    PlanError,
    Topology,
    hand_config_specs,
    mesh_shape_candidates,
    plan_program,
)
from paddle_tpu_torch.autoshard.__main__ import build_program
from paddle_tpu_torch.autoshard.cost_table import param_groups, state_var_names

V5E = dict(hbm_gb_per_chip=16.0, ici_gbps=400.0, dcn_gbps=25.0, ici_domain=0)


def v5e(chips, **kw):
    return Topology(chips=chips, **{**V5E, **kw})


def jax_v5e(chips, **kw):
    from paddle_tpu.autoshard import Topology as JT

    return JT(chips=chips, **{**V5E, **kw})


@pytest.fixture(scope="module")
def bert_program():
    return build_program("bert")


@pytest.fixture(scope="module")
def jax_bert_program():
    from tools.verify_bench_programs import build_bench_program

    return build_bench_program("bert")


@pytest.fixture(scope="module")
def bert_annotated(bert_program):
    program, feeds = bert_program
    result = analysis.infer_program(program, feeds=feeds)
    names = state_var_names(program)
    groups = param_groups(program.global_block(), names, result.env)
    return program, feeds, result, names, groups


def assert_same_plan(plan, jplan):
    a, b = plan.to_dict(), jplan.to_dict()
    assert a["mesh"] == b["mesh"] and a["world"] == b["world"]
    assert a["specs"] == b["specs"] and a["choices"] == b["choices"]
    assert a["config"] == b["config"]
    for k in ("hbm_per_device_mb", "hbm_replicated_mb", "collective_bytes",
              "bubble_fraction", "compute_fraction", "score"):
        x, y = getattr(plan.cost, k), getattr(jplan.cost, k)
        assert x == pytest.approx(y, rel=1e-9, abs=0), k
    assert plan.cost.feasible == jplan.cost.feasible


# ---------------------------------------------------------------------------
# the dryrun-grid acceptance gate, and equality with the JAX planner
# ---------------------------------------------------------------------------


def test_planner_matches_or_beats_every_hand_config_on_the_grid(bert_annotated,
                                                                 jax_bert_program):
    from paddle_tpu.autoshard import plan_program as jplan

    program, feeds, result, names, groups = bert_annotated
    jprogram, jfeeds = jax_bert_program
    topo = v5e(8)
    model = CostModel(topo)
    configs = hand_config_specs(program, 8)
    tags = [t for t, _, _ in configs]
    assert "replicated_dp" in tags and "zero1_dp8" in tags
    assert "zero_over_pipe4" in tags and "pp4xtp2" in tags
    for tag, axis_sizes, specs in configs:
        hand = model.cost(result.env, names, groups, specs, axis_sizes)
        plan = plan_program(program, topo, feeds=feeds, mesh_shape=axis_sizes,
                            baseline_specs=specs)
        assert plan.cost.dominates(hand), f"{tag}: {plan.cost} vs hand {hand}"
        if specs:
            assert plan.cost.hbm_per_device_mb < hand.hbm_replicated_mb
        assert_same_plan(plan, jplan(jprogram, jax_v5e(8), feeds=jfeeds,
                                     mesh_shape=axis_sizes, baseline_specs=specs))


def test_planner_strictly_beats_replicated_via_zero1(bert_annotated):
    program, feeds, result, names, groups = bert_annotated
    topo = v5e(8)
    model = CostModel(topo)
    axis_sizes = {"batch": 8, "model": 1, "pipe": 1}
    hand = model.cost(result.env, names, groups, {}, axis_sizes)
    plan = plan_program(program, topo, feeds=feeds, mesh_shape=axis_sizes, baseline_specs={})
    assert plan.cost.hbm_per_device_mb < hand.hbm_per_device_mb * 0.6
    assert plan.cost.collective_bytes == hand.collective_bytes
    assert any(t == "zero1" for t in plan.choices.values())


def test_free_choice_selects_zero1_on_dp_mesh_as_jax(bert_program, jax_bert_program):
    from paddle_tpu.autoshard import plan_program as jplan

    program, feeds = bert_program
    plan = plan_program(program, v5e(8), feeds=feeds)
    assert plan.axis_sizes == {"batch": 8, "model": 1, "pipe": 1}
    assert any(t == "zero1" for t in plan.choices.values())
    assert plan.cost.feasible
    jprogram, jfeeds = jax_bert_program
    assert_same_plan(plan, jplan(jprogram, jax_v5e(8), feeds=jfeeds))


def test_selects_zero1_over_replicated_at_bert_base_scale_as_jax():
    """BERT-base's replicated state (params and two Adam moments, 1321 MB)
    must come back ZeRO-sharded, as the JAX planner places it: on 8
    devices the moments but the tied word embedding's (its grad has two
    readers) shard, 715 MB a device."""
    from paddle_tpu import framework as jframework
    from paddle_tpu import optimizer as joptimizer
    from paddle_tpu.autoshard import plan_program as jplan
    from paddle_tpu.models.bert import BertConfig, build_bert_pretrain

    program, feeds = build_program("bert-base")
    plan = plan_program(program, v5e(8), feeds=feeds)
    assert any(t in ("zero1", "pipe", "pipe_z") for t in plan.choices.values())
    assert plan.cost.hbm_replicated_mb == pytest.approx(1321.28, abs=0.01)
    assert plan.cost.hbm_per_device_mb < plan.cost.hbm_replicated_mb * 0.6
    jmain, jstartup = jframework.Program(), jframework.Program()
    with jframework.program_guard(jmain, jstartup), jframework.unique_name.guard():
        loss = build_bert_pretrain(BertConfig.base(), 8, 128, max_preds=20)["loss"]
        joptimizer.Adam(1e-3).minimize(loss)
    assert_same_plan(plan, jplan(jmain, jax_v5e(8), feeds=feeds))


# ---------------------------------------------------------------------------
# cost model / topology tiers
# ---------------------------------------------------------------------------


def test_axis_tier_weights_cross_domain_axis_pays_the_slow_tier():
    topo = Topology(chips=8, ici_gbps=400.0, dcn_gbps=25.0, ici_domain=4)
    w = topo.axis_tier_weights({"batch": 2, "model": 1, "pipe": 4})
    assert w["pipe"] == 1.0
    assert w["batch"] == pytest.approx(16.0)
    w2 = Topology.single_slice(8).axis_tier_weights({"batch": 2, "model": 1, "pipe": 4})
    assert set(w2.values()) == {1.0}
    # the H100 defaults: 80 GB, NVLink 450 GB/s inside a node of 8, 50 GB/s
    # between nodes; a batch axis over 2 nodes pays 9x
    h100 = Topology(chips=16)
    assert (h100.hbm_gb_per_chip, h100.ici_gbps, h100.dcn_gbps, h100.ici_domain) == (
        80.0, 450.0, 50.0, 8)
    assert h100.axis_tier_weights({"batch": 16, "model": 1, "pipe": 1})["batch"] == 9.0
    assert h100.axis_tier_weights({"batch": 2, "model": 8, "pipe": 1})["model"] == 1.0
    assert Topology.from_spec("chips=4,hbm_gb=16").to_dict() == {
        "chips": 4, "hbm_gb_per_chip": 16.0, "ici_gbps": 450.0, "dcn_gbps": 50.0,
        "ici_domain": 8}


def test_topology_env_keys_read_as_in_jax(monkeypatch, tmp_path):
    from paddle_tpu.autoshard import Topology as JT

    spec = {"chips": 8, "hbm_gb": 16, "ici_gbps": 400, "dcn_gbps": 25, "ici_domain": 4}
    path = tmp_path / "topo.json"
    path.write_text(json.dumps(spec))
    monkeypatch.setenv("PADDLE_TPU_TOPOLOGY", str(path))
    assert Topology.from_env().to_dict() == JT.from_env().to_dict()


def test_tier_weighting_steers_the_search(bert_annotated):
    program, feeds, result, names, groups = bert_annotated
    flat = plan_program(program, v5e(8), feeds=feeds)
    slow = v5e(8, ici_domain=1)
    tiered = plan_program(program, slow, feeds=feeds)
    assert flat.axis_sizes["batch"] == 8
    flat_coll_tiered = CostModel(slow).collective_bytes(groups, flat.specs, flat.axis_sizes)
    assert tiered.cost.collective_bytes <= flat_coll_tiered


def test_infeasible_when_state_busts_hbm(bert_annotated):
    program, feeds, result, names, groups = bert_annotated
    tiny = Topology(chips=1, hbm_gb_per_chip=0.1 / 650)
    with pytest.raises(PlanError):
        plan_program(program, tiny, feeds=feeds, world=1)


def test_bubble_fraction_and_compute_fraction():
    assert CostModel.bubble_fraction({"pipe": 4}, 4) == pytest.approx(3 / 7)
    assert CostModel.bubble_fraction({"pipe": 1}, 8) == 0.0
    assert CostModel.compute_fraction({"batch": 4, "model": 2, "pipe": 1}, False) == 0.25
    assert CostModel.compute_fraction({"batch": 2, "model": 2, "pipe": 2}, True) == 0.25
    assert CostModel.compute_fraction({"batch": 1, "model": 8, "pipe": 1}, False) == 1.0


def test_mesh_shape_candidates_cover_factorizations():
    from paddle_tpu.autoshard import mesh_shape_candidates as jcand

    shapes = mesh_shape_candidates(8)
    assert {"batch": 8, "model": 1, "pipe": 1} in shapes
    assert {"batch": 1, "model": 2, "pipe": 4} in shapes
    for s in shapes:
        assert s["batch"] * s["model"] * s["pipe"] == 8
    assert shapes[0] == {"batch": 8, "model": 1, "pipe": 1}
    assert shapes == jcand(8)


def test_plan_refuses_unknown_shape_state_var():
    """A persistable whose shape is unknown (declared with an unknown dim;
    the port has no shape-function library to compute one) is refused by
    name, never costed as zero bytes."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import framework, layers

    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        x = layers.data("x", shape=[4, 6], dtype="float32")
        w = main.global_block().create_var(name="mystery_state", shape=[-1, 6],
                                           dtype="float32", persistable=True)
        main.global_block().append_op(type="assign", inputs={"X": [x.name]},
                                      outputs={"Out": [w.name]}, attrs={})
    assert fluid is not None
    with pytest.raises(PlanError) as ei:
        plan_program(main, v5e(8), feeds={"x": ((2, 4, 6), "float32")})
    assert "mystery_state" in str(ei.value) and "shape" in str(ei.value)


def test_analysis_seeds_persistables_and_poisons_the_rest(bert_program):
    program, feeds = bert_program
    result = analysis.infer_program(program, feeds=feeds)
    w = program.global_block().var("bert.layer0.attn.q.w_0")
    assert result.env[w.name] == analysis.VarMeta(tuple(w.shape), "float32")
    # no shape-function library yet: ops are missing, their outputs unknown
    assert result.missing and result.coverage() < 1.0
    some_out = next(n for op in program.global_block().ops if op.type == "mul"
                    for n in op.output("Out"))
    assert result.env[some_out] == analysis.VarMeta(None, None)
    assert analysis.check_sharding(program, mesh={"batch": 1, "model": 2, "pipe": 1}) == []
    bad = analysis.check_sharding(program, mesh={"batch": 1, "model": 3, "pipe": 1})
    assert bad and all(f.code == "sharding-indivisible" for f in bad)


# ---------------------------------------------------------------------------
# shrink-world sweep, the plan table the supervisor reads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base_world", [8, 12])
def test_every_shrink_world_yields_valid_plan_as_jax(bert_program, jax_bert_program,
                                                      base_world):
    from paddle_tpu.autoshard import plan_program as jplan

    from paddle_tpu_torch.parallel.mesh import smaller_mesh_shapes

    program, feeds = bert_program
    jprogram, jfeeds = jax_bert_program
    worlds = smaller_mesh_shapes(base_world)
    assert worlds
    result = analysis.infer_program(program, feeds=feeds)
    for w in worlds:
        plan = plan_program(program, v5e(w), feeds=feeds, world=w)
        b, m, p = (plan.axis_sizes[a] for a in ("batch", "model", "pipe"))
        assert b * m * p == w and plan.cost.feasible
        assert analysis.check_sharding(program, mesh=plan.axis_sizes, specs={},
                                       extra_specs=plan.specs, env=result) == []
        assert_same_plan(plan, jplan(jprogram, jax_v5e(w), feeds=jfeeds, world=w))


def test_cli_plan_table_drives_the_supervisor(tmp_path):
    from paddle_tpu_torch.autoshard.__main__ import main
    from paddle_tpu_torch.autoshard.elastic import PLACEMENT_ENV, load_plan_table
    from paddle_tpu_torch.resilience.trainer_fleet import TrainSupervisor

    out = tmp_path / "plans.json"
    assert main(["--program", "bert", "--worlds", "8,4,2,1", "--out", str(out)]) == 0
    table = load_plan_table(str(out))
    assert sorted(table) == [1, 2, 4, 8]
    assert json.loads(out.read_text())["topology"]["ici_gbps"] == 450.0
    sup = TrainSupervisor(["true"], nproc_per_node=1, elastic_world=8, allow_shrink=True,
                          plan_table=str(out))
    try:
        w, plan = sup._next_world()
        assert w in (4, 2, 1) and plan["world"] == w
        sup._shrink_to(w, "test", plan=plan)
        env = sup._per_rank_env(0)(0)
        assert json.loads(env[PLACEMENT_ENV])["config"] == plan["config"]
    finally:
        sup.close()


def test_cli_gate_and_explain(capsys):
    from paddle_tpu_torch.autoshard.__main__ import main

    assert main(["--program", "bert", "--explain", "--topology",
                 "chips=8,hbm_gb=16,ici_gbps=400,dcn_gbps=25,ici_domain=0"]) == 0
    text = capsys.readouterr().out
    assert '"config": "dp8xtp1xpp1+zero1"' in text
    assert main(["--gate", "--topology",
                 "chips=8,hbm_gb=16,ici_gbps=400,dcn_gbps=25,ici_domain=0"]) == 0
    assert "autoshard gate OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------


def test_autoshard_flip_changes_cache_signature(monkeypatch):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.passes import cache_signature, resolve_pass_names

    monkeypatch.delenv("PADDLE_TPU_AUTOSHARD", raising=False)
    assert "shard_propagation" not in resolve_pass_names(None)
    base_sig = cache_signature(None)
    monkeypatch.setenv("PADDLE_TPU_AUTOSHARD", "1")
    assert "shard_propagation" in resolve_pass_names(None)
    assert cache_signature(None) != base_sig
    assert resolve_pass_names(None)[-1] == "shard_propagation"
    monkeypatch.setenv("PADDLE_TPU_AUTOSHARD", "0")
    assert "shard_propagation" not in resolve_pass_names(None)
    bs = fluid.BuildStrategy()
    bs.auto_shard = True
    assert "shard_propagation" not in resolve_pass_names(bs)  # the env wins
    monkeypatch.delenv("PADDLE_TPU_AUTOSHARD", raising=False)
    assert "shard_propagation" in resolve_pass_names(bs)
    assert cache_signature(bs) != base_sig


def test_pass_is_noop_without_mesh_or_on_one_device(monkeypatch):
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.parallel.mesh import Mesh
    from paddle_tpu_torch.passes import PassContext
    from paddle_tpu_torch.passes.shard_propagation import shard_propagation_pass

    monkeypatch.setenv("PADDLE_TPU_AUTOSHARD", "1")
    for mesh in (None, Mesh()):
        prog = framework.Program()
        ctx = PassContext(mesh=mesh)
        assert shard_propagation_pass(prog, prog.global_block(), (), (), ctx) == 0
        assert not hasattr(prog, "_autoshard_specs")
        assert ctx.mutated is False


def test_planner_failure_warns_once_and_keeps_the_manual_placement(monkeypatch, capsys):
    from paddle_tpu_torch import framework, layers
    from paddle_tpu_torch.parallel.mesh import Mesh
    from paddle_tpu_torch.passes import PassContext
    from paddle_tpu_torch.passes.shard_propagation import shard_propagation_pass

    monkeypatch.setenv("PADDLE_TPU_AUTOSHARD", "1")
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        x = layers.data("x", shape=[4, 6], dtype="float32")
        w = main.global_block().create_var(name="unsized_state", shape=[-1, 6],
                                           dtype="float32", persistable=True)
        main.global_block().append_op(type="assign", inputs={"X": [x.name]},
                                      outputs={"Out": [w.name]}, attrs={})
    for _ in range(2):
        ctx = PassContext(mesh=Mesh(batch=2))
        assert shard_propagation_pass(main, main.global_block(), (), (), ctx) == 0
        assert not hasattr(main, "_autoshard_specs")
    err = capsys.readouterr().err
    assert err.count("shard_propagation: planner declined") == 1
    assert "unsized_state" in err
    assert os.environ["PADDLE_TPU_AUTOSHARD"] == "1"


def test_mesh_run_hands_the_global_feed_signature_to_the_passes(monkeypatch):
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import executor as texe
    from paddle_tpu_torch.parallel.mesh import Mesh

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1], dtype="int64")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            fluid.layers.fc(x, 8, act="softmax"), y))
    feed = {"x": np.zeros((4, 16), "float32"), "y": np.zeros((4, 1), "int32")}
    # the declared dtype wins over the fed value's, as the JAX executor casts
    local = texe.feed_signature(main, feed)
    assert local == (("x", (4, 16), "float32"), ("y", (4, 1), "int64"))

    class Seen(Exception):
        pass

    def passes(program, feed_names, fetch_names, **kw):
        raise Seen(feed_names, kw["feed_sig"], kw["mesh"])

    monkeypatch.setattr(texe, "apply_program_passes", passes)
    mesh = Mesh(batch=2, model=2)
    with pytest.raises(Seen) as e:
        fluid.Executor(fluid.CPUPlace())._prepare_mesh(main, mesh, local, [loss.name],
                                                      fluid.Scope())
    names, feed_sig, got_mesh = e.value.args
    # each rank feeds its batch coordinate's rows: the planner sees the
    # global batch, the JAX executor's feed signature
    assert names == ("x", "y") and got_mesh is mesh
    assert feed_sig == (("x", (8, 16), "float32"), ("y", (8, 1), "int64"))
