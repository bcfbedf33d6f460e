"""The autoshard planner's command line (the counterpart of the JAX
package's `tools/autoshard_plan.py`): plan placements device-free,
compare them with the hand-written configs, and write plan tables for
the TrainSupervisor's shrink policy.

    python -m paddle_tpu_torch.autoshard                          # plan every program
    python -m paddle_tpu_torch.autoshard --program bert --explain # the plan as JSON
    python -m paddle_tpu_torch.autoshard --gate                   # acceptance gate
    python -m paddle_tpu_torch.autoshard --worlds 8,4,2,1 --out plans.json

Programs are built and analysed (analysis.infer_program), never run; no
device is touched and no CUDA context is created. `--topology` takes a
Topology spec or JSON file (default: PADDLE_TPU_TOPOLOGY, else H100 nodes
of 8 GPUs over `--world` GPUs). `--worlds` writes the table
`TrainSupervisor(plan_table=)` reads.

--gate checks:
  * per hand-written config (replicated dp / ZeRO-1 dp / ZeRO over pipe /
    pp4xtp2), the planner pinned to that mesh shape matches or beats the
    hand specs on both per-device state MB and tier-weighted collective
    bytes;
  * the free-choice planner returns a feasible, checker-clean plan for
    every program;
  * at BERT-base width the free choice selects a ZeRO-style sharded
    placement over replicated, under 0.6 of the replicated footprint (the
    tied word embedding's moments stay whole: its grad has two readers).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

PROGRAMS = ("bert", "transformer", "bert-base")


def build_program(name, batch=4):
    """(main program, feed metas) of a training Program: "bert" (BERT-tiny
    MLM, s 32, 4 masked positions), "transformer" (Transformer-tiny) or
    "bert-base" (BERT-base pretraining at b 8, s 128, both heads, 20
    masked positions), each minimized with Adam."""
    from .. import framework, optimizer, unique_name

    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup), unique_name.guard():
        if name == "bert":
            from ..models.bert import BertConfig, build_bert_pretrain

            loss = build_bert_pretrain(BertConfig.tiny(), batch, 32, mlm_only=True,
                                       max_preds=4)["loss"]
        elif name == "bert-base":
            from ..models.bert import BertConfig, build_bert_pretrain

            batch = 8
            loss = build_bert_pretrain(BertConfig.base(), batch, 128, max_preds=20)["loss"]
        elif name == "transformer":
            from ..models.transformer import TransformerConfig, build_transformer

            loss = build_transformer(TransformerConfig.tiny(), batch, 16, 16)["loss"]
        else:
            raise ValueError(f"unknown program {name!r}: one of {PROGRAMS}")
        optimizer.Adam(1e-3).minimize(loss)
    feeds = {}
    for blk in main.blocks:
        for v in blk.vars.values():
            if getattr(v, "is_data", False):
                feeds[v.name] = (tuple(batch if (d is None or d < 0) else d
                                       for d in v.shape), v.dtype)
    return main, feeds


def compare_against_hand_configs(name, world, topology, verbose=True):
    """Per hand config: plan at the pinned shape with the hand specs as
    baseline -> (all dominate, [(tag, hand cost, plan, dominates)])."""
    from .. import analysis
    from . import CostModel, hand_config_specs, plan_program
    from .cost_table import param_groups, state_var_names

    program, feeds = build_program(name)
    result = analysis.infer_program(program, feeds=feeds)
    state_names = state_var_names(program)
    groups = param_groups(program.global_block(), state_names, result.env)
    model = CostModel(topology)
    micro = int(getattr(program, "_pipeline_microbatches", 1) or 1)
    rows, ok = [], True
    for tag, axis_sizes, specs in hand_config_specs(program, world):
        hand = model.cost(result.env, state_names, groups, specs, axis_sizes, micro=micro,
                          runs_pipe_schedule=micro > 1 and axis_sizes["pipe"] > 1)
        plan = plan_program(program, topology, feeds=feeds, mesh_shape=axis_sizes,
                            baseline_specs=specs)
        dom = plan.cost.dominates(hand)
        ok = ok and dom
        rows.append((tag, hand, plan, dom))
        if verbose:
            print(f"  {tag:18s} hand: hbm={hand.hbm_per_device_mb:10.3f}MB "
                  f"coll={hand.collective_bytes:14.0f}B | planner[{plan.config_tag}]: "
                  f"hbm={plan.cost.hbm_per_device_mb:10.3f}MB "
                  f"coll={plan.cost.collective_bytes:14.0f}B "
                  f"{'MATCH-OR-BEAT' if dom else '** WORSE **'}")
    return ok, rows


def gate(topology, world=8):
    """The acceptance gate, device-free -> exit code."""
    from . import plan_program

    rc = 0
    t0 = time.time()
    for name in PROGRAMS:
        t1 = time.time()
        program, feeds = build_program(name)
        plan = plan_program(program, topology, feeds=feeds, world=world)
        line = (f"{name}: plan {plan.config_tag} hbm={plan.cost.hbm_per_device_mb:.2f}MB/dev "
                f"coll={plan.cost.collective_bytes:.0f}B specs={len(plan.specs)} "
                f"({time.time() - t1:.1f}s)")
        if not plan.cost.feasible:
            rc = 1
            line += "  ** INFEASIBLE"
        print(line, flush=True)
        if name == "bert-base":
            zero_style = any(t in ("zero1", "pipe", "pipe_z") for t in plan.choices.values())
            if not zero_style or not (plan.cost.hbm_per_device_mb
                                      < 0.6 * plan.cost.hbm_replicated_mb):
                rc = 1
                print("  ** FAIL: expected a ZeRO-style placement well under the "
                      "replicated footprint", file=sys.stderr)
    print(f"grid comparison (world={world}):")
    ok, _ = compare_against_hand_configs("bert", world, topology)
    rc = rc or (0 if ok else 1)
    print(f"autoshard gate {'FAIL' if rc else 'OK'} ({time.time() - t0:.1f}s)")
    return rc


def plan_table(program, feeds, topology, worlds, name="program"):
    """{"program", "topology", "plans": {world: Plan.to_dict()}}: the
    table TrainSupervisor(plan_table=) reads."""
    from . import plan_program

    table = {"program": name, "topology": topology.to_dict(), "plans": {}}
    for w in worlds:
        plan = plan_program(program, topology._replace(chips=w), feeds=feeds, world=w)
        table["plans"][str(w)] = plan.to_dict()
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.autoshard",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--program", default=None,
                    help=f"one of {PROGRAMS} (default: all of them)")
    ap.add_argument("--world", type=int, default=8)
    ap.add_argument("--topology", default=None,
                    help="Topology spec or JSON (default: PADDLE_TPU_TOPOLOGY, else H100 "
                         "nodes over --world GPUs)")
    ap.add_argument("--worlds", default=None,
                    help="comma list: write a plan table (one plan a world) for the "
                         "supervisor's shrink policy")
    ap.add_argument("--out", default=None, help="write the JSON here")
    ap.add_argument("--compare", action="store_true",
                    help="compare the planner with the hand-written configs")
    ap.add_argument("--gate", action="store_true", help="run the acceptance gate")
    ap.add_argument("--explain", action="store_true",
                    help="print the chosen plan as indented JSON")
    args = ap.parse_args(argv)

    from . import Topology, plan_program

    topo = (Topology.from_spec(args.topology) if args.topology
            else Topology.from_env(default_chips=args.world))
    if args.gate:
        return gate(topo, args.world)
    if args.worlds:
        name = args.program or "bert"
        program, feeds = build_program(name)
        worlds = [int(x) for x in args.worlds.split(",") if x.strip()]
        table = plan_table(program, feeds, topo, worlds, name)
        for w in worlds:
            p = table["plans"][str(w)]
            print(f"world {w}: {p['config']} "
                  f"hbm={p['cost']['hbm_state_mb_per_device']:.2f}MB/dev")
        text = json.dumps(table, indent=2)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text + "\n")
            print(f"wrote {args.out}")
        else:
            print(text)
        return 0
    rc = 0
    for name in [args.program] if args.program else list(PROGRAMS):
        program, feeds = build_program(name)
        plan = plan_program(program, topo, feeds=feeds, world=args.world)
        print(f"{name}: {plan!r}")
        if args.explain:
            print(plan.to_json(indent=2))
        if args.compare:
            ok, _ = compare_against_hand_configs(name, args.world, topo)
            rc = rc or (0 if ok else 1)
        if args.out and args.program:
            with open(args.out, "w") as f:
                f.write(plan.to_json(indent=2) + "\n")
            print(f"wrote {args.out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
