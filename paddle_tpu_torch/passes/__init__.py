"""Program IR pass manager: graph rewrites the Executor runs over a clone
of each Program before it walks it (`paddle_tpu/passes/__init__.py`, the
same registry, selection and semantics).

Under the JAX package these passes save trace time; here, where the
Executor issues every op of the Program from Python on each step, every op
a pass removes is host time saved on every step. The passes, in execution
order:

  * const_fold     fold fill_constant / scale / cast / shape chains into
                   one assign_value (passes/const_fold.py)
  * copy_prop      drop pure `assign` renames, backward's single-partial
                   grad accumulation (passes/copy_prop.py)
  * dce            fetch- and state-driven dead-op elimination
                   (passes/dce.py)
  * fuse_conv_bn   inference only: fold an eval BatchNorm into the conv
                   before it, and a relu after it into the conv's
                   `fused_act` (passes/fuse_conv_bn.py)
  * layout_opt     carry NHWC through conv / pool / batch_norm /
                   elementwise regions, forward and backward, with
                   transposes only at the regions' edges; on the card the
                   NHWC tensors are channels_last memory for cuDNN
                   (passes/layout_opt.py)
  * fuse_layer_scan  OPT-IN (PADDLE_TPU_FUSE_LAYER_SCAN=1 or
                   BuildStrategy.fuse_layer_scan): one `layer_scan` op per
                   run of structurally identical layer blocks, forward
                   and backward (passes/fuse_layer_scan.py, lowered by
                   ops/scan_ops.py)
  * fuse_optimizer one fused_<type> op per group of per-parameter
                   sgd / momentum / adam / adamw / lamb ops, lowered
                   multi-tensor on torch._foreach_* (passes/fuse_optimizer.py,
                   ops/optimizer_ops.py)
  * optimizer_overlap  OPT-IN (PADDLE_TPU_OPTIMIZER_OVERLAP=1 or
                   BuildStrategy.optimizer_overlap): split each fused wave
                   by where its members' grads are final
                   (passes/optimizer_overlap.py)
  * shard_propagation  OPT-IN (PADDLE_TPU_AUTOSHARD=1 or
                   BuildStrategy.auto_shard; the variable wins): on a mesh
                   run over more than one device, the autoshard planner's
                   spec assignment attached to the clone as
                   `_autoshard_specs`, which the mesh run places
                   (passes/shard_propagation.py). Resolved last, and part
                   of `cache_signature()` only while enabled.

Selection: BuildStrategy knobs (compiler.py) choose the default set; the
PADDLE_TPU_PASSES environment variable overrides them ("all", "none" / "",
or a comma list of pass names; an unknown name raises). Passes run on a
CLONE of the program: the user's Program is never mutated. Per-pass wall
time and op counts are always-on profiler counters (pass_<name>_us,
pass_<name>_ops_removed, pass_manager_us, program_ops_before / _after).

Not ported with this module: the IR verifier hook (PADDLE_TPU_VERIFY in
the JAX package), which needs the IR verifier of `analysis/verifier.py`
and the static shape functions of `ops/shape_fns.py` (ROADMAP Queue 1,
item 11).
"""

from __future__ import annotations

import os
import weakref

from .. import profiler
from ..framework import Program

__all__ = [
    "register_pass",
    "resolve_pass_names",
    "apply_program_passes",
    "cache_signature",
    "scope_reads_current",
    "PassContext",
    "PASS_REGISTRY",
]

# name -> (fn(program, block, feed_names, fetch_names, ctx) -> int removed,
#          strategy_knob: BuildStrategy attr gating the pass, or None,
#          version: int bumped whenever the pass's output may change for
#          the same input program)
PASS_REGISTRY: dict[str, tuple] = {}
_PASS_ORDER: list[str] = []  # registration order == execution order


class PassContext:
    """Per-application context handed to every pass. `scope` is the
    executor's scope when the caller has one (fuse_conv_bn reads the
    parameter values through it, with `read_scope`); `build_strategy`,
    `mesh` and `feed_sig` ride along for shard_propagation (the planner
    needs the run's mesh shape). Passes tolerate all of them being
    None."""

    def __init__(self, scope=None, build_strategy=None, mesh=None, feed_sig=None):
        self.scope = scope
        self.build_strategy = build_strategy
        self.mesh = mesh
        self.feed_sig = feed_sig
        # set by a pass that changed the program without a net change of
        # its op count (layout_opt may only rewrite attrs), so the manager
        # keeps the rewritten clone
        self.mutated = False
        # name -> (weak reference, version) of each scope value a pass read
        self.scope_reads = {}

    def read_scope(self, name):
        """The scope's value of `name`, recorded: the rewritten program
        carries the record as `_scope_reads`, and `scope_reads_current`
        tells whether the scope still holds those values."""
        value = self.scope.get(name)
        self.scope_reads[name] = (weakref.ref(value), _version(value))
        return value


def _version(value):
    """A tensor's in-place version counter; None for an inference tensor
    (it tracks none, and allows no in-place write outside inference mode)
    or a numpy array."""
    try:
        return value._version
    except (AttributeError, RuntimeError):
        return None


def scope_reads_current(program, scope) -> bool:
    """Whether `scope` still holds, unmodified, every value the passes
    read when they rewrote `program`. A training step writes new tensor
    objects back to the scope, so after it a fold of the old values is
    stale."""
    for name, (ref, version) in getattr(program, "_scope_reads", {}).items():
        value = scope.get(name) if scope.has(name) else None
        if value is None or ref() is not value or _version(value) != version:
            return False
    return True


def register_pass(name: str, strategy_knob: str = None, version: int = 1):
    """Decorator. A pass takes (program, block, feed_names, fetch_names,
    ctx), mutates `block` (of a program clone) in place, and returns the
    number of ops it removed (net; negative for a pass that inserts
    ops)."""

    def deco(fn):
        PASS_REGISTRY[name] = (fn, strategy_knob, int(version))
        _PASS_ORDER.append(name)
        return fn

    return deco


def _opt_in_gates():
    """name -> enabled(build_strategy) for the default-off passes, looked
    up lazily: the gate modules import this package."""
    from .fuse_layer_scan import enabled as _scan_on
    from .optimizer_overlap import enabled as _overlap_on
    from .shard_propagation import autoshard_enabled as _autoshard_on

    return {"fuse_layer_scan": _scan_on, "optimizer_overlap": _overlap_on,
            "shard_propagation": _autoshard_on}


def resolve_pass_names(build_strategy=None) -> tuple:
    """The enabled pass names, in execution order. PADDLE_TPU_PASSES wins
    over the BuildStrategy knobs; with neither, every default pass runs.
    Part of the Executor's pass-cache key, so flipping the variable
    between runs re-runs the passes."""
    env = os.environ.get("PADDLE_TPU_PASSES")
    if env is not None:
        env = env.strip()
        if env in ("", "none", "off", "0"):
            return ()
        if env == "all":
            return tuple(_PASS_ORDER)
        requested = [p.strip() for p in env.split(",") if p.strip()]
        unknown = [p for p in requested if p not in PASS_REGISTRY]
        if unknown:
            raise ValueError(
                f"PADDLE_TPU_PASSES names unknown passes {unknown}; "
                f"registered: {sorted(PASS_REGISTRY)}"
            )
        return tuple(p for p in _PASS_ORDER if p in requested)
    gates = _opt_in_gates()
    enabled = []
    for name in _PASS_ORDER:
        _, knob, _ = PASS_REGISTRY[name]
        gate = gates.get(name)
        if gate is not None:
            # opt-in: off unless its variable or knob turns it on
            if not gate(build_strategy):
                continue
        elif (
            build_strategy is not None
            and knob is not None
            and not getattr(build_strategy, knob, True)
        ):
            continue
        enabled.append(name)
    return tuple(enabled)


def cache_signature(build_strategy=None) -> str:
    """Stable name of the resolved pass configuration: ordered pass
    names, each with its version ("const_fold:1,dce:1"), or "nopass"."""
    names = resolve_pass_names(build_strategy)
    if not names:
        return "nopass"
    return ",".join(f"{n}:{PASS_REGISTRY[n][2]}" for n in names)


# program attrs read after the passes that Program.clone() does not carry
# over (clone covers random_seed / _sharding_specs / _amp_dtype)
_CARRIED_ATTRS = (
    "_recompute_loss",
    "_pipeline_loss",
    "_amp_black_list",
    "_amp_white_list",
)


def _clone_for_passes(program: Program) -> Program:
    p = program.clone()
    for a in _CARRIED_ATTRS:
        if hasattr(program, a):
            setattr(p, a, getattr(program, a))
    return p


def apply_program_passes(
    program: Program,
    feed_names,
    fetch_names,
    build_strategy=None,
    scope=None,
    mesh=None,
    feed_sig=None,
):
    """Run the enabled passes over a clone of `program` (`mesh`: the mesh
    of a CompiledProgram's run, for shard_propagation). Returns
    (program, block, stats): the original objects (stats None) when no
    pass is enabled, or with stats when nothing changed."""
    names = resolve_pass_names(build_strategy)
    if not names:
        return program, program.global_block(), None
    clone = _clone_for_passes(program)
    block = clone.global_block()
    ops_before = len(block.ops)
    stats = {"ops_before": ops_before, "passes": {}}
    total_removed = 0
    ctx = PassContext(scope=scope, build_strategy=build_strategy, mesh=mesh,
                      feed_sig=feed_sig)
    with profiler.time_counter("pass_manager"):
        for name in names:
            fn, _, _ = PASS_REGISTRY[name]
            with profiler.time_counter(f"pass_{name}"):
                removed = fn(
                    clone, block, tuple(feed_names), tuple(fetch_names), ctx
                )
            profiler.bump_counter(f"pass_{name}_ops_removed", removed)
            stats["passes"][name] = removed
            total_removed += removed
    stats["ops_after"] = len(block.ops)
    profiler.bump_counter("program_ops_before", ops_before)
    profiler.bump_counter("program_ops_after", len(block.ops))
    if total_removed == 0 and not ctx.mutated:
        # nothing changed: run the original (identical) program
        return program, program.global_block(), stats
    clone._scope_reads = ctx.scope_reads
    return clone, block, stats


# importing the modules registers the passes, in execution order: fold
# constants first (exposes dead feeder chains), then copy propagation
# (drops backward's grad-accumulation assigns), then DCE, then the
# inference conv+BN fold (removes BN ops before layout assignment sees
# them), then NHWC layout propagation (on the cleaned graph), then the
# opt-in layer scan (the backward run must see the raw per-parameter grad
# producers), then optimizer fusion (on the final op list), then the
# opt-in overlap split of the fused waves; shard_propagation last: it plans
# on the graph the other rewrites produced, and only while autoshard is on
from . import const_fold as _const_fold  # noqa: E402,F401
from . import copy_prop as _copy_prop  # noqa: E402,F401
from . import dce as _dce  # noqa: E402,F401
from . import fuse_conv_bn as _fuse_conv_bn  # noqa: E402,F401
from . import layout_opt as _layout_opt  # noqa: E402,F401
from . import fuse_layer_scan as _fuse_layer_scan  # noqa: E402,F401
from . import fuse_optimizer as _fuse_optimizer  # noqa: E402,F401
from . import optimizer_overlap as _optimizer_overlap  # noqa: E402,F401
from . import shard_propagation as _shard_propagation  # noqa: E402,F401
