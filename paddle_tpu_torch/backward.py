"""append_backward: IR-level reverse-mode autodiff.

The same algorithm as `paddle_tpu/backward.py`, so both packages emit the
same grad ops, names and attrs for one Program: op-path discovery,
per-op grad emission, duplicate-grad accumulation through `assign` / `sum`
of `@PARTIAL` names, and no-grad pruning. Emitted grad ops default to the
generic `__auto_grad__` op (ops/registry.py), which on torch pulls the
cotangents through the autograd graph the forward recorded; ops whose
OpDef names a grad maker (dropout, layer_norm, elementwise_add,
softmax_with_cross_entropy) emit their own grad op types.
"""

from __future__ import annotations

from .framework import (
    Variable,
    core_op_role,
    grad_var_name,
    is_float_dtype,
    op_reads,
    unique_name,
)
from .ops import registry as _registry

__all__ = ["append_backward", "gradients", "calc_gradient"]


class _GradHelpers:
    """Handed to custom grad makers. grad_name returns a fresh @PARTIAL
    name per call: custom-maker grads join the same accumulation protocol
    as the generic path (two consumers of one variable must NOT write the
    same final @GRAD name — the second would overwrite the first and the
    sweep's _accumulate would double-count the survivor)."""

    @staticmethod
    def grad_name(name):
        return unique_name.generate(grad_var_name(name) + "@PARTIAL")


def _op_path(block, targets, inputs=None):
    """Ops that contribute to `targets` (reference: backward.py:780).
    Liveness uses framework.op_reads — the same walker as Program._prune
    and the DCE pass — so a control-flow op on the loss path keeps the
    ops feeding its sub-block's external reads."""
    needed = {t.name if isinstance(t, Variable) else t for t in targets}
    path = []
    for op in reversed(block.ops):
        if any(n in needed for n in op.output_arg_names()):
            path.append(op)
            needed.update(op_reads(op))
    path.reverse()
    return path


def _accumulate(block, partials, target_name, role=core_op_role.Backward):
    """Sum partial grads into target grad var (reference: backward.py:135
    _addup_repetitive_outputs_)."""
    if len(partials) == 1:
        if partials[0] != target_name:
            block.append_op(
                "assign",
                {"X": [partials[0]]},
                {"Out": [target_name]},
                {"op_role": role},
            )
        return
    block.append_op(
        "sum", {"X": list(partials)}, {"Out": [target_name]}, {"op_role": role}
    )


def _make_grad_var(block, fwd_var, grad_name=None):
    name = grad_name or grad_var_name(fwd_var.name)
    if not block.has_var_local(name):
        # grad vars stay differentiable: double grad (reference
        # gradient_checker.py) runs calc_gradient over a first backward's
        # outputs, and the second sweep must pass through the first's
        # @PARTIAL chain (stop_gradient=True here would silently truncate
        # it at the final assign)
        block.create_var(
            name=name,
            shape=fwd_var.shape,
            dtype=fwd_var.dtype,
            persistable=False,
            stop_gradient=False,
        )
    return block.vars[name]


def _wants_grad(block, name, no_grad_set):
    if name in no_grad_set:
        return False
    try:
        v = block.var(name)
    except KeyError:
        return False
    if v.stop_gradient:
        return False
    return is_float_dtype(v.dtype)


def _emit_grad_ops(block, op, avail_out_grads, no_grad_set):
    """Emit grad op(s) for one forward op. Returns
    {input_name: [partial_grad_names]} — a LIST because one variable may
    appear in several input slots of the same op (e.g. add(x, x)), each
    contributing its own partial."""
    opdef = _registry.get_op(op.type)
    if opdef.differentiable is False:
        return {}

    if callable(opdef.grad):
        # custom maker protocol: returns serialized grad-op dicts, or None
        # to defer to the generic vjp path (e.g. a grad flowing into an
        # output the maker doesn't model)
        grad_out_names = {
            slot: [avail_out_grads.get(n) for n in names]
            for slot, names in op.outputs.items()
        }
        descs = opdef.grad(op, {k: [n for n in v if n] or [None] for k, v in
                                grad_out_names.items()}, block, _GradHelpers)
        if descs is not None:
            produced = {}
            for d in descs:
                kept_any = False
                for slot, names in list(d["outputs"].items()):
                    if not slot.startswith("IGRAD_"):
                        kept_any = True
                        continue
                    fwd_slot = slot[len("IGRAD_") :]
                    # positional placeholders ("" = pruned) keep the slot
                    # index-aligned with op.inputs[fwd_slot] — same "" -
                    # marks-missing convention as the generic GRAD_ slots
                    kept = []
                    slot_any = False
                    for i, gname in enumerate(names):
                        fwd_name = op.inputs[fwd_slot][i]
                        # same stop_gradient / no_grad_set pruning as the
                        # generic path — custom makers must not leak
                        # grads across detach boundaries
                        if gname and _wants_grad(block, fwd_name,
                                                 no_grad_set):
                            produced.setdefault(fwd_name, []).append(gname)
                            kept.append(gname)
                            slot_any = True
                            kept_any = True
                        else:
                            kept.append("")
                    if slot_any:
                        d["outputs"][slot] = kept
                    else:
                        del d["outputs"][slot]
                if not kept_any:
                    continue
                attrs = dict(d.get("attrs", {}))
                attrs["op_role"] = core_op_role.Backward
                block.append_op(d["type"], d["inputs"], d["outputs"], attrs)
            for fwd_name, gnames in produced.items():
                for gname in gnames:
                    _make_grad_var(block, block.var(fwd_name), gname)
            return produced

    # --- generic vjp path ---
    # GRAD_ slots align index-wise with fwd outputs; "" marks a missing grad.
    grad_inputs = {f"FWD_{slot}": list(names) for slot, names in op.inputs.items()}
    has_any_outgrad = False
    for slot, names in op.outputs.items():
        gnames = [avail_out_grads.get(n) or "" for n in names]
        if any(gnames):
            grad_inputs[f"GRAD_{slot}"] = gnames
            has_any_outgrad = True
    if not has_any_outgrad:
        return {}

    grad_outputs = {}
    produced = {}
    for slot, names in op.inputs.items():
        if slot in opdef.no_grad_inputs:
            continue
        onames = []
        any_out = False
        for i, n in enumerate(names):
            if _wants_grad(block, n, no_grad_set):
                gname = unique_name.generate(grad_var_name(n) + "@PARTIAL")
                _make_grad_var(block, block.var(n), gname)
                onames.append(gname)
                produced.setdefault(n, []).append(gname)
                any_out = True
            else:
                onames.append("")
        if any_out:
            grad_outputs[f"IGRAD_{slot}"] = onames
    if not produced:
        return {}

    fwd_attrs = {
        k: v for k, v in op.attrs.items() if not hasattr(v, "idx")  # skip Blocks
    }
    gop = block.append_op(
        "__auto_grad__",
        grad_inputs,
        grad_outputs,
        {
            "fwd_type": op.type,
            "fwd_inputs": {k: list(v) for k, v in op.inputs.items()},
            "fwd_outputs": {k: list(v) for k, v in op.outputs.items()},
            "fwd_attrs": fwd_attrs,
            "op_role": core_op_role.Backward,
        },
    )
    # empty-string placeholders are positional markers for missing grads
    gop.inputs = grad_inputs
    gop.outputs = grad_outputs
    return produced


def _backward_sweep(block, targets, target_grads, no_grad_set, parameter_names=None):
    """Reverse sweep over the op path; returns {var_name: grad_var_name}."""
    op_path = _op_path(block, targets)
    # partials[var] = list of partial grad names awaiting accumulation
    partials: dict[str, list[str]] = {}
    final: dict[str, str] = {}
    for t, g in zip(targets, target_grads):
        partials.setdefault(t.name, []).append(g)

    for op in reversed(op_path):
        # finalize grads of this op's outputs
        avail = {}
        for n in op.output_arg_names():
            if n in final:
                avail[n] = final[n]
            elif n in partials:
                gname = grad_var_name(n)
                _make_grad_var(block, block.var(n), gname)
                _accumulate(block, partials.pop(n), gname)
                final[n] = gname
                avail[n] = gname
        if not avail:
            continue
        produced = _emit_grad_ops(block, op, avail, no_grad_set)
        for fwd_name, partial_names in produced.items():
            partials.setdefault(fwd_name, []).extend(partial_names)

    # finalize remaining leaves (params, data)
    for n, plist in list(partials.items()):
        if n in final:
            continue
        gname = grad_var_name(n)
        _make_grad_var(block, block.var(n), gname)
        _accumulate(block, plist, gname)
        final[n] = gname
    return final


def append_backward(loss, parameter_list=None, no_grad_set=None, callbacks=None):
    """reference: backward.py:558. Returns [(param, grad_var)] pairs."""
    if not isinstance(loss, Variable):
        raise TypeError(f"append_backward takes a Variable, got {type(loss)}")
    block = loss.block.program.global_block()
    program = loss.block.program
    no_grad = set(no_grad_set or ())

    # seed: loss@GRAD = 1 (reference: backward.py:663)
    loss_grad = grad_var_name(loss.name)
    block.create_var(
        name=loss_grad,
        shape=loss.shape or (1,),
        dtype=loss.dtype,
        stop_gradient=True,
    )
    block.append_op(
        "fill_constant",
        {},
        {"Out": [loss_grad]},
        {
            "shape": list(loss.shape or (1,)),
            "value": 1.0,
            "dtype": loss.dtype,
            "op_role": core_op_role.Backward | core_op_role.Loss,
        },
    )

    final = _backward_sweep(block, [loss], [loss_grad], no_grad)

    if parameter_list is not None:
        params = [
            block.var(p) if isinstance(p, str) else p for p in parameter_list
        ]
    else:
        params = [p for p in program.all_parameters() if p.trainable]

    params_and_grads = []
    for p in params:
        gname = final.get(p.name)
        if gname is None:
            continue
        params_and_grads.append((p, block.var(gname)))
    program.bump_version()
    return params_and_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """reference: backward.py:820. Grads of `targets` w.r.t. `inputs`."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    block = targets[0].block.program.global_block()
    program = targets[0].block.program

    tgrads = []
    if target_gradients:
        tg = (
            target_gradients
            if isinstance(target_gradients, (list, tuple))
            else [target_gradients]
        )
        tgrads = [g.name for g in tg]
    else:
        for t in targets:
            gname = grad_var_name(t.name)
            block.create_var(
                name=gname, shape=t.shape, dtype=t.dtype, stop_gradient=True
            )
            block.append_op(
                "fill_constant",
                {},
                {"Out": [gname]},
                {
                    "shape": list(t.shape or (1,)),
                    "value": 1.0,
                    "dtype": t.dtype,
                    "op_role": core_op_role.Backward,
                },
            )
            tgrads.append(gname)

    final = _backward_sweep(block, list(targets), tgrads, set(no_grad_set or ()))
    program.bump_version()
    out = []
    for v in inputs:
        gname = final.get(v.name)
        out.append(block.var(gname) if gname else None)
    return out


gradients = calc_gradient
