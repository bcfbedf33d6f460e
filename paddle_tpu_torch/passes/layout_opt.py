"""NHWC layout propagation over the Program IR, forward AND backward
(`paddle_tpu/passes/layout_opt.py`).

The authored Program is NCHW. This pass rewrites whole regions of the
graph to carry NHWC in the IR itself: layout-sensitive ops get
`data_format` / `data_layout` = "NHWC", layout-agnostic ops (relu,
elementwise, scale, cast, sum, ...) pass NHWC through, and explicit
`transpose2` boundary ops are inserted only where a region meets a feed,
a fetch, or a layout-locked op (mul, reshape, ...): on ResNet one at the
image input and one at each flatten / fc boundary, forward and backward.

On the card an NHWC tensor is channels_last memory: the conv2d lowering
views it as NCHW with channels_last strides, so cuDNN runs its NHWC
convolutions and writes channels_last outputs, and no NCHW <-> NHWC copy
runs between two converted ops (ops/nn_ops.py). Where a region starts at
a boundary transpose (a strided view), the conv makes its input
channels_last once.

Backward ops convert in lockstep: `__auto_grad__` twins take the SAME
rewritten attrs and input names as their primal op, and
`batch_norm_grad` follows its batch_norm. The port's `__auto_grad__`
finds the autograd graph its forward recorded by the forward's output
names (ops/registry.py `graph_users`), so where this pass renames a
converted forward op's output (a fetched activation, transposed back to
its NCHW name after the op) the twin's `fwd_outputs` follows the rename
too; otherwise the grad op would run the forward again. A gradient var
carries the layout of its primal var; where a boundary transpose was
inserted in the forward, the mirrored transpose is inserted on the
gradient path.

Numerics: a transpose is exact data movement, and every converted
lowering computes the same products and sums; the order of a
convolution's or a batch norm's sums may differ between the NCHW and
the channels_last kernels (tests/test_torch_passes.py measures it on the
CPU). Ops whose compute graph would change with layout are never
converted: dropout (its counter-hash mask is element-order dependent),
adaptive pools, and, in training programs, channel-broadcast elementwise
/ affine_channel ops (their grad reduction takes another axis; they
convert only in inference programs, with `axis` rewritten to 3).

Stats ride on the program as `program._layout_opt_stats` {removed,
inserted, remaining, converted_ops}, and in the always-on counters
`pass_layout_opt_transposes_removed`, `transpose_ops_before` and
`transpose_ops_after`.
"""

from __future__ import annotations

from .. import profiler
from ..framework import Operator, core_op_role, op_has_sub_block, op_reads
from . import register_pass

TO_NHWC = (0, 2, 3, 1)
TO_NCHW = (0, 3, 1, 2)

# anchor ops: want NHWC, save a transpose pair each when converted.
# slot tables: (activation input slots, activation output slots,
#               layout attr name, internal act-transposes in NCHW mode)
_ANCHORS = {
    "conv2d": (("Input",), ("Output",), "data_format", 2),
    "depthwise_conv2d": (("Input",), ("Output",), "data_format", 2),
    "pool2d": (("X",), ("Out",), "data_format", 2),  # 0 when global (below)
    "batch_norm": (("X",), ("Y",), "data_layout", 2),
}

# followers: layout-agnostic elementwise ops — converting costs nothing,
# they just extend a region. Unary: one 4D in, one 4D out.
_UNARY = frozenset({
    "relu", "relu6", "sigmoid", "tanh", "sqrt", "square", "abs", "exp",
    "leaky_relu", "gelu", "elu", "softplus", "softsign", "hard_sigmoid",
    "hard_swish", "swish", "scale", "cast", "assign", "clip",
})
_EW_BINARY = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
})
# explicit grad ops of the same-shape elementwise family: pure
# pass-through when X/Y shapes match (no broadcast reduction)
_EW_GRADS = frozenset({"elementwise_add_grad", "elementwise_sub_grad"})


def _perm_shape(shape, perm):
    if shape is None or len(shape) != 4:
        return shape
    return tuple(shape[p] for p in perm)


def _is_4d_float(block, name):
    v = block._find_var_recursive(name) if name else None
    if v is None or v.shape is None or len(v.shape) != 4:
        return False
    return str(v.dtype).startswith(("float", "bfloat"))


class _Rewriter:
    """One-walk layout assignment + rewrite over the global block."""

    def __init__(self, program, block, feed_names, fetch_names):
        self.program = program
        self.block = block
        self.feeds = set(feed_names)
        self.fetched = set(fetch_names)
        self.nhwc: set = set()  # var names currently carried NHWC
        self.aliases: dict = {}  # (name, to_nhwc: bool) -> alias name
        self.prim_rec: dict = {}  # fwd-outputs key -> primal record
        self.new_ops: list = []
        self.removed = 0
        self.inserted = 0
        self.remaining = 0
        self.converted_ops = 0
        self.uid = 0

        self.write_counts: dict = {}
        self.subblock_reads: set = set()
        self.has_backward = False
        for op in block.ops:
            for n in op.output_arg_names():
                if n:
                    self.write_counts[n] = self.write_counts.get(n, 0) + 1
            if op_has_sub_block(op):
                self.subblock_reads |= op_reads(op)
            if (op.attrs.get("op_role") or 0) & core_op_role.Backward:
                self.has_backward = True

    # -- layout legality ------------------------------------------------
    def _revoked(self, name):
        """A var that must stay NCHW no matter what: user-visible
        (feed/fetch/persistable), not a plain 4D float activation, or
        aliased in ways the single-assignment rewrite can't track."""
        if not name or name in self.feeds or name in self.fetched:
            return True
        if name in self.subblock_reads:
            return True
        if self.write_counts.get(name, 0) != 1:
            return True
        v = self.block._find_var_recursive(name)
        if v is None or v.persistable:
            return True
        if v.shape is None or len(v.shape) != 4:
            return True
        return not str(v.dtype).startswith(("float", "bfloat"))

    # -- op classification ---------------------------------------------
    def _pool_supported(self, attrs):
        ksize = list(attrs.get("ksize", [2, 2]))
        if attrs.get("global_pooling", False):
            return True
        if attrs.get("adaptive", False):
            return ksize == [1, 1]  # global-equivalent
        return True

    def _pool_pair_count(self, attrs):
        # global/adaptive-[1,1] pools reduce in place — no transposes to
        # save; windowed pools pay the pair
        if attrs.get("global_pooling", False) or (
            attrs.get("adaptive", False)
        ):
            return 0
        return 2

    def _anchor_supported(self, op_type, attrs, in_names):
        if attrs.get(_ANCHORS[op_type][2], "NCHW") != "NCHW":
            return False  # user-authored NHWC model: leave it alone
        if op_type == "pool2d":
            return self._pool_supported(attrs)
        if op_type == "batch_norm":
            return _is_4d_float(self.block, in_names[0]) if in_names else False
        return True

    def _anchor_pairs(self, op_type, attrs):
        if op_type == "pool2d":
            return self._pool_pair_count(attrs)
        return _ANCHORS[op_type][3]

    # -- rewrite helpers ------------------------------------------------
    def _fresh(self, base):
        self.uid += 1
        return f"{base}@lo.{self.uid}"

    def _emit_transpose(self, src, dst, to_nhwc, like_op):
        attrs = {
            "axis": list(TO_NHWC if to_nhwc else TO_NCHW),
            "op_role": like_op.attrs.get("op_role", 0),
        }
        for tag in ("device", "recompute_segment"):
            if tag in like_op.attrs:
                attrs[tag] = like_op.attrs[tag]
        self.new_ops.append(
            Operator(self.block, "transpose2", {"X": [src]},
                     {"Out": [dst]}, attrs)
        )
        self.inserted += 1

    def _alias(self, name, to_nhwc, like_op):
        """Alias of `name` in the requested layout, creating the
        boundary transpose on first use."""
        key = (name, to_nhwc)
        cached = self.aliases.get(key)
        if cached is not None:
            return cached
        v = self.block._find_var_recursive(name)
        alias = self._fresh(name)
        nv = self.block.create_var(
            name=alias,
            shape=_perm_shape(v.shape if v is not None else None,
                              TO_NHWC if to_nhwc else TO_NCHW),
            dtype=v.dtype if v is not None else "float32",
            persistable=False,
            stop_gradient=True,
        )
        nv.stop_gradient = True
        self._emit_transpose(name, alias, to_nhwc, like_op)
        if to_nhwc:
            self.nhwc.add(alias)
        self.aliases[key] = alias
        return alias

    def _fix_inputs(self, op, slots, want_nhwc):
        """Make every (4D activation) name in the given input slots
        arrive in the wanted layout, aliasing at mismatches. Returns
        {slot: [is_nhwc per position]} for the names actually used."""
        layout = {}
        for slot in slots:
            names = op.inputs.get(slot)
            if not names:
                continue
            flags = []
            for i, n in enumerate(names):
                if not n:
                    flags.append(False)
                    continue
                cur = n in self.nhwc
                want = want_nhwc and (cur or _is_4d_float(self.block, n))
                if cur != want:
                    names[i] = self._alias(n, want, op)
                    cur = want
                flags.append(cur)
            layout[slot] = flags
        return layout

    def _fix_all_inputs_nchw(self, op):
        """OTHER ops: any NHWC input gets a NCHW boundary alias.
        Returns {original: alias} for the names rewritten."""
        renames = {}
        for slot, names in op.inputs.items():
            for i, n in enumerate(names):
                if n and n in self.nhwc:
                    names[i] = renames[n] = self._alias(n, False, op)
        return renames

    def _fix_other_autograd(self, op):
        """__auto_grad__ of a layout-locked forward op: the grad op reads
        its forward's inputs by the names in the fwd_inputs ATTR (not just
        the FWD_ slots), so both must point at the NCHW aliases the
        forward op now reads; otherwise it would differentiate by names
        its forward's graph does not hold."""
        renames = self._fix_all_inputs_nchw(op)
        if not renames:
            return

        def _rewrite(attrs):
            # double grad nests fwd_attrs: an __auto_grad__ of an
            # __auto_grad__ replays the INNER op from the nested
            # fwd_inputs — every level must point at the aliases
            out = dict(attrs)
            if "fwd_inputs" in out and isinstance(out["fwd_inputs"], dict):
                out["fwd_inputs"] = {
                    s: [renames.get(n, n) for n in ns]
                    for s, ns in out["fwd_inputs"].items()
                }
            if "fwd_attrs" in out and isinstance(out["fwd_attrs"], dict):
                out["fwd_attrs"] = _rewrite(out["fwd_attrs"])
            return out

        op.attrs = _rewrite(op.attrs)

    def _bind_outputs(self, op, slots, produced_nhwc):
        """Declare output layouts. An output produced NHWC whose name
        must stay NCHW (fetched/etc.) is renamed and transposed back
        right after the op — the forward face of the removed pair."""
        post = []
        for slot in slots:
            names = op.outputs.get(slot)
            if not names:
                continue
            flags = (produced_nhwc if isinstance(produced_nhwc, dict)
                     else {slot: [produced_nhwc] * len(names)})[slot]
            for i, n in enumerate(names):
                if not n:
                    continue
                if not flags[i]:
                    self.nhwc.discard(n)
                    continue
                if self._revoked(n):
                    fresh = self._fresh(n)
                    v = self.block._find_var_recursive(n)
                    self.block.create_var(
                        name=fresh,
                        shape=_perm_shape(
                            v.shape if v is not None else None, TO_NHWC),
                        dtype=v.dtype if v is not None else "float32",
                        persistable=False,
                        stop_gradient=True,
                    )
                    names[i] = fresh
                    self.nhwc.add(fresh)
                    post.append((fresh, n))
                else:
                    self.nhwc.add(n)
                    v = self.block._find_var_recursive(n)
                    if v is not None:
                        v.shape = _perm_shape(v.shape, TO_NHWC)
        return post

    @staticmethod
    def _op_key(op_type, outputs):
        """Twin-matching key: an op's ORIGINAL output names identify it
        uniquely (single-assignment IR) and appear verbatim in its
        __auto_grad__ twin's fwd_outputs attr — compute BEFORE any
        output rename."""
        return ("__op__", op_type,
                tuple(sorted((s, tuple(ns)) for s, ns in outputs.items())))

    def _record(self, key, op, converted, in_layout):
        self.prim_rec[key] = {
            "converted": converted,
            "inputs": {s: list(ns) for s, ns in op.inputs.items()},
            # after _bind_outputs: a revoked output carries its fresh name
            "outputs": {s: list(ns) for s, ns in op.outputs.items()},
            "attrs": {k: v for k, v in op.attrs.items()
                      if not hasattr(v, "idx")},
            "in_nhwc": in_layout,
        }

    def _twin_key(self, gop):
        fwd_outputs = gop.attr("fwd_outputs") or {}
        return self._op_key(gop.attr("fwd_type"), fwd_outputs)

    def _canon_shape(self, name):
        """A var's logical NCHW shape (un-permuting names already
        flipped), for broadcast detection."""
        v = self.block._find_var_recursive(name) if name else None
        if v is None or v.shape is None:
            return None
        if name in self.nhwc:
            return _perm_shape(v.shape, TO_NCHW)
        return tuple(v.shape)

    # -- per-op handlers ------------------------------------------------
    def _handle_anchor(self, op):
        key = self._op_key(op.type, op.outputs)
        act_in, act_out, attr_name, _ = _ANCHORS[op.type]
        x0 = (op.inputs.get(act_in[0]) or [""])[0]
        supported = self._anchor_supported(op.type, op.attrs,
                                           op.inputs.get(act_in[0], []))
        pairs = self._anchor_pairs(op.type, op.attrs)
        if op.type == "batch_norm" and not (
            _is_4d_float(self.block, x0) or x0 in self.nhwc
        ):
            pairs = 0  # 2D BN never transposes in the NCHW lowering
        # revoked outputs are covered by _bind_outputs' rename +
        # transpose-back, so conversion only needs the op itself supported
        if supported:
            in_layout = self._fix_inputs(op, act_in, True)
            op.attrs[attr_name] = "NHWC"
            post = self._bind_outputs(op, act_out, True)
            self.removed += pairs
            self.converted_ops += 1
            self._record(key, op, True, in_layout)
            self.new_ops.append(op)
            for src, dst in post:
                self._emit_transpose(src, dst, False, op)
        else:
            self.remaining += pairs
            in_layout = self._fix_inputs(op, act_in, False)
            self._record(key, op, False, in_layout)
            self.new_ops.append(op)

    def _handle_follower(self, op, in_slots, out_slots, binary):
        key = self._op_key(op.type, op.outputs)
        in_names = [n for s in in_slots for n in op.inputs.get(s, []) if n]
        any_nhwc = any(n in self.nhwc for n in in_names)
        convert = any_nhwc
        bcast = False
        if convert and binary:
            shapes = {self._canon_shape(n) for n in in_names}
            shapes.discard(None)
            bcast = len(shapes) > 1
        if bcast:
            yv = self._canon_shape((op.inputs.get("Y") or [""])[0])
            if self.has_backward:
                # a [C]-bias broadcast is exact in either layout in the
                # FORWARD, but its grad's channel reduction takes a
                # different path per layout — convert only in inference
                convert = False
            elif not (yv is not None and len(yv) == 1
                      and op.attrs.get("axis", -1) in (1,)):
                # only the per-channel [C] @ axis=1 broadcast has a
                # well-defined NHWC rewrite (axis -> last)
                convert = False
        if convert:
            in_layout = self._fix_inputs(op, in_slots, True)
            if bcast:
                op.attrs["axis"] = 3  # channel moved to the last dim
            post = self._bind_outputs(op, out_slots, True)
            self.converted_ops += 1
            self._record(key, op, True, in_layout)
            self.new_ops.append(op)
            for src, dst in post:
                self._emit_transpose(src, dst, False, op)
        else:
            in_layout = self._fix_inputs(op, in_slots, False)
            self._record(key, op, False, in_layout)
            self.new_ops.append(op)

    def _handle_affine_channel(self, op):
        key = self._op_key(op.type, op.outputs)
        x = (op.inputs.get("X") or [""])[0]
        convert = (
            x in self.nhwc
            and op.attrs.get("data_layout", "NCHW") == "NCHW"
            and not self.has_backward  # grad reduction changes with layout
        )
        if convert:
            in_layout = self._fix_inputs(op, ("X",), True)
            op.attrs["data_layout"] = "NHWC"
            post = self._bind_outputs(op, ("Out",), True)
            self.converted_ops += 1
            self._record(key, op, True, in_layout)
            self.new_ops.append(op)
            for src, dst in post:
                self._emit_transpose(src, dst, False, op)
        else:
            in_layout = self._fix_inputs(op, ("X",), False)
            self._record(key, op, False, in_layout)
            self.new_ops.append(op)

    def _handle_bn_grad(self, op):
        # follows its batch_norm: matched through the SavedMean output
        # name the grad maker wired as an input
        saved = (op.inputs.get("SavedMean") or [""])[0]
        rec = None
        for key, r in self.prim_rec.items():
            if key[1] == "batch_norm" and any(
                saved in ns for _, ns in key[2]
            ):
                rec = r
                break
        convert = bool(rec and rec["converted"])
        if convert:
            # X must arrive exactly as the bn consumed it
            op.inputs["X"] = list(rec["inputs"]["X"])
            self._fix_inputs(op, ("GRAD_Y",), True)
            op.attrs["data_layout"] = "NHWC"
            produced = {"IGRAD_X": [True] * len(op.outputs.get("IGRAD_X", []))}
            post = self._bind_outputs(op, ("IGRAD_X",), produced)
            self.removed += 3  # xi, dyi and dx transposes of the NCHW path
            self.converted_ops += 1
            self.new_ops.append(op)
            for src, dst in post:
                self._emit_transpose(src, dst, False, op)
        else:
            xs = self._canon_shape((op.inputs.get("X") or [""])[0])
            if xs is not None and len(xs) == 4:
                self.remaining += 3  # 2D BN grads never transpose
            self._fix_inputs(op, ("X", "GRAD_Y"), False)
            self.new_ops.append(op)

    def _handle_auto_grad(self, op):
        fwd_type = op.attr("fwd_type")
        rec = self.prim_rec.get(self._twin_key(op))
        if rec is None:
            self._fix_other_autograd(op)
            self.new_ops.append(op)
            return
        if fwd_type in _ANCHORS:
            act_in = _ANCHORS[fwd_type][0]
            act_out = _ANCHORS[fwd_type][1]
            pairs = 2 * self._anchor_pairs(fwd_type, rec["attrs"])
        elif fwd_type in _UNARY:
            act_in, act_out, pairs = ("X",), ("Out",), 0
        elif fwd_type in _EW_BINARY:
            act_in, act_out, pairs = ("X", "Y"), ("Out",), 0
        elif fwd_type == "sum":
            act_in, act_out, pairs = ("X",), ("Out",), 0
        elif fwd_type == "affine_channel":
            act_in, act_out, pairs = ("X",), ("Out",), 0
        else:
            self._fix_other_autograd(op)
            self.new_ops.append(op)
            return
        if not rec["converted"]:
            self.remaining += pairs
            # primal stayed NCHW — its (possibly aliased) input names are
            # authoritative for the replay
            op.attrs["fwd_inputs"] = {s: list(ns)
                                      for s, ns in rec["inputs"].items()}
            for slot, ns in rec["inputs"].items():
                if f"FWD_{slot}" in op.inputs:
                    op.inputs[f"FWD_{slot}"] = list(ns)
            self._fix_inputs(
                op, tuple(f"GRAD_{s}" for s in act_out), False)
            self._fix_inputs(
                op, tuple(f"IGRAD_{s}" for s in act_in), False)
            self.new_ops.append(op)
            return
        # converted twin: replay the forward exactly as the primal now
        # runs it (same attrs, same — possibly aliased — input names)
        op.attrs["fwd_attrs"] = dict(rec["attrs"])
        op.attrs["fwd_inputs"] = {s: list(ns)
                                  for s, ns in rec["inputs"].items()}
        # and find its graph by the primal's output names as they now
        # are (a revoked output was renamed by _bind_outputs)
        fwd_outputs = op.attr("fwd_outputs") or {}
        if any(rec["outputs"].get(s) != list(ns)
               for s, ns in fwd_outputs.items()):
            op.attrs["fwd_outputs"] = {
                s: list(rec["outputs"].get(s, ns))
                for s, ns in fwd_outputs.items()}
        for slot, ns in rec["inputs"].items():
            if f"FWD_{slot}" in op.inputs:
                op.inputs[f"FWD_{slot}"] = list(ns)
        # cotangents of converted outputs arrive NHWC
        self._fix_inputs(op, tuple(f"GRAD_{s}" for s in act_out), True)
        # produced input-grads mirror the layout the replay consumed
        produced = {}
        for slot in act_in:
            gslot = f"IGRAD_{slot}"
            if gslot not in op.outputs:
                continue
            flags = rec["in_nhwc"].get(slot)
            ns = op.outputs[gslot]
            produced[gslot] = [
                bool(flags and i < len(flags) and flags[i])
                for i in range(len(ns))
            ]
        post = self._bind_outputs(op, tuple(produced.keys()), produced)
        self.removed += pairs
        self.converted_ops += 1
        self.new_ops.append(op)
        for src, dst in post:
            self._emit_transpose(src, dst, False, op)

    def _handle_ew_grad(self, op):
        # pass-through when X and Y share a shape (the residual-
        # connection grads — no broadcast reduction); anything broadcasty
        # stays NCHW (its primal wasn't converted in training either)
        slots_in = ("X", "Y", "GRAD_Out")
        in_names = [n for s in slots_in for n in op.inputs.get(s, []) if n]
        any_nhwc = any(n in self.nhwc for n in in_names)
        xs = self._canon_shape((op.inputs.get("X") or [""])[0])
        ys = self._canon_shape((op.inputs.get("Y") or [""])[0])
        same_shape = xs is not None and xs == ys
        if any_nhwc and same_shape:
            self._fix_inputs(op, slots_in, True)
            produced = {
                "IGRAD_X": [True] * len(op.outputs.get("IGRAD_X", [])),
                "IGRAD_Y": [True] * len(op.outputs.get("IGRAD_Y", [])),
            }
            post = self._bind_outputs(
                op, ("IGRAD_X", "IGRAD_Y"), produced)
            self.converted_ops += 1
            self.new_ops.append(op)
            for src, dst in post:
                self._emit_transpose(src, dst, False, op)
        else:
            self._fix_all_inputs_nchw(op)
            self.new_ops.append(op)

    # -- driver ---------------------------------------------------------
    def run(self):
        for op in self.block.ops:
            if op.type in _ANCHORS:
                self._handle_anchor(op)
            elif op.type == "affine_channel":
                self._handle_affine_channel(op)
            elif op.type in _UNARY:
                self._handle_follower(op, ("X",), ("Out",), False)
            elif op.type in _EW_BINARY:
                self._handle_follower(op, ("X", "Y"), ("Out",), True)
            elif op.type == "sum":
                self._handle_follower(op, ("X",), ("Out",), False)
            elif op.type in _EW_GRADS:
                self._handle_ew_grad(op)
            elif op.type == "batch_norm_grad":
                self._handle_bn_grad(op)
            elif op.type == "__auto_grad__":
                self._handle_auto_grad(op)
            else:
                self._fix_all_inputs_nchw(op)
                self.new_ops.append(op)
        self.block.ops = self.new_ops


@register_pass("layout_opt", strategy_knob="enable_layout_opt")
def propagate_layout(program, block, feed_names, fetch_names, ctx=None):
    rw = _Rewriter(program, block, feed_names, fetch_names)
    rw.run()
    stats = {
        "removed": rw.removed,
        "inserted": rw.inserted,
        "remaining": rw.remaining,
        "converted_ops": rw.converted_ops,
    }
    program._layout_opt_stats = stats
    profiler.bump_counter("pass_layout_opt_transposes_removed",
                          max(rw.removed - rw.inserted, 0))
    # gauges: activation transposes of the NCHW program (two for each op
    # that converts) against after this pass (boundary transposes)
    profiler.set_counter("transpose_ops_before", rw.removed + rw.remaining)
    profiler.set_counter("transpose_ops_after", rw.inserted + rw.remaining)
    if ctx is not None and (rw.converted_ops or rw.inserted):
        ctx.mutated = True
    return -rw.inserted
