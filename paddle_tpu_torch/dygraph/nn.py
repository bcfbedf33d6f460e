"""Dygraph layers (paddle_tpu/dygraph/nn.py; reference
python/paddle/fluid/dygraph/nn.py:35-2564): eager torch ops recorded on the
autograd tape (autograd.py), NCHW throughout.

Part 1 computes each layer in plain torch: Linear / FC, Conv2D, Pool2D,
BatchNorm, Embedding, LayerNorm, Dropout, GRUUnit, PRelu and NCE. Part 2
(`_run_op`) runs a registered graph-mode lowering of the port's ops
registry eagerly on VarBase inputs, as the JAX package does for
Conv2DTranspose, Conv3D, Conv3DTranspose, BilinearTensorProduct,
SequenceConv, RowConv, GroupNorm, SpectralNorm and TreeConv. None of these
reaches a CUDA kernel of ops/kernels: the JAX package's dygraph layers
compute in plain jnp / lax too."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .autograd import VarBase, _host_to_tensor, record, tape_rng
from .layers import Layer

__all__ = ["Conv2D", "Pool2D", "FC", "Linear", "BatchNorm", "Embedding",
           "LayerNorm", "Dropout", "GRUUnit", "PRelu", "NCE",
           "Conv2DTranspose", "Conv3D", "Conv3DTranspose",
           "BilinearTensorProduct", "SequenceConv", "RowConv",
           "GroupNorm", "SpectralNorm", "TreeConv"]


def _gelu(x):
    # jax.nn.gelu's default is the tanh form
    return F.gelu(x, approximate="tanh")


_ACTS = {
    None: lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda x: torch.softmax(x, -1),
    "gelu": _gelu,
}


def _act(out, act):
    if act is None:
        return out
    return record(_ACTS[act], out)


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


class Linear(Layer):
    """reference dygraph FC: y = act(x W + b), x flattened to [b, -1]."""

    def __init__(self, input_dim, output_dim, act=None, bias_attr=None,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "linear", dtype)
        self.weight = self.create_parameter([input_dim, output_dim], dtype)
        self.bias = self.create_parameter([output_dim], dtype, is_bias=True)
        self._act = act

    def forward(self, x):
        out = record(lambda xv, w, b: xv.reshape(xv.shape[0], -1) @ w + b,
                     x, self.weight, self.bias)
        return _act(out, self._act)


FC = Linear


class Conv2D(Layer):
    """reference dygraph Conv2D (nn.py:35), NCHW, symmetric padding."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, act=None, dtype="float32",
                 name_scope=None):
        super().__init__(name_scope or "conv2d", dtype)
        fh, fw = _pair(filter_size)
        self._stride = _pair(stride)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._groups = groups
        fan_in = num_channels * fh * fw
        std = float(np.sqrt(2.0 / fan_in))
        self.weight = self.create_parameter(
            [num_filters, num_channels // groups, fh, fw], dtype,
            default_initializer=lambda s, d: np.random.RandomState(0)
            .randn(*s).astype(d) * std,
        )
        self.bias = self.create_parameter([num_filters], dtype, is_bias=True)
        self._act = act

    def forward(self, x):
        st, pd, dl, g = self._stride, self._padding, self._dilation, self._groups
        return _act(record(lambda xv, w, b: F.conv2d(xv, w, b, st, pd, dl, g),
                           x, self.weight, self.bias), self._act)


class Pool2D(Layer):
    """reference dygraph Pool2D: max / avg, NCHW. Max pooling pads with
    -inf; exclusive avg pooling divides each window by its count of
    unpadded elements, the other by the window's size."""

    def __init__(self, pool_size=2, pool_type="max", pool_stride=None,
                 pool_padding=0, global_pooling=False, exclusive=True,
                 name_scope=None):
        super().__init__(name_scope or "pool2d")
        self._size = _pair(pool_size)
        self._stride = _pair(pool_stride if pool_stride is not None else pool_size)
        self._padding = _pair(pool_padding)
        self._type = pool_type
        self._global = global_pooling
        self._exclusive = exclusive

    def forward(self, x):
        if self._global:
            if self._type == "max":
                return record(lambda xv: xv.amax((2, 3), keepdim=True), x)
            return record(lambda xv: xv.mean((2, 3), keepdim=True), x)
        k, s, p = self._size, self._stride, self._padding
        # torch's own padding is limited to half the window
        native = p[0] <= k[0] // 2 and p[1] <= k[1] // 2
        pads = (p[1], p[1], p[0], p[0])
        if self._type == "max":
            if native:
                return record(lambda xv: F.max_pool2d(xv, k, s, p), x)
            return record(lambda xv: F.max_pool2d(
                F.pad(xv, pads, value=float("-inf")), k, s), x)
        exclusive = self._exclusive
        if native:
            return record(lambda xv: F.avg_pool2d(
                xv, k, s, p, count_include_pad=not exclusive), x)

        def pool(xv):
            total = F.avg_pool2d(F.pad(xv, pads), k, s, divisor_override=1)
            if not exclusive:
                return total / (k[0] * k[1])
            ones = torch.ones_like(xv[:1, :1])
            return total / F.avg_pool2d(F.pad(ones, pads), k, s, divisor_override=1)

        return record(pool, x)


class BatchNorm(Layer):
    """reference dygraph BatchNorm: train normalises by the batch's mean
    and biased variance and moves the running stats (computed apart from
    the tape); eval normalises by the running stats."""

    def __init__(self, num_channels, momentum=0.9, epsilon=1e-5, act=None,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "batch_norm", dtype)
        self.weight = self.create_parameter(
            [num_channels], dtype, default_initializer=lambda s, d: np.ones(s, d))
        self.bias = self.create_parameter([num_channels], dtype, is_bias=True)
        # running stats: persisted in state_dict but not trainable, so
        # persistable is set before assignment (Layer.__setattr__ makes
        # them buffers)
        mean = VarBase(_host_to_tensor(np.zeros((num_channels,), dtype)))
        mean.persistable = True
        variance = VarBase(_host_to_tensor(np.ones((num_channels,), dtype)))
        variance.persistable = True
        self._mean = mean
        self._variance = variance
        self._momentum = momentum
        self._epsilon = epsilon
        self._act = act

    def forward(self, x):
        eps = self._epsilon
        if self.training:
            out = record(lambda xv, w, b: F.batch_norm(xv, None, None, w, b, True, 0.0, eps),
                         x, self.weight, self.bias)
            m = self._momentum
            axes = tuple(i for i in range(len(x.shape)) if i != 1)
            with torch.no_grad():
                bvar, bmean = torch.var_mean(x.value, axes, correction=0)
                self._mean.value = m * self._mean.value + (1 - m) * bmean
                self._variance.value = m * self._variance.value + (1 - m) * bvar
            return _act(out, self._act)
        rmean, rvar = self._mean.value, self._variance.value
        return _act(record(lambda xv, w, b: F.batch_norm(xv, rmean, rvar, w, b, False,
                                                         0.0, eps),
                           x, self.weight, self.bias), self._act)


class Embedding(Layer):
    """reference dygraph Embedding; rows of padding_idx read as zeros."""

    def __init__(self, size, is_sparse=False, padding_idx=None,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "embedding", dtype)
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            list(size), dtype,
            default_initializer=lambda s, d: np.random.RandomState(0)
            .uniform(-0.05, 0.05, s).astype(d),
        )

    def forward(self, ids):
        pad = self._padding_idx

        def emb(w, idv):
            idv = idv.long()
            if idv.ndim >= 2 and idv.shape[-1] == 1:
                idv = idv.squeeze(-1)
            out = w[idv]
            if pad is not None:
                out = out * (idv != pad).unsqueeze(-1).to(out.dtype)
            return out

        return record(emb, self.weight, ids)


class LayerNorm(Layer):
    """Normalises over the last axis, then scales and shifts."""

    def __init__(self, normalized_shape, epsilon=1e-5, dtype="float32",
                 name_scope=None):
        super().__init__(name_scope or "layer_norm", dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.weight = self.create_parameter(
            normalized_shape, dtype, default_initializer=lambda s, d: np.ones(s, d))
        self.bias = self.create_parameter(normalized_shape, dtype, is_bias=True)
        self._epsilon = epsilon

    def forward(self, x):
        eps = self._epsilon

        def ln(xv, w, b):
            var, mean = torch.var_mean(xv, -1, correction=0, keepdim=True)
            return (xv - mean) * torch.rsqrt(var + eps) * w + b

        return record(ln, x, self.weight, self.bias)


class Dropout(Layer):
    """Each forward in training draws the mask of
    jax.random.bernoulli(fold_in(key(seed), step), 1 - p, shape), bit for
    bit (ops/prng.bernoulli_mask), and scales the kept values by 1/(1-p)."""

    def __init__(self, p=0.5, name_scope=None):
        super().__init__(name_scope or "dropout")
        self._p = p
        self._seed = np.random.RandomState(0).randint(2**31)
        self._step = 0

    def _host_state(self):
        return self._step

    def _set_host_state(self, state):
        self._step = state

    def forward(self, x):
        if not self.training or self._p == 0.0:
            return x
        from ..ops.prng import bernoulli_mask

        self._step += 1
        # tape_rng, not a host fold_in: under the JIT bridge the key is
        # the bridge's per-call key tensor, so each replay draws afresh
        key = tape_rng(self._seed, self._step, x.value.device)
        p = self._p

        def drop(xv):
            keep = bernoulli_mask(key, 1.0 - p, xv.shape)
            return torch.where(keep, xv / (1.0 - p), torch.zeros((), dtype=xv.dtype,
                                                                 device=xv.device))

        return record(drop, x)


class GRUUnit(Layer):
    """reference dygraph GRUUnit: one GRU step. input [b, 3D] (the x
    projections), hidden [b, D] -> (new hidden, reset hidden, gates)."""

    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype="float32", name_scope=None):
        super().__init__(name_scope or "gru_unit", dtype)
        self._d = size // 3  # reference: `size` is 3*D
        self.weight = self.create_parameter([self._d, 3 * self._d], dtype)
        self.bias = self.create_parameter([3 * self._d], dtype, is_bias=True)
        self._gate_act = _ACTS[gate_activation]
        self._cand_act = _ACTS[activation]
        self._origin = origin_mode

    def forward(self, input, hidden):
        d = self._d
        origin = self._origin
        gate_act, cand_act = self._gate_act, self._cand_act

        def parts(xt, h_prev, w, b):
            xt = xt + b
            gates = xt[:, : 2 * d] + h_prev @ w[:, : 2 * d]
            u = gate_act(gates[:, :d])
            r = gate_act(gates[:, d:])
            c = cand_act(xt[:, 2 * d:] + (r * h_prev) @ w[:, 2 * d:])
            return u, r, c

        def new_hidden(xt, h_prev, w, b):
            u, r, c = parts(xt, h_prev, w, b)
            if origin:
                return u * h_prev + (1.0 - u) * c
            return (1.0 - u) * h_prev + u * c

        args = (input, hidden, self.weight, self.bias)
        h = record(new_hidden, *args)
        reset_h = record(lambda xt, hp, w, b: parts(xt, hp, w, b)[1] * hp, *args)
        gate = record(lambda xt, hp, w, b: torch.cat(parts(xt, hp, w, b), 1), *args)
        return h, reset_h, gate


class PRelu(Layer):
    """reference dygraph PRelu: max(0, x) + alpha * min(0, x)."""

    def __init__(self, mode="all", channel=None, input_shape=None,
                 param_attr=None, dtype="float32", name_scope=None):
        super().__init__(name_scope or "prelu", dtype)
        if mode == "all":
            shape = [1]
        elif mode == "channel":
            shape = [channel or 1]
        else:  # element: one alpha per feature, batch dim excluded
            shape = [1] + list(input_shape or [1])[1:]
        self._mode = mode
        self.weight = self.create_parameter(
            shape, dtype, default_initializer=lambda s, d: np.full(s, 0.25, d))

    def forward(self, x):
        mode = self._mode

        def prelu(xv, a):
            if mode == "channel" and xv.ndim == 4:
                a = a.reshape(1, -1, 1, 1)
            return torch.clamp_min(xv, 0) + a * torch.clamp_max(xv, 0)

        return record(prelu, x, self.weight)


class NCE(Layer):
    """reference dygraph NCE (nce_op.cc): noise-contrastive estimation with
    a uniform or log_uniform negative sampler drawn by numpy on the host,
    as the JAX package draws it. forward(input [b, d], label [b, 1]) ->
    cost [b, 1]."""

    def __init__(self, num_total_classes, dim, sample_weight=None,
                 param_attr=None, bias_attr=None, num_neg_samples=10,
                 sampler="uniform", custom_dist=None, seed=0,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "nce", dtype)
        if sampler not in ("uniform", "log_uniform"):
            raise ValueError(f"NCE: unknown sampler {sampler!r}")
        self._v = int(num_total_classes)
        self._k = int(num_neg_samples)
        self._sampler = sampler
        self._rng = np.random.RandomState(seed or None)
        self.weight = self.create_parameter([self._v, dim], dtype)
        self.bias = self.create_parameter([self._v], dtype, is_bias=True)

    def _host_state(self):
        return self._rng.get_state()

    def _set_host_state(self, state):
        self._rng.set_state(state)

    def _draw(self, b):
        if self._sampler == "uniform":
            neg = self._rng.randint(0, self._v, (b, self._k))
        else:
            u = self._rng.rand(b, self._k)
            neg = np.clip((np.exp(u * np.log(self._v + 1.0)) - 1.0).astype("int64"),
                          0, self._v - 1)
        return neg, self._log_p(neg)

    def _log_p(self, ids):
        if self._sampler == "uniform":
            return np.full(ids.shape, -np.log(self._v), "float32")
        idf = np.asarray(ids, "float64")
        return np.log(np.log((idf + 2.0) / (idf + 1.0))
                      / np.log(self._v + 1.0)).astype("float32")

    def forward(self, input, label):
        lab = (label.numpy() if isinstance(label, VarBase)
               else np.asarray(label)).reshape(-1).astype("int64")
        b = lab.shape[0]
        neg, neg_logp = self._draw(b)
        pos_logp = self._log_p(lab)
        log_k = float(np.log(self._k))
        dev = input.value.device
        neg_t = _host_to_tensor(neg, dev).long()
        lab_t = _host_to_tensor(lab, dev).long()
        pos_lp = _host_to_tensor(pos_logp, dev)
        neg_lp = _host_to_tensor(neg_logp, dev)

        def nce_cost(x, w, bias):
            pos_logit = torch.sum(w[lab_t] * x, -1) + bias[lab_t]
            neg_logit = torch.sum(w[neg_t] * x[:, None, :], -1) + bias[neg_t]
            pos = F.logsigmoid(pos_logit - (log_k + pos_lp))
            negs = F.logsigmoid(-(neg_logit - (log_k + neg_lp)))
            return -(pos + torch.sum(negs, 1)).reshape(-1, 1)

        return record(nce_cost, input, self.weight, self.bias)


# ---------------------------------------------------------------------------
# part 2: the reference classes the JAX package builds on its graph-mode
# lowerings (reference dygraph/nn.py:244,441,662,1964,2199,2289,2365,2464,
# 2564): one lowering per op, shared by both modes
# ---------------------------------------------------------------------------


class _EagerOp:
    """Op-desc stand-in so a registered lowering can run eagerly."""

    def __init__(self, type, input_slots, output_slots, attrs):
        self.type = type
        self.inputs = {s: [f"{s}#{i}" for i in range(n)] for s, n in input_slots.items()}
        self.outputs = {s: [f"out:{s}"] for s in output_slots}
        self.attrs = dict(attrs)

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]


def _run_op(op_type, inputs, attrs, out_slot, out_slots=None):
    """Run the port's registered lowering of `op_type` eagerly on VarBase /
    array inputs, taping the grad through `record`. inputs: {slot: VarBase
    | array | list | None}."""
    from ..ops import prng
    from ..ops.registry import LoweringContext, get_op

    slots, flat = [], []
    for s, v in inputs.items():
        if v is None:
            continue
        vs = v if isinstance(v, (list, tuple)) else [v]
        slots.append((s, len(vs)))
        flat.extend(vs)
    op = _EagerOp(op_type, dict(slots), tuple(out_slots or (out_slot,)), attrs)
    lowering = get_op(op_type).lower

    def fn(*vals):
        ctx = LoweringContext(device=vals[0].device, rng_key=prng.key(0))
        i = 0
        for s, n in slots:
            for k in range(n):
                ctx.values[f"{s}#{k}"] = vals[i]
                i += 1
        lowering(ctx, op)
        return ctx.get(f"out:{out_slot}")

    flat = [v if isinstance(v, VarBase) else VarBase(_host_to_tensor(v), True) for v in flat]
    return record(fn, *flat)


def _three(v):
    return [v] * 3 if isinstance(v, int) else list(v)


class Conv2DTranspose(Layer):
    """reference dygraph Conv2DTranspose; filter [in_c, out_c / groups, kh, kw]."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, act=None,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "conv2d_transpose", dtype)
        fh, fw = _pair(filter_size)
        self._attrs = {"strides": list(_pair(stride)), "paddings": list(_pair(padding)),
                       "dilations": list(_pair(dilation)), "groups": groups}
        self.weight = self.create_parameter(
            [num_channels, num_filters // groups, fh, fw], dtype)
        self.bias = self.create_parameter([num_filters], dtype, is_bias=True)
        self._act = act

    def forward(self, x):
        out = _run_op("conv2d_transpose", {"Input": x, "Filter": self.weight},
                      self._attrs, "Output")
        out = record(lambda o, b: o + b[None, :, None, None], out, self.bias)
        return _act(out, self._act)


class Conv3D(Layer):
    """reference dygraph Conv3D (nn.py:244), NCDHW."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, act=None,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "conv3d", dtype)
        self._attrs = {"strides": _three(stride), "paddings": _three(padding),
                       "dilations": _three(dilation), "groups": groups}
        self.weight = self.create_parameter(
            [num_filters, num_channels // groups] + _three(filter_size), dtype)
        self.bias = self.create_parameter([num_filters], dtype, is_bias=True)
        self._act = act

    def forward(self, x):
        out = _run_op("conv3d", {"Input": x, "Filter": self.weight}, self._attrs, "Output")
        out = record(lambda o, b: o + b[None, :, None, None, None], out, self.bias)
        return _act(out, self._act)


class Conv3DTranspose(Layer):
    """reference dygraph Conv3DTranspose (nn.py:441)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, act=None,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "conv3d_transpose", dtype)
        self._attrs = {"strides": _three(stride), "paddings": _three(padding),
                       "dilations": _three(dilation), "groups": groups}
        self.weight = self.create_parameter(
            [num_channels, num_filters // groups] + _three(filter_size), dtype)
        self.bias = self.create_parameter([num_filters], dtype, is_bias=True)
        self._act = act

    def forward(self, x):
        out = _run_op("conv3d_transpose", {"Input": x, "Filter": self.weight},
                      self._attrs, "Output")
        out = record(lambda o, b: o + b[None, :, None, None, None], out, self.bias)
        return _act(out, self._act)


class BilinearTensorProduct(Layer):
    """reference dygraph BilinearTensorProduct (nn.py:1864):
    out[:, k] = x W_k y^T + b_k."""

    def __init__(self, input1_dim, input2_dim, output_dim, act=None,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "bilinear_tensor_product", dtype)
        self.weight = self.create_parameter([output_dim, input1_dim, input2_dim], dtype)
        self.bias = self.create_parameter([output_dim], dtype, is_bias=True)
        self._act = act

    def forward(self, x, y):
        out = _run_op("bilinear_tensor_product",
                      {"X": x, "Y": y, "Weight": self.weight, "Bias": self.bias}, {}, "Out")
        return _act(out, self._act)


class SequenceConv(Layer):
    """reference dygraph SequenceConv (nn.py:2199), dense: input [b, t, d]
    and an optional [b, t] mask."""

    def __init__(self, input_dim, num_filters, filter_size=3,
                 filter_stride=1, act=None, dtype="float32",
                 name_scope=None):
        super().__init__(name_scope or "sequence_conv", dtype)
        if filter_stride != 1:
            raise NotImplementedError("sequence_conv stride must be 1")
        self._ctx_len = filter_size
        self.weight = self.create_parameter([filter_size * input_dim, num_filters], dtype)
        self.bias = self.create_parameter([num_filters], dtype, is_bias=True)
        self._act = act

    def forward(self, x, mask=None):
        inputs = {"X": x, "Filter": self.weight}
        if mask is not None:
            inputs["Mask"] = mask
        out = _run_op("sequence_conv", inputs,
                      {"contextLength": self._ctx_len,
                       "contextStart": -(self._ctx_len // 2)}, "Out")
        out = record(lambda o, b: o + b, out, self.bias)
        return _act(out, self._act)


class RowConv(Layer):
    """reference dygraph RowConv (nn.py:2289): lookahead row conv."""

    def __init__(self, input_dim, future_context_size=2, act=None,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "row_conv", dtype)
        self.weight = self.create_parameter([future_context_size + 1, input_dim], dtype)
        self._act = act

    def forward(self, x):
        out = _run_op("row_conv", {"X": x, "Filter": self.weight}, {}, "Out")
        return _act(out, self._act)


class GroupNorm(Layer):
    """reference dygraph GroupNorm (nn.py:2365)."""

    def __init__(self, channels, groups=32, epsilon=1e-5, act=None,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "group_norm", dtype)
        self._attrs = {"groups": groups, "epsilon": epsilon}
        self.weight = self.create_parameter(
            [channels], dtype, default_initializer=lambda s, d: np.ones(s, d))
        self.bias = self.create_parameter([channels], dtype, is_bias=True)
        self._act = act

    def forward(self, x):
        out = _run_op("group_norm", {"X": x, "Scale": self.weight, "Bias": self.bias},
                      self._attrs, "Y", out_slots=("Y", "Mean", "Variance"))
        return _act(out, self._act)


class SpectralNorm(Layer):
    """reference dygraph SpectralNorm (nn.py:2464): weight / sigma, with the
    power-iterated u / v persistable, non-trainable buffers that each
    forward moves first (with their grads stopped), then the op at
    power_iters 0, so one iteration runs per forward."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", name_scope=None):
        super().__init__(name_scope or "spectral_norm", dtype)
        self._attrs = {"dim": dim, "power_iters": power_iters, "eps": eps}
        h = int(weight_shape[dim])
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= int(s)
        rng = np.random.RandomState(0)

        def buf(val):
            b = VarBase(_host_to_tensor(val), stop_gradient=True)
            b.persistable = True
            return b

        self.weight_u = buf(rng.randn(h).astype(dtype))
        self.weight_v = buf(rng.randn(w).astype(dtype))

    def forward(self, weight):
        wv = weight.value if isinstance(weight, VarBase) else _host_to_tensor(weight)
        dim = self._attrs["dim"]
        perm = [dim] + [i for i in range(wv.ndim) if i != dim]
        eps = self._attrs["eps"]
        with torch.no_grad():
            mat = wv.permute(perm).reshape(wv.shape[dim], -1)
            u, v = self.weight_u.value, self.weight_v.value
            for _ in range(self._attrs["power_iters"]):
                v = mat.T @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = mat @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
        self.weight_u.value = u
        self.weight_v.value = v
        return _run_op("spectral_norm",
                       {"Weight": weight, "U": self.weight_u, "V": self.weight_v},
                       {**self._attrs, "power_iters": 0}, "Out")


class TreeConv(Layer):
    """reference dygraph TreeConv (nn.py:2564): TBCNN tree conv."""

    def __init__(self, feature_size, output_size, num_filters=1,
                 max_depth=2, act="tanh", dtype="float32",
                 name_scope=None):
        super().__init__(name_scope or "tree_conv", dtype)
        self._attrs = {"max_depth": max_depth}
        self.weight = self.create_parameter(
            [feature_size, 3, output_size, num_filters], dtype)
        self.bias = self.create_parameter([num_filters], dtype, is_bias=True)
        self._act = act

    def forward(self, nodes_vector, edge_set):
        out = _run_op("tree_conv", {"NodesVector": nodes_vector, "EdgeSet": edge_set,
                                    "Filter": self.weight}, self._attrs, "Out")
        out = record(lambda o, b: o + b, out, self.bias)
        return _act(out, self._act)
