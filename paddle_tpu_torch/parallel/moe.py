"""Mixture of experts with expert parallelism: the port's copy of
`paddle_tpu/parallel/moe.py`, line for line in torch.

GShard's top-k dense dispatch: tokens route to experts through one-hot
dispatch / combine tensors, capacity overflow drops tokens, the gates of
a token's experts are renormalised, and the load-balance auxiliary loss
E * sum_e f_e * p_e is returned for the trainer to add. The two expert
products stay `torch.einsum`: the JAX package computes them outside any
Pallas kernel.

Expert parallelism (`expert_shard`): with the expert dim of w1 / b1 / w2
/ b2 split over a `model` group of m ranks, every rank routes all tokens
with the replicated gate, so routing, capacity and the aux loss are the
same on every rank; it keeps the dispatch columns of its E/m experts,
runs their FFNs, and its share of the combine is a partial sum, which the
caller all-reduces (ops/moe_ops.py). `moe_shardings(mesh, axis)` gives
the placements of that split.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MoEParams", "init_moe_params", "moe_ffn", "moe_shardings"]


def init_moe_params(rng, d_model, d_ff, num_experts, dtype=torch.float32):
    """A dict of CPU tensors: gate [D, E], per-expert FFN stacks w1 [E, D,
    F], b1 [E, F], w2 [E, F, D], b2 [E, D], drawn from RandomState(rng) as
    the JAX package draws them."""
    r = np.random.RandomState(rng)
    s1 = (2.0 / (d_model + d_ff)) ** 0.5

    def t(a):
        return torch.as_tensor(a).to(dtype)

    return {
        "gate": t(r.randn(d_model, num_experts).astype("float32") * 0.02),
        "w1": t(r.randn(num_experts, d_model, d_ff).astype("float32") * s1),
        "b1": torch.zeros((num_experts, d_ff), dtype=dtype),
        "w2": t(r.randn(num_experts, d_ff, d_model).astype("float32") * s1),
        "b2": torch.zeros((num_experts, d_model), dtype=dtype),
    }


MoEParams = dict  # alias for annotation clarity


def moe_shardings(mesh, axis="model"):
    """The DTensor placements (one per mesh axis) of each MoE leaf: the
    expert (leading) dim of w1 / b1 / w2 / b2 on `axis` (legacy 'ep'
    accepted), the gate replicated."""
    from .mesh import P, canonical_axis, named_sharding

    e = P(canonical_axis(axis))
    return {
        "gate": named_sharding(mesh, P()),
        "w1": named_sharding(mesh, e),
        "b1": named_sharding(mesh, e),
        "w2": named_sharding(mesh, e),
        "b2": named_sharding(mesh, e),
    }


def _one_hot(idx, n, dtype):
    return torch.nn.functional.one_hot(idx, n).to(dtype)


def moe_ffn(params, x, capacity_factor=1.25, k=2, compute_dtype=None, expert_shard=None):
    """Top-k gated MoE FFN -> (y, aux_loss). x: [..., D] (leading dims
    flattened to tokens); y has x's shape; aux_loss is GShard's
    load-balance loss.

    compute_dtype: the AMP dtype of the two expert einsums; routing,
    its bookkeeping and the aux loss run in the input dtype.

    expert_shard: None, or (first, count): params["w1"] / "b1" / "w2" /
    "b2" hold experts [first, first + count) of E = params["gate"].shape[1],
    and y is this rank's partial sum over them (the caller sums the
    partials over the ranks)."""
    orig_shape = x.shape
    d = orig_shape[-1]
    tokens = x.reshape(-1, d)
    n = tokens.shape[0]
    e = params["gate"].shape[1]
    cap = max(1, int(n * capacity_factor * k / e))

    logits = tokens @ params["gate"]  # [N, E]
    probs = torch.softmax(logits, dim=-1)

    combine = torch.zeros((n, e, cap), dtype=tokens.dtype, device=tokens.device)
    remaining = probs
    # position counters per expert accumulate across the k routing rounds
    fill = torch.zeros((e,), dtype=torch.int32, device=tokens.device)
    frac_routed = torch.zeros((e,), dtype=probs.dtype, device=tokens.device)
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)  # [N]
        gate = torch.take_along_dim(remaining, idx[:, None], dim=-1)[:, 0]
        onehot = _one_hot(idx, e, tokens.dtype)  # [N, E]
        frac_routed = frac_routed + torch.mean(onehot, dim=0)
        # position of each token within its expert's buffer
        pos = (torch.cumsum(onehot, dim=0) - onehot) + fill[None, :]
        pos_t = torch.sum(pos * onehot, dim=-1).to(torch.int32)  # [N]
        keep = pos_t < cap
        gate = gate * keep.to(gate.dtype)
        # a position past the capacity has no one-hot column (jax.nn.one_hot)
        pos_onehot = _one_hot(torch.where(keep, pos_t, cap).long(), cap + 1,
                              tokens.dtype)[:, :cap]
        combine = combine + gate[:, None, None] * (onehot[:, :, None] * pos_onehot[:, None, :])
        fill = fill + torch.sum(onehot * keep[:, None].to(onehot.dtype), dim=0).to(torch.int32)
        remaining = remaining * (1.0 - onehot)  # mask the chosen expert

    # renormalize the k gates per token (GShard normalizes top-k probs)
    denom = torch.sum(combine, dim=(1, 2), keepdim=True)
    combine = combine / torch.clamp(denom, min=1e-9)

    if expert_shard is not None:
        first, count = expert_shard
        combine = combine[:, first:first + count]
    dispatch = (combine > 0).to(tokens.dtype)
    expert_in = torch.einsum("nec,nd->ecd", dispatch, tokens)
    cd = compute_dtype or tokens.dtype
    h = torch.relu(
        torch.einsum("ecd,edf->ecf", expert_in.to(cd), params["w1"].to(cd))
        + params["b1"].to(cd)[:, None, :]
    )
    expert_out = (
        torch.einsum("ecf,efd->ecd", h, params["w2"].to(cd))
        + params["b2"].to(cd)[:, None, :]
    ).to(tokens.dtype)
    y = torch.einsum("nec,ecd->nd", combine, expert_out)

    # load-balance aux loss (Shazeer/GShard): E * sum_e f_e * p_e
    mean_prob = torch.mean(probs, dim=0)
    aux = e * torch.sum((frac_routed / k) * mean_prob)
    return y.reshape(orig_shape), aux
