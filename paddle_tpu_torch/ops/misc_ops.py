"""Metric op lowerings: accuracy (paddle_tpu/ops/misc_ops.py:12-21); and
tree_conv (:493-553 there), which the dygraph TreeConv runs eagerly."""

from __future__ import annotations

import torch

from .registry import register_op


@register_op("accuracy", differentiable=False)
def _accuracy(ctx, op):
    """The share of rows whose label is among their top-k Indices [N, k]:
    Accuracy [1] float32, Correct and Total [1] int32."""
    indices = ctx.in_(op, "Indices")
    lbl = ctx.in_(op, "Label").to(torch.int32)
    if lbl.dim() == 2:
        lbl = lbl.squeeze(-1)
    hit = (indices.to(torch.int32) == lbl[:, None]).any(dim=1)
    ctx.out(op, "Accuracy", hit.float().mean().reshape(1))
    ctx.out(op, "Correct", hit.to(torch.int32).sum().to(torch.int32).reshape(1))
    # a fill on the device: a tensor copied from the host would wait for
    # the device to finish the step so far
    ctx.out(op, "Total", torch.full((1,), lbl.shape[0], dtype=torch.int32, device=lbl.device))


@register_op("tree_conv", no_grad_inputs=("EdgeSet",))
def _tree_conv(ctx, op):
    """Tree-based convolution (tree_conv_op.cc, TBCNN): each node's patch of
    its subtree to max_depth, weighted by the continuous left / right / top
    coefficients of math/tree2col.h, contracted with the [feat, 3, out,
    filters] filter. As the JAX package does it: three [N+1, N+1]
    coefficient matrices a tree from depth / child-index / sibling-count
    tensors, then matmuls. EdgeSet rows are 1-indexed (u, v), (0, 0)
    padding."""
    emb = ctx.in_(op, "NodesVector")  # [B, N, F]
    edges = ctx.in_(op, "EdgeSet").to(torch.int64)  # [B, E, 2]
    w = ctx.in_(op, "Filter")  # [F, 3, out, filters]
    max_depth = int(op.attr("max_depth", 2))
    _, n, feat = emb.shape
    fdim, _, osz, nf = w.shape
    w2 = w.reshape(fdim * 3, osz * nf)
    dev, f32 = emb.device, torch.float32

    def per_tree(e, x):
        u, v = e[:, 0], e[:, 1]
        live = (u > 0) & (v > 0)
        uu, vv = torch.where(live, u, 0), torch.where(live, v, 0)
        adj = torch.zeros((n + 1, n + 1), dtype=f32, device=dev)
        adj[uu, vv] = 1.0
        adj[:, 0] = 0.0
        adj[0, :] = 0.0
        # each child's 1-based index among its siblings, in edge order
        earlier = (u[None, :] == u[:, None]) & live[None, :] & live[:, None]
        idx_e = torch.tril(earlier).sum(1)
        child_idx = torch.zeros((n + 1,), dtype=f32, device=dev)
        child_idx[vv] = idx_e.to(f32)
        outdeg = adj.sum(1)
        parent = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
        parent[vv] = uu
        pclen = outdeg[parent]  # siblings, self included
        reach = torch.eye(n + 1, dtype=f32, device=dev)  # depth 0
        cl, cr, ct = (torch.zeros((n + 1, n + 1), dtype=f32, device=dev) for _ in range(3))
        d_f = float(max_depth)
        for d in range(max_depth):
            eta_t = (d_f - d) / d_f
            if d == 0:
                # the root's own entry: index 1 of 1
                el = (1.0 - eta_t) * 0.5
                er = (1.0 - eta_t) * (1.0 - el)
                cl, cr, ct = cl + reach * el, cr + reach * er, ct + reach * eta_t
            else:
                frac = torch.where(pclen <= 1.0, torch.full_like(pclen, 0.5),
                                   (child_idx - 1.0) / torch.clamp_min(pclen - 1.0, 1.0))
                el = (1.0 - eta_t) * frac
                # tree2col.h: eta_r = (1 - eta_t) * (1 - eta_l), eta_l
                # already carrying its (1 - eta_t)
                er = (1.0 - eta_t) * (1.0 - el)
                cl, cr = cl + reach * el[None, :], cr + reach * er[None, :]
                ct = ct + reach * eta_t
            reach = torch.clamp_max(reach @ adj, 1.0)
        x1 = torch.cat([torch.zeros((1, feat), dtype=x.dtype, device=dev), x], 0)
        pl, pr, pt = (cl @ x1)[1:], (cr @ x1)[1:], (ct @ x1)[1:]
        patch = torch.stack([pl, pr, pt], 2).reshape(n, feat * 3)
        return (patch @ w2).reshape(n, osz, nf)

    ctx.out(op, "Out", torch.stack([per_tree(edges[i], emb[i]) for i in range(emb.shape[0])]))
