"""Mixture-of-Experts FFN of the port, from ``repro.models.moe``: top-k
routing and its two execution forms.

  * ``moe_dense_reference`` runs every expert on every token and weighs
    the outputs by the top-k gates: O(E) FLOPs, the oracle, and the
    form the model takes for small steps (``transformer._ffn``).
  * ``moe_layer`` dispatches by capacity: the (token, k) pairs are
    sorted by expert (stable), packed into an (E, C, d) buffer with
    C = ceil(T·k / E · 1.25) counted over every row of the step, pads
    included, run through the expert products and combined.  A pair
    ranked >= C in its expert's group is dropped (its gate weight
    contributes nothing).

One shard: the reference's per-shard dispatch and its sharding
constraints have no counterpart on one card.  Both forms are
token-independent apart from the capacity, so a packed flat stream
feeds them as one (1, T, d) batch.

Ties: ``jax.lax.top_k`` keeps the lower expert index first on equal
probabilities, and so does the stable descending sort here;
``torch.topk`` promises no order.  The combine sums each token's k
contributions in the order the reference's scatter-add meets them
(expert-ascending) in the model dtype, with no atomics, so a step gives
the same bits every run and replays from a CUDA graph bit for bit.
Neither form syncs with the host: the capacity C is a function of the
step's shape, so a captured step keeps it at every replay.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def _routing(p: Dict, x2d: torch.Tensor, top_k: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router logits → (weights (T, k) fp32, experts (T, k) int64, the
    Switch-style load-balance aux loss E · sum_e f_e · P_e)."""
    logits = (x2d @ p["router"]).float()                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = top[:, :top_k], idx[:, :top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    e = logits.shape[-1]
    me = probs.mean(dim=0)                                     # mean prob
    ce = F.one_hot(experts[:, 0], e).float().mean(dim=0)       # top-1 share
    aux = e * (me * ce).sum()
    return weights, experts, aux


def moe_dense_reference(p: Dict, x: torch.Tensor, *, top_k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert on every token of x (..., d), combined with the
    top-k gate weights in fp32.  Returns (y like x, aux)."""
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    weights, experts, aux = _routing(p, x2d, top_k)
    # the expert products as batched matmuls over E, which read each
    # expert stack in place (einsum's "td,edf->tef" permutes and copies
    # the stack first: 3x the bytes of a decode step)
    xb = x2d[None]                                             # (1, T, d)
    h = torch.matmul(xb, p["wg"])                              # (E, T, F)
    g = F.silu(h) * torch.matmul(xb, p["wi"])
    y_all = torch.matmul(g, p["wo"])                           # (E, T, d)
    gates = torch.zeros((x2d.shape[0], p["router"].shape[-1]),
                        dtype=torch.float32, device=x.device)
    gates.scatter_add_(1, experts, weights)
    y = torch.einsum("te,etd->td", gates, y_all.float())
    return y.reshape(x.shape).to(x.dtype), aux


def moe_layer(p: Dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-dispatch MoE over x (..., d): every row of x, pads
    included, counts toward the capacity C, as in the reference.
    Returns (y like x, aux)."""
    d = x.shape[-1]
    e = p["router"].shape[-1]
    x2d = x.reshape(-1, d)
    t = x2d.shape[0]
    dev = x.device
    weights, experts, aux = _routing(p, x2d, top_k)
    cap = max(1, int(math.ceil(t * top_k / e * capacity_factor)))

    flat_expert = experts.reshape(-1)                           # (t·k,)
    flat_weight = weights.reshape(-1)
    flat_token = torch.arange(t, device=dev).repeat_interleave(top_k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    group_start = torch.searchsorted(sorted_expert,
                                     torch.arange(e, device=dev))
    ranks = torch.arange(t * top_k, device=dev) - group_start[sorted_expert]
    keep = ranks < cap
    dest = torch.where(keep, sorted_expert * cap + ranks,
                       torch.full_like(ranks, e * cap))
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    buf[dest] = x2d[sorted_token]          # dropped pairs: the junk row
    dispatched = buf[:e * cap].reshape(e, cap, d)

    # batched matmuls over E: each reads its expert stack in place
    h = torch.matmul(dispatched, p["wg"])                       # (E, C, F)
    g = F.silu(h) * torch.matmul(dispatched, p["wi"])
    y_exp = torch.matmul(g, p["wo"])                            # (E, C, d)

    y_flat = torch.cat([y_exp.reshape(e * cap, d),
                        torch.zeros((1, d), dtype=y_exp.dtype, device=dev)])
    s_w = flat_weight[order] * keep
    contrib = y_flat[dest] * s_w[:, None].to(y_flat.dtype)    # sorted order
    # each token's k contributions in the sorted (expert-ascending)
    # order, added one after another from zero
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * top_k, device=dev)
    at = inv.reshape(t, top_k).sort(dim=1).values
    y = torch.zeros((t, d), dtype=y_flat.dtype, device=dev)
    for j in range(top_k):
        y = y + contrib[at[:, j]]
    return y.reshape(x.shape).to(x.dtype), aux
