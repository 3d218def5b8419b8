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

Under sharding rules with a batch axis of size S > 1 that divides the
step's T rows (``_data_shards``), the capacity dispatch is shard-local,
as the reference's: each of the S shards sorts and packs its own T / S
rows with a capacity counted over them, so which pairs drop follows
the shards.  The dispatch and combine run on each shard's tokens and
the expert products on each rank's experts (``distributed.local``).
Without rules (the serving engine, one card) S is 1.  Both forms are
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
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import constrain, current_rules


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
    gates = torch.zeros((x2d.shape[0], p["router"].shape[-1]),
                        dtype=torch.float32, device=x.device)
    gates = gates.scatter_add(1, experts, weights)
    if isinstance(x2d, DTensor):
        from repro_torch.distributed import local
        y = local.expert_ffn(_gated_experts, x2d, p["wg"], p["wi"],
                             p["wo"], gates)
    else:
        y = _gated_experts(x2d, p["wg"], p["wi"], p["wo"], gates)
    return y.reshape(x.shape).to(x.dtype), aux


def _gated_experts(x2d, wg, wi, wo, gates):
    """Every expert of (wg, wi, wo) on every row of x2d (T, d), summed
    with the rows' gates (T, E) in fp32: (T, d)."""
    # the expert products as batched matmuls over E, which read each
    # expert stack in place (einsum's "td,edf->tef" permutes and copies
    # the stack first: 3x the bytes of a decode step)
    xb = x2d[None]                                             # (1, T, d)
    h = torch.matmul(xb, wg)                                   # (E, T, F)
    g = F.silu(h) * torch.matmul(xb, wi)
    y_all = torch.matmul(g, wo)                                # (E, T, d)
    return torch.einsum("te,etd->td", gates, y_all.float())


def _data_shards(t: int) -> int:
    """The batch (pod x data) shards the T rows are split over under the
    current rules: the axis' size when it divides T, else 1 — dispatch
    stays local to a shard, so the sort and scatter never cross
    devices."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return 1
    s = rules.axis_size(rules.rules.get("batch"))
    return s if s > 1 and t % s == 0 else 1


def moe_layer(p: Dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-dispatch MoE over x (..., d): every row of x, pads
    included, counts toward the capacity C, as in the reference, per
    batch shard (``_data_shards``).  Returns (y like x, aux)."""
    d = x.shape[-1]
    e = p["router"].shape[-1]
    x2d = x.reshape(-1, d)
    t = x2d.shape[0]
    weights, experts, aux = _routing(p, x2d, top_k)
    s = _data_shards(t)
    tl = t // s
    cap = max(1, int(math.ceil(tl * top_k / e * capacity_factor)))

    def stack(parts):      # one shard (the serving engine's): a view
        return parts[0][None] if len(parts) == 1 else torch.stack(parts)

    def dispatch(xs, ws, es):
        out = [_dispatch_one(xs[i], ws[i], es[i], e, cap)
               for i in range(xs.shape[0])]
        return tuple(stack(z) for z in zip(*out))

    def experts_ffn(buf, wg, wi, wo):
        # batched matmuls over E: each reads its expert stack in place
        h = torch.matmul(buf, wg)                            # (S, E, C, F)
        g = F.silu(h) * torch.matmul(buf, wi)
        return torch.matmul(g, wo)                           # (S, E, C, d)

    def combine(y_exp, dest, s_tok, s_w):
        return stack([_combine_one(y_exp[i], dest[i], s_tok[i], s_w[i],
                                   tl, top_k)
                      for i in range(y_exp.shape[0])])

    x3 = constrain(x2d.reshape(s, tl, d), "batch", None, "embed_act")
    w3, e3 = weights.reshape(s, tl, top_k), experts.reshape(s, tl, top_k)
    if isinstance(x3, DTensor):
        from repro_torch.distributed import local
        buf, dest, s_tok, s_w = local.moe_dispatch(dispatch, x3, w3, e3)
        buf = constrain(buf, "batch", "experts", None, "embed_act")
        y_exp = local.expert_ffn(experts_ffn, buf, p["wg"], p["wi"],
                                 p["wo"])
        y_exp = constrain(y_exp, "batch", "experts", None, "embed_act")
        y = local.moe_combine(combine, y_exp, dest, s_tok, s_w)
        y = constrain(y, "batch", None, "embed_act")
    else:
        buf, dest, s_tok, s_w = dispatch(x3, w3, e3)
        y = combine(experts_ffn(buf, p["wg"], p["wi"], p["wo"]), dest,
                    s_tok, s_w)
    return y.reshape(x.shape).to(x.dtype), aux


def _dispatch_one(x2d, weights, experts, e: int, cap: int):
    """One shard's dispatch: its (token, k) pairs sorted by expert
    (stable) and packed into an (E, C, d) buffer.  Returns (buffer,
    dest (T·k,) — each sorted pair's buffer row, E·C if dropped — its
    token, its gate weight, 0 if dropped)."""
    t, top_k = experts.shape
    d = x2d.shape[-1]
    dev = x2d.device
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
    buf = torch.zeros((e * cap + 1, d), dtype=x2d.dtype, device=dev)
    buf[dest] = x2d[sorted_token]          # dropped pairs: the junk row
    return (buf[:e * cap].reshape(e, cap, d), dest, sorted_token,
            flat_weight[order] * keep)


def _combine_one(y_exp, dest, sorted_token, s_w, t: int, top_k: int):
    """One shard's combine: each token's k expert outputs weighted by
    their gates, added in the sorted (expert-ascending) order one after
    another from zero, in the model dtype.  Returns (t, d)."""
    e, cap, d = y_exp.shape
    dev = y_exp.device
    y_flat = torch.cat([y_exp.reshape(e * cap, d),
                        torch.zeros((1, d), dtype=y_exp.dtype, device=dev)])
    contrib = y_flat[dest] * s_w[:, None].to(y_flat.dtype)    # sorted order
    # each sorted pair's place, token by token
    order = torch.argsort(sorted_token, stable=True)
    at = order.reshape(t, top_k)
    y = torch.zeros((t, d), dtype=y_flat.dtype, device=dev)
    for j in range(top_k):
        y = y + contrib[at[:, j]]
    return y
