"""AdamW with fp32 master weights, from ``repro.optim.adamw``.

The optimizer state mirrors the parameter tree: fp32 ``m``, ``v`` and
``master`` leaves and an int ``count``.  Compute params stay in the
model dtype; the update runs in fp32 per leaf, in the reference's order
of operations, so an update from the same inputs agrees to fp32
rounding.  One difference: the reference returns new state buffers
(its jitted step donates the old ones), while ``adamw_update`` updates
``m``, ``v`` and ``master`` IN PLACE, which keeps one copy of the state
on the card (a second would be 12 B a parameter more).  The reference's
update is XLA, not a Pallas kernel, and so is this one: plain tensor
ops.

Trees are nested dicts and lists of tensors; leaves are visited in the
order ``jax.tree.leaves`` visits the reference's tree (dict keys
sorted), so sums over leaves (the global norm) add in the same order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves of a nested dict / list tree in ``jax.tree.leaves``
    order: dict keys sorted, lists in index order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of each
    tree of ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(tree: Any, leaves) -> Any:
    """``leaves``, given in :func:`tree_leaves` order, put back in
    ``tree``'s structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(tree)


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio·lr, in fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Any) -> Dict:
    """Zero fp32 ``m`` and ``v``, an fp32 ``master`` copy of the params
    (a copy, never a view, also for fp32 params) and ``count`` 0."""
    dev = tree_leaves(params)[0].device
    return {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params),
        "master": tree_map(lambda p: p.detach().to(torch.float32,
                                                   copy=True), params),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: Any) -> torch.Tensor:
    total = None
    for g in tree_leaves(tree):
        s = torch.sum(torch.square(g.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Any, state: Dict, cfg: AdamWConfig,
                 param_dtype=torch.float32) -> Tuple[Any, Dict, Dict]:
    """One AdamW step.  Returns (new params in ``param_dtype``, the
    state, {"lr", "grad_norm"}).  ``state``'s ``m``, ``v`` and
    ``master`` are updated in place and returned in a new dict with the
    new ``count``; the params are a fresh copy of the master (never an
    alias, also in fp32).  ``grads`` are read, never written."""
    count = state["count"] + 1
    lr = lr_schedule(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=count.device),
                          count.to(torch.float32))
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=count.device),
                          count.to(torch.float32))

    flat = zip(tree_leaves(grads), tree_leaves(state["m"]),
               tree_leaves(state["v"]), tree_leaves(state["master"]))
    for g, m, v, p in flat:
        g = g.to(torch.float32) * scale
        # m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2, each product
        # rounded before the sum as in the reference
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
        step = m / b1c
        step.div_(torch.sqrt(v / b2c).add_(cfg.eps))
        step.add_(cfg.weight_decay * p)
        p.sub_(step.mul_(lr))
        del g, step
    new_state = {"m": state["m"], "v": state["v"],
                 "master": state["master"], "count": count}
    params = tree_map(lambda p: p.to(param_dtype, copy=True),
                      new_state["master"])
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
