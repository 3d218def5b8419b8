"""Training step of the port, from ``repro.training.train_step``: the
(optionally rematerialised) forward, microbatch gradient accumulation
and the AdamW update.

The reference scans its microbatches with an fp32 grad carry under
``jax.lax.scan``; here each microbatch runs forward then backward
(``torch.autograd.grad`` over the param leaves, so no ``.grad`` is
kept) and adds its grads into an accumulator of ``grad_dtype``, then the
sum is divided by the number of microbatches and AdamW updates the
state.  Activations exist for one microbatch at a time.

Under sharding rules (``distributed.use_rules`` with a mesh) params,
optimizer state and batch are DTensors and so are the accumulators
(``zeros_like``); ``constrain_grads`` pins the accumulator to the
params' placements after each microbatch (``constrain_tree`` over
``param_axes``), or once after the loop when False, as the reference.
The loss over vocab-sharded logits takes each shard's log-sum-exp terms
and gold logit (``cross_entropy``).

On the card every attention layer's forward is the ``flash_attn``
kernel and its backward the ``flash_attn_bwd`` kernels
(``kernels.flash_attn.FlashAttnFn``); every SSD layer's forward is
``ssd_scan``'s training form and its backward the ``ssd_scan_bwd``
kernels (``kernels.ssd_scan.SSDScanFn``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import constrain_tree
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     tree_leaves, tree_map, tree_unflatten)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (B, L, V) any dtype, fp32 math:
    the logsumexp minus the gold logit, averaged over ``mask`` where
    given.  Over DTensor logits whose vocab is sharded, each shard takes
    its part of the log-sum-exp and the gold logit and the backward stays
    on the shards (``distributed.local.token_nll``)."""
    logits = logits.to(torch.float32)
    if isinstance(logits, DTensor):
        from repro_torch.distributed import local
        nll = local.token_nll(logits, labels)
        # per-shard sums: the backward keeps each shard's gradient local
        if mask is None:
            return local.total(nll) / nll.numel()
        mask = local.as_dtensor(mask.to(torch.float32), nll.device_mesh)
        return local.total(nll * mask) / torch.clamp(local.total(mask),
                                                     min=1.0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def make_loss_fn(cfg: ModelConfig, *, remat: bool = True,
                 aux_weight: float = 0.01) -> Callable:
    """loss_fn(params, tokens, labels, embeds=None) → (loss + aux_weight
    · MoE aux, loss).  Labels < 0 are masked out (none are for an
    encoder-only config, as in the reference)."""
    def loss_fn(params, tokens, labels, embeds=None):
        logits, aux = tr.forward(
            params, cfg, tokens=tokens if embeds is None else None,
            embeds=embeds, remat=remat, return_aux=True)
        mask = None if cfg.is_encoder_only else (labels >= 0)
        labels = torch.clamp(labels, min=0)
        loss = cross_entropy(logits, labels, mask)
        return loss + aux_weight * aux, loss

    return loss_fn


def _on(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    accum: int = 1, remat: bool = True,
                    with_embeds: bool = False,
                    grad_dtype=torch.float32,
                    constrain_grads: bool = True) -> Callable:
    """Returns train_step(params, opt_state, batch) → (params, opt_state,
    metrics).  batch: {"tokens": (A, B, L) or "embeds": (A, B, L, D),
    "labels": (A, B, L)} (numpy arrays or tensors) with A = accumulation
    steps; metrics {"loss", "lr", "grad_norm"} are 0-d tensors on the
    params' device (nothing is read back to the host).

    grad_dtype: the accumulator's dtype (the update still runs in
    fp32).  The optimizer state is updated in place
    (``adamw_update``); the params come back as new tensors.
    constrain_grads: pin the accumulator to the params' placements
    inside the microbatch loop (False: once after it); a no-op without
    sharding rules."""
    loss_fn = make_loss_fn(cfg, remat=remat)
    axes = tr.param_axes(cfg)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        dev = leaves[0].device
        acc = [torch.zeros_like(p, dtype=grad_dtype) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        labels = _on(batch["labels"], dev)
        xs = _on(batch["embeds" if with_embeds else "tokens"], dev)
        for a in range(accum):
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            live_leaves = tree_leaves(live)
            with torch.enable_grad():
                if with_embeds:
                    tot, loss = loss_fn(live, None, labels[a],
                                        embeds=xs[a])
                else:
                    tot, loss = loss_fn(live, xs[a], labels[a])
                # a leaf the loss never reads (the token embedding of a
                # run on embeddings) gets no grad: its accumulator stays
                # 0, as the reference's grad of it is 0
                grads = torch.autograd.grad(tot, live_leaves,
                                            allow_unused=True)
            for s, g in zip(acc, grads):
                if g is not None:
                    s.add_(g)             # upcast inside the add
            if constrain_grads:
                acc = _pin(params, acc, axes)
            loss_sum = loss_sum + loss.detach()
            del live, live_leaves, grads, tot, loss
        if not constrain_grads:
            acc = _pin(params, acc, axes)
        for s in acc:
            s.div_(accum)
        grads = tree_unflatten(params, acc)
        params, opt_state, om = adamw_update(grads, opt_state, opt_cfg,
                                             param_dtype=cfg.torch_dtype)
        return params, opt_state, {"loss": loss_sum / accum, **om}

    return train_step


def _pin(params, acc, axes):
    """The accumulator leaves pinned to the params' logical placements
    (``constrain_tree``; the same list back without rules)."""
    pinned = constrain_tree(tree_unflatten(params, acc), axes)
    return tree_leaves(pinned)


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     device="cuda") -> Tuple[Any, Dict]:
    params = tr.init_params(cfg, seed=seed, device=device)
    return params, adamw_init(params)
