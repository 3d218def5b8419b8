"""Dispatch for the kernels, shaped like ``repro.kernels.ops``.

The dispatch follows the tensor's device and nothing else: a CUDA tensor
reaches the hand-written CUDA kernel (which raises on what it does not
take), a CPU tensor the plain PyTorch version.  Nothing is caught and
nothing falls back; there is no backend switch.

The serving kernels have no backward kernels, as the Pallas kernels
they port define no VJP: each of their CUDA branches first runs
``check_no_grad``, which raises where autograd would record the call,
rather than return a result cut off from the graph.  The two kernels of
the training forward have one: under grad with an input that requires
grad, ``mha`` (every attention layer) goes through
``flash_attn.FlashAttnFn`` (the forward kernel, then the
``flash_attn_bwd`` kernels) and ``ssd_grouped`` (every SSD layer)
through ``ssd_scan.SSDScanFn`` (the forward's training form, then the
``ssd_scan_bwd`` kernels).  The plain versions differentiate.

A meta tensor takes the CUDA branch: each launcher allocates the
outputs and workspace it would on the card, by shape, and launches
nothing (the dry run's footprint is the kernels', not the plain
versions' score matrices).  DTensors (a step under sharding rules) go
to ``distributed.local``: ``mha``, ``decode`` and ``ssd_grouped`` run
the same dispatch on each rank's local shards through ``local_map``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import decode_attn as _decode
from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import ragged_prefill as _prefill
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sampling as _sampling
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.sampling import MAX_BIAS  # noqa: F401  (re-export)

# every hand-written kernel by name → its launcher, whose ``launches``
# counts the launches it made (a step graph adds its captured launches
# at each replay, ``serving/graphs.py``)
LAUNCHERS = {
    "ragged_prefill_paged": _prefill.ragged_prefill_paged,
    "decode_attn_paged": _decode.decode_attn_paged,
    "decode_attn_arena": _decode.decode_attn_arena,
    "ragged_prefill_arena": _prefill.ragged_prefill_arena,
    "ragged_prefill_attn": _prefill.ragged_prefill_attn,
    "fused_sample": _sampling.fused_sample,
    "ssd_scan": _ssd.ssd_scan,
    "flash_attn": _flash.flash_attn,
    "decode_attn": _decode.decode_attn,
    # the training forms of flash_attn: a forward launch that writes the
    # log-sum-exp (counts here and in flash_attn's own count) and the
    # backward kernels' launches (one a call)
    "flash_attn@lse": _flash.flash_attn.lse,
    "flash_attn_bwd": _flash.flash_attn_bwd,
    # the training forms of ssd_scan: a forward launch that writes the
    # chunk states (counts here and in ssd_scan's own count) and the
    # backward kernels' launches (one a call)
    "ssd_scan@states": _ssd.ssd_scan.states,
    "ssd_scan_bwd": _ssd.ssd_scan_bwd,
    # the windowed forms (ring tables, rolling slots): each windowed
    # launch counts here and in its kernel's own count
    "ragged_prefill_paged@window": _prefill.ragged_prefill_paged.window,
    "decode_attn_paged@window": _decode.decode_attn_paged.window,
    "ragged_prefill_arena@window": _prefill.ragged_prefill_arena.window,
    "decode_attn_arena@window": _decode.decode_attn_arena.window,
    # the non-causal form of the three ragged prefill kernels: each
    # non-causal launch counts here and in its kernel's own count
    "ragged_prefill_paged@nc": _prefill.ragged_prefill_paged.noncausal,
    "ragged_prefill_arena@nc": _prefill.ragged_prefill_arena.noncausal,
    "ragged_prefill_attn@nc": _prefill.ragged_prefill_attn.noncausal,
    # the paged prefill's TMA-fed core (``ragged_prefill.tma_core``):
    # each launch that took it counts here and in the kernel's own count
    "ragged_prefill_paged@tma": _prefill.ragged_prefill_paged.tma,
    # the SSD scan with B/C in several groups of several heads each:
    # each such launch counts here and in the kernel's own count
    "ssd_scan@grouped": _ssd.ssd_scan.grouped,
    # the six paged, arena and gathered attention kernels by head width:
    # each launch at width d counts here and in its kernel's own count
    **{f"{fn.__name__}@d{d}": fn.width[d]
       for fn in (_prefill.ragged_prefill_paged, _decode.decode_attn_paged,
                  _decode.decode_attn_arena, _prefill.ragged_prefill_arena,
                  _prefill.ragged_prefill_attn, _decode.decode_attn)
       for d in _prefill.HEAD_DIMS},
}


def _no_device(fn: str, dev: torch.device):
    return RuntimeError(f"{fn}: no implementation for tensors on {dev}")


def check_no_grad(fn: str, *inputs) -> None:
    """Raise RuntimeError when grad mode is on and any tensor of
    ``inputs`` requires grad: kernel ``fn`` writes its output through a
    raw pointer, so autograd would get a result with no ``grad_fn`` and
    no error.  The serving kernels have no backward kernel; run under
    ``torch.no_grad()`` or on tensors that do not require grad."""
    if not torch.is_grad_enabled():
        return
    if any(isinstance(x, torch.Tensor) and x.requires_grad for x in inputs):
        raise RuntimeError(
            f"{fn}: the CUDA kernel has no backward kernel yet (ROADMAP "
            "item 15b), and an input requires grad; call it under "
            "torch.no_grad() or on tensors that do not require grad")


def mha(q, k, v, q_offsets=None, kv_lengths=None, *, causal=True,
        window: Optional[int] = None) -> torch.Tensor:
    """Dense prefill / re-prefill attention, and an encoder layer's.
    q: (B, Lq, Hq, D); k, v: (B, S, Hkv, D); q_offsets: (B,) position of
    each row's first query (None = 0); kv_lengths: (B,) valid KV entries
    (None = S).  On the card, under grad mode with an input that
    requires grad, the call goes through ``FlashAttnFn`` (the kernel
    writes its log-sum-exp and the backward is the ``flash_attn_bwd``
    kernels); otherwise it is the plain launch."""
    if isinstance(q, DTensor):
        from repro_torch.distributed import local
        return local.mha(q, k, v, q_offsets, kv_lengths, causal=causal,
                         window=window)
    b, s = k.shape[0], k.shape[1]
    if q_offsets is None:
        q_offsets = torch.zeros((b,), dtype=torch.int32, device=q.device)
    if kv_lengths is None:
        kv_lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if q.is_meta or q.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (q, k, v)):
            return _flash.FlashAttnFn.apply(q, k, v, q_offsets, kv_lengths,
                                            causal, window)
        return _flash.flash_attn(q, k, v, q_offsets, kv_lengths,
                                 causal=causal, window=window)
    if q.device.type == "cpu":
        return _flash.flash_attn_plain(q, k, v, q_offsets, kv_lengths,
                                       causal=causal, window=window)
    raise _no_device("mha", q.device)


def ragged_mha(q, k, v, cu_seqlens, q_offsets=None, kv_lengths=None, *,
               causal=True) -> torch.Tensor:
    """Packed padding-free prefill attention over gathered caches.
    q: (T, Hq, D) flat stream; k, v: (B, S, Hkv, D), segment b reading
    row b."""
    b, s = k.shape[0], k.shape[1]
    if q_offsets is None:
        q_offsets = torch.zeros((b,), dtype=torch.int32, device=q.device)
    if kv_lengths is None:
        kv_lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if q.is_meta or q.device.type == "cuda":
        check_no_grad("ragged_mha", q, k, v)
        return _prefill.ragged_prefill_attn(q, k, v, cu_seqlens, q_offsets,
                                            kv_lengths, causal=causal)
    if q.device.type == "cpu":
        return _prefill.ragged_prefill_attn_plain(
            q, k, v, cu_seqlens, q_offsets, kv_lengths, causal=causal)
    raise _no_device("ragged_mha", q.device)


def ragged_mha_arena(q, k, v, slot_map, cu_seqlens, q_offsets=None,
                     kv_lengths=None, *, causal=True,
                     window: Optional[int] = None) -> torch.Tensor:
    """Slot-arena packed prefill attention.  q: (T, Hq, D) flat stream;
    k, v: (N_slots, S_max, Hkv, D) full arenas; slot_map: (B,) arena
    slot per segment."""
    b = slot_map.shape[0]
    if q_offsets is None:
        q_offsets = torch.zeros((b,), dtype=torch.int32, device=q.device)
    if kv_lengths is None:
        kv_lengths = torch.full((b,), k.shape[1], dtype=torch.int32,
                                device=q.device)
    if q.is_meta or q.device.type == "cuda":
        check_no_grad("ragged_mha_arena", q, k, v)
        return _prefill.ragged_prefill_arena(
            q, k, v, slot_map, cu_seqlens, q_offsets, kv_lengths,
            causal=causal, window=window)
    if q.device.type == "cpu":
        return _prefill.ragged_prefill_arena_plain(
            q, k, v, slot_map, cu_seqlens, q_offsets, kv_lengths,
            causal=causal, window=window)
    raise _no_device("ragged_mha_arena", q.device)


def ragged_mha_paged(q, k, v, page_table, cu_seqlens, q_offsets=None,
                     kv_lengths=None, *, causal=True,
                     window: Optional[int] = None) -> torch.Tensor:
    """Paged packed prefill attention.  q: (T, Hq, D) flat stream;
    k, v: (N_pages, page_size, Hkv, D) page pools; page_table: (B, P_max)
    physical page per logical block — pages may be shared between
    segments (prefix reuse, COW forks)."""
    b, p_max = page_table.shape
    if q_offsets is None:
        q_offsets = torch.zeros((b,), dtype=torch.int32, device=q.device)
    if kv_lengths is None:
        kv_lengths = torch.full((b,), k.shape[1] * p_max, dtype=torch.int32,
                                device=q.device)
    if q.is_meta or q.device.type == "cuda":
        check_no_grad("ragged_mha_paged", q, k, v)
        return _prefill.ragged_prefill_paged(
            q, k, v, page_table, cu_seqlens, q_offsets, kv_lengths,
            causal=causal, window=window)
    if q.device.type == "cpu":
        return _prefill.ragged_prefill_paged_plain(
            q, k, v, page_table, cu_seqlens, q_offsets, kv_lengths,
            causal=causal, window=window)
    raise _no_device("ragged_mha_paged", q.device)


def decode(q, k, v, lengths, *, return_lse: bool = False):
    """Single-token decode attention over gathered caches.  q: (B, Hq,
    D); k, v: (B, S, Hkv, D), row b reading cache row b; lengths: (B,)
    valid KV entries.  ``return_lse``: also each query head's
    log-sum-exp of its scaled scores, (B, Hq) fp32, -inf on a row with
    no key (a local call's; not over DTensors)."""
    if isinstance(q, DTensor):
        if return_lse:
            raise ValueError("decode over DTensors returns no lse")
        from repro_torch.distributed import local
        return local.decode(q, k, v, lengths)
    if q.is_meta or q.device.type == "cuda":
        check_no_grad("decode", q, k, v)
        return _decode.decode_attn(q, k, v, lengths, return_lse=return_lse)
    if q.device.type == "cpu":
        out = _decode.decode_attn_plain(q, k, v, lengths)
        if not return_lse:
            return out
        lens = lengths.long()
        lse = _ref.ref_flash_attn_lse(q[:, None], k, lens - 1, lens)[..., 0]
        return out, lse
    raise _no_device("decode", q.device)


def decode_arena(q, k, v, slot_map, lengths, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """Slot-arena single-token decode attention.  q: (B, Hq, D);
    k, v: (N_slots, S_max, Hkv, D) full arenas; slot_map, lengths:
    (B,)."""
    if q.is_meta or q.device.type == "cuda":
        check_no_grad("decode_arena", q, k, v)
        return _decode.decode_attn_arena(q, k, v, slot_map, lengths,
                                         window=window)
    if q.device.type == "cpu":
        return _decode.decode_attn_arena_plain(q, k, v, slot_map, lengths,
                                               window=window)
    raise _no_device("decode_arena", q.device)


def decode_paged(q, k, v, page_table, lengths, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """Paged single-token decode attention.  q: (B, Hq, D); k, v:
    (N_pages, page_size, Hkv, D) page pools; page_table: (B, P_max);
    lengths: (B,)."""
    if q.is_meta or q.device.type == "cuda":
        check_no_grad("decode_paged", q, k, v)
        return _decode.decode_attn_paged(q, k, v, page_table, lengths,
                                         window=window)
    if q.device.type == "cpu":
        return _decode.decode_attn_paged_plain(q, k, v, page_table, lengths,
                                               window=window)
    raise _no_device("decode_paged", q.device)


def fused_sample(logits, temp, top_k, top_p, bias_ids, bias_vals, u, draft):
    """Fused on-device sampling: bias → temperature → exact top-k →
    tie-inclusive top-p → inverse-CDF draw per (R, V) logits row, plus
    p(draft) and the residual resample.  The per-row inputs may be host
    arrays.  Returns (token (R,) int32, p_draft (R,) float32, alt (R,)
    int32) on ``logits``' device."""
    if logits.is_meta or logits.device.type == "cuda":
        check_no_grad("fused_sample", logits, temp, top_k, top_p, bias_ids,
                      bias_vals, u, draft)
        return _sampling.fused_sample(logits, temp, top_k, top_p, bias_ids,
                                      bias_vals, u, draft)
    if logits.device.type == "cpu":
        return _sampling.fused_sample_plain(logits, temp, top_k, top_p,
                                            bias_ids, bias_vals, u, draft)
    raise _no_device("fused_sample", logits.device)


def ssd_grouped(x, dt, a, bg, cg, init_state=None, *, chunk=128):
    """Chunked SSD scan with B/C in group form, the mamba layer's entry.
    x: (B, L, NH, HD); dt: (B, L, NH) float32 post-softplus; a: (NH,)
    negative; bg, cg: (B, L, G, DS), NH % G == 0; init_state: (B, NH, HD,
    DS) float32 or None (zeros).  Returns (y (B, L, NH, HD) in x's dtype,
    final state (B, NH, HD, DS) float32).  On the card, under grad mode
    with an input that requires grad, the call goes through
    ``SSDScanFn`` (the kernel writes its chunk states and the backward
    is the ``ssd_scan_bwd`` kernels); otherwise it is the plain
    launch."""
    if isinstance(x, DTensor):
        from repro_torch.distributed import local
        return local.heads_local(
            lambda *t: ssd_grouped(*t, chunk=chunk), x, dt, a, bg, cg,
            init_state)
    if init_state is None:
        b, _, nh, hd = x.shape
        init_state = torch.zeros((b, nh, hd, bg.shape[-1]),
                                 dtype=torch.float32, device=x.device)
    if x.is_meta or x.device.type == "cuda":
        args = (x, dt.float().contiguous(), a.float().contiguous(), bg, cg,
                init_state.float().contiguous())
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, dt, a, bg, cg, init_state)):
            return _ssd.SSDScanFn.apply(*args, chunk)
        return _ssd.ssd_scan(*args, chunk=chunk)
    if x.device.type == "cpu":
        return _ssd.ssd_scan_plain(x, dt, a, bg, cg, init_state,
                                   chunk=chunk)
    raise _no_device("ssd", x.device)


def ssd(x, dt, a, bmat, cmat, init_state, *, chunk=128):
    """Chunked SSD scan with per-head B/C (B, L, NH, DS), shaped like
    ``repro.kernels.ops.ssd``: the group form with G == NH."""
    return ssd_grouped(x, dt, a, bmat, cmat, init_state, chunk=chunk)
