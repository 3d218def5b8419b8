"""Plain PyTorch versions of the attention kernels (the correctness
contract), ported from ``repro.kernels.ref``.

Each ``ref_*`` function computes the same math as its kernel with plain
tensor ops in fp32.  The CPU tests run them against the JAX oracles,
the serving stack takes them for tensors on the CPU, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _no_window(window: Optional[int]) -> None:
    if window is not None:
        raise NotImplementedError(
            "windowed attention (ring tables, rolling slots) is not "
            "ported yet (ROADMAP Queue 1, item 10)")


def ref_ragged_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cu_seqlens: torch.Tensor,
                       q_offsets: Optional[torch.Tensor] = None,
                       kv_lengths: Optional[torch.Tensor] = None, *,
                       causal: bool = True) -> torch.Tensor:
    """Packed padding-free prefill attention.

    q: (T, Hq, D) flat packed queries — sequence i owns rows
    [cu_seqlens[i], cu_seqlens[i+1]); k, v: (B, S, Hkv, D) per-sequence
    KV caches.  q_offsets: (B,) history length; kv_lengths: (B,) valid
    KV entries.  Rows beyond cu_seqlens[-1], and rows whose segment has
    no valid key, produce zeros (the JAX oracle averages junk there; the
    kernels, Pallas and CUDA alike, write 0).
    """
    t, hq, d = q.shape
    b, s, hkv = k.shape[0], k.shape[1], k.shape[2]
    rep = hq // hkv
    dev = q.device
    if q_offsets is None:
        q_offsets = torch.zeros((b,), dtype=torch.int32, device=dev)
    if kv_lengths is None:
        kv_lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    cu = cu_seqlens.long()
    rows = torch.arange(t, device=dev)
    seg = (rows[:, None] >= cu[None, 1:]).sum(dim=1)            # (T,)
    valid_row = rows < cu[-1]
    segc = seg.clamp(0, b - 1)
    qpos = q_offsets.long()[segc] + rows - cu[segc]              # (T,)
    kpos = torch.arange(s, device=dev)
    mask = segc[:, None, None] == torch.arange(b, device=dev)[None, :, None]
    mask = mask & valid_row[:, None, None]
    mask = mask & (kpos[None, None, :] < kv_lengths.long()[None, :, None])
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[:, None, None])
    qg = q.reshape(t, hkv, rep, d).float()
    scores = torch.einsum("tgrd,bsgd->tgrbs", qg, k.float())
    scores = scores / math.sqrt(d)
    scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    flat = scores.reshape(t, hkv, rep, b * s)
    probs = torch.softmax(flat, dim=-1).reshape(t, hkv, rep, b, s)
    out = torch.einsum("tgrbs,bsgd->tgrd", probs, v.float())
    # rows with no valid key (bucket tail past cu_seqlens[-1], empty
    # segments) → exactly 0, as the kernels give them
    has_key = mask.flatten(1).any(dim=1)
    out = out * has_key[:, None, None, None]
    return out.reshape(t, hq, d).to(q.dtype)


def ref_ragged_prefill_paged(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, page_table: torch.Tensor,
                             cu_seqlens: torch.Tensor,
                             q_offsets: Optional[torch.Tensor] = None,
                             kv_lengths: Optional[torch.Tensor] = None, *,
                             causal: bool = True,
                             window: Optional[int] = None) -> torch.Tensor:
    """Paged packed prefill attention.

    q: (T, Hq, D) flat packed stream; k, v: (N_pages, page_size, Hkv, D)
    full page pools; page_table: (B, P_max) physical page per logical
    page.  The gather here — materializing each segment's logical
    (P_max·ps)-deep cache from its pages — is this version's
    convenience; the kernel reads pages in place through the table.
    """
    _no_window(window)
    b, p_max = page_table.shape
    ps, hkv, d = k.shape[1], k.shape[2], k.shape[3]
    idx = page_table.long()
    kg = k[idx].reshape(b, p_max * ps, hkv, d)
    vg = v[idx].reshape(b, p_max * ps, hkv, d)
    return ref_ragged_prefill(q, kg, vg, cu_seqlens, q_offsets=q_offsets,
                              kv_lengths=kv_lengths, causal=causal)


def ref_ragged_prefill_arena(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, slot_map: torch.Tensor,
                             cu_seqlens: torch.Tensor,
                             q_offsets: Optional[torch.Tensor] = None,
                             kv_lengths: Optional[torch.Tensor] = None, *,
                             causal: bool = True,
                             window: Optional[int] = None) -> torch.Tensor:
    """Slot-arena packed prefill attention.

    q: (T, Hq, D) flat packed stream; k, v: (N_slots, S_max, Hkv, D)
    full arenas; slot_map: (B,) arena slot per segment.  The gather here
    is this version's convenience; the kernel indexes the slot axis in
    place.
    """
    _no_window(window)
    idx = slot_map.long()
    return ref_ragged_prefill(q, k[idx], v[idx], cu_seqlens,
                              q_offsets=q_offsets, kv_lengths=kv_lengths,
                              causal=causal)


def ref_decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention.

    q: (B, Hq, D); k, v: (B, S, Hkv, D); lengths: (B,) valid KV entries.
    Rows with ``lengths == 0`` produce zeros, as the kernels give them.
    """
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.long()[:, None])                          # (B, S)
    qg = q.reshape(b, hkv, rep, d).float()
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, k.float())
    scores = scores / math.sqrt(d)
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", probs, v.float())
    out = out * valid.any(dim=1)[:, None, None, None]   # lengths 0 → 0
    return out.reshape(b, hq, d).to(q.dtype)


def ref_decode_attn_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          page_table: torch.Tensor, lengths: torch.Tensor, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """Paged single-token decode attention.

    q: (B, Hq, D); k, v: (N_pages, page_size, Hkv, D) full page pools;
    page_table: (B, P_max); lengths: (B,) valid KV entries.  Gathers
    each row's pages into a contiguous logical cache and delegates.
    """
    _no_window(window)
    b, p_max = page_table.shape
    ps, hkv, d = k.shape[1], k.shape[2], k.shape[3]
    idx = page_table.long()
    kg = k[idx].reshape(b, p_max * ps, hkv, d)
    vg = v[idx].reshape(b, p_max * ps, hkv, d)
    return ref_decode_attn(q, kg, vg, lengths)


def ref_decode_attn_arena(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          slot_map: torch.Tensor, lengths: torch.Tensor, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """Slot-arena single-token decode attention.

    q: (B, Hq, D); k, v: (N_slots, S_max, Hkv, D) full arenas; slot_map:
    (B,) arena slot per row; lengths: (B,) valid KV entries.  The gather
    here is this version's convenience; the kernel indexes the slot axis
    in place.
    """
    _no_window(window)
    idx = slot_map.long()
    return ref_decode_attn(q, k[idx], v[idx], lengths)


FP32_TOL = 1e-4        # fp32 kernel vs plain version: summation order
U_BF16 = 2.0 ** -8     # unit roundoff of bfloat16


def kernel_error_bound(plain, dtype: torch.dtype, q: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor, *index):
    """The plain version ``plain`` run in fp32 on a kernel's inputs, and
    the elementwise bound on how far the kernel's output in ``dtype`` may
    lie from it.

    fp32: ``FP32_TOL``.  bf16: the kernels round p to bf16 before the PV
    product and round their output once, each a relative error of at
    most u = 2^-8, so ``|out - ref| <= u * (sum_j p_j |v_j| / l + |ref|)
    + FP32_TOL``; ``sum_j p_j |v_j| / l`` is the plain version run on
    ``|v|``.  A dropped or repeated key tile lies far outside it.
    Returns ``(ref, bound)``.
    """
    qf, kf, vf = q.float(), k.float(), v.float()
    ref = plain(qf, kf, vf, *index)
    if dtype == torch.float32:
        return ref, torch.full_like(ref, FP32_TOL)
    absv = plain(qf, kf, vf.abs(), *index)
    return ref, U_BF16 * (absv + ref.abs()) + FP32_TOL
