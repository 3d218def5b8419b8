"""Decode attention: the CUDA kernels' launchers and, beside each, its
plain PyTorch version.

Three kernels share one body (``csrc/decode_attn.cuh``) and differ in
where a row's keys live:

- ``decode_attn`` (``csrc/decode_attn_dense.cu``): a gathered batch
  cache, row b reading cache row b, the port of
  ``repro.kernels.decode_attn.decode_attn`` (the dense decode step);
- ``decode_attn_paged`` (``csrc/decode_attn_paged.cu``): a page pool
  read through a page table, the port of
  ``repro.kernels.decode_attn.decode_attn_paged``;
- ``decode_attn_arena`` (``csrc/decode_attn_arena.cu``): the slot arena
  read in place through a slot map, the port of
  ``repro.kernels.decode_attn.decode_attn_arena``.

Each launcher takes CUDA tensors only and raises on anything its kernel
does not take; the ``*_plain`` functions (``kernels/ref.py``) compute the
same functions with plain tensor ops.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ragged_prefill import (_DTYPES, check_kernel_inputs,
                                                launch)
from repro_torch.kernels.ref import \
    ref_decode_attn as decode_attn_plain  # noqa: F401
from repro_torch.kernels.ref import \
    ref_decode_attn_arena as decode_attn_arena_plain  # noqa: F401
from repro_torch.kernels.ref import \
    ref_decode_attn_paged as decode_attn_paged_plain  # noqa: F401


def _refuse(window: Optional[int]) -> None:
    if window is not None:
        raise NotImplementedError(
            "windowed decode (ring tables, rolling slots) is not ported "
            "yet (ROADMAP Queue 1, item 10)")


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """Launch the batch-cache decode kernel on the current stream.

    q: (B, Hq, D); k, v: (B, S, Hkv, D) gathered caches with each row's
    new KV already written, row b reading cache row b; lengths: (B,)
    int32 valid cache entries including the new row, all on the card.
    Returns (B, Hq, D) in q's dtype, zeros on rows with ``lengths ==
    0``.  Never synchronises.
    """
    check_kernel_inputs(q, k, v, lengths, max_rep=8)
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    if k.shape[0] != b or lengths.shape != (b,):
        raise ValueError("k, v must be (B, S, Hkv, D) and lengths (B,) "
                         "with q's B")
    out = torch.empty_like(q)
    if b == 0:
        return out
    launch("decode_attn_dense",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
           out.data_ptr(), b, hq, hkv, d, s, _DTYPES[q.dtype],
           torch.cuda.current_stream(q.device).cuda_stream)
    decode_attn.launches += 1
    return out


def decode_attn_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      page_table: torch.Tensor, lengths: torch.Tensor, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """Launch the paged decode kernel on the current stream.

    q: (B, Hq, D); k, v: (N_pages, page_size, Hkv, D) page pools (one
    layer's slice of the stacked pool); page_table: (B, P_max) int32;
    lengths: (B,) int32 valid cache entries, all on the card.  Returns
    (B, Hq, D) in q's dtype, zeros on rows with ``lengths == 0``.  Never
    synchronises and never reads a device tensor back to the host.
    """
    _refuse(window)
    check_kernel_inputs(q, k, v, page_table, lengths, max_rep=8)
    b, hq, d = q.shape
    n_pages, ps, hkv, _ = k.shape
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError("page_table must be (B, P_max) and lengths (B,)")
    p_max = page_table.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    launch("decode_attn_paged",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), page_table.data_ptr(),
           lengths.data_ptr(), out.data_ptr(), b, hq, hkv, d, ps, p_max,
           _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    decode_attn_paged.launches += 1
    return out


def decode_attn_arena(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      slot_map: torch.Tensor, lengths: torch.Tensor, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """Launch the slot-arena decode kernel on the current stream.

    q: (B, Hq, D); k, v: (N_slots, S_max, Hkv, D) — one layer's slice of
    the arena, with each row's new KV already written; slot_map: (B,)
    int32 arena slot of each row; lengths: (B,) int32 valid cache
    entries including the new row, all on the card.  Returns (B, Hq, D)
    in q's dtype, zeros on rows with ``lengths == 0``.  Never
    synchronises.
    """
    _refuse(window)
    check_kernel_inputs(q, k, v, slot_map, lengths, max_rep=8)
    b, hq, d = q.shape
    n_slots, s_max, hkv, _ = k.shape
    if slot_map.shape != (b,) or lengths.shape != (b,):
        raise ValueError("slot_map and lengths must be (B,)")
    out = torch.empty_like(q)
    if b == 0:
        return out
    launch("decode_attn_arena",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_map.data_ptr(),
           lengths.data_ptr(), out.data_ptr(), b, hq, hkv, d, s_max,
           _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    decode_attn_arena.launches += 1
    return out


decode_attn.launches = 0
decode_attn_paged.launches = 0
decode_attn_arena.launches = 0
