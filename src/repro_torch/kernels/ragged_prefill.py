"""Ragged prefill attention: the CUDA kernels' launchers and, beside
each, its plain PyTorch version.

Three kernels share one body (``csrc/ragged_prefill.cuh``) and differ in
where a segment's keys live:

- ``ragged_prefill_paged`` (``csrc/ragged_prefill_paged.cu``): a page
  pool read through a page table, the port of
  ``repro.kernels.ragged_prefill.ragged_prefill_paged``;
- ``ragged_prefill_arena`` (``csrc/ragged_prefill_arena.cu``): the slot
  arena read in place through a slot map, the port of
  ``repro.kernels.ragged_prefill.ragged_prefill_arena``;
- ``ragged_prefill_attn`` (``csrc/ragged_prefill_attn.cu``): a gathered
  per-segment cache, segment b reading row b, the port of
  ``repro.kernels.ragged_prefill.ragged_prefill_attn``.

Each takes ``causal=`` as the TPU kernels do: causal, every row attends
its segment's keys up to its own position; non-causal, every held key of
its segment below its kv length.  The paged and arena kernels also take
``window=``, the TPU kernels' windowed forms over a ring page table and
rolling slots.

Each launcher takes CUDA tensors only and raises on anything its kernel
does not take; the ``*_plain`` functions (``kernels/ref.py``) compute the
same functions with plain tensor ops.  Each counts its launches in
``launches``, a windowed launch also in ``window.launches``, a
non-causal launch also in ``noncausal.launches``, and a launch at head
width d also in ``width[d].launches``.

The paged kernel has two cores.  A call with no window, in bf16, at head
width 128, over pages of 8, 16, 32 or 64 tokens (``tma_core``: what both
served models run) takes the TMA-fed core (``csrc/attn_tma.cuh``), whose
producer warp streams whole pages of K and V by TMA; every other call
takes the ``cp.async`` tile core (``csrc/attn_tiles.cuh``).  The C side
chooses by the same rule; ``ragged_prefill_paged.tma.launches`` counts
the calls that took the TMA-fed core.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import \
    ref_ragged_prefill as ragged_prefill_attn_plain  # noqa: F401
from repro_torch.kernels.ref import \
    ref_ragged_prefill_arena as ragged_prefill_arena_plain  # noqa: F401
from repro_torch.kernels.ref import \
    ref_ragged_prefill_paged as ragged_prefill_paged_plain  # noqa: F401

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head widths every attention kernel takes: every width of the
# reference's configs
HEAD_DIMS = (64, 80, 96, 128)


# the devices a launcher takes: the card, and the meta device, on which
# it allocates its outputs and workspace by shape and launches nothing
ON_CARD = ("cuda", "meta")


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *index: torch.Tensor, max_rep: int) -> None:
    """Raise ValueError on anything the attention kernels do not take:
    tensors off the card or on two devices, dtypes other than fp32/bf16
    (int32 tables and index vectors), K/V storage that is not
    (N, rows, Hkv, D) alike with D in ``HEAD_DIMS``, GQA groups wider
    than ``max_rep``, non-contiguous memory, or q/K/V not 16-byte
    aligned.  Meta tensors pass: on them a launcher allocates what it
    would on the card and launches nothing (the dry run's footprint)."""
    dev = q.device
    if dev.type not in ON_CARD:
        raise ValueError(f"CUDA kernel called with a tensor on {dev}")
    named = [("k", k), ("v", v)] + [(f"index{i}", x)
                                    for i, x in enumerate(index)]
    for name, x in named:
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, q on {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: "
                         "the kernel takes float32 or bfloat16, all alike")
    if any(x.dtype != torch.int32 for x in index):
        raise ValueError("page tables, slot maps and index vectors must "
                         "be int32")
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"K/V must be (N, rows, Hkv, D) alike: "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    hq, d = q.shape[-2], q.shape[-1]
    hkv = k.shape[2]
    if k.shape[3] != d or d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} (K/V {k.shape[3]}): the kernel "
                         f"takes {' or '.join(map(str, HEAD_DIMS))}")
    if hq % hkv or hq // hkv > max_rep:
        raise ValueError(f"{hq} query heads over {hkv} KV heads: needs "
                         f"Hq % Hkv == 0 and Hq / Hkv <= {max_rep}")
    for name, x in [("q", q)] + named:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("q, K and V must start on a 16-byte boundary "
                         "(the kernels copy 16-byte vectors)")


def _check_segments(n_seqs: int, cu_seqlens: torch.Tensor,
                    q_offsets: torch.Tensor,
                    kv_lengths: torch.Tensor) -> None:
    if cu_seqlens.shape != (n_seqs + 1,) or q_offsets.shape != (n_seqs,) \
            or kv_lengths.shape != (n_seqs,):
        raise ValueError("cu_seqlens must be (B+1,), q_offsets and "
                         "kv_lengths (B,)")


def window_arg(window: Optional[int]) -> int:
    """The C launchers' window argument: 0 for none, else the width,
    which must be >= 1."""
    if window is None:
        return 0
    if window < 1:
        raise ValueError(f"window {window}: must be >= 1 (or None)")
    return int(window)


# page sizes the TMA-fed core takes: whole pages, 64 // page_size of them
# a 64-key step, each box 8-row aligned for the 128-byte swizzle
TMA_PAGE_SIZES = (8, 16, 32, 64)


def tma_core(dtype: torch.dtype, head_dim: int, page_size: int,
             window: Optional[int]) -> bool:
    """Whether a ``ragged_prefill_paged`` call takes the TMA-fed core
    (``csrc/attn_tma.cuh``; ``attn::tma_core`` states the same rule): no
    window, bf16, head width 128 and a page size in ``TMA_PAGE_SIZES``.
    Read from the call's own tensors and arguments."""
    return (window_arg(window) == 0 and dtype == torch.bfloat16
            and head_dim == 128 and page_size in TMA_PAGE_SIZES)


class LaunchCount:
    """The launch counter of a kernel's windowed or non-causal form, of
    one of its head widths, or of the paged kernel's TMA-fed core."""

    def __init__(self) -> None:
        self.launches = 0


def width_counts() -> Dict[int, LaunchCount]:
    """A launcher's counters by head width, one for each of HEAD_DIMS."""
    return {d: LaunchCount() for d in HEAD_DIMS}


def _facts(name: str, symbol: str, *args: int) -> Dict[str, int]:
    """Call kernel library ``name``'s C function ``symbol`` with ``args``
    and an int[3] it fills: shared bytes a block, registers a thread,
    blocks resident per SM."""
    out = (ctypes.c_int * 3)()
    fn = _build.function(name, symbol,
                         (ctypes.c_int,) * len(args) + (ctypes.c_void_p,))
    err = fn(*args, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")
    return dict(zip(("smem", "regs", "blocks_per_sm"), out))


def launch_info(name: str, head_dim: int,
                dtype: torch.dtype) -> Dict[str, int]:
    """The launch facts of the paged kernel ``name``
    (``ragged_prefill_paged`` or ``decode_attn_paged``, the split
    kernel) at ``head_dim`` and ``dtype`` on this card: shared bytes a
    block, registers a thread, blocks resident per SM.  Needs the
    card."""
    return _facts(name, f"{name}_info", head_dim, _DTYPES[dtype])


def tma_launch_info() -> Dict[str, int]:
    """The launch facts of ``ragged_prefill_paged``'s TMA-fed kernel
    (bf16, head width 128) on this card, as ``launch_info``.  Needs the
    card."""
    return _facts("ragged_prefill_paged", "ragged_prefill_paged_tma_info")


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C launcher with ``args`` (pointers, sizes,
    dtype code, stream; see ``_build.SIGNATURES``) and raise if the
    launch was refused."""
    err = _build.launcher(name)(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def ragged_prefill_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         page_table: torch.Tensor, cu_seqlens: torch.Tensor,
                         q_offsets: torch.Tensor, kv_lengths: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the paged ragged prefill kernel on the current stream.

    q: (T, Hq, D); k, v: (N_pages, page_size, Hkv, D) page pools (one
    layer's slice of the stacked pool); page_table: (B, P_max) int32;
    cu_seqlens: (B+1,), q_offsets, kv_lengths: (B,) int32, all on the
    card.  Returns (T, Hq, D) in q's dtype, zeros on rows past
    cu_seqlens[-1].  Causal, each row of segment b attends the keys at
    positions <= its own (q_offsets[b] + its row in the segment) and <
    kv_lengths[b]; non-causal (``causal=False``), every key < kv_lengths[b].
    ``window`` selects the ring-table form: the table is a ring over its
    P_max entries, position p on entry (p // ps) % P_max, and each row
    attends the held keys in (its position − window, its position] —
    non-causal, every held key above its position − window.  A call for
    which ``tma_core`` holds runs on the TMA-fed core.  Never
    synchronises and never reads a device tensor back to the host.
    """
    w = window_arg(window)
    check_kernel_inputs(q, k, v, page_table, cu_seqlens, q_offsets,
                        kv_lengths, max_rep=32)
    if page_table.dim() != 2:
        raise ValueError("page_table must be (B, P_max)")
    t, hq, d = q.shape
    n_pages, ps, hkv, _ = k.shape
    b, p_max = page_table.shape
    _check_segments(b, cu_seqlens, q_offsets, kv_lengths)
    out = torch.empty_like(q)
    if t == 0 or q.is_meta:
        return out
    launch("ragged_prefill_paged",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), page_table.data_ptr(),
           cu_seqlens.data_ptr(), q_offsets.data_ptr(), kv_lengths.data_ptr(),
           out.data_ptr(), t, hq, hkv, d, ps, n_pages, b, p_max, int(causal),
           w, _DTYPES[q.dtype],
           torch.cuda.current_stream(q.device).cuda_stream)
    ragged_prefill_paged.launches += 1
    ragged_prefill_paged.tma.launches += tma_core(q.dtype, d, ps, window)
    ragged_prefill_paged.noncausal.launches += not causal
    ragged_prefill_paged.window.launches += bool(w)
    ragged_prefill_paged.width[d].launches += 1
    return out


def ragged_prefill_arena(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         slot_map: torch.Tensor, cu_seqlens: torch.Tensor,
                         q_offsets: torch.Tensor, kv_lengths: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the slot-arena ragged prefill kernel on the current stream.

    q: (T, Hq, D); k, v: (N_slots, S_max, Hkv, D) — one layer's slice of
    the arena, with this step's new KV already written at each token's
    (slot, position); slot_map: (B,) arena slot of each segment (pad
    segments name any live slot); cu_seqlens: (B+1,), q_offsets,
    kv_lengths: (B,) int32, all on the card.  Returns (T, Hq, D) in q's
    dtype, zeros on rows past cu_seqlens[-1] and on rows of segments
    with no valid key.  Causal, each row attends its segment's keys up to
    its own position; non-causal (``causal=False``), every key below its
    segment's kv length.  ``window`` selects the rolling form: each slot
    a rolling cache of depth S_max (position p at row p % S_max, pads on
    the scratch slot), each row attending the held keys in (its position
    − window, its position] — non-causal, every held key above its
    position − window.  Never synchronises.
    """
    w = window_arg(window)
    check_kernel_inputs(q, k, v, slot_map, cu_seqlens, q_offsets,
                        kv_lengths, max_rep=32)
    t, hq, d = q.shape
    n_slots, s_max, hkv, _ = k.shape
    b = slot_map.shape[0]
    if slot_map.dim() != 1:
        raise ValueError("slot_map must be (B,)")
    _check_segments(b, cu_seqlens, q_offsets, kv_lengths)
    out = torch.empty_like(q)
    if t == 0 or q.is_meta:
        return out
    launch("ragged_prefill_arena",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_map.data_ptr(),
           cu_seqlens.data_ptr(), q_offsets.data_ptr(), kv_lengths.data_ptr(),
           out.data_ptr(), t, hq, hkv, d, s_max, b, int(causal), w,
           _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    ragged_prefill_arena.launches += 1
    ragged_prefill_arena.noncausal.launches += not causal
    ragged_prefill_arena.window.launches += bool(w)
    ragged_prefill_arena.width[d].launches += 1
    return out


def ragged_prefill_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cu_seqlens: torch.Tensor, q_offsets: torch.Tensor,
                        kv_lengths: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Launch the batch-cache ragged prefill kernel on the current
    stream.

    q: (T, Hq, D); k, v: (B, S, Hkv, D) gathered per-segment caches,
    segment b reading row b; cu_seqlens: (B+1,), q_offsets, kv_lengths:
    (B,) int32, all on the card.  Returns (T, Hq, D) in q's dtype, zeros
    on rows past cu_seqlens[-1] and on rows of segments with no valid
    key.  Causal, each row attends its segment's keys up to its own
    position; non-causal (``causal=False``), every key below its
    segment's kv length.  Never synchronises.
    """
    check_kernel_inputs(q, k, v, cu_seqlens, q_offsets, kv_lengths,
                        max_rep=32)
    t, hq, d = q.shape
    b, s, hkv, _ = k.shape
    _check_segments(b, cu_seqlens, q_offsets, kv_lengths)
    out = torch.empty_like(q)
    if t == 0 or q.is_meta:
        return out
    launch("ragged_prefill_attn",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), cu_seqlens.data_ptr(),
           q_offsets.data_ptr(), kv_lengths.data_ptr(), out.data_ptr(),
           t, hq, hkv, d, s, b, int(causal), _DTYPES[q.dtype],
           torch.cuda.current_stream(q.device).cuda_stream)
    ragged_prefill_attn.launches += 1
    ragged_prefill_attn.noncausal.launches += not causal
    ragged_prefill_attn.width[d].launches += 1
    return out


ragged_prefill_paged.launches = 0
ragged_prefill_paged.noncausal = LaunchCount()
ragged_prefill_paged.window = LaunchCount()
ragged_prefill_paged.width = width_counts()
ragged_prefill_paged.tma = LaunchCount()
ragged_prefill_arena.launches = 0
ragged_prefill_arena.noncausal = LaunchCount()
ragged_prefill_arena.window = LaunchCount()
ragged_prefill_arena.width = width_counts()
ragged_prefill_attn.launches = 0
ragged_prefill_attn.noncausal = LaunchCount()
ragged_prefill_attn.width = width_counts()
