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

The body splits each row's key walk over the whole card: one block per
(key chunk, KV head, row), fp32 partials in a workspace, and a combine
kernel that merges them.  ``split_plan`` is where the chunks come from,
for the three launchers alike and for the CPU rehearsal of the split
(``tests/test_torch_decode_split.py``): it reads shapes and the SM count
only, never ``lengths``, so a launch reads nothing back from the card
and can be captured in a CUDA graph.

The paged and arena kernels also take ``window=``, the TPU kernels'
windowed forms over a ring page table and rolling slots: each row's key
walk covers its newest min(window, depth, length) keys, and the plan
spans min(depth, window) keys.

Each launcher takes CUDA tensors only and raises on anything its kernel
does not take; the ``*_plain`` functions (``kernels/ref.py``) compute the
same functions with plain tensor ops.  Each counts its launches in
``launches``, a windowed launch also in ``window.launches``, and a
launch at head width d also in ``width[d].launches``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.ragged_prefill import (_DTYPES, LaunchCount,
                                                check_kernel_inputs, launch,
                                                width_counts, window_arg)
from repro_torch.kernels.ref import \
    ref_decode_attn as decode_attn_plain  # noqa: F401
from repro_torch.kernels.ref import \
    ref_decode_attn_arena as decode_attn_arena_plain  # noqa: F401
from repro_torch.kernels.ref import \
    ref_decode_attn_paged as decode_attn_paged_plain  # noqa: F401


WARP_KEYS = 16          # keys a warp scores per tile (csrc kKT)
ROUND_KEYS = 64         # keys a block's 4 warps take per round (kRound)
MAX_CHUNK = 512         # keys per chunk at most
UNITS_PER_SM = 4        # (KV head, row, chunk) blocks asked of each SM


class SplitPlan(NamedTuple):
    chunk: int                    # keys per chunk, a multiple of ROUND_KEYS
    n_chunks: int                 # chunks per (row, KV head)
    workspace: Tuple[int, ...]    # fp32 partials, () with one chunk


def split_plan(n_rows: int, hq: int, hkv: int, head_dim: int,
               capacity: int, n_sms: int) -> SplitPlan:
    """How the decode kernels split each row's keys over the card.

    ``capacity`` is the most keys a row's walk can span (P_max *
    page_size, the arena's S_max, the batch cache's S; for a windowed
    call min(that, window), the keys the window can touch, as the TPU
    kernel streams (window − 1) // block_k + 2 blocks).  The chunk is
    the largest of
    MAX_CHUNK, MAX_CHUNK / 2, ... ROUND_KEYS keys that still gives at
    least UNITS_PER_SM blocks per SM over the full capacity, and no
    larger than the capacity rounded up to ROUND_KEYS.  A block whose
    chunk lies past its row's length writes an empty partial and exits,
    so the plan spans the capacity without knowing the lengths.  The
    workspace holds
    (acc[D], m, l, two pad floats) of every (row, KV head, chunk, query
    head of the group): (n_rows, hkv, n_chunks, hq // hkv, head_dim + 4);
    with one chunk the blocks write the output directly and it is
    ``()``."""
    cap = max(int(capacity), 1)
    chunk = MAX_CHUNK
    while chunk > ROUND_KEYS and \
            n_rows * hkv * -(-cap // chunk) < UNITS_PER_SM * n_sms:
        chunk //= 2
    chunk = min(chunk, -(-cap // ROUND_KEYS) * ROUND_KEYS)
    n_chunks = -(-cap // chunk)
    workspace = ((n_rows, hkv, n_chunks, hq // hkv, head_dim + 4)
                 if n_chunks > 1 else ())
    return SplitPlan(chunk, n_chunks, workspace)


# the SMs of an H100 SXM: the split a card would plan, for a launcher
# called on meta tensors
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the kernels whose C entry point takes an lse pointer after the workspace
_LSE_ARG = ("decode_attn_dense",)


def _launch_split(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, index: Tuple[torch.Tensor, ...],
                  layout: Tuple[int, ...], capacity: int,
                  window: Optional[int] = None,
                  lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plan the split, allocate the output and the workspace on q's
    device, and launch kernel ``name`` on the current stream.
    ``window``: the C launcher's window argument (0 = none; None: the
    kernel takes none); a window > 0 spans min(capacity, window) keys.
    ``lse``: a (B, Hq) fp32 tensor the kernel writes each query head's
    log-sum-exp into (kernels in ``_LSE_ARG`` only; None: not asked)."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    if window:
        capacity = min(capacity, window)
    n_sms = H100_SMS if q.is_meta else _sm_count(q.device.index)
    plan = split_plan(b, hq, hkv, d, capacity, n_sms)
    out = torch.empty_like(q)
    ws = (torch.empty(plan.workspace, dtype=torch.float32, device=q.device)
          if plan.workspace else None)
    if q.is_meta:
        return out
    lse_arg = (None if lse is None else lse.data_ptr(),) \
        if name in _LSE_ARG else ()
    launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           *(x.data_ptr() for x in index), out.data_ptr(),
           None if ws is None else ws.data_ptr(), *lse_arg, b, hq, hkv, d,
           *layout, plan.chunk, plan.n_chunks,
           *(() if window is None else (window,)), _DTYPES[q.dtype],
           torch.cuda.current_stream(q.device).cuda_stream)
    return out


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor, *, return_lse: bool = False):
    """Launch the batch-cache decode kernel on the current stream.

    q: (B, Hq, D); k, v: (B, S, Hkv, D) gathered caches with each row's
    new KV already written, row b reading cache row b; lengths: (B,)
    int32 valid cache entries including the new row, all on the card.
    Returns (B, Hq, D) in q's dtype, zeros on rows with ``lengths ==
    0``; with ``return_lse`` also (B, Hq) fp32, each query head's
    log-sum-exp of its scaled scores (``ref_flash_attn_lse``'s), -inf on
    rows with ``lengths == 0`` — the partial that a sequence-sharded
    cache's shards merge.  Never synchronises and never reads a device
    tensor back to the host.
    """
    check_kernel_inputs(q, k, v, lengths, max_rep=8)
    b = q.shape[0]
    s = k.shape[1]
    if k.shape[0] != b or lengths.shape != (b,):
        raise ValueError("k, v must be (B, S, Hkv, D) and lengths (B,) "
                         "with q's B")
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device) \
        if return_lse else None
    if b == 0:
        out = torch.empty_like(q)
        return (out, lse) if return_lse else out
    out = _launch_split("decode_attn_dense", q, k, v, (lengths,), (s,), s,
                        lse=lse)
    if not q.is_meta:
        decode_attn.launches += 1
        decode_attn.width[q.shape[-1]].launches += 1
    return (out, lse) if return_lse else out


def decode_attn_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      page_table: torch.Tensor, lengths: torch.Tensor, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """Launch the paged decode kernel on the current stream.

    q: (B, Hq, D); k, v: (N_pages, page_size, Hkv, D) page pools (one
    layer's slice of the stacked pool); page_table: (B, P_max) int32;
    lengths: (B,) int32 valid cache entries, all on the card.  Returns
    (B, Hq, D) in q's dtype, zeros on rows with ``lengths == 0``.
    ``window`` selects the ring-table form: each row attends its newest
    min(window, P_max * page_size, length) keys through entry (p // ps)
    % P_max.  Never synchronises and never reads a device tensor back to
    the host.
    """
    w = window_arg(window)
    check_kernel_inputs(q, k, v, page_table, lengths, max_rep=8)
    b = q.shape[0]
    ps = k.shape[1]
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError("page_table must be (B, P_max) and lengths (B,)")
    p_max = page_table.shape[1]
    if b == 0:
        return torch.empty_like(q)
    out = _launch_split("decode_attn_paged", q, k, v, (page_table, lengths),
                        (ps, p_max), p_max * ps, w)
    if q.is_meta:
        return out
    decode_attn_paged.launches += 1
    decode_attn_paged.window.launches += bool(w)
    decode_attn_paged.width[q.shape[-1]].launches += 1
    return out


def decode_attn_arena(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      slot_map: torch.Tensor, lengths: torch.Tensor, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """Launch the slot-arena decode kernel on the current stream.

    q: (B, Hq, D); k, v: (N_slots, S_max, Hkv, D) — one layer's slice of
    the arena, with each row's new KV already written; slot_map: (B,)
    int32 arena slot of each row; lengths: (B,) int32 valid cache
    entries including the new row, all on the card.  Returns (B, Hq, D)
    in q's dtype, zeros on rows with ``lengths == 0``.  ``window``
    selects the rolling form: each slot a rolling cache of depth S_max,
    each row attending its newest min(window, S_max, length) keys.
    Never synchronises and never reads a device tensor back to the host.
    """
    w = window_arg(window)
    check_kernel_inputs(q, k, v, slot_map, lengths, max_rep=8)
    b = q.shape[0]
    s_max = k.shape[1]
    if slot_map.shape != (b,) or lengths.shape != (b,):
        raise ValueError("slot_map and lengths must be (B,)")
    if b == 0:
        return torch.empty_like(q)
    out = _launch_split("decode_attn_arena", q, k, v, (slot_map, lengths),
                        (s_max,), s_max, w)
    if q.is_meta:
        return out
    decode_attn_arena.launches += 1
    decode_attn_arena.window.launches += bool(w)
    decode_attn_arena.width[q.shape[-1]].launches += 1
    return out


decode_attn.launches = 0
decode_attn.width = width_counts()
decode_attn_paged.launches = 0
decode_attn_paged.window = LaunchCount()
decode_attn_paged.width = width_counts()
decode_attn_arena.launches = 0
decode_attn_arena.window = LaunchCount()
decode_attn_arena.width = width_counts()
