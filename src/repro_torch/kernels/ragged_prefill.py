"""Paged ragged prefill attention: the CUDA kernel's launcher and, beside
it, its plain PyTorch version.

``ragged_prefill_paged`` launches ``csrc/ragged_prefill_paged.cu``, the
port of ``repro.kernels.ragged_prefill.ragged_prefill_paged``.  It takes
CUDA tensors only and raises on anything the kernel does not take;
``ragged_prefill_paged_plain`` (``ref.ref_ragged_prefill_paged``)
computes the same function with plain tensor ops.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import \
    ref_ragged_prefill_paged as ragged_prefill_paged_plain  # noqa: F401

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_paged_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       page_table: torch.Tensor, *index: torch.Tensor,
                       max_rep: int) -> None:
    """Raise ValueError on anything the paged CUDA kernels do not take:
    tensors off the card or on two devices, dtypes other than fp32/bf16
    (int32 tables), mismatched shapes, non-contiguous memory, or pools
    not 16-byte aligned."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {dev}")
    for name, x in [("k", k), ("v", v), ("page_table", page_table)] + [
            (f"index{i}", x) for i, x in enumerate(index)]:
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, q on {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: "
                         "the kernel takes float32 or bfloat16, all alike")
    if page_table.dtype != torch.int32 or any(
            x.dtype != torch.int32 for x in index):
        raise ValueError("page table and index vectors must be int32")
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"pools must be (N, page_size, Hkv, D): "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    hq, d = q.shape[-2], q.shape[-1]
    hkv = k.shape[2]
    if k.shape[3] != d or d != 128:
        raise ValueError(f"head_dim {d} (pool {k.shape[3]}): the kernels "
                         "take 128, the head_dim of every config served")
    if hq % hkv or hq // hkv > max_rep:
        raise ValueError(f"{hq} query heads over {hkv} KV heads: needs "
                         f"Hq % Hkv == 0 and Hq / Hkv <= {max_rep}")
    if page_table.dim() != 2:
        raise ValueError("page_table must be (B, P_max)")
    for name, x in [("q", q), ("k", k), ("v", v),
                    ("page_table", page_table)] + [
            (f"index{i}", x) for i, x in enumerate(index)]:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k/v pools must start on a 16-byte boundary "
                         "(the kernels load 16-byte vectors)")


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
    cu_seqlens[-1].  Never synchronises and never reads a device tensor
    back to the host.
    """
    if window is not None:
        raise NotImplementedError(
            "windowed (ring-table) prefill is not ported yet "
            "(ROADMAP Queue 1, item 10)")
    if not causal:
        raise NotImplementedError(
            "non-causal (encoder-only) prefill is not on the serving path")
    check_paged_inputs(q, k, v, page_table, cu_seqlens, q_offsets,
                       kv_lengths, max_rep=32)
    t, hq, d = q.shape
    n_pages, ps, hkv, _ = k.shape
    b, p_max = page_table.shape
    if cu_seqlens.shape != (b + 1,) or q_offsets.shape != (b,) \
            or kv_lengths.shape != (b,):
        raise ValueError("cu_seqlens must be (B+1,), q_offsets and "
                         "kv_lengths (B,)")
    out = torch.empty_like(q)
    if t == 0:
        return out
    launch = _build.launcher("ragged_prefill_paged")
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 page_table.data_ptr(), cu_seqlens.data_ptr(),
                 q_offsets.data_ptr(), kv_lengths.data_ptr(), out.data_ptr(),
                 t, hq, hkv, d, ps, b, p_max, _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"ragged_prefill_paged launch failed: CUDA "
                           f"error {err}")
    ragged_prefill_paged.launches += 1
    return out


ragged_prefill_paged.launches = 0
