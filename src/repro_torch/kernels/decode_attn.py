"""Paged decode attention: the CUDA kernel's launcher and, beside it, its
plain PyTorch version.

``decode_attn_paged`` launches ``csrc/decode_attn_paged.cu``, the port
of ``repro.kernels.decode_attn.decode_attn_paged``.  It takes CUDA
tensors only and raises on anything the kernel does not take;
``decode_attn_paged_plain`` (``ref.ref_decode_attn_paged``) computes the
same function with plain tensor ops.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ragged_prefill import _DTYPES, check_paged_inputs
from repro_torch.kernels.ref import \
    ref_decode_attn_paged as decode_attn_paged_plain  # noqa: F401


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
    if window is not None:
        raise NotImplementedError(
            "windowed (ring-table) decode is not ported yet "
            "(ROADMAP Queue 1, item 10)")
    check_paged_inputs(q, k, v, page_table, lengths, max_rep=8)
    b, hq, d = q.shape
    n_pages, ps, hkv, _ = k.shape
    p_max = page_table.shape[1]
    if page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError("page_table must be (B, P_max) and lengths (B,)")
    out = torch.empty_like(q)
    if b == 0:
        return out
    launch = _build.launcher("decode_attn_paged")
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 b, hq, hkv, d, ps, p_max, _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attn_paged launch failed: CUDA error "
                           f"{err}")
    decode_attn_paged.launches += 1
    return out


decode_attn_paged.launches = 0
