"""Dense flash attention: the CUDA kernel's launcher and, beside it, its
plain PyTorch version.

``flash_attn`` (``csrc/flash_attn.cu``) is the port of
``repro.kernels.flash_attn.flash_attn``: the dense (B, Lq) attention of
the (L, B) grid step (causal, per-row query offsets, over gathered
caches) and of an encoder layer (non-causal, with per-row key lengths),
optionally banded by a sliding window.  The launcher takes CUDA tensors
only and raises on anything its kernel does not take;
``flash_attn_plain`` (``kernels/ref.py``) computes the same function
with plain tensor ops.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ragged_prefill import (_DTYPES, HEAD_DIMS,
                                                check_kernel_inputs, launch)
from repro_torch.kernels.ref import \
    ref_flash_attn as flash_attn_plain  # noqa: F401

MAX_REP = 8                     # query heads per KV group


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_offsets: torch.Tensor, kv_lengths: torch.Tensor, *,
               causal: bool = True,
               window: Optional[int] = None) -> torch.Tensor:
    """Launch the dense flash attention kernel on the current stream.

    q: (B, Lq, Hq, D); k, v: (B, S, Hkv, D), row b reading cache row b;
    q_offsets, kv_lengths: (B,) int32, all on the card; D in
    ``HEAD_DIMS``, Hq / Hkv <= ``MAX_REP``.  Query i of row b sits at
    q_offsets[b] + i and attends keys p < kv_lengths[b] (p <= its
    position if ``causal``, p > its position - ``window`` if given).
    Returns (B, Lq, Hq, D) in q's dtype, zeros on rows with no valid
    key.  Never synchronises and never reads a device tensor back to the
    host.
    """
    check_kernel_inputs(q, k, v, q_offsets, kv_lengths, max_rep=MAX_REP)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Lq, Hq, D): {tuple(q.shape)}")
    b, lq, hq, d = q.shape
    _, s, hkv, _ = k.shape
    if k.shape[0] != b or q_offsets.shape != (b,) \
            or kv_lengths.shape != (b,):
        raise ValueError("k, v must be (B, S, Hkv, D) and q_offsets, "
                         "kv_lengths (B,) with q's B")
    if window is not None and window < 1:
        raise ValueError(f"window {window}: must be >= 1 (or None)")
    out = torch.empty_like(q)
    if b == 0 or lq == 0:
        return out
    launch("flash_attn",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), q_offsets.data_ptr(),
           kv_lengths.data_ptr(), out.data_ptr(), b, lq, s, hq, hkv, d,
           int(causal), window or 0, _DTYPES[q.dtype],
           torch.cuda.current_stream(q.device).cuda_stream)
    flash_attn.launches += 1
    return out


flash_attn.launches = 0
