"""Dense flash attention: the CUDA kernels' launchers, their autograd
function and, beside them, their plain PyTorch versions.

``flash_attn`` (``csrc/flash_attn.cu``) is the port of
``repro.kernels.flash_attn.flash_attn``: the dense (B, Lq) attention of
the (L, B) grid step (causal, per-row query offsets, over gathered
caches), of an encoder layer (non-causal, with per-row key lengths) and
of every attention layer of the training forward, optionally banded by
a sliding window.  Asked for it, it also writes each query's
log-sum-exp, which its backward reads.

``flash_attn_bwd`` (``csrc/flash_attn_bwd.cu``) is that backward: dq,
dk and dv from q, k, v, the output, its log-sum-exp and the output's
gradient, in three kernels (delta, dK/dV per key tile, dQ per query
tile) with no float atomics, so two runs give the same bits.  In bf16
every product runs on the tensor cores (wgmma, P and dS rounded to
bf16 as their operands); fp32, the checking type, keeps CUDA-core
kernels.  It ports no TPU kernel: the reference differentiates XLA
attention, and the port's forward of the same layers is the kernel
above.  ``FlashAttnFn`` joins the two for autograd; ``ops.mha`` takes it
on the card when an input requires grad.

The launchers take CUDA tensors only and raise on anything their
kernels do not take; ``flash_attn_plain``, ``flash_attn_lse_plain`` and
``flash_attn_bwd_plain`` (``kernels/ref.py``) compute the same functions
with plain tensor ops.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ragged_prefill import (_DTYPES, HEAD_DIMS,  # noqa
                                                LaunchCount,
                                                check_kernel_inputs, launch)
from repro_torch.kernels.ref import \
    flash_attn_bwd_plain  # noqa: F401
from repro_torch.kernels.ref import \
    ref_flash_attn as flash_attn_plain  # noqa: F401
from repro_torch.kernels.ref import \
    ref_flash_attn_lse as flash_attn_lse_plain  # noqa: F401

MAX_REP = 8                     # query heads per KV group


def _check(q, k, v, q_offsets, kv_lengths, window):
    check_kernel_inputs(q, k, v, q_offsets, kv_lengths, max_rep=MAX_REP)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Lq, Hq, D): {tuple(q.shape)}")
    b = q.shape[0]
    if k.shape[0] != b or q_offsets.shape != (b,) \
            or kv_lengths.shape != (b,):
        raise ValueError("k, v must be (B, S, Hkv, D) and q_offsets, "
                         "kv_lengths (B,) with q's B")
    if window is not None and window < 1:
        raise ValueError(f"window {window}: must be >= 1 (or None)")


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_offsets: torch.Tensor, kv_lengths: torch.Tensor, *,
               causal: bool = True, window: Optional[int] = None,
               return_lse: bool = False):
    """Launch the dense flash attention kernel on the current stream.

    q: (B, Lq, Hq, D); k, v: (B, S, Hkv, D), row b reading cache row b;
    q_offsets, kv_lengths: (B,) int32, all on the card; D in
    ``HEAD_DIMS``, Hq / Hkv <= ``MAX_REP``.  Query i of row b sits at
    q_offsets[b] + i and attends keys p < kv_lengths[b] (p <= its
    position if ``causal``, p > its position - window if given).
    Returns (B, Lq, Hq, D) in q's dtype, zeros on rows with no valid
    key; with ``return_lse`` also each query's log-sum-exp of its
    scaled scores, (B, Hq, Lq) fp32, -inf on such rows (each such launch
    counts in ``flash_attn.lse`` too).  Never synchronises and never
    reads a device tensor back to the host.
    """
    _check(q, k, v, q_offsets, kv_lengths, window)
    b, lq, hq, d = q.shape
    _, s, hkv, _ = k.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if b and lq and not q.is_meta:
        launch("flash_attn",
               q.data_ptr(), k.data_ptr(), v.data_ptr(),
               q_offsets.data_ptr(), kv_lengths.data_ptr(), out.data_ptr(),
               lse.data_ptr() if return_lse else None, b, lq, s, hq, hkv,
               d, int(causal), window or 0, _DTYPES[q.dtype],
               torch.cuda.current_stream(q.device).cuda_stream)
        flash_attn.launches += 1
        flash_attn.lse.launches += return_lse
    return (out, lse) if return_lse else out


flash_attn.launches = 0
flash_attn.lse = LaunchCount()


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   q_offsets: torch.Tensor, kv_lengths: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None):
    """Launch the backward kernels of ``flash_attn`` on the current
    stream: (dq, dk, dv) like (q, k, v) from the forward's inputs, its
    output ``out`` and log-sum-exp ``lse`` (B, Hq, Lq) fp32, and the
    output's gradient ``dout`` (B, Lq, Hq, D), all contiguous on the
    card.  The same band as the forward; keys no query attends get 0.
    Deterministic: no float atomics.  Never synchronises."""
    _check(q, k, v, q_offsets, kv_lengths, window)
    b, lq, hq, d = q.shape
    _, s, hkv, _ = k.shape
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("out and dout must be like q")
    if lse.shape != (b, hq, lq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {hq}, {lq}) float32")
    for name, x in (("out", out), ("dout", dout), ("lse", lse)):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on q's device")
    if out.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("out and dout must start on a 16-byte boundary")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if b == 0 or lq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    if q.is_meta:
        return dq, dk, dv
    launch("flash_attn_bwd",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           dout.data_ptr(), lse.data_ptr(), q_offsets.data_ptr(),
           kv_lengths.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), delta.data_ptr(), b, lq, s, hq, hkv, d,
           int(causal), window or 0, _DTYPES[q.dtype],
           torch.cuda.current_stream(q.device).cuda_stream)
    flash_attn_bwd.launches += 1
    return dq, dk, dv


flash_attn_bwd.launches = 0


BWD_KERNELS = ("delta", "dkdv", "dq")
# keys a dK/dV block and query vectors a dQ block: bf16 (two warpgroups
# of 64 on the tensor cores), fp32 (the CUDA-core kernels)
BWD_TILE = {torch.bfloat16: 128, torch.float32: 64}


def bwd_launch_info(head_dim: int, dtype: torch.dtype
                    ) -> Dict[str, Dict[str, int]]:
    """The launch facts of ``flash_attn_bwd``'s three kernels at
    ``head_dim`` and ``dtype`` on this card: {kernel: {"smem": dynamic
    shared bytes a block, "regs": registers a thread, "blocks_per_sm":
    blocks resident per SM}}.  Needs the card."""
    out = (ctypes.c_int * 9)()
    fn = _build.function("flash_attn_bwd", "flash_attn_bwd_info",
                         (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    err = fn(head_dim, _DTYPES[dtype], ctypes.addressof(out))
    if err:
        raise RuntimeError(f"flash_attn_bwd_info failed: CUDA error {err}")
    keys = ("smem", "regs", "blocks_per_sm")
    return {k: dict(zip(keys, out[3 * i:3 * i + 3]))
            for i, k in enumerate(BWD_KERNELS)}


def bwd_grid(b: int, lq: int, s: int, hq: int, hkv: int,
             dtype: torch.dtype) -> Dict[str, int]:
    """Blocks of each backward kernel (256 threads each) for a (B, Lq,
    Hq) x (S, Hkv) call in ``dtype``: a warp per query vector, a block
    per (tile of ``BWD_TILE`` keys, KV head, row), a block per (tile of
    ``BWD_TILE`` / rep rows, KV head, row)."""
    tile = BWD_TILE[dtype]
    rows = tile // (hq // hkv)
    return {"delta": -(-b * lq * hq // 8),
            "dkdv": -(-s // tile) * hkv * b,
            "dq": -(-lq // rows) * hkv * b}


class FlashAttnFn(torch.autograd.Function):
    """``flash_attn`` with its backward kernel: the forward launches
    the kernel with its log-sum-exp and saves q, k, v, the output, the
    log-sum-exp, the offsets and the lengths; the backward launches
    ``flash_attn_bwd`` and returns dq, dk, dv (None for the index
    vectors and the flags)."""

    @staticmethod
    def forward(ctx, q, k, v, q_offsets, kv_lengths, causal, window):
        out, lse = flash_attn(q, k, v, q_offsets, kv_lengths,
                              causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_offsets, kv_lengths)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_offsets, kv_lengths = ctx.saved_tensors
        dq, dk, dv = flash_attn_bwd(q, k, v, out, lse, dout.contiguous(),
                                    q_offsets, kv_lengths,
                                    causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None
