"""Chunked Mamba2 SSD scan: the CUDA kernel's launcher and its plain
PyTorch version.

``ssd_scan`` (``csrc/ssd_scan.cu``) is the port of
``repro.kernels.ssd_scan.ssd_scan`` in the group-factored form of
``repro.models.mamba.ssd_chunked``: B and C stay (B, L, G, DS) and each
head reads its group, so mamba2's single group is never repeated to its
80 heads in device memory.  One call runs two CUDA kernels: C·Bᵀ once
per (batch row, chunk, group) into a workspace, then the chunk walk of
each (batch row, head, slice of the head's columns).  The launcher takes
CUDA tensors only and raises on anything the kernel does not take;
``ssd_scan_plain`` (``kernels/ref.py``) computes the same function with
plain tensor ops.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ragged_prefill import _DTYPES, LaunchCount, launch
from repro_torch.kernels.ref import \
    ref_ssd_scan as ssd_scan_plain  # noqa: F401

MAX_CHUNK = 128
PLAN_KEYS = ("cb_blocks", "cb_smem", "cb_regs", "cb_blocks_per_sm",
             "walk_blocks", "walk_smem", "walk_regs", "walk_blocks_per_sm",
             "slices_per_head", "chunk_padded")


def workspace_floats(b: int, l: int, g: int, chunk: int) -> int:
    """Floats of the C·Bᵀ workspace of one call: a (Q16, Q16) fp32 block
    per (batch row, chunk, group), Q16 the chunk rounded up to 16."""
    q = min(chunk, l)
    qp = -(-q // 16) * 16
    return b * (-(-l // q)) * g * qp * qp


def plan(b: int, l: int, nh: int, hd: int, ds: int, g: int,
         dtype: torch.dtype, chunk: int = MAX_CHUNK) -> Dict[str, int]:
    """The launch plan of one call at these shapes, from the built
    kernel (``PLAN_KEYS``): each kernel's blocks per launch, dynamic
    shared memory per block, registers per thread and blocks per SM on
    this card, the slices a head's columns are cut into and the padded
    chunk.  Needs the card."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    fn = _build.function("ssd_scan", "ssd_scan_info",
                         (ctypes.c_int,) * 8 + (ctypes.c_void_p,))
    err = fn(b, l, nh, hd, ds, g, chunk, _DTYPES[dtype],
             ctypes.addressof(out))
    if err:
        raise RuntimeError(f"ssd_scan_info failed: CUDA error {err}")
    return dict(zip(PLAN_KEYS, out))


def _row_stride(name: str, t: torch.Tensor) -> int:
    """Element stride between consecutive (batch, position) rows of a
    (B, L, H, D) tensor whose inner two dims are contiguous; raise if
    its rows are not uniformly strided."""
    b, l, h, d = t.shape
    # a size-1 dim's stride carries no layout: take the row stride from
    # the outer dim then
    rs = t.stride(1) if l > 1 else (t.stride(0) if b > 1 else h * d)
    if (d > 1 and t.stride(3) != 1) or (h > 1 and t.stride(2) != d) \
            or rs < h * d or (b > 1 and l > 1 and t.stride(0) != l * rs):
        raise ValueError(f"{name} must be (B, L, H, D) with contiguous "
                         f"(H, D) rows evenly strided: strides {t.stride()}")
    return rs


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor,
             init_state: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the SSD scan kernel on the current stream.

    x: (B, L, NH, HD) float32 or bfloat16; bmat, cmat: (B, L, G, DS) in
    x's dtype with NH % G == 0 (views into a wider row, such as the
    mamba layer's conv output, are read in place); dt: (B, L, NH)
    float32 post-softplus; a: (NH,) float32, negative; init_state:
    (B, NH, HD, DS) float32; all on one card.  ``chunk``: rows per chunk,
    at most 128.  Returns (y (B, L, NH, HD) in x's dtype, final state
    (B, NH, HD, DS) float32).  Never synchronises and allocates by shape
    only, so a call replays from a CUDA graph.
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {dev}")
    for name, t in (("dt", dt), ("a", a), ("bmat", bmat), ("cmat", cmat),
                    ("init_state", init_state)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
    if x.dtype not in _DTYPES or bmat.dtype != x.dtype \
            or cmat.dtype != x.dtype:
        raise ValueError(f"x/bmat/cmat dtypes {x.dtype}/{bmat.dtype}/"
                         f"{cmat.dtype}: the kernel takes float32 or "
                         "bfloat16, all alike")
    if any(t.dtype != torch.float32 for t in (dt, a, init_state)):
        raise ValueError("dt, a and init_state must be float32")
    b, l, nh, hd = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    if bmat.shape[:2] != (b, l) or cmat.shape != bmat.shape \
            or g <= 0 or nh % g:
        raise ValueError(f"bmat/cmat must be (B, L, G, DS) alike with "
                         f"NH % G == 0: {tuple(bmat.shape)} / "
                         f"{tuple(cmat.shape)}, NH {nh}")
    if dt.shape != (b, l, nh) or a.shape != (nh,) \
            or init_state.shape != (b, nh, hd, ds):
        raise ValueError("dt must be (B, L, NH), a (NH,) and init_state "
                         "(B, NH, HD, DS)")
    if not (dt.is_contiguous() and a.is_contiguous()
            and init_state.is_contiguous()):
        raise ValueError("dt, a and init_state must be contiguous")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel takes 1..{MAX_CHUNK}")
    rs = [_row_stride(n, t) for n, t in (("x", x), ("bmat", bmat),
                                         ("cmat", cmat))]
    y = torch.empty((b, l, nh, hd), dtype=x.dtype, device=dev)
    state = torch.empty_like(init_state)
    if b == 0 or l == 0:
        state.copy_(init_state)
        return y, state
    work = torch.empty(workspace_floats(b, l, g, chunk),
                       dtype=torch.float32, device=dev)
    launch("ssd_scan", x.data_ptr(), dt.data_ptr(), a.data_ptr(),
           bmat.data_ptr(), cmat.data_ptr(), init_state.data_ptr(),
           y.data_ptr(), state.data_ptr(), work.data_ptr(), b, l, nh, hd,
           ds, g, chunk, *rs, _DTYPES[x.dtype],
           torch.cuda.current_stream(dev).cuda_stream)
    ssd_scan.launches += 1
    # B/C in several groups, each shared by several heads (jamba's 8)
    ssd_scan.grouped.launches += 1 < g < nh
    return y, state


ssd_scan.launches = 0
ssd_scan.grouped = LaunchCount()
