"""Chunked Mamba2 SSD scan: the CUDA kernels' launchers, their autograd
function and, beside them, their plain PyTorch versions.

``ssd_scan`` (``csrc/ssd_scan.cu``) is the port of
``repro.kernels.ssd_scan.ssd_scan`` in the group-factored form of
``repro.models.mamba.ssd_chunked``: B and C stay (B, L, G, DS) and each
head reads its group, so mamba2's single group is never repeated to its
80 heads in device memory.  One call runs two CUDA kernels: C·Bᵀ once
per (batch row, chunk, group) into a workspace, then the chunk walk of
each (batch row, head, slice of the head's columns).  Its training
form (``return_states=True``) also writes the state at the start of
each chunk, which the backward reads.

``ssd_scan_bwd`` (``csrc/ssd_scan_bwd.cu``) is that backward: dx, d dt,
da, dB, dC and the initial state's gradient from the forward's inputs,
its chunk states, dy and the final state's gradient.  It ports no TPU
kernel: the reference differentiates ``ssd_chunked`` through XLA.
``SSDScanFn`` joins the two for autograd; ``ops.ssd_grouped`` takes it
on the card when an input requires grad.

The launchers take CUDA tensors only and raise on anything their
kernels do not take; ``ssd_scan_plain`` and ``ssd_scan_bwd_plain``
(``kernels/ref.py``) compute the same functions with plain tensor ops.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ragged_prefill import (_DTYPES, ON_CARD,
                                                LaunchCount, launch)
from repro_torch.kernels.ref import \
    ref_ssd_scan as ssd_scan_plain  # noqa: F401
from repro_torch.kernels.ref import \
    ref_ssd_scan_bwd as ssd_scan_bwd_plain  # noqa: F401

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


def n_chunks(l: int, chunk: int) -> int:
    """Chunks of a length-``l`` call: ceil(L / Q), Q = min(chunk, L)."""
    return -(-l // min(chunk, l)) if l else 0


def _check(x, dt, a, bmat, cmat, chunk, state, state_name):
    """Raise on inputs the kernels do not take (see ``ssd_scan``);
    ``state``: the forward's init_state or the backward's dstate (None
    allowed), (B, NH, HD, DS) float32.  Return the row strides of x,
    bmat and cmat.  Meta tensors pass (``ragged_prefill.ON_CARD``)."""
    dev = x.device
    if dev.type not in ON_CARD:
        raise ValueError(f"CUDA kernel called with a tensor on {dev}")
    named = (("dt", dt), ("a", a), ("bmat", bmat), ("cmat", cmat),
             (state_name, state))
    for name, t in named:
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
    if x.dtype not in _DTYPES or bmat.dtype != x.dtype \
            or cmat.dtype != x.dtype:
        raise ValueError(f"x/bmat/cmat dtypes {x.dtype}/{bmat.dtype}/"
                         f"{cmat.dtype}: the kernel takes float32 or "
                         "bfloat16, all alike")
    fp32 = [t for t in (dt, a, state) if t is not None]
    if any(t.dtype != torch.float32 for t in fp32):
        raise ValueError(f"dt, a and {state_name} must be float32")
    b, l, nh, hd = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    if bmat.shape[:2] != (b, l) or cmat.shape != bmat.shape \
            or g <= 0 or nh % g:
        raise ValueError(f"bmat/cmat must be (B, L, G, DS) alike with "
                         f"NH % G == 0: {tuple(bmat.shape)} / "
                         f"{tuple(cmat.shape)}, NH {nh}")
    if dt.shape != (b, l, nh) or a.shape != (nh,) or (
            state is not None and state.shape != (b, nh, hd, ds)):
        raise ValueError(f"dt must be (B, L, NH), a (NH,) and {state_name}"
                         " (B, NH, HD, DS)")
    if not all(t.is_contiguous() for t in fp32):
        raise ValueError(f"dt, a and {state_name} must be contiguous")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel takes 1..{MAX_CHUNK}")
    return [_row_stride(n, t) for n, t in (("x", x), ("bmat", bmat),
                                           ("cmat", cmat))]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor,
             init_state: torch.Tensor, *, chunk: int = 128,
             return_states: bool = False):
    """Launch the SSD scan kernel on the current stream.

    x: (B, L, NH, HD) float32 or bfloat16; bmat, cmat: (B, L, G, DS) in
    x's dtype with NH % G == 0 (views into a wider row, such as the
    mamba layer's conv output, are read in place); dt: (B, L, NH)
    float32 post-softplus; a: (NH,) float32, negative; init_state:
    (B, NH, HD, DS) float32; all on one card.  ``chunk``: rows per chunk,
    at most 128.  Returns (y (B, L, NH, HD) in x's dtype, final state
    (B, NH, HD, DS) float32); with ``return_states`` also the state at
    the start of each chunk, (B, NH, n_chunks, HD, DS) float32 (each such
    launch counts in ``ssd_scan.states`` too).  Never synchronises and
    allocates by shape only, so a call replays from a CUDA graph.
    """
    rs = _check(x, dt, a, bmat, cmat, chunk, init_state, "init_state")
    b, l, nh, hd = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    dev = x.device
    y = torch.empty((b, l, nh, hd), dtype=x.dtype, device=dev)
    state = torch.empty_like(init_state)
    states = torch.empty((b, nh, n_chunks(l, chunk), hd, ds),
                         dtype=torch.float32, device=dev) \
        if return_states else None
    if b == 0 or l == 0:
        state.copy_(init_state)
        return (y, state, states) if return_states else (y, state)
    work = torch.empty(workspace_floats(b, l, g, chunk),
                       dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return (y, state, states) if return_states else (y, state)
    launch("ssd_scan", x.data_ptr(), dt.data_ptr(), a.data_ptr(),
           bmat.data_ptr(), cmat.data_ptr(), init_state.data_ptr(),
           y.data_ptr(), state.data_ptr(), work.data_ptr(),
           states.data_ptr() if return_states else None, b, l, nh, hd,
           ds, g, chunk, *rs, _DTYPES[x.dtype],
           torch.cuda.current_stream(dev).cuda_stream)
    ssd_scan.launches += 1
    # B/C in several groups, each shared by several heads (jamba's 8)
    ssd_scan.grouped.launches += 1 < g < nh
    ssd_scan.states.launches += return_states
    return (y, state, states) if return_states else (y, state)


ssd_scan.launches = 0
ssd_scan.grouped = LaunchCount()
ssd_scan.states = LaunchCount()


BWD_MAX_HD = 64                 # head widths the backward takes
BWD_MAX_DS = 256                # state widths the backward takes
BWD_KT = 64                     # DS columns of a group block
BWD_SMS = 132                   # group blocks resident at once: an H100's
BWD_BLOCK_HEADS = 2             # a group block's own work, in heads' worth
BWD_PLAN_KEYS = ("cb_blocks", "dstate_blocks", "dstate_smem",
                 "dstate_regs", "head_blocks", "head_smem", "head_regs",
                 "head_blocks_per_sm", "group_blocks", "group_smem",
                 "group_regs", "group_blocks_per_sm", "head_ranges",
                 "heads_per_range")


def bwd_ranges(b: int, l: int, nh: int, ds: int, g: int,
               chunk: int) -> tuple:
    """(ranges, heads a range) of the backward's group blocks, from the
    shapes alone: each group's heads are cut into ranges of ``heads``
    consecutive heads, one block per (batch row, chunk, group, 64 DS
    columns, range).  A group block holds an SM and walks its heads one
    after another, so a call takes about (its waves of ``BWD_SMS``
    blocks) x (``heads`` + ``BWD_BLOCK_HEADS``, the block's own staging
    and products): the fewest ranges that minimise that.  mamba2's one
    group of 80 heads at (4, 1024) takes 2 ranges of 40 (128 blocks, one
    wave); jamba's 8 groups of 16 one range."""
    hpg = nh // g
    base = b * n_chunks(l, chunk) * g * -(-ds // BWD_KT)
    best, heads = None, hpg
    for want in range(1, hpg + 1):
        per = -(-hpg // want)
        cost = -(-base * -(-hpg // per) // BWD_SMS) * (per + BWD_BLOCK_HEADS)
        if best is None or cost < best:
            best, heads = cost, per
    return -(-hpg // heads), heads


def bwd_workspace_floats(b: int, l: int, nh: int, hd: int, ds: int, g: int,
                         chunk: int) -> int:
    """Floats of the backward's workspace (``csrc/ssd_scan_bwd.cu``
    ``carve``): C·Bᵀ's upper band (B, n_chunks, G, Q16, Q16), each
    chunk's end-state gradient (B, NH, n_chunks, HD, DS), the chunks'
    decays exp(cum_last) (B, NH, n_chunks), the da partials (NH, B,
    n_chunks) and, with more than one head range, the dB and dC partials
    (ranges, B, L, G, DS) each.  Q16: the chunk rounded up to 16."""
    q, nc = min(chunk, l), n_chunks(l, chunk)
    qp = -(-q // 16) * 16
    ranges, _ = bwd_ranges(b, l, nh, ds, g, chunk)
    parts = 2 * ranges * b * l * g * ds if ranges > 1 else 0
    return (b * nc * g * qp * qp + b * nh * nc * hd * ds + 2 * b * nh * nc
            + parts)


def bwd_plan(b: int, l: int, nh: int, hd: int, ds: int, g: int,
             dtype: torch.dtype, chunk: int = MAX_CHUNK) -> Dict[str, int]:
    """The backward's launch plan at these shapes, from the built kernels
    (``BWD_PLAN_KEYS``): the (B·Cᵀ)ᵀ kernel's blocks; the dH terms'
    blocks, dynamic shared memory per block and registers per thread;
    the head and group kernels' blocks, shared memory, registers and
    blocks per SM; the head ranges a group and the heads a range.  Needs
    the card."""
    out = (ctypes.c_int * len(BWD_PLAN_KEYS))()
    fn = _build.function("ssd_scan_bwd", "ssd_scan_bwd_info",
                         (ctypes.c_int,) * 8 + (ctypes.c_void_p,))
    err = fn(b, l, nh, hd, ds, g, chunk, _DTYPES[dtype],
             ctypes.addressof(out))
    if err:
        raise RuntimeError(f"ssd_scan_bwd_info failed: CUDA error {err}")
    return dict(zip(BWD_PLAN_KEYS, out))


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor,
                 states: torch.Tensor, dy: torch.Tensor,
                 dstate: Optional[torch.Tensor] = None, *,
                 chunk: int = 128):
    """Launch the backward kernels of ``ssd_scan`` on the current stream.

    x, dt, a, bmat, cmat and ``chunk`` as the forward took them;
    ``states``: the forward's chunk states (B, NH, n_chunks, HD, DS)
    float32 (``ssd_scan(..., return_states=True)``); dy: (B, L, NH, HD)
    in x's dtype, the gradient of y; ``dstate``: (B, NH, HD, DS) float32,
    the final state's gradient, or None for zeros; all contiguous but x,
    bmat and cmat (read as the forward reads them).  Returns (dx, ddt,
    da, dbmat, dcmat, dinit) like (x, dt, a, bmat, cmat, init_state),
    contiguous.  Deterministic: no float atomics.  Never synchronises."""
    rs = _check(x, dt, a, bmat, cmat, chunk, dstate, "dstate")
    b, l, nh, hd = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    dev = x.device
    if states.shape != (b, nh, n_chunks(l, chunk), hd, ds) \
            or states.dtype != torch.float32 or not states.is_contiguous():
        raise ValueError(f"states must be ({b}, {nh}, "
                         f"{n_chunks(l, chunk)}, {hd}, {ds}) float32, "
                         "contiguous")
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("dy must be like x, contiguous")
    if hd > BWD_MAX_HD or ds > BWD_MAX_DS:
        raise ValueError(f"HD {hd}, DS {ds}: the backward takes HD <= "
                         f"{BWD_MAX_HD} and DS <= {BWD_MAX_DS}")
    for name, t in (("states", states), ("dy", dy)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
    dx = torch.empty((b, l, nh, hd), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, l, nh), dtype=torch.float32, device=dev)
    da = torch.zeros((nh,), dtype=torch.float32, device=dev)
    dbm = torch.empty((b, l, g, ds), dtype=x.dtype, device=dev)
    dcm = torch.empty_like(dbm)
    dinit = torch.empty((b, nh, hd, ds), dtype=torch.float32, device=dev)
    if b == 0 or l == 0:
        if dstate is None:
            return dx, ddt, da, dbm, dcm, dinit.zero_()
        return dx, ddt, da, dbm, dcm, dinit.copy_(dstate)
    work = torch.empty(bwd_workspace_floats(b, l, nh, hd, ds, g, chunk),
                       dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return dx, ddt, da, dbm, dcm, dinit
    launch("ssd_scan_bwd", x.data_ptr(), dt.data_ptr(), a.data_ptr(),
           bmat.data_ptr(), cmat.data_ptr(), dy.data_ptr(),
           dstate.data_ptr() if dstate is not None else None,
           states.data_ptr(), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
           dbm.data_ptr(), dcm.data_ptr(), dinit.data_ptr(),
           work.data_ptr(), b, l, nh, hd, ds, g, chunk, *rs,
           _DTYPES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    ssd_scan_bwd.launches += 1
    return dx, ddt, da, dbm, dcm, dinit


ssd_scan_bwd.launches = 0


class SSDScanFn(torch.autograd.Function):
    """``ssd_scan`` with its backward kernel: the forward launches the
    training form and saves x, dt, a, B, C and the chunk states; the
    backward launches ``ssd_scan_bwd`` and returns the six gradients
    (None for ``chunk``).  A missing gradient of y is zeros, of the final
    state none."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, init_state, chunk):
        y, state, states = ssd_scan(x, dt, a, bmat, cmat, init_state,
                                    chunk=chunk, return_states=True)
        ctx.save_for_backward(x, dt, a, bmat, cmat, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, bmat, cmat, states = ctx.saved_tensors
        dy = torch.zeros_like(x, memory_format=torch.contiguous_format) \
            if dy is None else dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        grads = ssd_scan_bwd(x, dt, a, bmat, cmat, states, dy, dstate,
                             chunk=ctx.chunk)
        return (*grads, None)
