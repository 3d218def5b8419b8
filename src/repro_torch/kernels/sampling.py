"""Fused on-device sampling: the CUDA kernel's launcher and, beside it,
its plain PyTorch version.

``fused_sample`` (``csrc/fused_sample.cu``) is the port of
``repro.kernels.sampling.fused_sample``: per logits row an additive
logit bias of up to ``MAX_BIAS`` entries, the temperature, EXACT top-k
(every column whose monotone int32 key is >= the kth largest, ties
kept), tie-inclusive top-p (a 31-step descent over the probability
bits), then the inverse-CDF draw from one host-drawn uniform — plus the
speculative-decoding outputs: the filtered probability of a draft token
and the residual resample with the draft zeroed.  Greedy rows
(``temp <= 0``) take the biased argmax.  Only the (R,) results leave the
card.

The kernel runs one thread-block cluster per row (``plan``: 8 CTAs, 16
where a slice of 8 would not leave three CTAs an SM), each CTA holding
its slice of the row in shared memory.  Top-k finds the kth largest
logit key exactly: for k <= ``THREADS`` from the few candidates past a
bound (the kth largest of each CTA's thread maxima), which the leader
CTA gathers (at most ``MAX_CANDIDATES``), else by a radix select over
the slices.  When at most ``CAPACITY`` columns are kept the leader runs
the softmaxes, the top-p descent and both draws over them alone;
otherwise the whole cluster-resident row does
(``tests/test_torch_sample_select.py`` rehearses the schedule in plain
PyTorch).

``fused_sample_plain`` computes the same function with plain tensor ops,
vectorised over rows, op for op as the reference's ``_sample_core`` +
``_bias_row``, so thresholds agree bit for bit and only the order of the
float sums (the softmax totals, the top-p masses, the CDF) may differ.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ragged_prefill import ON_CARD

NEG = -1e30       # masked logit, as the reference kernel uses
MAX_BIAS = 8      # logit-bias entries per row (the engine samples on the
#                   host past it)
_SIGN_LOW = 0x7FFFFFFF
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The kernel's launch shape (``csrc/fused_sample.cu``): threads a CTA,
# kept columns the leader draws over, top-k candidates it refines, and
# the dynamic shared memory a CTA may take so that three share an SM
# (233,472 B / 3 less the 1 KB each reserves and its static share) or,
# past that, at all.
THREADS = 256
CAPACITY = 4096
MAX_CANDIDATES = 512
_BINS = 256
ONE_WAVE_SMEM = 76288
MAX_SMEM = 232448 - 512
CLUSTERS = (8, 16)
PLAN_KEYS = ("cluster", "ctas", "threads", "smem", "static_smem", "regs",
             "clusters_resident", "slice", "capacity")


def _smem(n: int, el: int) -> int:
    """A CTA's dynamic shared memory for a slice of ``n`` columns of
    ``el`` bytes: the slice, two radix histograms and the compact
    candidates, or the whole-row fp32 slice that overlays them.  The C
    side's ``Layout`` computes the same total; ``chip_smoke.py`` phase 1
    holds ``launch_plan``'s shared bytes to this."""
    a16 = lambda x: (x + 15) // 16 * 16                      # noqa: E731
    compact = a16(n * el) + 2 * _BINS * 4 + 2 * CAPACITY * 4
    return a16(max(compact, 4 * n))


def plan(v: int, dtype: torch.dtype) -> dict:
    """The cluster size and slice of a row of ``v`` columns: the first of
    8 and 16 CTAs whose slice leaves three CTAs an SM, else 16 CTAs if
    their slices fit in shared memory at all.  Raises ValueError past
    that (V > 788,480 in fp32, 927,744 in bf16)."""
    el = 2 if dtype == torch.bfloat16 else 4
    for limit, sizes in ((ONE_WAVE_SMEM, CLUSTERS), (MAX_SMEM, CLUSTERS[-1:])):
        for cs in sizes:
            n = (-(-v // cs) + 7) // 8 * 8    # ceil(V / cs), 8-aligned
            if _smem(n, el) <= limit:
                return dict(cluster=cs, slice=n, smem=_smem(n, el))
    raise ValueError(f"a vocabulary of {v} columns does not fit the shared "
                     f"memory of a {CLUSTERS[-1]}-CTA cluster")


def launch_plan(r: int, v: int, dtype: torch.dtype) -> dict:
    """The kernel's launch at (R, V) from the built library
    (``PLAN_KEYS``): cluster size, CTAs, threads, dynamic and static
    shared bytes a CTA, registers a thread, clusters resident at once
    (``cudaOccupancyMaxActiveClusters``), slice and compact capacity.
    Needs the card."""
    pl = plan(v, dtype)
    out = (ctypes.c_int * len(PLAN_KEYS))()
    fn = _build.function("fused_sample", "fused_sample_info",
                         (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
    err = fn(r, v, _DTYPES[dtype], pl["cluster"], pl["slice"],
             ctypes.addressof(out))
    if err:
        raise RuntimeError(f"fused_sample_info failed: CUDA error {err}")
    return dict(zip(PLAN_KEYS, out))


def _float_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone int32 key of float32 ``x``: positives keep their bits,
    negatives flip the low 31 (so ``-0.0`` keys below ``+0.0``)."""
    bits = x.view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ _SIGN_LOW)


def _kth_key(keys: torch.Tensor, valid: torch.Tensor,
             k: torch.Tensor) -> torch.Tensor:
    """Per row, the largest non-negative T with ``count(valid & keys >=
    T) >= k``: a greedy 31-step MSB descent."""
    t = torch.zeros(keys.shape[0], dtype=torch.int32, device=keys.device)
    for i in range(31):
        cand = t | (1 << (30 - i))
        cnt = (valid & (keys >= cand[:, None])).sum(-1)
        t = torch.where(cnt >= k, cand, t)
    return t


def _topk_keep(scaled: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Keep-mask of each row's k largest entries, ties included; the
    descent runs on whichever side of zero holds the kth key."""
    key = _float_key(scaled)
    nonneg = key >= 0
    cnt_nn = nonneg.sum(-1)
    t_nn = _kth_key(key, nonneg, k)
    low = key & _SIGN_LOW
    t_ng = _kth_key(low, ~nonneg, k - cnt_nn)
    keep_nn = nonneg & (key >= t_nn[:, None])
    keep_ng = nonneg | ((low >= t_ng[:, None]) & ~nonneg)
    return torch.where((cnt_nn >= k)[:, None], keep_nn, keep_ng)


def _topp_theta(probs: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per row, the minimal probability theta whose strictly-greater mass
    is < top_p (keeping ``probs >= theta`` is the tie-inclusive
    nucleus)."""
    keys = probs.view(torch.int32)
    kacc = torch.zeros(probs.shape[0], dtype=torch.int32,
                       device=probs.device)
    for i in range(31):
        bit = 1 << (30 - i)
        trial = kacc | (bit - 1)
        mass = torch.where(keys > trial[:, None], probs,
                           torch.zeros((), device=probs.device)).sum(-1)
        kacc = torch.where(mass < top_p, kacc, kacc | bit)
    return kacc.view(torch.float32)


def _softmax(scaled: torch.Tensor) -> torch.Tensor:
    probs = torch.exp(scaled - scaled.max(-1, keepdim=True).values)
    return probs / probs.sum(-1, keepdim=True)


def _inv_cdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Count of cumulative masses <= u, clamped to V - 1."""
    idx = (torch.cumsum(probs, -1) <= u[:, None]).sum(-1)
    return torch.clamp(idx, max=probs.shape[-1] - 1).to(torch.int32)


def filtered_probs_plain(logits, temp, top_k, top_p, bias_ids, bias_vals
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(biased logits (R, V), the filtered distribution (R, V)) of every
    row: bias, temperature, top-k, top-p and the second softmax."""
    x = logits.float()
    v = x.shape[-1]
    iota = torch.arange(v, dtype=torch.int32, device=x.device)[None]
    for j in range(MAX_BIAS):
        x = torch.where(iota == bias_ids[:, j:j + 1],
                        x + bias_vals[:, j:j + 1], x)
    scaled = x / torch.clamp(temp, min=1e-6)[:, None]
    do_k = (top_k > 0) & (top_k < v)
    keep = _topk_keep(scaled, top_k) | ~do_k[:, None]
    scaled = torch.where(keep, scaled, NEG)
    probs = _softmax(scaled)
    do_p = (top_p > 0.0) & (top_p < 1.0)
    keep = (probs >= _topp_theta(probs, top_p)[:, None]) | ~do_p[:, None]
    scaled = torch.where(keep, scaled, NEG)
    return x, _softmax(scaled)


def _residual(probs: torch.Tensor, draft: torch.Tensor):
    """(draft column mask, residual distribution with the draft zeroed
    and renormalised, its mass)."""
    v = probs.shape[-1]
    iota = torch.arange(v, dtype=torch.int32, device=probs.device)[None]
    dcol = iota == torch.clamp(draft, 0, v - 1)[:, None]
    resid = torch.where(dcol, 0.0, probs)
    mass = resid.sum(-1)
    return dcol, resid / torch.clamp(mass, min=1e-30)[:, None], mass


def _as_inputs(logits, temp, top_k, top_p, bias_ids, bias_vals, u, draft):
    """The seven per-row inputs as tensors on ``logits``' device with the
    kernel's types (host arrays are cast the way the engine builds them:
    float32 uniforms, int32 ids)."""
    dev = logits.device

    def to(x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=dtype).contiguous()
        np_dtype = np.float32 if dtype == torch.float32 else np.int32
        return torch.from_numpy(np.ascontiguousarray(x, np_dtype)).to(dev)

    f, i = torch.float32, torch.int32
    return (to(temp, f), to(top_k, i), to(top_p, f), to(bias_ids, i),
            to(bias_vals, f), to(u, f), to(draft, i))


def fused_sample_plain(logits, temp, top_k, top_p, bias_ids, bias_vals, u,
                       draft) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of the fused sampling kernel.  logits:
    (R, V); temp/top_p/u: (R,) float32; top_k/draft: (R,) int32;
    bias_ids/bias_vals: (R, MAX_BIAS).  Returns (token (R,) int32,
    p_draft (R,) float32, alt (R,) int32)."""
    temp, top_k, top_p, bias_ids, bias_vals, u, draft = _as_inputs(
        logits, temp, top_k, top_p, bias_ids, bias_vals, u, draft)
    biased, probs = filtered_probs_plain(logits, temp, top_k, top_p,
                                         bias_ids, bias_vals)
    gtok = torch.argmax(biased, -1).to(torch.int32)
    stok = _inv_cdf(probs, u)
    dcol, resid, mass = _residual(probs, draft)
    p_d = torch.where(dcol, probs, 0.0).sum(-1)
    salt = torch.where(mass > 0, _inv_cdf(resid, u), stok)
    greedy = temp <= 0.0
    token = torch.where(greedy, gtok, stok)
    p_draft = torch.where(greedy, (gtok == draft).float(), p_d)
    alt = torch.where(greedy, gtok, salt)
    return token, p_draft, alt


def cdf_margin(logits, temp, top_k, top_p, bias_ids, bias_vals, u, draft
               ) -> torch.Tensor:
    """Per row, the distance from ``u`` to the nearest non-zero
    cumulative mass of the plain version's two draws (the filtered
    distribution and the residual); +inf on greedy rows.  A kernel whose sums run in another
    order may move a draw whose u lies within rounding of a boundary to
    the neighbouring kept token — the tests and the chip check allow
    that only where this margin is below their stated 1e-5."""
    temp, top_k, top_p, bias_ids, bias_vals, u, draft = _as_inputs(
        logits, temp, top_k, top_p, bias_ids, bias_vals, u, draft)
    _, probs = filtered_probs_plain(logits, temp, top_k, top_p, bias_ids,
                                    bias_vals)
    _, resid, _ = _residual(probs, draft)
    gap = torch.full_like(u, float("inf"))
    for p in (probs, resid):
        # leading masked columns sum to exactly 0 in any order: no
        # boundary a summation order can move
        cdf = torch.cumsum(p, -1)
        d = torch.where(cdf > 0, (cdf - u[:, None]).abs(), float("inf"))
        gap = torch.minimum(gap, d.min(-1).values)
    return torch.where(temp <= 0.0, float("inf"), gap)


def fused_sample(logits: torch.Tensor, temp, top_k, top_p, bias_ids,
                 bias_vals, u, draft) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Launch the fused sampling kernel on the current stream.

    logits: (R, V) float32 or bfloat16, contiguous, on the card; the
    seven per-row inputs may be host arrays or tensors (they are moved
    to the card as float32 / int32).  Returns (token (R,) int32,
    p_draft (R,) float32, alt (R,) int32) on the card.  One launch of
    R clusters (``plan``); allocates only the three outputs, never
    synchronises, and replays from a CUDA graph when the per-row inputs
    are tensors on the card.
    """
    if logits.device.type not in ON_CARD:
        raise ValueError(f"CUDA kernel called with a tensor on "
                         f"{logits.device}")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"logits dtype {logits.dtype}: the kernel takes "
                         "float32 or bfloat16")
    if logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError("logits must be a contiguous (R, V) tensor")
    r, v = logits.shape
    ins = _as_inputs(logits, temp, top_k, top_p, bias_ids, bias_vals, u,
                     draft)
    for x, shape in zip(ins, [(r,)] * 3 + [(r, MAX_BIAS)] * 2 + [(r,)] * 2):
        if tuple(x.shape) != shape:
            raise ValueError(f"sampling input of shape {tuple(x.shape)}, "
                             f"expected {shape}")
    dev = logits.device
    token = torch.empty((r,), dtype=torch.int32, device=dev)
    p_draft = torch.empty((r,), dtype=torch.float32, device=dev)
    alt = torch.empty((r,), dtype=torch.int32, device=dev)
    if r == 0 or dev.type == "meta":
        return token, p_draft, alt
    if v < 1:
        raise ValueError("empty vocabulary")
    pl = plan(v, logits.dtype)
    err = _build.launcher("fused_sample")(
        logits.data_ptr(), *(x.data_ptr() for x in ins), token.data_ptr(),
        p_draft.data_ptr(), alt.data_ptr(), r, v, _DTYPES[logits.dtype],
        pl["cluster"], pl["slice"],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_sample launch failed: CUDA error {err}")
    fused_sample.launches += 1
    return token, p_draft, alt


fused_sample.launches = 0
