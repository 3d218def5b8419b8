"""Plain PyTorch versions of the kernels (the correctness contract),
ported from ``repro.kernels.ref`` and, for the SSD scan, from
``repro.models.mamba.ssd_chunked``.

Each ``ref_*`` function computes the same math as its kernel with plain
tensor ops in fp32.  The CPU tests run them against the JAX oracles,
the serving stack takes them for tensors on the CPU, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _defaults(b: int, depth: int, device, q_offsets, kv_lengths):
    """q_offsets (None = 0) and kv_lengths (None = ``depth``) as (B,)
    int32 tensors."""
    if q_offsets is None:
        q_offsets = torch.zeros((b,), dtype=torch.int32, device=device)
    if kv_lengths is None:
        kv_lengths = torch.full((b,), depth, dtype=torch.int32,
                                device=device)
    return q_offsets, kv_lengths


def ref_flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_offsets: Optional[torch.Tensor] = None,
                   kv_lengths: Optional[torch.Tensor] = None, *,
                   causal: bool = True,
                   window: Optional[int] = None) -> torch.Tensor:
    """Dense (B, Lq) prefill / re-prefill attention, and the non-causal
    attention of an encoder layer.

    q: (B, Lq, Hq, D); k, v: (B, S, Hkv, D) — S may exceed Lq (a KV
    cache).  q_offsets: (B,) position of each row's first query (the
    history length), None = 0; query i of row b sits at q_offsets[b] +
    i.  kv_lengths: (B,) valid KV entries, None = all S.  Key p of row b
    is attended where p < kv_lengths[b], p <= the query's position
    (causal) and p > the query's position - window.  Rows with no valid
    key produce zeros (the JAX oracle averages junk there; the kernels,
    Pallas and CUDA alike, write 0).
    """
    b, lq, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    dev = q.device
    if q_offsets is None:
        q_offsets = torch.zeros((b,), dtype=torch.int32, device=dev)
    qpos = q_offsets.long()[:, None] + torch.arange(lq, device=dev)
    kpos = torch.arange(s, device=dev)[None, None, :]
    mask = torch.ones((b, lq, s), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos[:, :, None])
    if window is not None:
        mask = mask & (kpos > qpos[:, :, None] - window)
    if kv_lengths is not None:
        mask = mask & (kpos < kv_lengths.long()[:, None, None])
    qg = q.reshape(b, lq, hkv, rep, d).float()
    scores = torch.einsum("blgrd,bsgd->bglrs", qg, k.float())
    scores = scores / math.sqrt(d)
    scores = scores.masked_fill(~mask[:, None, :, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bglrs,bsgd->blgrd", probs, v.float())
    out = out * mask.any(dim=2)[:, :, None, None, None]   # keyless → 0
    return out.reshape(b, lq, hq, d).to(q.dtype)


def _flash_scores(q, k, q_offsets, kv_lengths, causal, window):
    """Scaled scores (B, Hkv, Lq, rep, S) in fp32 and the (B, Lq, S) mask
    of ``ref_flash_attn``."""
    b, lq, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    dev = q.device
    if q_offsets is None:
        q_offsets = torch.zeros((b,), dtype=torch.int32, device=dev)
    qpos = q_offsets.long()[:, None] + torch.arange(lq, device=dev)
    kpos = torch.arange(s, device=dev)[None, None, :]
    mask = torch.ones((b, lq, s), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos[:, :, None])
    if window is not None:
        mask = mask & (kpos > qpos[:, :, None] - window)
    if kv_lengths is not None:
        mask = mask & (kpos < kv_lengths.long()[:, None, None])
    qg = q.reshape(b, lq, hkv, hq // hkv, d).float()
    scores = torch.einsum("blgrd,bsgd->bglrs", qg, k.float()) / math.sqrt(d)
    return scores, mask


def ref_flash_attn_lse(q: torch.Tensor, k: torch.Tensor,
                       q_offsets: Optional[torch.Tensor] = None,
                       kv_lengths: Optional[torch.Tensor] = None, *,
                       causal: bool = True,
                       window: Optional[int] = None) -> torch.Tensor:
    """The log-sum-exp (B, Hq, Lq) fp32 of each query's scaled scores
    over the keys ``ref_flash_attn`` lets it attend; -inf for a row with
    no valid key.  The ``flash_attn`` kernel writes it when asked, for
    its backward."""
    b, lq, hq, _ = q.shape
    scores, mask = _flash_scores(q, k, q_offsets, kv_lengths, causal,
                                 window)
    scores = scores.masked_fill(~mask[:, None, :, None, :], -math.inf)
    lse = torch.logsumexp(scores, dim=-1)                  # (B, G, L, R)
    return lse.permute(0, 1, 3, 2).reshape(b, hq, lq)


def flash_attn_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor,
                         q_offsets: Optional[torch.Tensor] = None,
                         kv_lengths: Optional[torch.Tensor] = None, *,
                         causal: bool = True,
                         window: Optional[int] = None, _abs: bool = False):
    """The backward of ``ref_flash_attn`` from its saved tensors, by the
    formulas the ``flash_attn_bwd`` kernels compute, in fp32: P =
    exp(S·scale − lse) on each query's valid keys (0 elsewhere), Δ =
    rowsum(dO ∘ O), dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P ∘ (dP − Δ), dK =
    dSᵀ·Q·scale, dQ = dS·K·scale, the GQA sum over each KV head's rep
    query heads.  A row with no valid key gets dQ = 0 and adds nothing.
    q, out, dout: (B, Lq, Hq, D); k, v: (B, S, Hkv, D); lse: (B, Hq, Lq)
    fp32.  Returns (dq, dk, dv) in q's, k's and v's dtypes.

    ``_abs``: the same sums over absolute values, the magnitudes
    ``flash_attn_bwd_error_bound`` scales (fp32, never rounded)."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    scale = 1.0 / math.sqrt(d)
    scores, mask = _flash_scores(q, k, q_offsets, kv_lengths, causal,
                                 window)
    m = mask[:, None, :, None, :]
    lse5 = lse.float().reshape(b, hkv, rep, lq).permute(0, 1, 3, 2)
    p = torch.where(m, torch.exp(scores - lse5[..., None]),
                    torch.zeros((), device=q.device))
    og = out.reshape(b, lq, hkv, rep, d).float()
    dog = dout.reshape(b, lq, hkv, rep, d).float()
    qg = q.reshape(b, lq, hkv, rep, d).float()
    kf, vf = k.float(), v.float()
    delta = (dog * og).sum(-1).permute(0, 2, 1, 3)          # (B, G, L, R)
    if _abs:
        dog, og, qg, kf, vf = (x.abs() for x in (dog, og, qg, kf, vf))
        delta = (dog * og).sum(-1).permute(0, 2, 1, 3)
    dp = torch.einsum("blgrd,bsgd->bglrs", dog, vf)
    ds = p * (dp + delta[..., None] if _abs else dp - delta[..., None])
    dv = torch.einsum("bglrs,blgrd->bsgd", p, dog)
    dk = torch.einsum("bglrs,blgrd->bsgd", ds, qg) * scale
    dq = torch.einsum("bglrs,bsgd->blgrd", ds, kf) * scale
    dq = dq.reshape(b, lq, hq, d)
    if _abs:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ref_ragged_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cu_seqlens: torch.Tensor,
                       q_offsets: Optional[torch.Tensor] = None,
                       kv_lengths: Optional[torch.Tensor] = None, *,
                       causal: bool = True) -> torch.Tensor:
    """Packed padding-free prefill attention.

    q: (T, Hq, D) flat packed queries — sequence i owns rows
    [cu_seqlens[i], cu_seqlens[i+1]); k, v: (B, S, Hkv, D) per-sequence
    KV caches.  q_offsets: (B,) history length; kv_lengths: (B,) valid
    KV entries.  Rows beyond cu_seqlens[-1], and rows whose segment has
    no valid key, produce zeros (the JAX oracle averages junk there; the
    kernels, Pallas and CUDA alike, write 0).
    """
    t, hq, d = q.shape
    b, s, hkv = k.shape[0], k.shape[1], k.shape[2]
    rep = hq // hkv
    dev = q.device
    if q_offsets is None:
        q_offsets = torch.zeros((b,), dtype=torch.int32, device=dev)
    if kv_lengths is None:
        kv_lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    cu = cu_seqlens.long()
    rows = torch.arange(t, device=dev)
    seg = (rows[:, None] >= cu[None, 1:]).sum(dim=1)            # (T,)
    valid_row = rows < cu[-1]
    segc = seg.clamp(0, b - 1)
    qpos = q_offsets.long()[segc] + rows - cu[segc]              # (T,)
    kpos = torch.arange(s, device=dev)
    mask = segc[:, None, None] == torch.arange(b, device=dev)[None, :, None]
    mask = mask & valid_row[:, None, None]
    mask = mask & (kpos[None, None, :] < kv_lengths.long()[None, :, None])
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[:, None, None])
    qg = q.reshape(t, hkv, rep, d).float()
    scores = torch.einsum("tgrd,bsgd->tgrbs", qg, k.float())
    scores = scores / math.sqrt(d)
    scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    flat = scores.reshape(t, hkv, rep, b * s)
    probs = torch.softmax(flat, dim=-1).reshape(t, hkv, rep, b, s)
    out = torch.einsum("tgrbs,bsgd->tgrd", probs, v.float())
    # rows with no valid key (bucket tail past cu_seqlens[-1], empty
    # segments) → exactly 0, as the kernels give them
    has_key = mask.flatten(1).any(dim=1)
    out = out * has_key[:, None, None, None]
    return out.reshape(t, hq, d).to(q.dtype)


def _rolling_kpos(kv_lengths: torch.Tensor, depth: int):
    """Absolute position held by each row of a rolling cache.

    Row s of a depth-D rolling cache (a rolling arena slot, or a ring of
    pages gathered in ring order) holds the newest position < kv_len
    congruent to s mod D: kpos = s + D·⌊max(kv_len − 1 − s, 0)/D⌋.
    Returns (kpos (B, D), valid (B, D)) — valid is s < min(kv_len, D),
    so the valid rows hold positions [max(0, kv_len − D), kv_len).
    """
    slots = torch.arange(depth, device=kv_lengths.device)[None, :]
    kvl = kv_lengths.long()[:, None]
    wraps = (kvl - 1 - slots).clamp(min=0) // depth
    return slots + wraps * depth, slots < kvl.clamp(max=depth)


def ref_ragged_prefill_rolling(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, cu_seqlens: torch.Tensor,
                               q_offsets: torch.Tensor,
                               kv_lengths: torch.Tensor, *, window: int,
                               causal: bool = True) -> torch.Tensor:
    """Windowed packed prefill over ROLLING per-segment caches.

    q: (T, Hq, D) flat packed stream; k, v: (B, D_slot, Hkv, D), row s
    of segment b holding the newest position congruent to s mod D_slot.
    Each query row attends only the held keys whose position lies in
    (qpos − window, qpos].  Rows past cu_seqlens[-1], and rows with no
    such key, produce zeros, as the kernels give them.
    """
    t, hq, d = q.shape
    b, s_depth, hkv = k.shape[0], k.shape[1], k.shape[2]
    rep = hq // hkv
    dev = q.device
    cu = cu_seqlens.long()
    rows = torch.arange(t, device=dev)
    seg = (rows[:, None] >= cu[None, 1:]).sum(dim=1)            # (T,)
    valid_row = rows < cu[-1]
    segc = seg.clamp(0, b - 1)
    qpos = q_offsets.long()[segc] + rows - cu[segc]              # (T,)
    kpos, kvalid = _rolling_kpos(kv_lengths, s_depth)            # (B, D)
    mask = segc[:, None, None] == torch.arange(b, device=dev)[None, :, None]
    mask = mask & valid_row[:, None, None] & kvalid[None]
    if causal:
        mask = mask & (kpos[None] <= qpos[:, None, None])
    mask = mask & (kpos[None] > qpos[:, None, None] - window)
    qg = q.reshape(t, hkv, rep, d).float()
    scores = torch.einsum("tgrd,bsgd->tgrbs", qg, k.float())
    scores = scores / math.sqrt(d)
    scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    flat = scores.reshape(t, hkv, rep, b * s_depth)
    probs = torch.softmax(flat, dim=-1).reshape(t, hkv, rep, b, s_depth)
    out = torch.einsum("tgrbs,bsgd->tgrd", probs, v.float())
    out = out * mask.flatten(1).any(dim=1)[:, None, None, None]
    return out.reshape(t, hq, d).to(q.dtype)


def ref_ragged_prefill_paged(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, page_table: torch.Tensor,
                             cu_seqlens: torch.Tensor,
                             q_offsets: Optional[torch.Tensor] = None,
                             kv_lengths: Optional[torch.Tensor] = None, *,
                             causal: bool = True,
                             window: Optional[int] = None) -> torch.Tensor:
    """Paged packed prefill attention.

    q: (T, Hq, D) flat packed stream; k, v: (N_pages, page_size, Hkv, D)
    full page pools; page_table: (B, P_max) physical page per logical
    page.  The gather here — materializing each segment's logical
    (P_max·ps)-deep cache from its pages — is this version's
    convenience; the kernel reads pages in place through the table.
    ``window`` selects the ring-table form: position p lives on ring
    page (p // ps) % P_max at offset p % ps, so the gathered pages form
    a depth-(P_max·ps) rolling cache and the rolling version applies.
    """
    b, p_max = page_table.shape
    ps, hkv, d = k.shape[1], k.shape[2], k.shape[3]
    idx = page_table.long()
    kg = k[idx].reshape(b, p_max * ps, hkv, d)
    vg = v[idx].reshape(b, p_max * ps, hkv, d)
    if window is not None:
        q_offsets, kv_lengths = _defaults(b, p_max * ps, q.device,
                                          q_offsets, kv_lengths)
        return ref_ragged_prefill_rolling(q, kg, vg, cu_seqlens, q_offsets,
                                          kv_lengths, window=window,
                                          causal=causal)
    return ref_ragged_prefill(q, kg, vg, cu_seqlens, q_offsets=q_offsets,
                              kv_lengths=kv_lengths, causal=causal)


def ref_ragged_prefill_arena(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, slot_map: torch.Tensor,
                             cu_seqlens: torch.Tensor,
                             q_offsets: Optional[torch.Tensor] = None,
                             kv_lengths: Optional[torch.Tensor] = None, *,
                             causal: bool = True,
                             window: Optional[int] = None) -> torch.Tensor:
    """Slot-arena packed prefill attention.

    q: (T, Hq, D) flat packed stream; k, v: (N_slots, S_max, Hkv, D)
    full arenas; slot_map: (B,) arena slot per segment.  The gather here
    is this version's convenience; the kernel indexes the slot axis in
    place.  ``window`` selects the rolling form (each slot a depth-S_max
    rolling cache, written at position % S_max).
    """
    idx = slot_map.long()
    if window is not None:
        q_offsets, kv_lengths = _defaults(idx.shape[0], k.shape[1], q.device,
                                          q_offsets, kv_lengths)
        return ref_ragged_prefill_rolling(q, k[idx], v[idx], cu_seqlens,
                                          q_offsets, kv_lengths,
                                          window=window, causal=causal)
    return ref_ragged_prefill(q, k[idx], v[idx], cu_seqlens,
                              q_offsets=q_offsets, kv_lengths=kv_lengths,
                              causal=causal)


def ref_decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention: a causal one-query step whose query
    sits at position lengths[b] - 1.

    q: (B, Hq, D); k, v: (B, S, Hkv, D); lengths: (B,) valid KV entries.
    Rows with ``lengths == 0`` produce zeros, as the kernels give them.
    """
    lengths = lengths.long()
    return ref_flash_attn(q[:, None], k, v, lengths - 1, lengths)[:, 0]


def ref_decode_attn_rolling(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor, *,
                            window: int) -> torch.Tensor:
    """Windowed single-token decode over ROLLING per-row caches.

    q: (B, Hq, D); k, v: (B, D_slot, Hkv, D) rolling cache rows;
    lengths: (B,) cached entries including the new row.  The query at
    position lengths − 1 attends the held keys whose position lies in
    (qpos − window, qpos].  Rows with ``lengths == 0`` produce zeros.
    """
    b, hq, d = q.shape
    s_depth, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    kpos, valid = _rolling_kpos(lengths, s_depth)                # (B, D)
    qpos = lengths.long()[:, None] - 1
    valid = valid & (kpos > qpos - window)
    qg = q.reshape(b, hkv, rep, d).float()
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, k.float()) / math.sqrt(d)
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", probs, v.float())
    out = out * valid.any(dim=1)[:, None, None, None]
    return out.reshape(b, hq, d).to(q.dtype)


def ref_decode_attn_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          page_table: torch.Tensor, lengths: torch.Tensor, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """Paged single-token decode attention.

    q: (B, Hq, D); k, v: (N_pages, page_size, Hkv, D) full page pools;
    page_table: (B, P_max); lengths: (B,) valid KV entries.  Gathers
    each row's pages into a contiguous logical cache and delegates — to
    the rolling version when ``window`` selects the ring-table form.
    """
    b, p_max = page_table.shape
    ps, hkv, d = k.shape[1], k.shape[2], k.shape[3]
    idx = page_table.long()
    kg = k[idx].reshape(b, p_max * ps, hkv, d)
    vg = v[idx].reshape(b, p_max * ps, hkv, d)
    if window is not None:
        return ref_decode_attn_rolling(q, kg, vg, lengths, window=window)
    return ref_decode_attn(q, kg, vg, lengths)


def ref_decode_attn_arena(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          slot_map: torch.Tensor, lengths: torch.Tensor, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """Slot-arena single-token decode attention.

    q: (B, Hq, D); k, v: (N_slots, S_max, Hkv, D) full arenas; slot_map:
    (B,) arena slot per row; lengths: (B,) valid KV entries.  The gather
    here is this version's convenience; the kernel indexes the slot axis
    in place.  ``window`` selects the rolling form (slots written at
    position % S_max).
    """
    idx = slot_map.long()
    if window is not None:
        return ref_decode_attn_rolling(q, k[idx], v[idx], lengths,
                                       window=window)
    return ref_decode_attn(q, k[idx], v[idx], lengths)


def ref_ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None, *,
                 chunk: int = 128, return_states: bool = False):
    """Chunked Mamba2 SSD scan, group-factored (``ssd_chunked``).

    x: (B, L, NH, HD); dt: (B, L, NH) post-softplus; a: (NH,) negative;
    bmat, cmat: (B, L, G, DS) with NH % G == 0, head h reading group
    h // (NH / G) — the per-head form is G == NH, and B/C are never
    repeated to heads; init_state: (B, NH, HD, DS) or None (zeros).
    Returns (y (B, L, NH, HD) in x's dtype, final state (B, NH, HD, DS)
    fp32).  Per chunk of Q = min(chunk, L) rows, in fp32, with
    la = dt * a and cum its prefix sums: the intra-chunk quadratic term
    M[t, s] = exp(seg[t, s]) (C_t . B_s) dt_s for s <= t, the carried
    state's term (C_t exp(cum_t)) . state, and the update
    state <- exp(cum_last) state + X^T (w * B), w_s = exp(seg[last, s])
    dt_s.  seg[t, s] = sum_{s < r <= t} la_r is summed directly where
    the reference takes cum_t - cum_s: after a large decay early in a
    chunk cum is large and the difference keeps few digits (a spike of
    |a dt| ~ 30 put an error of 3e-4 of max |y| into it), while every
    sum here adds terms of one sign.  seg is masked to -inf above the
    diagonal BEFORE exp (exp overflows there).  L off the chunk grid is
    zero-padded: dt = 0 rows are exact identities of the state.
    ``return_states``: also the state at the start of each chunk, (B,
    NH, n_chunks, HD, DS) fp32, which the kernel's training form writes
    for its backward.
    """
    b, l, nh, hd = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    hpg = nh // g
    q = min(chunk, l)
    orig_l = l
    if l % q:
        pad = q - l % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        l += pad
    nc = l // q
    f32 = torch.float32
    xc = x.reshape(b, nc, q, g, hpg, hd)
    dtc = dt.reshape(b, nc, q, g, hpg)
    bc = bmat.reshape(b, nc, q, g, ds)
    cc = cmat.reshape(b, nc, q, g, ds)
    ag = a.reshape(g, hpg).to(f32)
    if init_state is None:
        h = torch.zeros((b, g, hpg, hd, ds), dtype=f32, device=x.device)
    else:
        h = init_state.to(f32).reshape(b, g, hpg, hd, ds)
    ones = torch.ones((q, q), dtype=torch.bool, device=x.device)
    tri = ones.tril()[None, :, :, None, None]          # s <= t
    later = ones.tril(-1)[None, :, :, None, None]      # r > s
    ys, starts = [], []
    for c in range(nc):
        starts.append(h)
        xq, dq = xc[:, c].to(f32), dtc[:, c].to(f32)
        bq, cq = bc[:, c].to(f32), cc[:, c].to(f32)
        la = dq * ag                                         # (b,q,g,hpg)
        cum = torch.cumsum(la, dim=1)
        # seg[b, t, s] = sum over s < r <= t of la_r: the cumsum over r
        # of la_r kept where r > s
        seg = torch.cumsum(la[:, :, None].expand(b, q, q, g, hpg)
                           .masked_fill(~later, 0.0), dim=1)
        seg = seg.masked_fill(~tri, -math.inf)               # (b,t,s,g,hpg)
        cb = torch.einsum("btgd,bsgd->btsg", cq, bq)
        m = torch.exp(seg) * cb[..., None] * dq[:, None]
        y = torch.einsum("btsgh,bsghp->btghp", m, xq)
        y = y + torch.einsum("btgd,btgh,bghpd->btghp", cq, torch.exp(cum),
                             h)
        w = torch.exp(seg[:, -1]) * dq                        # (b,s,g,hpg)
        dstate = torch.einsum("bsgh,bsghp,bsgd->bghpd", w, xq, bq)
        h = torch.exp(cum[:, -1])[..., None, None] * h + dstate
        ys.append(y.to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(b, l, nh, hd)[:, :orig_l]
    if return_states:
        states = torch.stack(starts, dim=3).reshape(b, nh, nc, hd, ds)
        return y, h.reshape(b, nh, hd, ds), states
    return y, h.reshape(b, nh, hd, ds)


def ref_ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     bmat: torch.Tensor, cmat: torch.Tensor,
                     init_state: Optional[torch.Tensor], dy: torch.Tensor,
                     dstate: Optional[torch.Tensor] = None, *,
                     chunk: int = 128,
                     states: Optional[torch.Tensor] = None,
                     _abs: bool = False):
    """The backward of ``ref_ssd_scan``, by the reverse chunk walk the
    ``ssd_scan_bwd`` kernel computes, in fp32.

    Inputs as ``ref_ssd_scan`` takes them, with dy (B, L, NH, HD) the
    gradient of y, ``dstate`` (B, NH, HD, DS) that of the final state
    (None = zeros) and ``states`` the forward's chunk states (B, NH,
    n_chunks, HD, DS) fp32 (None = computed here by ``ref_ssd_scan``).
    Returns (dx, ddt, da, dbmat, dcmat, dinit) like (x,
    dt, a, bmat, cmat, init_state): dx, dbmat and dcmat in x's dtype,
    the rest fp32.

    Per chunk of n <= Q rows, last chunk first, with dH the gradient of
    the state at the chunk's end (seeded by ``dstate``), H the state at
    its start (the forward's chunk states), e_t = exp(cum_t), E[t, s] =
    exp(seg(t, s)) for s <= t, M = E (C_t . B_s) dt_s and w_s =
    E[last, s] dt_s:
      G[t, s] = dy_t . x_s (over the head's columns);
      dx_s = sum_{t >= s} M[t, s] dy_t + w_s (dH B_s);
      dCB[t, s] = G E dt_s, so dC_t = sum_s dCB[t, s] B_s + e_t (dy_t H)
        and dB_s = sum_t dCB[t, s] C_t + w_s (x_s dH), summed over the
        heads of the group;
      d dt_s = sum_t G E (C_t . B_s) + (x_s . dH B_s) E[last, s] + dla_s a;
      dla_r = sum_{t >= r} D_t with D_t = dcum_t + rowsum_t - colsum_t:
        dcum_t = e_t (dy_t . H C_t), plus e_last (dH . H) at the last row;
        dseg[t, s] = G E (C_t . B_s) dt_s for s < t, plus (x_s . dH B_s)
        w_s on the last row, and rowsum / colsum its sums over s < t and
        over t > s.  The suffix sum of rowsum - colsum is the sum of dseg
        over the pairs s < r <= t whose seg holds la_r;
      da = sum dla_r dt_r;  dH <- e_last dH + sum_t e_t dy_t^T C_t, which
      is the initial state's gradient after the first chunk.
    Rows past L get no gradient; a zero-dt chunk has no x or B gradient
    and a full dt gradient.

    ``_abs``: the same sums over absolute values (|x|, |B|, |C|, |dy|,
    |dstate|, |a|, rowsum + colsum, and the states of the scan run on
    |x|, |B|, |init_state|, which bound |states|), the magnitudes
    ``ssd_bwd_error_bound`` scales (fp32, never rounded)."""
    b, l, nh, hd = x.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    hpg = nh // g
    q = min(chunk, l)
    nc = -(-l // q)
    f32 = torch.float32
    dev = x.device
    xf, bf, cf, dyf = (t.to(f32) for t in (x, bmat, cmat, dy))
    h0 = (torch.zeros((b, nh, hd, ds), dtype=f32, device=dev)
          if init_state is None else init_state.to(f32))
    dh = (torch.zeros((b, nh, hd, ds), dtype=f32, device=dev)
          if dstate is None else dstate.to(f32))
    ag = a.to(f32).reshape(g, hpg)
    if _abs:
        xf, bf, cf, dyf, h0, dh = (t.abs() for t in (xf, bf, cf, dyf, h0,
                                                      dh))
    if states is None or _abs:
        _, _, states = ref_ssd_scan(xf, dt.to(f32), a.to(f32), bf, cf, h0,
                                    chunk=q, return_states=True)
    states = states.to(f32).reshape(b, g, hpg, nc, hd, ds)
    dh = dh.reshape(b, g, hpg, hd, ds)
    dxs, ddts, dbs, dcs = [], [], [], []
    da = torch.zeros((g, hpg), dtype=f32, device=dev)
    sign = 1.0 if _abs else -1.0
    a_mul = ag.abs() if _abs else ag
    for c in reversed(range(nc)):
        r0, n = c * q, min(q, l - c * q)
        xq = xf[:, r0:r0 + n].reshape(b, n, g, hpg, hd)
        dyq = dyf[:, r0:r0 + n].reshape(b, n, g, hpg, hd)
        dq = dt[:, r0:r0 + n].to(f32).reshape(b, n, g, hpg)
        bq, cq = bf[:, r0:r0 + n], cf[:, r0:r0 + n]          # (b, n, g, ds)
        hs = states[:, :, :, c]                              # (b,g,h,p,k)
        la = dq * ag
        e = torch.exp(torch.cumsum(la, dim=1))               # (b, n, g, h)
        ones = torch.ones((n, n), dtype=torch.bool, device=dev)
        tri = ones.tril()[None, :, :, None, None]
        strict = ones.tril(-1)[None, :, :, None, None]
        seg = torch.cumsum(la[:, :, None].expand(b, n, n, g, hpg)
                           .masked_fill(~strict, 0.0), dim=1)
        es = torch.exp(seg.masked_fill(~tri, -math.inf))     # (b,t,s,g,h)
        cb = torch.einsum("btgk,bsgk->btsg", cq, bq)[..., None]
        gm = torch.einsum("btghp,bsghp->btsgh", dyq, xq)
        m = es * cb * dq[:, None]
        dcb = gm * es * dq[:, None]
        u = gm * es * cb
        dseg = (u * dq[:, None]).masked_fill(~strict, 0.0)
        esl = es[:, -1]                                      # (b, s, g, h)
        w = esl * dq
        dxa = torch.einsum("bghpk,bsgk->bsghp", dh, bq)
        dx = torch.einsum("btsgh,btghp->bsghp", m, dyq) + w[..., None] * dxa
        dw = (xq * dxa).sum(-1)
        ch = torch.einsum("btgk,bghpk->btghp", cq, hs)
        dcum = e * (dyq * ch).sum(-1)
        dlast = e[:, -1] * (dh * hs).sum((-1, -2))            # (b, g, h)
        edy = e[..., None] * dyq
        dcs.append(torch.einsum("btsgh,bsgk->btgk", dcb, bq)
                   + torch.einsum("btghp,bghpk->btgk", edy, hs))
        dbs.append(torch.einsum("btsgh,btgk->bsgk", dcb, cq)
                   + torch.einsum("bsgh,bsghp,bghpk->bsgk", w, xq, dh))
        dsw = dw * w
        dsw[:, -1] = 0.0                                      # seg(last, last)
        rowsum = dseg.sum(2)
        rowsum[:, -1] += dsw.sum(1)
        colsum = dseg.sum(1) + dsw
        d = dcum + rowsum + sign * colsum
        d[:, -1] += dlast
        dla = torch.flip(torch.cumsum(torch.flip(d, (1,)), 1), (1,))
        ddts.append(u.sum(1) + dw * esl + dla * a_mul)
        da = da + (dla * dq).sum((0, 1))
        dxs.append(dx)
        dh = e[:, -1][..., None, None] * dh + torch.einsum(
            "btghp,btgk->bghpk", edy, cq)
    cat = [torch.cat(t[::-1], dim=1) for t in (dxs, ddts, dbs, dcs)]
    dx = cat[0].reshape(b, l, nh, hd)
    ddt = cat[1].reshape(b, l, nh)
    dbm, dcm = cat[2], cat[3]
    dinit = dh.reshape(b, nh, hd, ds)
    da = da.reshape(nh)
    if _abs:
        return dx, ddt, da, dbm, dcm, dinit
    return (dx.to(x.dtype), ddt, da, dbm.to(bmat.dtype), dcm.to(cmat.dtype),
            dinit)


FP32_TOL = 1e-4        # fp32 kernel vs plain version: summation order
U_BF16 = 2.0 ** -8     # unit roundoff of bfloat16


def kernel_error_bound(plain, dtype: torch.dtype, q: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor, *index):
    """The plain version ``plain`` run in fp32 on a kernel's inputs, and
    the elementwise bound on how far the kernel's output in ``dtype`` may
    lie from it.

    fp32: ``FP32_TOL``.  bf16: the kernels round p to bf16 before the PV
    product and round their output once, each a relative error of at
    most u = 2^-8, so ``|out - ref| <= u * (sum_j p_j |v_j| / l + |ref|)
    + FP32_TOL``; ``sum_j p_j |v_j| / l`` is the plain version run on
    ``|v|``.  A dropped or repeated key tile lies far outside it.
    Returns ``(ref, bound)``.
    """
    qf, kf, vf = q.float(), k.float(), v.float()
    ref = plain(qf, kf, vf, *index)
    if dtype == torch.float32:
        return ref, torch.full_like(ref, FP32_TOL)
    absv = plain(qf, kf, vf.abs(), *index)
    return ref, U_BF16 * (absv + ref.abs()) + FP32_TOL


BWD_REL_TOL = 1e-4     # fp32 backward vs plain version, of the |.| sums


def flash_attn_bwd_error_bound(q, k, v, out, lse, dout, *index, causal=True,
                               window=None):
    """The plain backward run in fp32 on the ``flash_attn_bwd`` kernels'
    inputs, and the elementwise bounds on how far the kernels' dq, dk
    and dv (in the inputs' dtype) may lie from it.

    The kernels accumulate in fp32 from the same inputs and the same
    lse, so each gradient moves only by the order of its fp32 sums and
    by exp: at most ``BWD_REL_TOL`` of the same sums taken over absolute
    values (``flash_attn_bwd_plain(..., _abs=True)``, where dS's
    magnitude is P·(|dO|·|V| + |dO|·|O|)).  In bf16 each output is
    rounded once (u·|ref|, u = 2^-8), and the tensor cores take bf16
    operands: dV's product takes P rounded to bf16 (the forward's own
    rounding of p), so it moves by at most u·Pᵀ|dO|, the |.| sum of dV;
    dK's and dQ's products take dS rounded to bf16, |dS - bf16(dS)| <=
    u·|dS| <= u·P·(|dO|·|V| + |dO|·|O|), so they move by at most
    u·|dS|ᵀ|Q|·scale and u·|dS|·|K|·scale, the |.| sums of dk and dq.
    A dropped query or key tile moves dq, dk or dv far past it.
    Returns ((dq, dk, dv) refs, (dq, dk, dv) bounds)."""
    f = [x.float() for x in (q, k, v, out, dout)]
    kw = dict(causal=causal, window=window)
    ref = flash_attn_bwd_plain(f[0], f[1], f[2], f[3], lse, f[4], *index,
                               **kw)
    mag = flash_attn_bwd_plain(f[0], f[1], f[2], f[3], lse, f[4], *index,
                               _abs=True, **kw)
    bounds = [BWD_REL_TOL * a + 1e-6 for a in mag]
    if q.dtype != torch.float32:
        bounds = [bd + U_BF16 * (r.abs() + m)
                  for bd, r, m in zip(bounds, ref, mag)]
    return tuple(ref), tuple(bounds)


SSD_REL_TOL = 1e-4     # fp32 SSD scan vs plain version, of max |out|


def ssd_error_bound(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    bmat: torch.Tensor, cmat: torch.Tensor,
                    init_state: torch.Tensor, chunk: int):
    """The plain SSD scan run in fp32 on a kernel's inputs, and the
    elementwise bounds on how far the kernel's y (in x's dtype) and final
    state (fp32) may lie from it.

    Every output is a sum of up to Q + DS fp32 products (Q·DS more in
    the intra-chunk dot products) that the kernel takes in another
    order, so each may move by ``SSD_REL_TOL`` of the largest magnitude
    in its (batch row, head); a bf16 y is rounded once more, a relative
    error of at most u = 2^-8, so its bound adds ``u * |y_ref|``.  A
    dropped chunk, a wrong decay or a wrong group lies far outside.
    Returns ``(y_ref, y_bound, state_ref, state_bound)``.
    """
    y_ref, s_ref = ref_ssd_scan(x.float(), dt.float(), a.float(),
                                bmat.float(), cmat.float(),
                                init_state.float(), chunk=chunk)

    def scale(t, dims, view):
        m = t.abs().amax(dim=dims)
        m = torch.maximum(m, 1e-6 * m.max())
        return (SSD_REL_TOL * m).reshape(view)

    b, _, nh, _ = x.shape
    y_bound = scale(y_ref, (1, 3), (b, 1, nh, 1)).expand_as(y_ref)
    if x.dtype != torch.float32:
        y_bound = y_bound + U_BF16 * (y_ref.abs() + y_bound)
    s_bound = scale(s_ref, (2, 3), (b, nh, 1, 1)).expand_as(s_ref)
    return y_ref, y_bound, s_ref, s_bound


SSD_BWD_REL_TOL = 1e-4  # fp32 SSD backward vs plain version, of the |.| sums


def ssd_bwd_error_bound(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        bmat: torch.Tensor, cmat: torch.Tensor,
                        init_state: torch.Tensor, dy: torch.Tensor,
                        dstate: Optional[torch.Tensor],
                        states: torch.Tensor, chunk: int):
    """The plain backward run in fp32 on the ``ssd_scan_bwd`` kernel's
    inputs (the forward's chunk states among them), and the elementwise
    bounds on how far the kernel's six gradients may lie from it.

    The kernel computes in fp32 from the same inputs and the same
    states, so each gradient moves only by the order of its fp32 sums
    and by expf: at most ``SSD_BWD_REL_TOL`` of the same sums taken over
    absolute values (``ref_ssd_scan_bwd(..., _abs=True)``), plus 1e-6 of
    that gradient's largest magnitude for the terms that underflow.  In
    bf16, dx, dB and dC are rounded once more (u·|ref|, u = 2^-8).  A
    dropped chunk moves them far past it.  Returns (refs, bounds), each
    (dx, ddt, da, dB, dC, dinit)."""
    f = [t.float() for t in (x, dt, a, bmat, cmat, init_state, dy)]
    ds_ = None if dstate is None else dstate.float()
    ref = ref_ssd_scan_bwd(*f, ds_, chunk=chunk, states=states)
    mag = ref_ssd_scan_bwd(*f, ds_, chunk=chunk, _abs=True)
    bounds = [SSD_BWD_REL_TOL * m + 1e-6 * m.max() for m in mag]
    if x.dtype != torch.float32:
        for i in (0, 3, 4):
            bounds[i] = bounds[i] + U_BF16 * ref[i].abs()
    return tuple(ref), tuple(bounds)
