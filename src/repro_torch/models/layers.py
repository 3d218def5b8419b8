"""Transformer layers of the port, from ``repro.models.layers``: RMSNorm,
RoPE, GQA attention (the dense path's, with or without a cache, through
``ops.mha`` and ``ops.decode``), SwiGLU, and the attention layers of the
serving steps: over a gathered cache batch, over the slot arena and over
the page pool.

Parameters are plain nested dicts of tensors with the JAX package's
names and layouts, so weights converted from its pytree compute the
same function.  Every layer with a cache writes the step's new KV into
it IN PLACE (``index_put_``) where the JAX layers return updated caches.

The dense layers take DTensors too (a step under sharding rules):
``constrain`` pins the reference's layouts at the reference's sites (a
no-op without rules), and the cache write and the kernels run on each
rank's shards (``distributed.local``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import constrain, reshape
from repro_torch.kernels import ops as kernel_ops

# ------------------------------------------------------------------ norms


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


# ------------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, L, H, D); positions: (B, L) absolute token positions."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (D/2,)
    angles = positions[..., None].float() * freqs                # (B, L, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention


ATTN_Q_CHUNK = 1024


def attention_core(q: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                   q_positions: torch.Tensor, *, causal: bool,
                   window: Optional[int],
                   kv_valid_len: Optional[torch.Tensor] = None,
                   q_chunk: int = ATTN_Q_CHUNK) -> torch.Tensor:
    """Dense attention of q (B, Lq, Hq, D) over keys / vals (B, S, Hkv,
    D), cache slot s holding absolute position s, through ``ops.mha``.

    Row b's queries sit at q_positions[b, 0] + arange(Lq): the dense
    grid builds every real row so (pad tokens and dummy depth rows park
    at S_max − 1, and their junk outputs and KV land only in the park
    row, which nothing reads).  kv_valid_len (B,): valid keys per row
    (None = all S).  On the card one kernel launch holds no score
    matrix; on the CPU the plain version runs in q-chunks so the
    (Lq × S) score matrix is never held beyond one chunk (long dense
    prefills)."""
    lq = q.shape[1]
    offsets = q_positions[:, 0].to(torch.int32)
    if kv_valid_len is not None:
        kv_valid_len = kv_valid_len.to(torch.int32)
    step = q_chunk if q.device.type == "cpu" else lq
    outs = [kernel_ops.mha(q[:, c0:c0 + step], keys, vals, offsets + c0,
                           kv_valid_len, causal=causal, window=window)
            for c0 in range(0, lq, step)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _split_heads(x: torch.Tensor, h: int, hd: int) -> torch.Tensor:
    """(B, L, H·D) → (B, L, H, D).  A DTensor whose H·D dim is sharded
    over more devices than divide H (8 KV heads of 128 on a 16-way axis:
    1024 columns divide, 8 heads do not) is gathered over those first,
    as the reference's partitioner would reshard it."""
    b, l = x.shape[:2]
    if isinstance(x, DTensor):
        split = [i for i, pl in enumerate(x.placements) if pl == Shard(2)]
        n = 1
        for i in split:
            n *= x.device_mesh.shape[i]
        if h % n:
            x = x.redistribute(x.device_mesh, [
                Replicate() if i in split else pl
                for i, pl in enumerate(x.placements)])
    return x.reshape(b, l, h, hd)


def _qkv(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Shared projection → (qk-norm) → rope of the attention layers.
    x: (B, L, d); positions: (B, L).  Returns q (B, L, Hq, D) and k, v
    (B, L, Hkv, D)."""
    b, l, _ = x.shape
    hd = cfg.hdim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = _split_heads(q, cfg.num_heads, hd)
    k = _split_heads(k, cfg.num_kv_heads, hd)
    v = _split_heads(v, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.causal:  # encoder-only models use absolute (no) rope here
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def write_kv_cache(cache: torch.Tensor, new: torch.Tensor,
                   positions: torch.Tensor) -> None:
    """Write new KV rows into the cache at per-token absolute positions,
    in place.  cache: (B, S, Hkv, D); new: (B, L, Hkv, D); positions:
    (B, L).  A DTensor cache is written on the shards that hold the
    positions (``distributed.local.write_rows``)."""
    if isinstance(cache, DTensor):
        from repro_torch.distributed import local
        local.write_rows(cache, new, positions)
        return
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache.index_put_((rows.expand_as(positions), positions.long()),
                     new.to(cache.dtype))


def write_kv_prefix(cache: torch.Tensor, new: torch.Tensor) -> None:
    """Write new KV (B, L, Hkv, D) into rows [0, L) of every row of the
    cache (B, S, Hkv, D), S >= L, in place: a fresh prefill from
    position 0.  A DTensor cache is written on the shards that hold the
    rows (``distributed.local.write_prefix``)."""
    if isinstance(cache, DTensor):
        from repro_torch.distributed import local
        local.write_prefix(cache, new)
        return
    cache[:, :new.shape[1]].copy_(new)


def attention_layer(p: Dict, x: torch.Tensor, *, cfg,
                    positions: torch.Tensor,
                    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    kv_valid_len: Optional[torch.Tensor] = None,
                    dense_cache_write: bool = False,
                    rolling: bool = False) -> torch.Tensor:
    """One attention mixer over x (B, L, d).

    Without a cache (the dense oracle, an encoder forward):
    self-attention over x.  With ``kv=(K, V)`` cache tensors of shape
    (B, S, Hkv, D) (the dense (L, B) grid step): the new tokens' KV is
    written at ``positions`` in place and attention runs over the cache
    through ``ops.mha``, masked by position; a causal one-token step
    (L == 1, the dense decode step) runs ``ops.decode`` over each row's
    first ``positions + 1`` keys.  ``dense_cache_write``: a fresh full
    prefill from position 0 (L a multiple of S: the cache takes the last
    S tokens' KV; S > L: its first L rows) and attention runs over x.
    ``kv_valid_len`` (B,) bounds each row's keys, and applies only with
    a cache, as in the reference.  ``rolling``: the legacy window-deep
    cache of a sliding-window config (S == window), one token a step:
    position p is written at slot p % S and attends the slots below
    min(p + 1, S) — the reference's ``rolling_mask`` — through
    ``ops.decode``.  Returns (B, L, d)."""
    b, l, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    keys, vals = k, v
    valid = kv_valid_len if kv is not None else None
    if kv is not None and dense_cache_write:
        s_cache = kv[0].shape[1]
        assert s_cache >= l or l % s_cache == 0, (kv[0].shape, l)
        for c, new in zip(kv, (k, v)):
            if s_cache > l:
                # a fresh prefill into a deeper cache: its first L rows
                write_kv_prefix(c, new)
                continue
            # a layout change into the cache's sharding, then a local copy
            c.copy_(constrain(new[:, l - s_cache:], "batch", "cache_seq",
                              "kv_heads", "head_dim"))
    elif kv is not None:
        depth = kv[0].shape[1]
        if rolling and l != 1:
            raise ValueError("a rolling cache takes one-token steps")
        write_pos = positions % depth if rolling else positions
        write_kv_cache(kv[0], k, write_pos)
        write_kv_cache(kv[1], v, write_pos)
        keys, vals = kv
        if l == 1 and cfg.causal and (cfg.sliding_window is None
                                      or rolling):
            lengths = positions[:, 0] + 1
            if rolling:
                lengths = torch.clamp(lengths, max=depth)
            elif valid is not None:
                lengths = torch.minimum(lengths, valid.to(lengths.dtype))
            out = kernel_ops.decode(q[:, 0].contiguous(), keys, vals,
                                    lengths.to(torch.int32))
            out = reshape(out, b, l, cfg.num_heads * cfg.hdim) @ p["wo"]
            return constrain(out, "batch", "seq", "embed_act")
    out = attention_core(q, keys, vals, positions, causal=cfg.causal,
                         window=cfg.sliding_window, kv_valid_len=valid)
    out = reshape(out, b, l, cfg.num_heads * cfg.hdim) @ p["wo"]
    return constrain(out, "batch", "seq", "embed_act")


def _qkv_flat(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """``_qkv`` of a flat stream or decode batch x (T, d) with positions
    (T,): q (T, Hq, D), k and v (T, Hkv, D)."""
    q, k, v = _qkv(p, x[None], cfg, positions[None])
    return q[0], k[0], v[0]


def packed_attention_layer(p: Dict, x: torch.Tensor, *, cfg,
                           positions: torch.Tensor, seg_ids: torch.Tensor,
                           cu_seqlens: torch.Tensor,
                           q_offsets: torch.Tensor,
                           kv_lengths: torch.Tensor,
                           kv: Tuple[torch.Tensor, torch.Tensor]
                           ) -> torch.Tensor:
    """Attention over a packed flat stream, GATHERED caches.

    x: (T, d); kv: (K, V) per-segment caches (B, S, Hkv, D) copied out
    of the slot arena; seg_ids: (T,) cache row each token's KV is
    written to (tail rows write at the park position S − 1).  The write
    is in place; the ragged kernel then attends each stream row to its
    own segment's row only.  Returns out (T, d)."""
    t = x.shape[0]
    q, k, v = _qkv_flat(p, x, cfg, positions)
    idx = (seg_ids.long(), positions.long())
    kv[0].index_put_(idx, k.to(kv[0].dtype))
    kv[1].index_put_(idx, v.to(kv[1].dtype))
    out = kernel_ops.ragged_mha(q, kv[0], kv[1], cu_seqlens, q_offsets,
                                kv_lengths, causal=cfg.causal)
    return out.reshape(t, cfg.num_heads * cfg.hdim) @ p["wo"]


def packed_arena_attention_layer(p: Dict, x: torch.Tensor, *, cfg,
                                 positions: torch.Tensor,
                                 seg_slots: torch.Tensor,
                                 slot_map: torch.Tensor,
                                 cu_seqlens: torch.Tensor,
                                 q_offsets: torch.Tensor,
                                 kv_lengths: torch.Tensor,
                                 kv: Tuple[torch.Tensor, torch.Tensor],
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """Attention over a packed flat stream, SLOT ARENA resident.

    x: (T, d); kv: (K, V) this layer's full arena (N_slots, S_max, Hkv,
    D); positions: (T,) absolute position of each token in its sequence
    (tail rows park at S_max − 1); seg_slots: (T,) arena slot each
    token's KV is written to (tail rows reuse a live slot but write its
    park row, never live data); slot_map: (B,) arena slot per segment.
    Only the step's new KV rows are written, in place; the arena kernel
    attends each stream row to its segment's valid cache prefix.  No
    whole slot is copied.  Returns out (T, d).

    ``window``: the sliding-window width.  Each slot is then a ROLLING
    cache of depth S_max = window + margin, written at position % S_max
    (the wrap overwrites only positions that fell out of every query's
    window while no segment writes more than the margin), tail rows
    park on the scratch slot, and the kernel masks each query to
    (qpos − window, qpos]."""
    t = x.shape[0]
    q, k, v = _qkv_flat(p, x, cfg, positions)
    write_pos = positions if window is None else positions % kv[0].shape[1]
    idx = (seg_slots.long(), write_pos.long())
    kv[0].index_put_(idx, k.to(kv[0].dtype))
    kv[1].index_put_(idx, v.to(kv[1].dtype))
    out = kernel_ops.ragged_mha_arena(q, kv[0], kv[1], slot_map, cu_seqlens,
                                      q_offsets, kv_lengths,
                                      causal=cfg.causal, window=window)
    return out.reshape(t, cfg.num_heads * cfg.hdim) @ p["wo"]


def packed_paged_attention_layer(p: Dict, x: torch.Tensor, *, cfg,
                                 positions: torch.Tensor,
                                 token_pages: torch.Tensor,
                                 token_offs: torch.Tensor,
                                 page_table: torch.Tensor,
                                 cu_seqlens: torch.Tensor,
                                 q_offsets: torch.Tensor,
                                 kv_lengths: torch.Tensor,
                                 kv: Tuple[torch.Tensor, torch.Tensor],
                                 window: Optional[int] = None,
                                 ) -> torch.Tensor:
    """Attention over a packed flat stream, PAGED.

    x: (T, d); kv: (K, V) page pools (N_pages, page_size, Hkv, D) of
    this layer; each segment's cache is the page list in its row of
    ``page_table`` (B, P_max).  positions: (T,) absolute position of
    each token in its sequence; token_pages/token_offs: (T,) physical
    (page, offset) each token's new KV is written to — pad/tail rows
    all target the reserved scratch page at offset page_size − 1, which
    is harmless.  ``window``: the page table is a RING over its P_max
    entries, position p on entry (p // ps) % P_max; the engine computes
    token_pages through it, so only the kernel's mask changes here.  The
    write is in place; returns out (T, d).
    """
    t = x.shape[0]
    q, k, v = _qkv_flat(p, x, cfg, positions)
    idx = (token_pages.long(), token_offs.long())
    kv[0].index_put_(idx, k.to(kv[0].dtype))
    kv[1].index_put_(idx, v.to(kv[1].dtype))
    out = kernel_ops.ragged_mha_paged(q, kv[0], kv[1], page_table,
                                      cu_seqlens, q_offsets, kv_lengths,
                                      causal=cfg.causal, window=window)
    return out.reshape(t, cfg.num_heads * cfg.hdim) @ p["wo"]


def paged_decode_layer(p: Dict, x: torch.Tensor, *, cfg,
                       positions: torch.Tensor,
                       write_pages: torch.Tensor, write_offs: torch.Tensor,
                       page_table: torch.Tensor, kv_lengths: torch.Tensor,
                       kv: Tuple[torch.Tensor, torch.Tensor],
                       window: Optional[int] = None) -> torch.Tensor:
    """Attention for one PAGED decode tick.

    x: (B, d) one new token per row; kv: (K, V) page pools of this
    layer; positions: (B,) absolute position of the new token;
    write_pages/write_offs: (B,) physical (page, offset) its KV lands in
    (pad rows target the scratch page at offset page_size − 1);
    kv_lengths: (B,) valid entries including the new row.  ``window``
    selects the ring-table form (write_pages already walk the ring).
    The write is in place; returns out (B, d).
    """
    b = x.shape[0]
    q, k, v = _qkv(p, x[:, None], cfg, positions[:, None])
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    idx = (write_pages.long(), write_offs.long())
    kv[0].index_put_(idx, k.to(kv[0].dtype))
    kv[1].index_put_(idx, v.to(kv[1].dtype))
    out = kernel_ops.decode_paged(q.contiguous(), kv[0], kv[1], page_table,
                                  kv_lengths, window=window)
    return out.reshape(b, cfg.num_heads * cfg.hdim) @ p["wo"]


def arena_decode_layer(p: Dict, x: torch.Tensor, *, cfg,
                       slot_map: torch.Tensor, positions: torch.Tensor,
                       kv_lengths: torch.Tensor,
                       kv: Tuple[torch.Tensor, torch.Tensor],
                       window: Optional[int] = None) -> torch.Tensor:
    """Attention for one SLOT ARENA decode tick.

    x: (B, d) one new token per row; kv: (K, V) this layer's full arena
    (N_slots, S_max, Hkv, D); slot_map: (B,) arena slot of each row;
    positions: (B,) absolute write position of the new token (its cached
    history; pad rows park at S_max − 1); kv_lengths: (B,) valid entries
    including the new row.  The single new KV row per session is written
    in place and the arena kernel attends each row over its own valid
    prefix.  ``window``: each slot a rolling cache written at position %
    S_max (pad rows on the scratch slot), each row attending its newest
    min(window, length) keys.  Returns out (B, d)."""
    b = x.shape[0]
    q, k, v = _qkv(p, x[:, None], cfg, positions[:, None])
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    write_pos = positions if window is None else positions % kv[0].shape[1]
    idx = (slot_map.long(), write_pos.long())
    kv[0].index_put_(idx, k.to(kv[0].dtype))
    kv[1].index_put_(idx, v.to(kv[1].dtype))
    out = kernel_ops.decode_arena(q.contiguous(), kv[0], kv[1], slot_map,
                                  kv_lengths, window=window)
    return out.reshape(b, cfg.num_heads * cfg.hdim) @ p["wo"]


# ------------------------------------------------------------------- mlp


def swiglu(p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    h = constrain(h, "batch", "seq", "mlp")
    return constrain(h @ p["wo"], "batch", "seq", "embed_act")
