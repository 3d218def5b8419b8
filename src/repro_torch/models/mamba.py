"""Mamba2 (SSD) mixer of the port, from ``repro.models.mamba``.

Sequence mode (prefill, re-prefill, chunks, the dense grid) runs the
chunked SSD scan through ``kernels.ops.ssd_grouped`` — the hand-written
CUDA kernel on the card, its plain version on the CPU; decode runs the
O(1) recurrent step ``ssd_step`` in plain PyTorch, as the reference keeps
it in jnp.  The per-layer recurrent cache is ``(ssm_state, conv_state)``:

  ssm_state:  (B, nheads, head_dim, d_state)   fp32
  conv_state: (B, conv_width-1, conv_channels) activation dtype

The arena layers read each row's state at ``slot_map`` and write the
stepped state back in place (the JAX layers return updated arenas).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import rms_norm


def conv_channels(cfg) -> int:
    return cfg.ssm_d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state_size


def init_mamba(cfg, dense, zeros, ones) -> Dict[str, torch.Tensor]:
    """One mixer's parameters, drawn with the caller's ``dense`` /
    ``zeros`` / ``ones`` makers (``transformer._param_tree``: each takes
    the leaf's shape and logical axes); ``A_log`` is log(linspace(1, 16,
    nheads)), as in the reference."""
    di, ds, nh = cfg.ssm_d_inner, cfg.ssm_state_size, cfg.ssm_nheads
    w, c = cfg.ssm_conv_width, conv_channels(cfg)
    proj_out = 2 * di + 2 * cfg.ssm_n_groups * ds + nh   # z, x, B, C, dt
    a_rows = ones((nh,), ("ssm_heads",))
    if isinstance(a_rows, torch.Tensor):
        a_log = torch.log(torch.linspace(1.0, 16.0, nh))
        a_rows = a_rows.mul_(a_log.to(a_rows.device))
    return {"in_proj": dense((cfg.d_model, proj_out), ("embed", "ssm_inner")),
            "conv_w": dense((w, c), (None, "conv_ch"), scale=w ** -0.5),
            "conv_b": zeros((c,), ("conv_ch",)),
            "dt_bias": zeros((nh,), ("ssm_heads",)),
            "A_log": a_rows,
            "D": ones((nh,), ("ssm_heads",)),
            "norm": ones((di,), (None,)),
            "out_proj": dense((di, cfg.d_model), ("ssm_inner", "embed"))}


def _causal_conv_seq(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     conv_state: Optional[torch.Tensor],
                     valid_len: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  xbc: (B, L, C); w: (W, C); returns (y,
    new_state).  valid_len (B,): per-row count of real tokens — the new
    conv state is taken from each row's true end, so right-padding
    cannot corrupt the recurrent state."""
    width = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                    # (B, W-1+L, C)
    l = xbc.shape[1]
    y = sum(full[:, j:j + l, :] * w[j][None, None, :] for j in range(width))
    y = F.silu(y + b[None, None, :])
    if valid_len is None:
        new_state = full[:, full.shape[1] - (width - 1):, :]
    else:
        # token t sits at row (W-1)+t of `full`; the last W-1 real inputs
        # of row i are rows valid_len[i] .. valid_len[i]+W-2
        idx = valid_len.long()[:, None] + torch.arange(
            width - 1, device=xbc.device)[None, :]
        new_state = torch.gather(
            full, 1, idx[:, :, None].expand(-1, -1, full.shape[2]))
    return y, new_state


def _causal_conv_step(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      conv_state: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token conv step.  xbc: (B, 1, C); conv_state: (B, W-1, C)."""
    window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)  # (B, W, C)
    y = torch.einsum("bwc,wc->bc", window, w)[:, None, :]
    y = F.silu(y + b[None, None, :])
    return y, window[:, 1:, :]


def _split_proj(cfg, proj: torch.Tensor):
    di, ds, nh = cfg.ssm_d_inner, cfg.ssm_state_size, cfg.ssm_nheads
    g = cfg.ssm_n_groups
    return torch.split(proj, [di, di, g * ds, g * ds, nh], dim=-1)


def ssd_step(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bg: torch.Tensor, cg: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  xh: (B, 1, NH, HD); bg, cg: (B, 1, G, DS);
    state: (B, NH, HD, DS) fp32.  Plain PyTorch, as the reference keeps
    it jnp: O(NH·HD·DS) per row, no scan to fuse."""
    f32 = torch.float32
    b, nh, hd = xh.shape[0], xh.shape[2], xh.shape[3]
    g, ds = bg.shape[2], bg.shape[3]
    hpg = nh // g
    x0 = xh[:, 0].to(f32).reshape(b, g, hpg, hd)
    d0 = dt[:, 0].to(f32).reshape(b, g, hpg)
    b0 = bg[:, 0].to(f32)                                  # (b, g, ds)
    c0 = cg[:, 0].to(f32)
    ag = a.reshape(g, hpg).to(f32)
    st = state.to(f32).reshape(b, g, hpg, hd, ds)
    da = torch.exp(d0 * ag[None])                          # (b, g, hpg)
    new = da[..., None, None] * st + torch.einsum(
        "bgh,bghp,bgd->bghpd", d0, x0, b0)
    y = torch.einsum("bghpd,bgd->bghp", new, c0)
    return (y.reshape(b, 1, nh, hd).to(xh.dtype),
            new.reshape(b, nh, hd, ds))


def mamba_layer(p: Dict, x: torch.Tensor, *, cfg,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                decode: bool = False,
                valid_len: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor,
                           Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Full Mamba2 block.  x: (B, L, d_model).

    cache = (ssm_state, conv_state) carries recurrent state across turns
    (re-prefill) and steps (decode).  Returns (y, new_cache) — new_cache
    is None without a cache.  valid_len (B,): real tokens per row;
    padded positions get dt = 0, an exact identity of the SSD step.
    """
    a = -torch.exp(p["A_log"].float())
    # a DTensor is split along its columns only once they are whole on
    # every rank (DTensor would otherwise gather its batch too)
    proj = constrain(x @ p["in_proj"], "batch", "seq", None)
    z, xs, bmat, cmat, dt_raw = _split_proj(cfg, proj)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)
    xbc = constrain(xbc, "batch", "seq", "conv_ch")

    ssm_state = conv_state = None
    if cache is not None:
        ssm_state, conv_state = cache

    if decode:
        xbc, conv_state = _causal_conv_step(xbc, p["conv_w"], p["conv_b"],
                                            conv_state)
    else:
        xbc, conv_state = _causal_conv_seq(xbc, p["conv_w"], p["conv_b"],
                                           conv_state, valid_len)

    di, ds, g = cfg.ssm_d_inner, cfg.ssm_state_size, cfg.ssm_n_groups
    bsz, l = x.shape[0], x.shape[1]
    xbc = constrain(xbc, "batch", "seq", None)
    xs, bmat, cmat = torch.split(xbc, [di, g * ds, g * ds], dim=-1)
    # views into the conv output: the kernel reads them in place
    xh = xs.reshape(bsz, l, cfg.ssm_nheads, cfg.ssm_head_dim)
    bg = bmat.reshape(bsz, l, g, ds)
    cg = cmat.reshape(bsz, l, g, ds)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    if valid_len is not None and not decode:
        keep = (torch.arange(l, device=x.device)[None, :]
                < valid_len.long()[:, None])
        dt = torch.where(keep[:, :, None], dt, 0.0)
    xh = constrain(xh, "batch", "seq", "ssm_heads", None)

    if decode and isinstance(xh, DTensor):
        from repro_torch.distributed import local
        y, ssm_state = local.heads_local(ssd_step, xh, dt, a, bg, cg,
                                         ssm_state)
    elif decode:
        y, ssm_state = ssd_step(xh, dt, a, bg, cg, ssm_state)
    else:
        y, ssm_state = kernel_ops.ssd_grouped(xh, dt, a, bg, cg, ssm_state,
                                              chunk=cfg.ssm_chunk)

    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(bsz, l, di)
    # gated norm: silu stays in model dtype (rms_norm is fp32 inside)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = constrain(y @ p["out_proj"], "batch", "seq", "embed_act")
    new_cache = (ssm_state, conv_state) if cache is not None else None
    return out, new_cache


def init_mamba_cache(cfg, batch: int, dtype, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    ssm = torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_head_dim,
                       cfg.ssm_state_size), dtype=torch.float32,
                      device=device)
    conv = torch.zeros((batch, cfg.ssm_conv_width - 1, conv_channels(cfg)),
                       dtype=dtype, device=device)
    return ssm, conv


# --------------------------------------------------- arena-resident serving


def _write_states(cache: Dict[str, torch.Tensor], slot_map: torch.Tensor,
                  ssm: torch.Tensor, conv: torch.Tensor) -> None:
    """Write each row's stepped state back at its slot, in place.  Live
    slots are distinct; every pad row targets the scratch slot, where
    the duplicate writes land in an undefined order (as in JAX)."""
    idx = slot_map.long()
    cache["ssm"].index_put_((idx,), ssm.to(cache["ssm"].dtype))
    cache["conv"].index_put_((idx,), conv.to(cache["conv"].dtype))


def packed_arena_mamba_layer(p: Dict, x: torch.Tensor, *, cfg,
                             slot_map: torch.Tensor,
                             cache: Dict[str, torch.Tensor],
                             seg_rows: torch.Tensor, seg_pos: torch.Tensor,
                             valid_row: torch.Tensor,
                             seg_lens: torch.Tensor) -> torch.Tensor:
    """Mamba2 mixer over a packed flat stream with an SSM STATE ARENA:
    each segment's recurrent state is read at ``slot_map`` and the
    stepped state written back in place.

    x: (T, d) flat stream; cache: {"ssm": (N_slots(+1), NH, HD, DS),
    "conv": (N_slots(+1), W-1, C)} — this layer's state arenas;
    slot_map: (B,) arena slot per segment (pad segments point at the
    scratch slot); seg_rows/seg_pos: (T,) each flat token's (segment
    row, local index); valid_row: (T,) bool; seg_lens: (B,) new tokens
    per segment (0 for pads, which makes their update an identity).

    The SSD scan is sequential per segment, so the flat stream is
    bridged to a dense (B, T, d) view for the scan and gathered back.
    The bridge drops the bucket-tail rows explicitly: they scatter into
    a spare row B of a (B + 1, T, d) buffer that is cut off before the
    layer (the JAX layer scatters them out of bounds with
    ``mode="drop"``, which PyTorch refuses and the card would assert
    on).  Returns out (T, d)."""
    t, d = x.shape
    b = slot_map.shape[0]
    dest_rows = torch.where(valid_row, seg_rows, b).long()
    dense = torch.zeros((b + 1, t, d), dtype=x.dtype, device=x.device)
    dense.index_put_((dest_rows, seg_pos.long()), x)
    idx = slot_map.long()
    y, (ssm1, conv1) = mamba_layer(
        p, dense[:b], cfg=cfg, cache=(cache["ssm"][idx], cache["conv"][idx]),
        decode=False, valid_len=seg_lens)
    out = y[dest_rows.clamp(max=b - 1), seg_pos.long()]
    out = torch.where(valid_row[:, None], out, 0.0).to(x.dtype)
    _write_states(cache, slot_map, ssm1, conv1)
    return out


def arena_decode_mamba_layer(p: Dict, x: torch.Tensor, *, cfg,
                             slot_map: torch.Tensor,
                             cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One arena-resident decode tick through a Mamba2 mixer: every
    row's recurrent state is read at ``slot_map``, stepped once and
    written back in place.  x: (B, d); pad rows point at the scratch
    slot.  Returns out (B, d)."""
    idx = slot_map.long()
    y, (ssm1, conv1) = mamba_layer(
        p, x[:, None, :], cfg=cfg,
        cache=(cache["ssm"][idx], cache["conv"][idx]), decode=True)
    _write_states(cache, slot_map, ssm1, conv1)
    return y[:, 0]
