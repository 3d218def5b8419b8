"""Model assembly of the port, from ``repro.models.transformer``: the
dense full-attention decoder stack (its FFNs dense or MoE, its attention
full or windowed), the encoder-only (audio) stack, the attention-free
SSM (mamba2) stack and the hybrid (jamba) stack that interleaves
attention, SSM, dense and MoE layers, their caches, the dense
``forward`` (the oracle the serving steps are held against, the encoder
forward, and with caches the dense (L, B) grid and decode steps),
and the flat-stream serving steps: packed prefill over gathered caches,
over the slot arena and over the page pool, and decode over the slot
arena and over the page pool.

Parameters keep the JAX package's layout: ``blocks`` is a list with one
dict per layer-pattern position whose leaves are stacked over the
``G = num_layers / period`` groups (a dense stack has period 1, a
hybrid one lcm(attn_layer_period, moe_layer_period)).  The reference's
layer scan over groups becomes a Python loop, its unrolled pattern
positions an inner loop, so layer i is group i // p, position i % p.
Every cache (gathered batch, slot arena, page pool) is updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import constrain, unshard
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import moe_dense_reference, moe_layer
from repro_torch.models.layers import (arena_decode_layer, attention_layer,
                                       packed_arena_attention_layer,
                                       packed_attention_layer,
                                       packed_paged_attention_layer,
                                       paged_decode_layer, rms_norm, swiglu)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device without a card
    raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "asks for the CPU (device='cpu')")
    return dev


# a weight whose fp32 draw would take more bytes is drawn one layer
# group at a time (mixtral-8x7b's expert stacks: 30 GB in fp32 at 16
# layers), so the draw never holds an fp32 copy of a whole stack
_DRAW_BYTES = 8 << 30


def pattern_period(cfg: ModelConfig) -> int:
    """Layers in one pattern group: 1, or for a hybrid stack the least
    common multiple of its attention and MoE periods (jamba: 8)."""
    if cfg.family == "hybrid":
        return math.lcm(cfg.attn_layer_period, cfg.moe_layer_period)
    return 1


def num_groups(cfg: ModelConfig) -> int:
    p = pattern_period(cfg)
    if cfg.num_layers % p:
        raise ValueError(
            f"{cfg.name}: num_layers {cfg.num_layers} is not a multiple of "
            f"the layer pattern's period {p}")
    return cfg.num_layers // p


# ------------------------------------------------------------------- init


def _param_tree(cfg: ModelConfig, dense, ones, zeros) -> Dict[str, Any]:
    """The parameter tree built with the caller's makers, each called as
    ``maker(shape, axes)`` (``dense`` also with ``scale=``): ``axes``
    names each dim's logical axis where the leaf is declared, as the
    reference's ``ParamBuilder`` records it.  One block dict per pattern
    position ``j`` — ``ln1``, the mixer (attention or mamba by
    ``cfg.layer_kind(j)``) and, in every family but ``ssm`` (mamba2 has
    no separate FFN), ``ln2`` and an FFN, MoE where
    ``cfg.layer_is_moe(j)`` ({"router" (d, E), "wg", "wi" (E, d, F),
    "wo" (E, F, d)}) and a dense SwiGLU otherwise.  Each block leaf is
    stacked over the groups: a leading dim of G, logical axis None.  The
    blocks are drawn first, position by position, then the embedding and
    the head."""
    g = num_groups(cfg)
    d, hd = cfg.d_model, cfg.hdim

    def stacked(make):
        return lambda shape, axes, **kw: make((g,) + tuple(shape),
                                              (None,) + tuple(axes), **kw)

    bdense, bones, bzeros = stacked(dense), stacked(ones), stacked(zeros)
    blocks = []
    for j in range(pattern_period(cfg)):
        block = {"ln1": bones((d,), (None,))}
        if cfg.layer_kind(j) == "attn":
            qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
            mixer = {"wq": bdense((d, qd), ("embed", "heads")),
                     "wk": bdense((d, kvd), ("embed", "kv_heads")),
                     "wv": bdense((d, kvd), ("embed", "kv_heads")),
                     "wo": bdense((qd, d), ("heads", "embed"))}
            if cfg.qkv_bias:
                mixer.update(bq=bzeros((qd,), ("heads",)),
                             bk=bzeros((kvd,), ("kv_heads",)),
                             bv=bzeros((kvd,), ("kv_heads",)))
            if cfg.qk_norm:
                mixer.update(q_norm=bones((hd,), (None,)),
                             k_norm=bones((hd,), (None,)))
        else:
            mixer = mamba_mod.init_mamba(cfg, bdense, bzeros, bones)
        block["mixer"] = mixer
        if cfg.family != "ssm":
            block["ln2"] = bones((d,), (None,))
            if cfg.layer_is_moe(j):
                e, ff = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
                # expert weights get their own FSDP axis ("expert_embed")
                block["ffn"] = {
                    "router": bdense((d, e), ("embed", None)),
                    "wg": bdense((e, d, ff),
                                 ("experts", "expert_embed", "expert_mlp")),
                    "wi": bdense((e, d, ff),
                                 ("experts", "expert_embed", "expert_mlp")),
                    "wo": bdense((e, ff, d),
                                 ("experts", "expert_mlp", "expert_embed"))}
            else:
                block["ffn"] = {
                    "wg": bdense((d, cfg.d_ff), ("embed", "mlp")),
                    "wi": bdense((d, cfg.d_ff), ("embed", "mlp")),
                    "wo": bdense((cfg.d_ff, d), ("mlp", "embed"))}
        blocks.append(block)
    return {"embed": dense((cfg.padded_vocab, d), ("vocab", "embed"),
                           scale=0.02),
            "blocks": blocks,
            "final_norm": ones((d,), (None,)),
            "lm_head": dense((d, cfg.padded_vocab), ("embed", "vocab"),
                             scale=d ** -0.5)}


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random parameters with the JAX package's shapes and stacked
    ``blocks`` layout (:func:`_param_tree`), drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``.  Dense
    weights are N(0, 1/fan_in) (embed 0.02, lm_head d_model^-0.5), norms
    1, biases 0, in ``cfg.dtype``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = cfg.torch_dtype

    def dense(shape, axes, scale=None):
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
        scale = scale if scale is not None else fan_in ** -0.5
        if 4 * math.prod(shape) <= _DRAW_BYTES:
            w = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32)
            return (w.mul_(scale)).to(dt)
        # too large to draw in fp32 at once: one layer group at a time
        out = torch.empty(shape, dtype=dt, device=dev)
        for i in range(shape[0]):
            w = torch.randn(shape[1:], generator=gen, device=dev,
                            dtype=torch.float32)
            out[i] = w.mul_(scale)
        return out

    def ones(shape, axes):
        return torch.ones(shape, dtype=dt, device=dev)

    def zeros(shape, axes):
        return torch.zeros(shape, dtype=dt, device=dev)

    return _param_tree(cfg, dense, ones, zeros)


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree of :func:`init_params` as shape-only ("meta")
    tensors: its leaf paths, shapes and dtypes, nothing allocated."""
    def meta(shape, axes, scale=None):
        return torch.empty(shape, dtype=cfg.torch_dtype, device="meta")

    return _param_tree(cfg, meta, meta, meta)


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical-axes tree of the parameters (a tuple of names per
    leaf, ``None`` for the group stack), as the reference's
    ``param_axes``."""
    def axes(shape, names, scale=None):
        return tuple(names)

    return _param_tree(cfg, axes, axes, axes)


# ------------------------------------------------------------------ cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda", swa_depth: Optional[int] = None
               ) -> List[Dict[str, torch.Tensor]]:
    """Per-pattern-position cache stacked over groups:

      attn position: {"k": (G, batch, S, Hkv, D), "v": ...}
      ssm  position: {"ssm": (G, batch, NH, HD, DS) fp32,
                      "conv": (G, batch, W-1, C)}

    S is max_len, and for a sliding-window config min(max_len,
    swa_depth or window): the rolling slot arena passes window + margin,
    the dense baseline max_len (it masks the window instead of
    rolling), the page pool page_size.  The slot arena passes batch =
    N_slots(+1 scratch); the paged arena passes batch = N_pages + 1 and
    max_len = page_size, so each KV pool is (G, N_pages + 1, page_size,
    Hkv, D) and the SSM leaves use the page axis as the state-slot
    axis."""
    dev = resolve_device(device)
    g = num_groups(cfg)
    dt = dtype or cfg.torch_dtype
    caches = []
    for j in range(pattern_period(cfg)):
        if cfg.layer_kind(j) == "attn":
            s = max_len
            if cfg.sliding_window is not None:
                s = min(max_len, swa_depth if swa_depth is not None
                        else cfg.sliding_window)
            shape = (g, batch, s, cfg.num_kv_heads, cfg.hdim)
            caches.append({"k": torch.zeros(shape, dtype=dt, device=dev),
                           "v": torch.zeros(shape, dtype=dt, device=dev)})
        else:
            ssm, conv = mamba_mod.init_mamba_cache(cfg, g * batch, dt, dev)
            caches.append({"ssm": ssm.reshape((g, batch) + ssm.shape[1:]),
                           "conv": conv.reshape((g, batch)
                                                + conv.shape[1:])})
    return caches


def cache_logical_axes(cfg: ModelConfig) -> List[Dict[str, Tuple]]:
    """Logical axes of the cache tree of :func:`init_cache` (the serve
    rules shard a KV cache's sequence)."""
    out: List[Dict[str, Tuple]] = []
    for j in range(pattern_period(cfg)):
        if cfg.layer_kind(j) == "attn":
            ax = (None, "batch", "cache_seq", "kv_heads", "head_dim")
            out.append({"k": ax, "v": ax})
        else:
            out.append({"ssm": (None, "batch", "ssm_heads", None, None),
                        "conv": (None, "batch", None, "conv_ch")})
    return out


# ---------------------------------------------------------------- forward


def _layer(block: Dict, g: int) -> Dict:
    """Group ``g``'s slice of a stacked block dict (views, no copies)."""
    return {k: (_layer(v, g) if isinstance(v, dict) else v[g])
            for k, v in block.items()}


def _groups(block: Dict) -> List[Dict]:
    """Every group's slice of a stacked block dict, as views made by one
    ``unbind`` per leaf: under autograd each leaf's grad is then one
    stack of its groups' grads, where a select per group (``_layer``)
    would add a zero-padded full-size grad per group."""
    split = {k: (_groups(v) if isinstance(v, dict) else v.unbind(0))
             for k, v in block.items()}
    n = len(next(iter(split.values())))
    return [{k: v[g] for k, v in split.items()} for g in range(n)]


def _ffn(cfg: ModelConfig, j: int, lp: Dict, x: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Post-mixer FFN residual of pattern position ``j`` over x (..., d)
    (none in a pure SSM stack: the mamba2 block already mixes channels;
    a hybrid's SSM layers have theirs), and
    its MoE aux loss.  An MoE FFN takes the reference's rule: every
    expert on every row (``moe_dense_reference``) for at most 8 experts
    over at most 4096 rows of x — the padded step, bucket tail
    included — else the capacity dispatch (``moe_layer``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        return x, aux
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.layer_is_moe(j):
        k = cfg.num_experts_per_tok
        if cfg.num_experts <= 8 and h.numel() // h.shape[-1] <= 4096:
            y, aux = moe_dense_reference(lp["ffn"], h, top_k=k)
        else:
            y, aux = moe_layer(lp["ffn"], h, top_k=k)
    else:
        y = swiglu(lp["ffn"], h)
    return x + y, aux


def _lm_head_logits(params: Dict, cfg: ModelConfig,
                    x: torch.Tensor) -> torch.Tensor:
    """Final-norm'd rows → logits with the padded-vocab columns masked
    (argmax/softmax safety).  One implementation shared by every
    serving step and the dense oracle.  Vocab-sharded DTensor logits
    take the reference's mask row, added out of place (a slice of a
    sharded dim cannot be written in place)."""
    logits = x @ unshard(params["lm_head"])
    vpad = cfg.padded_vocab - cfg.vocab_size
    if isinstance(logits, DTensor):
        names = ("batch", "seq", "vocab")[3 - logits.dim():]
        logits = constrain(logits, *names)
        if vpad:
            neg = torch.zeros((cfg.padded_vocab,), dtype=logits.dtype,
                              device=logits.device)
            neg[cfg.vocab_size:] = -1e9
            logits = logits + neg
        return logits
    if vpad:
        logits[..., cfg.vocab_size:] += -1e9
    return logits


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The token embedding: a row gather, over a DTensor table (its vocab
    sharded) on each vocab shard (``distributed.local.embed``)."""
    if isinstance(table, DTensor):
        from repro_torch.distributed import local
        return local.embed(unshard(table), tokens)
    return table[tokens.long()]


def _unshard_tree(tree: Dict) -> Dict:
    """Every weight of a layer's dict gathered over the batch's mesh
    axes (``unshard``: FSDP), under sharding rules."""
    return {k: (_unshard_tree(v) if isinstance(v, dict) else unshard(v))
            for k, v in tree.items()}


def forward(params: Dict, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[List[Dict[str, torch.Tensor]]] = None,
            logits_slice: Optional[str] = None,
            seq_valid_len: Optional[torch.Tensor] = None, *,
            embeds: Optional[torch.Tensor] = None,
            kv_valid_len: Optional[torch.Tensor] = None,
            dense_cache_write: bool = False, return_aux: bool = False,
            remat: bool = False, rolling: bool = False):
    """The plain dense forward.

    tokens: (B, L) int — or embeds: (B, L, d), the frame or patch
    embeddings of a stub frontend (hubert's audio encoder, causal
    through a vlm backbone such as phi-3-vision's); positions:
    (B, L) absolute positions (default arange).  Without ``caches`` it
    is the oracle the serving steps are held against (an SSM layer scans
    from a zero state) and the encoder forward.  With ``caches`` (from
    :func:`init_cache` with batch B, e.g. whole slots gathered from the
    arena) each attention layer writes the new tokens' KV at
    ``positions`` in place and attends over its cache through the
    kernels — row b's queries at positions[b, 0] + arange(L), a
    one-token step (L == 1) over its first positions + 1 keys — and
    each SSM layer carries its (ssm, conv) state through the cache in
    place: the dense (L, B) grid step, prefill and re-prefill alike
    (positions carry the history offset), and the (B, 1) decode step.
    kv_valid_len (B,): valid cache entries per row (a padded encoder
    batch), read only with caches.  dense_cache_write: a fresh full
    prefill covering the whole cache (L == S): the KV write is a copy
    and attention runs over the new tokens.  seq_valid_len (B,): real
    tokens per row, read by SSM layers only (padded positions become
    identities of the state).  logits_slice: None → (B, L, V); "last" →
    (B, V) of the final position only.  A sliding-window layer masks its
    window over full-depth caches (the dense baseline's).
    ``return_aux``: return (logits, the MoE load-balance aux loss summed
    over layers), the reference's third result.  ``remat``: recompute
    each layer group's activations in the backward instead of keeping
    them (``torch.utils.checkpoint``, non-reentrant), and, when a group
    holds several layers (a hybrid pattern), each layer's inside it, as
    the reference nests ``jax.checkpoint``; training's forward, so it
    takes no caches (a recompute would write them twice).  ``rolling``:
    the legacy window-deep cache of a sliding-window config (from
    :func:`init_cache` with its default depth, the window), one token a
    step, each written at position % window (the reference's
    ``rolling=True``; the dry run's long decode cells).

    Under sharding rules (``distributed.use_rules`` with a mesh) the
    params, caches and inputs are DTensors: ``constrain`` pins the
    reference's layouts at its sites and the kernels run on each rank's
    shards.  The caches are written in place, so they keep their
    placements, where the reference re-constrains its carried caches."""
    if remat and caches is not None:
        raise ValueError("forward(remat=True) takes no caches")
    if embeds is None:
        x = _embed(params["embed"], tokens)
    else:
        x = embeds.to(params["embed"].dtype)
    b, l = x.shape[:2]
    if positions is None:
        positions = torch.arange(l, device=x.device)[None].expand(b, l)
    x = constrain(x, "batch", "seq", "embed_act")
    decode = l == 1 and caches is not None
    period = len(params["blocks"])
    groups = [_groups(block) for block in params["blocks"]]

    def layer(x, g, j):
        lp = groups[j][g]
        if isinstance(lp["ln1"], DTensor):
            lp = _unshard_tree(lp)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.layer_kind(j) == "attn":
            kv = None if caches is None else (caches[j]["k"][g],
                                              caches[j]["v"][g])
            x = x + attention_layer(
                lp["mixer"], h, cfg=cfg, positions=positions, kv=kv,
                kv_valid_len=kv_valid_len,
                dense_cache_write=dense_cache_write, rolling=rolling)
        else:
            cc = None if caches is None else (caches[j]["ssm"][g],
                                              caches[j]["conv"][g])
            mix, upd = mamba_mod.mamba_layer(
                lp["mixer"], h, cfg=cfg, cache=cc, decode=decode,
                valid_len=seq_valid_len)
            if upd is not None:
                cc[0].copy_(upd[0])
                cc[1].copy_(upd[1])
            x = x + mix
        return _ffn(cfg, j, lp, x)

    def group(x, aux, g):
        for j in range(period):
            if remat and period > 1:
                x, a = checkpoint(layer, x, g, j, use_reentrant=False)
            else:
                x, a = layer(x, g, j)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(num_groups(cfg)):
        if remat:
            x, aux = checkpoint(group, x, aux, g, use_reentrant=False)
        else:
            x, aux = group(x, aux, g)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_slice == "last":
        x = x[:, -1]
    logits = _lm_head_logits(params, cfg, x)
    return (logits, aux) if return_aux else logits


def _scan_serving_stack(params: Dict, cfg: ModelConfig,
                        tokens: torch.Tensor,
                        caches: List[Dict[str, torch.Tensor]],
                        mix_fn) -> torch.Tensor:
    """Shared layer loop of the flat-stream serving steps: embed →
    per-layer {norm → mix_fn → FFN} → final norm.

    mix_fn(j, layer_params, h, cache_j) → mix, where cache_j is the
    layer's {"k", "v"} or {"ssm", "conv"} slice (views: mix_fn writes
    them in place).  Returns the final-normed activations."""
    x = params["embed"][tokens.long()]
    for g in range(num_groups(cfg)):
        for j, block in enumerate(params["blocks"]):
            lp = _layer(block, g)
            cache_j = {name: pool[g] for name, pool in caches[j].items()}
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            x = x + mix_fn(j, lp["mixer"], h, cache_j)
            x = _ffn(cfg, j, lp, x)[0]
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


# ------------------------------------------------- capability descriptor


@dataclasses.dataclass(frozen=True)
class LayerCapability:
    """Arena capability of ONE pattern position: "attn" (full-attention
    KV slots or pages), "attn_window" (rolling window-deep KV slots or
    ring page tables, and the windowed kernels; ``window`` its width) or
    "ssm" (a recurrent-state slot stepped in place)."""
    kind: str
    window: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ArenaCapability:
    """Per-layer arena-residency descriptor of a model config."""
    layers: Tuple[LayerCapability, ...]   # one per pattern position
    causal: bool

    @property
    def packed_ok(self) -> bool:
        return self.causal

    @property
    def pure_attn(self) -> bool:
        return all(c.kind == "attn" for c in self.layers)

    @property
    def has_window(self) -> bool:
        return any(c.kind == "attn_window" for c in self.layers)

    @property
    def has_ssm(self) -> bool:
        return any(c.kind == "ssm" for c in self.layers)

    @property
    def window(self) -> Optional[int]:
        for c in self.layers:
            if c.kind == "attn_window":
                return c.window
        return None

    @property
    def needs_scratch_slot(self) -> bool:
        """Rolling KV slots have no spare park row and SSM state has no
        park position at all: pads must target a dedicated scratch slot
        instead of aliasing a live one."""
        return self.has_window or self.has_ssm


def arena_capability(cfg: ModelConfig) -> ArenaCapability:
    """Per-layer capability descriptor (the routing contract)."""
    layers = []
    for j in range(pattern_period(cfg)):
        if cfg.layer_kind(j) != "attn":
            layers.append(LayerCapability("ssm"))
        elif cfg.sliding_window is not None:
            layers.append(LayerCapability("attn_window",
                                          window=cfg.sliding_window))
        else:
            layers.append(LayerCapability("attn"))
    return ArenaCapability(layers=tuple(layers), causal=cfg.causal)


def _ssm_bridge(t: int, cu_seqlens: torch.Tensor, b: int
                ) -> Dict[str, torch.Tensor]:
    """Flat → (segment row, local index) bridge of the SSM layers,
    computed once per step and shared by every ssm pattern position:
    seg_rows / seg_pos (T,), valid_row (T,) (False on bucket-tail rows)
    and seg_lens (B,) new tokens per segment (0 for pads)."""
    cu = cu_seqlens.long()
    rows = torch.arange(t, device=cu.device)
    seg = (rows[:, None] >= cu[None, 1:]).sum(dim=1)
    seg_rows = seg.clamp(0, b - 1)
    return {"seg_rows": seg_rows, "seg_pos": rows - cu[seg_rows],
            "valid_row": rows < cu[-1], "seg_lens": cu[1:] - cu[:-1]}


# ------------------------------------------------- packed slot serving


def forward_packed(params: Dict, cfg: ModelConfig, *,
                   tokens: torch.Tensor,
                   positions: torch.Tensor,
                   seg_ids: torch.Tensor,
                   cu_seqlens: torch.Tensor,
                   q_offsets: torch.Tensor,
                   kv_lengths: torch.Tensor,
                   caches: List[Dict[str, torch.Tensor]],
                   last_idx: torch.Tensor) -> torch.Tensor:
    """Padding-free forward over a packed flat stream with GATHERED
    caches: prefill, re-prefill, chunk and decode segments side by side.

    tokens/positions/seg_ids: (T,) — every segment's new tokens, each
    with its absolute position and its cache row; segment i owns rows
    [cu_seqlens[i], cu_seqlens[i+1]); rows past cu_seqlens[-1] are
    bucket tail (parked positions).  caches: {"k"/"v": (G, B, S, Hkv,
    D)}, whole arena slots copied out by the caller, written in place.
    last_idx: (B,) flat index of each segment's final token.  Returns
    last_logits (B, V).  Attention-only: an SSM state has no gathered
    form."""
    assert arena_capability(cfg).pure_attn, \
        f"{cfg.name}: the gathered packed path is attention-only"

    def mix_fn(j, lp, h, cache_j):
        return packed_attention_layer(
            lp, h, cfg=cfg, positions=positions, seg_ids=seg_ids,
            cu_seqlens=cu_seqlens, q_offsets=q_offsets,
            kv_lengths=kv_lengths, kv=(cache_j["k"], cache_j["v"]))

    x = _scan_serving_stack(params, cfg, tokens, caches, mix_fn)
    return _lm_head_logits(params, cfg, x[last_idx.long()])


def forward_packed_arena(params: Dict, cfg: ModelConfig, *,
                         tokens: torch.Tensor,
                         positions: torch.Tensor,
                         seg_slots: torch.Tensor,
                         slot_map: torch.Tensor,
                         cu_seqlens: torch.Tensor,
                         q_offsets: torch.Tensor,
                         kv_lengths: torch.Tensor,
                         arena: List[Dict[str, torch.Tensor]],
                         last_idx: torch.Tensor) -> torch.Tensor:
    """Arena-resident packed forward: :func:`forward_packed` with the
    slot arena itself ({"k"/"v": (G, N_slots, S_max, Hkv, D)}) read and
    written IN PLACE instead of gathered caches.

    seg_slots (T,) carries each token's arena slot (tail rows reuse a
    live slot but park at S_max − 1); slot_map (B,) routes each
    segment's KV reads inside the kernel.  Each layer writes only the
    step's new KV rows, so a step moves O(history + new) rows, not the
    O(b_max · S_max) whole-slot copies of the gathered path.  SSM
    positions step each segment's state slot at ``slot_map`` in place
    (pad segments point at the arena's scratch slot).  Returns
    last_logits (B, V)."""
    cap = arena_capability(cfg)
    bridge = (_ssm_bridge(tokens.shape[0], cu_seqlens, slot_map.shape[0])
              if cap.has_ssm else None)

    def mix_fn(j, lp, h, cache_j):
        if cap.layers[j].kind == "ssm":
            return mamba_mod.packed_arena_mamba_layer(
                lp, h, cfg=cfg, slot_map=slot_map, cache=cache_j, **bridge)
        return packed_arena_attention_layer(
            lp, h, cfg=cfg, positions=positions, seg_slots=seg_slots,
            slot_map=slot_map, cu_seqlens=cu_seqlens, q_offsets=q_offsets,
            kv_lengths=kv_lengths, kv=(cache_j["k"], cache_j["v"]),
            window=cap.layers[j].window)

    x = _scan_serving_stack(params, cfg, tokens, arena, mix_fn)
    return _lm_head_logits(params, cfg, x[last_idx.long()])


def forward_decode_arena(params: Dict, cfg: ModelConfig, *,
                         tokens: torch.Tensor,
                         slot_map: torch.Tensor,
                         write_pos: torch.Tensor,
                         kv_lengths: torch.Tensor,
                         arena: List[Dict[str, torch.Tensor]]
                         ) -> torch.Tensor:
    """One arena-resident decode tick: B rows advance one token each
    against the slot arena IN PLACE.

    tokens: (B,) last sampled token per row; slot_map: (B,) arena slot
    of each row; write_pos: (B,) absolute position of the new token (the
    row's cached history; pad rows park at S_max − 1); kv_lengths: (B,)
    valid entries INCLUDING the new row (pad rows 1).  SSM positions
    step each row's state slot in place (pad rows point at the scratch
    slot).  Returns logits (B, V).  B is a decode-ladder rung."""
    cap = arena_capability(cfg)

    def mix_fn(j, lp, h, cache_j):
        if cap.layers[j].kind == "ssm":
            return mamba_mod.arena_decode_mamba_layer(
                lp, h, cfg=cfg, slot_map=slot_map, cache=cache_j)
        return arena_decode_layer(
            lp, h, cfg=cfg, slot_map=slot_map, positions=write_pos,
            kv_lengths=kv_lengths, kv=(cache_j["k"], cache_j["v"]),
            window=cap.layers[j].window)

    x = _scan_serving_stack(params, cfg, tokens, arena, mix_fn)
    return _lm_head_logits(params, cfg, x)


def forward_packed_verify_arena(params: Dict, cfg: ModelConfig, *,
                                tokens: torch.Tensor,
                                positions: torch.Tensor,
                                seg_slots: torch.Tensor,
                                slot_map: torch.Tensor,
                                cu_seqlens: torch.Tensor,
                                q_offsets: torch.Tensor,
                                kv_lengths: torch.Tensor,
                                arena: List[Dict[str, torch.Tensor]],
                                gather_idx: torch.Tensor) -> torch.Tensor:
    """Speculative verification step: the unchanged
    :func:`forward_packed_arena` dispatch gathering L logit rows per
    segment instead of one.

    Each verify segment ``[t0, d_1..d_{L-1}]`` is a length-L re-prefill
    scored against its arena history; ``gather_idx (B, L)`` names every
    row of every segment (other segments repeat their last row), so row
    j of a segment scores position ``history + j + 1``.  Returns logits
    (B, L, V)."""
    b, l = gather_idx.shape
    logits = forward_packed_arena(
        params, cfg, tokens=tokens, positions=positions,
        seg_slots=seg_slots, slot_map=slot_map, cu_seqlens=cu_seqlens,
        q_offsets=q_offsets, kv_lengths=kv_lengths, arena=arena,
        last_idx=gather_idx.reshape(-1))
    return logits.reshape(b, l, -1)


# ------------------------------------------------------- paged serving


def forward_packed_paged(params: Dict, cfg: ModelConfig, *,
                         tokens: torch.Tensor,
                         positions: torch.Tensor,
                         token_pages: torch.Tensor,
                         token_offs: torch.Tensor,
                         page_table: torch.Tensor,
                         cu_seqlens: torch.Tensor,
                         q_offsets: torch.Tensor,
                         kv_lengths: torch.Tensor,
                         arena: List[Dict[str, torch.Tensor]],
                         last_idx: torch.Tensor,
                         state_map: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Paged packed forward: prefill, chunk and decode segments side by
    side in one flat stream, one logit row per segment via ``last_idx``.

    The cache is a page POOL per pattern position ({"k"/"v": (G,
    N_pages + 1, page_size, Hkv, D)}) and each segment's logical cache is
    the ordered page list in its row of ``page_table (B, P_max)``.
    Pages may be shared between segments; writes land via
    ``token_pages`` / ``token_offs (T,)``, which the PagedKVArena only
    points at exclusively-owned pages (pads park on the scratch page).
    SSM positions hold each session's recurrent state on a STATE PAGE —
    the pool's page axis doubles as the state-slot axis ({"ssm": (G,
    N_pages + 1, NH, HD, DS), "conv": ...}) — and ``state_map (B,)``
    names each segment's state page (pads point at the scratch page).
    The pools are updated in place.  Returns last_logits (B, V)."""
    cap = arena_capability(cfg)
    bridge = None
    if cap.has_ssm:
        assert state_map is not None, "paged SSM needs a state_map"
        bridge = _ssm_bridge(tokens.shape[0], cu_seqlens,
                             page_table.shape[0])

    def mix_fn(j, lp, h, cache_j):
        if cap.layers[j].kind == "ssm":
            return mamba_mod.packed_arena_mamba_layer(
                lp, h, cfg=cfg, slot_map=state_map, cache=cache_j, **bridge)
        return packed_paged_attention_layer(
            lp, h, cfg=cfg, positions=positions, token_pages=token_pages,
            token_offs=token_offs, page_table=page_table,
            cu_seqlens=cu_seqlens, q_offsets=q_offsets,
            kv_lengths=kv_lengths, kv=(cache_j["k"], cache_j["v"]),
            window=cap.layers[j].window)

    x = _scan_serving_stack(params, cfg, tokens, arena, mix_fn)
    return _lm_head_logits(params, cfg, x[last_idx.long()])


def forward_packed_verify_paged(params: Dict, cfg: ModelConfig, *,
                                tokens: torch.Tensor,
                                positions: torch.Tensor,
                                token_pages: torch.Tensor,
                                token_offs: torch.Tensor,
                                page_table: torch.Tensor,
                                cu_seqlens: torch.Tensor,
                                q_offsets: torch.Tensor,
                                kv_lengths: torch.Tensor,
                                arena: List[Dict[str, torch.Tensor]],
                                gather_idx: torch.Tensor) -> torch.Tensor:
    """Paged speculative verification: :func:`forward_packed_paged`
    gathering L logit rows per segment via ``gather_idx (B, L)`` (see
    :func:`forward_packed_verify_arena`).  Returns logits (B, L, V)."""
    b, l = gather_idx.shape
    logits = forward_packed_paged(
        params, cfg, tokens=tokens, positions=positions,
        token_pages=token_pages, token_offs=token_offs,
        page_table=page_table, cu_seqlens=cu_seqlens, q_offsets=q_offsets,
        kv_lengths=kv_lengths, arena=arena, last_idx=gather_idx.reshape(-1))
    return logits.reshape(b, l, -1)


def forward_decode_paged(params: Dict, cfg: ModelConfig, *,
                         tokens: torch.Tensor,
                         positions: torch.Tensor,
                         write_pages: torch.Tensor,
                         write_offs: torch.Tensor,
                         page_table: torch.Tensor,
                         kv_lengths: torch.Tensor,
                         arena: List[Dict[str, torch.Tensor]],
                         state_map: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One PAGED decode tick.

    tokens: (B,) last sampled token per row; positions: (B,) absolute
    position of the new token; write_pages/write_offs: (B,) physical
    (page, offset) its KV lands in (pad rows park on the scratch page at
    offset page_size − 1); page_table: (B, P_max); kv_lengths: (B,)
    valid entries INCLUDING the new row.  SSM positions step the state
    page named by ``state_map (B,)`` in place (pads point at the scratch
    page).  The pools are updated in place.  Returns logits (B, V)."""
    cap = arena_capability(cfg)
    assert not cap.has_ssm or state_map is not None, \
        "paged SSM needs a state_map"

    def mix_fn(j, lp, h, cache_j):
        if cap.layers[j].kind == "ssm":
            return mamba_mod.arena_decode_mamba_layer(
                lp, h, cfg=cfg, slot_map=state_map, cache=cache_j)
        return paged_decode_layer(
            lp, h, cfg=cfg, positions=positions, write_pages=write_pages,
            write_offs=write_offs, page_table=page_table,
            kv_lengths=kv_lengths, kv=(cache_j["k"], cache_j["v"]),
            window=cap.layers[j].window)

    x = _scan_serving_stack(params, cfg, tokens, arena, mix_fn)
    return _lm_head_logits(params, cfg, x)
