"""Input specs for every (arch x shape) dry-run cell, from
``repro.launch.specs``.

Each argument of a train / prefill / decode / encode step is an
:class:`ArgSpec` — its global shape, dtype and spec (the counterpart of
the reference's sharded ``ShapeDtypeStruct``) — that makes a meta
DTensor holding only this rank's shard (``ArgSpec.meta``): nothing is
allocated.  Modality frontends are stubs, as in the reference: a
frontend config takes precomputed patch / frame embeddings of the
backbone width instead of token ids.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed.sharding import (ShardingRules, Spec,
                                              placements, shard, spec_for)
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """One step argument: global shape, dtype and spec (``()`` without a
    mesh)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Spec

    def meta(self, mesh: Optional[DeviceMesh]) -> torch.Tensor:
        """A meta DTensor of this rank's shard placed by the spec (a
        plain meta tensor without a mesh)."""
        x = torch.empty(self.shape, dtype=self.dtype, device="meta")
        if mesh is None:
            return x
        spec = self.spec or (None,) * len(self.shape)
        return shard(x, placements(spec, mesh), mesh)


def _sds(shape, dtype, logical, rules: ShardingRules) -> ArgSpec:
    return ArgSpec(tuple(shape), dtype, spec_for(shape, logical, rules))


@dataclasses.dataclass
class CellSpec:
    kind: str                      # train | prefill | decode | encode
    args: Tuple                    # positional ArgSpec trees after params
    accum: int = 1
    rolling: bool = False
    with_embeds: bool = False
    cache_len: Optional[int] = None


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                rules: ShardingRules):
    """ArgSpecs of the cache tree of ``tr.init_cache``, with its logical
    axes' specs."""
    shapes = tr.init_cache(cfg, batch, max_len, device="meta")
    axes = tr.cache_logical_axes(cfg)
    return [{k: _sds(v.shape, v.dtype, ax[k], rules) for k, v in cs.items()}
            for cs, ax in zip(shapes, axes)]


def train_accum(shape: ShapeSpec, cfg: Optional[ModelConfig] = None
                ) -> Tuple[int, int]:
    """(accum_steps, microbatch) for the train shape.  The largest models
    (>= 30B total params) take deeper accumulation: smaller microbatch
    activations keep them inside device memory."""
    accum = 4
    if cfg is not None and cfg.param_count() > 30e9:
        accum = 8
    return accum, shape.global_batch // accum


def input_specs(cfg: ModelConfig, shape: ShapeSpec, rules: ShardingRules,
                accum_override: Optional[int] = None) -> CellSpec:
    b, s = shape.global_batch, shape.seq_len
    emb = cfg.frontend is not None
    act = cfg.torch_dtype
    i32 = torch.int32
    if shape.kind == "train":
        a, mb = train_accum(shape, cfg)
        if accum_override:
            a, mb = accum_override, shape.global_batch // accum_override
        batch: Dict[str, Any] = {
            "labels": _sds((a, mb, s), i32, (None, "batch", "seq"), rules),
        }
        if emb:
            batch["embeds"] = _sds((a, mb, s, cfg.d_model), act,
                                   (None, "batch", "seq", "embed_act"), rules)
        else:
            batch["tokens"] = _sds((a, mb, s), i32, (None, "batch", "seq"),
                                   rules)
        return CellSpec("train", (batch,), accum=a, with_embeds=emb)

    if shape.kind == "prefill":
        if cfg.is_encoder_only:
            x = _sds((b, s, cfg.d_model), act, ("batch", "seq", "embed_act"),
                     rules)
            return CellSpec("encode", (x,), with_embeds=True)
        tokens = (_sds((b, s, cfg.d_model), act,
                       ("batch", "seq", "embed_act"), rules) if emb else
                  _sds((b, s), i32, ("batch", "seq"), rules))
        positions = _sds((b, s), i32, ("batch", "seq"), rules)
        caches = cache_specs(cfg, b, s, rules)
        sample_idx = _sds((b,), i32, ("batch",), rules)
        return CellSpec("prefill", (tokens, positions, caches, sample_idx),
                        with_embeds=emb, cache_len=s)

    # decode: one new token against a cache of seq_len
    cache_len = s
    rolling = False
    if cfg.sliding_window is not None and s > cfg.sliding_window:
        cache_len = cfg.sliding_window       # rolling-window KV (mixtral)
        rolling = True
    tokens = _sds((b, 1), i32, ("batch", None), rules)
    positions = _sds((b, 1), i32, ("batch", None), rules)
    caches = cache_specs(cfg, b, cache_len, rules)
    return CellSpec("decode", (tokens, positions, caches), rolling=rolling,
                    cache_len=cache_len)
