"""Model configuration of the port: ``repro.models.config.ModelConfig``
with its dtype string mapped to a torch dtype.

One dataclass describes every architecture family of the JAX package,
so the fields stay the same (with the dry run's input-shape cells,
``SHAPES``); the port serves the dense, MoE and vlm
(the backbone) decoder families, the SSM (mamba2) family and the hybrid
(jamba) family, and runs the encoder-only (audio) family through
``forward``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | ssm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default d_model // num_heads
    # --- attention options -------------------------------------------------
    qk_norm: bool = False            # per-head RMSNorm on q,k (qwen3)
    qkv_bias: bool = False           # bias on qkv projections (qwen2.5)
    sliding_window: Optional[int] = None   # SWA width (mixtral)
    causal: bool = True              # False for encoder-only (hubert)
    rope_theta: float = 1_000_000.0
    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: Optional[int] = None
    # --- SSM (Mamba2 / SSD) -------------------------------------------------
    ssm_state_size: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_n_groups: int = 1
    ssm_chunk: int = 128
    # --- hybrid layout (jamba) ----------------------------------------------
    attn_layer_period: int = 1
    attn_layer_offset: int = 0
    moe_layer_period: int = 1
    moe_layer_offset: int = 1
    # --- modality frontend --------------------------------------------------
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    # --- numerics -----------------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    max_seq_len: int = 131_072
    tie_embeddings: bool = False
    vocab_pad_to: int = 256

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p

    @property
    def hdim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM, hybrid, or sliding-window attention."""
        return self.family in ("ssm", "hybrid") or \
            self.sliding_window is not None

    @property
    def activated_params_ratio(self) -> float:
        """Fraction of FFN params active per token (MoE top-k / E)."""
        if self.num_experts > 0:
            return self.num_experts_per_tok / self.num_experts
        return 1.0

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for mixer of layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            if i % self.attn_layer_period == self.attn_layer_offset:
                return "attn"
            return "ssm"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        if self.family == "hybrid":
            return i % self.moe_layer_period == self.moe_layer_offset
        return True

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head), as
        ``repro.models.config.ModelConfig.param_count``."""
        d, v = self.d_model, self.vocab_size
        total = v * d                                   # embed
        if not self.tie_embeddings and not self.is_encoder_only:
            total += v * d                              # lm head
        if self.is_encoder_only:
            total += d * v                              # ctc-style head
        for i in range(self.num_layers):
            total += 2 * d                              # pre-norms
            if self.layer_kind(i) == "attn":
                hd = self.hdim
                qd = self.num_heads * hd
                kvd = self.num_kv_heads * hd
                total += d * qd + 2 * d * kvd + qd * d  # qkvo
                if self.qkv_bias:
                    total += qd + 2 * kvd
                if self.qk_norm:
                    total += 2 * hd
            else:
                di, ds = self.ssm_d_inner, self.ssm_state_size
                nh, g = self.ssm_nheads, self.ssm_n_groups
                proj_in = 2 * di + 2 * g * ds + nh
                total += d * proj_in + proj_in          # in_proj (+dt bias)
                total += self.ssm_conv_width * (di + 2 * g * ds)
                total += 2 * nh + di                    # A_log, D, norm
                total += di * d                         # out_proj
            if self.layer_is_moe(i):
                e, ff = self.num_experts, (self.moe_d_ff or self.d_ff)
                total += d * e                          # router
                total += e * (3 * d * ff)               # gate/up/down
            elif self.layer_kind(i) == "attn":
                # a dense FFN is counted beside attention mixers only, as
                # the reference counts it (mamba2 blocks have none, and
                # the reference counts none for a hybrid's SSM layers)
                total += 3 * d * self.d_ff
        total += d                                      # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only the top-k experts)."""
        if self.num_experts == 0:
            return self.param_count()
        e, k = self.num_experts, self.num_experts_per_tok
        ff = self.moe_d_ff or self.d_ff
        n_moe = sum(1 for i in range(self.num_layers) if self.layer_is_moe(i))
        return self.param_count() - n_moe * (e - k) * 3 * self.d_model * ff

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell of the dry run."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; the reason when not."""
    if shape.kind == "decode" and cfg.is_encoder_only:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full quadratic attention cannot serve 500k context"
    return True, ""
