"""The dense decoder family (Qwen2, Qwen3): every layer is GQA attention
and a SwiGLU of ``intermediate_size``, and a pool page holds K and V of
every layer.  A configuration file without a ``"model"`` key is of this
family; ``harness.family_module`` says what a family module gives."""
from __future__ import annotations

from typing import Dict

import torch

from laps_bench import arith


def program_config(config: Dict):
    """The program's ModelConfig for a Hugging Face style config."""
    from repro_torch.models.config import ModelConfig
    mt = config["model_type"]
    d, hq = int(config["hidden_size"]), int(config["num_attention_heads"])
    return ModelConfig(
        name=config["name"], family="dense",
        num_layers=int(config["num_hidden_layers"]), d_model=d,
        num_heads=hq, num_kv_heads=int(config["num_key_value_heads"]),
        d_ff=int(config["intermediate_size"]),
        vocab_size=int(config["vocab_size"]),
        head_dim=int(config.get("head_dim") or d // hq),
        qk_norm=mt == "qwen3",
        qkv_bias=bool(config.get("attention_bias", mt == "qwen2")),
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        tie_embeddings=bool(config.get("tie_word_embeddings", False)),
        max_seq_len=int(config["max_position_embeddings"]),
        vocab_pad_to=int(config.get("vocab_pad_to", 256)),
        dtype=config.get("torch_dtype", "bfloat16"))


def page_bytes(config: Dict, page_size: int) -> int:
    """Device bytes of one KV page: K and V of every layer."""
    d, hq = int(config["hidden_size"]), int(config["num_attention_heads"])
    hd = int(config.get("head_dim") or d // hq)
    el = torch.empty(0, dtype=getattr(torch, config.get(
        "torch_dtype", "bfloat16"))).element_size()
    return (2 * int(config["num_hidden_layers"]) * page_size
            * int(config["num_key_value_heads"]) * hd * el)


def pool(config: Dict, free_bytes: float) -> Dict[str, int]:
    """One page pool: as many whole pages as ``free_bytes`` hold."""
    ps = int(config["serving"]["page_size"])
    return {"num_pages": int(free_bytes // page_bytes(config, ps))}


def yardstick(config: Dict) -> arith.Shape:
    """The published widths, counted by ``arith``'s dense formulas."""
    return arith.Shape.from_config(config)
