"""Architecture registry of the port: the configs it serves.

Each module defines ``FULL`` (the published config) and ``smoke()`` (a
reduced same-family config for CPU tests), as in ``repro.configs``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen3-4b": "qwen3_4b",
    # the paper's own serving model (Qwen2.5-32B, §4)
    "qwen2.5-32b": "qwen2_5_32b",
    # the SSM family: attention-free, SSD scan in every layer
    "mamba2-2.7b": "mamba2_2_7b",
    # the encoder-only audio family: non-causal attention at head_dim 80
    "hubert-xlarge": "hubert_xlarge",
    # the windowed and MoE family: a 4096-token sliding window, 8 experts
    "mixtral-8x7b": "mixtral_8x7b",
    # MHA at head_dim 64 and 96 (the vision frontend a stub)
    "stablelm-1.6b": "stablelm_1_6b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    # the other dense GQA configs at head_dim 128
    "qwen2.5-14b": "qwen2_5_14b",
    "minitron-8b": "minitron_8b",
    # the last MoE config: 128 experts top 8 through the capacity
    # dispatch, GQA 32 / 4
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    # the hybrid family: attention, SSD and MoE layers interleaved
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}


# every config but the paper's own serving model, as the reference's
# ``ASSIGNED``: the dry run's default set of architectures
ASSIGNED: List[str] = [k for k in _MODULES if k != "qwen2.5-32b"]


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.FULL


def get_smoke(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.smoke()


def all_configs() -> Dict[str, ModelConfig]:
    return {k: get_config(k) for k in _MODULES}
