"""A cell small enough for the CPU tests: the benchmark's metrics on a
two-layer Qwen-shaped model, a pool that holds every session of the
window whole (the program admits turns without looking at free pages),
and a multi-turn mix with long prompts served in chunks.  The harness runs it
exactly as a real cell, with the program's plain PyTorch kernels."""
from __future__ import annotations

import copy
import json
import os
from typing import Dict

from laps_bench import harness

HERE = os.path.dirname(os.path.abspath(__file__))

_CONFIG = {
    "name": "tiny", "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
    "vocab_size": 256, "num_hidden_layers": 2, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "max_position_embeddings": 4096,
    "hidden_act": "silu", "torch_dtype": "float32",
    "reference": "qwen_dense",
    "init": {"embed_std": 0.02, "bias_std": 0.2, "norm_std": 0.1},
    "serving": {"variant": "pla_full", "max_len": 512, "page_size": 16,
                "chunk_tokens": 32, "threshold": 48, "num_slots": 8,
                "token_buckets": [16, 32, 64], "decode_buckets": [1, 2, 4, 8],
                "slo_ttft_s": 2.0, "num_pages": 384},
}

_MIX = {"plan_seed": 0, "arrival": {"kind": "poisson"},
        "turns": [2, 3], "think_s": {"kind": "exp", "mean": 0.05},
        "long_share": 0.3, "long": [64, 200, "loguniform"],
        "short": [4, 30], "decode": [3, 8]}

# the gaps of float32 against float32 are round-off; 1e-3 is far below
# the 0.09-0.22 of the fp8 control and far above the 0 read on the CPU
_CELL = {"load": {"rate": 8.0}, "trace_seconds": 1.0,
         "check": {"limits": {"widest_logit_gap": 1e-3,
                              "mean_logit_gap": 1e-4},
                   "served_tokens": 60,
                   "served_tokens_min": 20, "min_conversations": 3,
                   "max_tokens": 2000,
                   "control_precision": "fp8"}}


def spec(model_type: str = "qwen3", **serving) -> Dict:
    """The tiny cell as ``harness.load_spec`` returns a real one, with
    every metric of ``BENCHMARK.json`` but ``prompt_tok_s`` (closed loop
    only)."""
    cfg = copy.deepcopy(_CONFIG)
    cfg["model_type"] = model_type
    cfg["tie_word_embeddings"] = model_type == "qwen3"
    if model_type == "qwen3":
        cfg["attention_bias"] = False
    cfg["serving"].update(serving)
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    return {"name": "tiny", "chips": 1, "config": cfg,
            "family": harness.family_module(cfg),
            "mix": copy.deepcopy(_MIX), "cell": copy.deepcopy(_CELL),
            "end_to_end": [m for m in bench["end_to_end"]
                           if m["name"] != "prompt_tok_s"],
            "per_layer": bench["per_layer"]}
