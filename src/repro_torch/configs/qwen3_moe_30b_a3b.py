"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, qk_norm.  [hf:Qwen/Qwen3-30B-A3B; hf]

d_ff=768 is the per-expert (moe) FFN width; every layer is MoE.  With
more than 8 experts every MoE step takes the capacity dispatch
(``models.moe.moe_layer``); its 32 / 4 heads are a GQA group of 8.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151_936, head_dim=128,
    num_experts=128, num_experts_per_tok=8, moe_d_ff=768,
    qk_norm=True, rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        d_ff=32, moe_d_ff=32, vocab_size=256, head_dim=16,
                        num_experts=8, num_experts_per_tok=2, dtype="float32")
