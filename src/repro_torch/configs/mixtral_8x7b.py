"""mixtral-8x7b [moe] — 8 experts top-2, SWA(4096).  [arXiv:2401.04088; hf]

The port's windowed and MoE family: every layer's attention is a
4096-token sliding window (ring page tables on the paged pool, rolling
slots on the slot arena, a masked full-depth slot in the dense
baseline) and every FFN routes each token to 2 of 8 experts.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14_336, vocab_size=32_000, head_dim=128,
    num_experts=8, num_experts_per_tok=2,
    sliding_window=4096, rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        d_ff=128, vocab_size=256, head_dim=16,
                        num_experts=4, num_experts_per_tok=2,
                        sliding_window=32, dtype="float32")
