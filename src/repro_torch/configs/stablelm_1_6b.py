"""stablelm-1.6b [dense] — MHA (kv == q heads).  [hf:stabilityai/stablelm-2-1_6b; unverified]

The port's head width 64: 32 query and 32 KV heads of 64, so every
attention kernel runs at rep 1.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=5632, vocab_size=100_352, head_dim=64,
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                        d_ff=128, vocab_size=256, head_dim=16, dtype="float32")
