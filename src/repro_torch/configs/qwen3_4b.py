"""qwen3-4b [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=9728, vocab_size=151_936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        d_ff=128, vocab_size=256, head_dim=16, dtype="float32")
