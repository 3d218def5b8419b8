"""qwen2.5-32b [dense] — the paper's own serving model (§4, Fig.1/6).
[hf:Qwen/Qwen2.5-32B; hf]"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=27_648, vocab_size=152_064, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        d_ff=128, vocab_size=256, head_dim=16, dtype="float32")
