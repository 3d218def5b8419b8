"""qwen2.5-14b [dense] — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13_824, vocab_size=152_064, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        d_ff=128, vocab_size=256, head_dim=16, dtype="float32")
