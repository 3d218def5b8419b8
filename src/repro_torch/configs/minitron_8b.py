"""minitron-8b [dense] — pruned nemotron, 256k vocab.  [arXiv:2407.14679; hf]"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16_384, vocab_size=256_000, head_dim=128,
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                        d_ff=128, vocab_size=512, head_dim=16, dtype="float32")
