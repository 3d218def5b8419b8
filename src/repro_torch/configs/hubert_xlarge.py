"""hubert-xlarge [audio] — encoder-only (w2v2 arch), frame-level head.
[arXiv:2106.07447; unverified]

The frontend (the CNN feature extractor) is a stub, as in the
reference: ``forward(embeds=...)`` takes precomputed frame embeddings.
Encoder-only: non-causal attention at head_dim 80, no rope, and no
serving decode loop.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504, head_dim=80,
    causal=False, frontend="audio",
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                        d_ff=128, vocab_size=64, head_dim=16, dtype="float32")
