"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (STUB).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The modality frontend is a stub, as in the reference: precomputed patch
embeddings of width d_model (``frontend_tokens`` of them an image) enter
through ``forward(embeds=...)``; the serving stack serves the backbone
on tokens.  The port's head width 96: 32 query and 32 KV heads of 96
(MHA, rep 1).
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32_064, head_dim=96,
    frontend="vision", frontend_tokens=1024,
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                        d_ff=128, vocab_size=256, head_dim=16,
                        frontend_tokens=8, dtype="float32")
