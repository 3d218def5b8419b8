"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]

d_inner = 2*d_model = 5120, 80 ssd heads of dim 64, state 128.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50_280,
    ssm_state_size=128, ssm_head_dim=64, ssm_expand=2,
    ssm_conv_width=4, ssm_n_groups=1, ssm_chunk=128,
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, vocab_size=256,
                        ssm_state_size=16, ssm_head_dim=8, ssm_chunk=8,
                        dtype="float32")
