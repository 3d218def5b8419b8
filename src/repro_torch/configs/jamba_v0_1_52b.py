"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]

Layer pattern period 8: one attention layer (offset 4) per 7 mamba
layers; MoE FFN on every other layer.  The mamba layers are the SSD
(Mamba2) block with B/C in 8 groups, as in the reference.  A session
holds KV in the attention layers and a recurrent state in the SSD
layers side by side: a state page beside its KV pages on the page pool,
both in its slot on the slot arena.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14_336, vocab_size=65_536, head_dim=128,
    num_experts=16, num_experts_per_tok=2,
    attn_layer_period=8, attn_layer_offset=4,
    moe_layer_period=2, moe_layer_offset=1,
    ssm_state_size=128, ssm_head_dim=64, ssm_expand=2,
    ssm_conv_width=4, ssm_n_groups=8, ssm_chunk=128,
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                        d_ff=128, vocab_size=256, head_dim=16,
                        num_experts=4, num_experts_per_tok=2,
                        attn_layer_period=4, attn_layer_offset=2,
                        moe_layer_period=2, moe_layer_offset=1,
                        ssm_state_size=16, ssm_head_dim=8, ssm_n_groups=2,
                        ssm_chunk=8, dtype="float32")
