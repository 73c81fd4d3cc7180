"""jamba-v0.1-52b [hybrid Mamba+attn, MoE] — arXiv:2403.19887 (hf).

32L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=65536; MoE 16e top-2
every 2nd layer; attention every 8th layer (1:7 attn:mamba interleave,
attn_layer_offset=4 as in the HF config). Mamba layers use SSD/Mamba2 form
(DESIGN §4 notes the Mamba1->SSD substitution). Hybrid -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    rope_theta=0.0,           # jamba uses no positional encoding
    attn_period=8,
    attn_offset=4,
    num_experts=16,
    num_experts_per_tok=2,
    d_ff_expert=14336,
    moe_every=2,
    moe_offset=1,
    ssm_state=16,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_expand=2,
    grad_accum=8,
    fsdp=True,
)
