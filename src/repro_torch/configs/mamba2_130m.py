"""mamba2-130m [SSM, attention-free] — arXiv:2405.21060 (unverified).

24L, d_model=768, d_ff=0 (pure mamba blocks), vocab=50280, ssm_state=128,
SSD (state-space duality). Attention-free -> runs long_500k (O(1) state).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_conv=4,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    rope_theta=0.0,
    grad_accum=1,
    fsdp=False,
)
