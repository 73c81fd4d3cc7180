"""command-r-35b [dense] — hf:CohereForAI/c4ai-command-r-v01 (unverified).

40L, d_model=8192, 64H (GQA kv=8), d_ff=22528, vocab=256000, no-bias,
rope_theta=8e6 (cohere), full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    use_bias=False,
    rope_theta=8_000_000.0,
    grad_accum=8,
    fsdp=True,
)
