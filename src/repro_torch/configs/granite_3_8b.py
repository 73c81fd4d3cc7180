"""granite-3-8b [dense] — hf:ibm-granite/granite-3.0 family.

40L, d_model=4096, 32H (GQA kv=8), d_ff=12800, vocab=49155.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    tie_embeddings=True,
    grad_accum=4,
    fsdp=True,
)
