"""deepseek-coder-33b [dense, llama-arch] — arXiv:2401.14196 (hf).

62L, d_model=7168, 56H (GQA kv=8), d_ff=19200, vocab=32256.
56 heads % 16 != 0 -> attention uses the embed-contraction TP fallback
(DESIGN §6). Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
    grad_accum=8,
    fsdp=True,
)
