"""mixtral-8x22b [MoE] — arXiv:2401.04088 (hf).

56L, d_model=6144, 48H (GQA kv=8), d_ff=16384 (expert), vocab=32768,
8 experts top-2, SWA (window 4096 per the assignment's "SWA" tag; the rolling
window-bounded KV cache is what makes long_500k decode runnable).
8 experts % 16 != 0 -> experts TP-shard on d_ff_expert, not EP (DESIGN §6).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=32768,
    num_experts=8,
    num_experts_per_tok=2,
    d_ff_expert=16384,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    grad_accum=8,
    fsdp=True,
)
