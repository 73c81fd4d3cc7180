"""kimi-k2-1t-a32b [MoE, trillion-param] — arXiv:2501.kimi2 (paper-table,
unverified).

61L, d_model=7168, 64H (GQA kv=8), vocab=163840, MoE 384e top-8 with expert
d_ff=2048 (the assignment's exact numbers; the real Kimi-K2 additionally has
MLA attention, one dense first layer and a shared expert — not in the
assignment table, so not modeled; noted per DESIGN.md).

Memory note: ~1T params cannot *train* on <= 2 v5e pods; the dry-run
compiles and EXPERIMENTS.md reports honest bytes/device. fsdp + bf16
optimizer state are on to minimize the gap.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,                   # all layers MoE per the assignment row
    vocab_size=163840,
    num_experts=384,
    num_experts_per_tok=8,
    d_ff_expert=2048,
    rope_theta=50_000.0,
    grad_accum=8,
    fsdp=True,
    opt_state_dtype="bfloat16",
    param_dtype="bfloat16",
)
