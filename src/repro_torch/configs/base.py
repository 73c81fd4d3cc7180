"""Model configuration schema — the port's copy of ``repro.configs.base``.

``ModelConfig`` keeps ``repro``'s field names and defaults one for one, so a
config built for either package reads the same; the methods the serving
path needs (``reduced``, ``padded_vocab``, ``layer_kind``, ``layer_ffn``)
come across unchanged.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "pad_to_multiple"]


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0            # 0 -> d_model // num_heads
    use_bias: bool = False
    tie_embeddings: bool = False
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: int = 0      # 0 -> full attention
    attn_impl: str = "flash"     # flash | naive
    attn_block_q: int = 512
    attn_block_kv: int = 1024

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    moe_route_blocks: int = 0

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # --- hybrid (jamba-style) ---
    attn_period: int = 0
    attn_offset: int = 0

    # --- enc-dec (seamless-style) ---
    enc_layers: int = 0
    frontend: str = ""
    frontend_seq: int = 0

    # --- quantization (the paper's technique) ---
    quantization: str = "none"   # none | ternary | ternary_packed
    ternary_threshold: float = 0.7
    ternary_min_dim: int = 512   # only ternarize matmuls with min dim >= this
    ternary_kernel: str = "auto"
    fused_mlp: str = "auto"      # auto | off — fused MLP kernel for packed
                                 # blocks whose tensors lie on the card

    # --- numerics / memory ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"
    logits_chunk: int = 0

    # --- distribution ---
    fsdp: bool = False
    opt_state_dtype: str = "float32"
    grad_accum: int = 1
    decode_cache_shard: str = "seq"
    cache_dtype: str = "bfloat16"
    cache_layout: str = "bshd"
    paged_attn_impl: str = "auto"
    head_pad: int = 0
    gqa_repeat_kv: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' mixer for decoder layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.attn_period:
            return "attn" if (i % self.attn_period == self.attn_offset) else "ssm"
        return "attn"

    def layer_ffn(self, i: int) -> str:
        """'moe', 'mlp' or 'none' for decoder layer i."""
        if self.d_ff == 0 and self.num_experts == 0:
            return "none"
        if self.num_experts and (i % self.moe_every == self.moe_offset):
            return "moe"
        return "mlp" if self.d_ff else "none"

    def padded_vocab(self, multiple: int = 16) -> int:
        return pad_to_multiple(self.vocab_size, multiple)

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes = dict(
            num_layers=min(self.num_layers, 4) if not self.attn_period
            else self.attn_period,
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            d_ff_expert=128 if self.d_ff_expert else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32,
            ssm_chunk=16,
            enc_layers=2 if self.enc_layers else 0,
            capacity_factor=4.0,
            frontend_seq=8 if self.frontend else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            attn_block_q=16,
            attn_block_kv=32,
            remat="none",
            fsdp=False,
        )
        changes.update(overrides)
        return dataclasses.replace(self, **changes)
