"""Model configuration schema — the port's copy of ``repro.configs.base``.

``ModelConfig`` keeps ``repro``'s field names and defaults one for one, so a
config built for either package reads the same; the methods the serving
path needs (``reduced``, ``padded_vocab``, ``layer_kind``, ``layer_ffn``)
come across unchanged, and so do the shape cells (``SHAPES``), the
analytic ``param_count`` / ``active_param_count`` and ``supports_shape``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "pad_to_multiple"]


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


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

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

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

    def param_count(self) -> int:
        """Total parameter count (embedding + layers), analytic."""
        d, v = self.d_model, self.padded_vocab()
        hd = self.head_dim
        total = v * d  # embed
        if not self.tie_embeddings:
            total += d * v

        def attn_params():
            p = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                + self.num_heads * hd * d
            if self.use_bias:
                p += (self.num_heads + 2 * self.num_kv_heads) * hd + d
            return p

        def mlp_params(ff):
            return 3 * d * ff  # gated (SwiGLU): in, gate, out

        def ssm_params():
            di, s, h = self.d_inner, self.ssm_state, self.ssm_heads
            proj_in = d * (2 * di + 2 * self.ssm_groups * s + h)
            conv = self.ssm_conv * (di + 2 * self.ssm_groups * s)
            return proj_in + conv + 3 * h + di + di * d

        def layer_params(i):
            p = 2 * d  # norms
            p += attn_params() if self.layer_kind(i) == "attn" else ssm_params()
            ffn = self.layer_ffn(i)
            if ffn == "moe":
                p += d * self.num_experts
                p += self.num_experts * mlp_params(self.d_ff_expert)
                p += self.n_shared_experts * mlp_params(self.d_ff_expert)
            elif ffn == "mlp":
                p += mlp_params(self.d_ff)
            return p

        for i in range(self.num_layers):
            total += layer_params(i)
        if self.is_encdec:
            for _ in range(self.enc_layers):
                total += 2 * d + attn_params() + mlp_params(self.d_ff)
            # cross attention per decoder layer
            total += self.num_layers * (d + attn_params())
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        per_expert = 3 * self.d_model * self.d_ff_expert
        n_moe_layers = sum(1 for i in range(self.num_layers)
                           if self.layer_ffn(i) == "moe")
        inactive = n_moe_layers * (self.num_experts - self.num_experts_per_tok) \
            * per_expert
        return full - inactive

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

    def supports_shape(self, shape_name: str) -> Tuple[bool, str]:
        """(supported, reason-if-not). long_500k needs sub-quadratic
        attention."""
        if shape_name == "long_500k":
            subquad = (self.family in ("ssm", "hybrid")
                       or self.sliding_window > 0)
            if not subquad:
                return False, ("full quadratic attention; 500k decode cache "
                               "infeasible (see DESIGN.md §4)")
        return True, ""
