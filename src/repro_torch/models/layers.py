"""Core layers of the port (functional, parameters in plain dicts): linear
(latent or ternary-packed), norms, embeddings, RoPE, gated MLP — the
counterparts of ``repro.models.layers``, with the same rounding points.

Dtypes follow ``repro``: activations in ``cfg.dtype`` (bf16), parameters in
``cfg.param_dtype`` (f32); norms compute in f32 and cast back; the packed
GEMM's epilogue is f32.

Tensor parallelism (``distributed.tp``): a rank's linear carries a ``"tp"``
mark. ``"n"`` (a column split) runs as any linear on its columns; ``"k"``
(a row split) computes its f32 partial product, all-reduces it over the
current group (``tp.bound``), then adds the bias and casts, where a single
card's f32 epilogue does; ``"gather"`` (the lm head) all-gathers its
columns' logits; ``("kv", KV, tp)`` (k or v columns of the one K/V
head a rank's query heads read) runs as a column split, and
``("qo", part, H, KV, tp)`` (q's columns or o's rows of the rank's
query heads where tp does not divide them) as its ``part``. A gated MLP
whose down projection is a row split all-reduces B4's f32 partial the
same way. A ``"vocab"`` embedding holds the rank's vocabulary rows: a
token outside them reads zeros, and the ranks' lookups are summed (one
nonzero term: exact). ``linear_spec`` gives ``repro``'s logical spec of
a projection.

Training a rank's latent shards (``distributed.tp.shard_params(...,
latent=True)``) takes gradients through the same collectives as
Megatron's f/g pair: the row split's all-reduce passes the gradient
through, each column-split region's input (``region_input``: q/k/v,
gate/up, the lm head) all-reduces its input gradient, the logits'
all-gather keeps this rank's columns of the gradient, a replicated
K/V head's partial gradients are summed over its ranks
(``tp.reduce_head_grads``), the lookup's sum passes the gradient through
to the rank's rows. A row split's latent weight ternarizes with its
column statistics summed over the group
(``quantize.ste_ternarize_rows``); a column split's ternarizes whole
columns locally.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quantize, weights
from repro_torch.distributed import tp as tp_lib
from repro_torch.kernels import ops


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def _randn(gen: torch.Generator, shape, cfg: ModelConfig) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype_of(cfg.param_dtype))


# ---------------------------------------------------------------------------
# Linear — the layer the paper's technique lives in
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, cfg: ModelConfig, d_in: int,
                d_out: int, use_bias: Optional[bool] = None,
                scale: Optional[float] = None) -> dict:
    """A latent (d_in, d_out) projection, N(0, 1/d_in) unless ``scale``."""
    use_bias = cfg.use_bias if use_bias is None else use_bias
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    params = {"w": _randn(gen, (d_in, d_out), cfg) * std}
    if use_bias:
        params["b"] = torch.zeros((d_out,), dtype=dtype_of(cfg.param_dtype),
                                  device=gen.device)
    return params


def linear_spec(in_axis, out_axis, use_bias: bool,
                packed: bool = False) -> dict:
    """``repro``'s spec twin of a projection: ``{"w": (in, out)}`` (+
    ``{"b": (out,)}``), or for a packed one ``{"w_packed": {"packed": (in,
    out), "scale": (out,), "bias": (out,) or None}}``."""
    if packed:
        return {"w_packed": {"packed": (in_axis, out_axis),
                             "scale": (out_axis,),
                             "bias": (out_axis,) if use_bias else None}}
    spec = {"w": (in_axis, out_axis)}
    if use_bias:
        spec["b"] = (out_axis,)
    return spec


def _group() -> "tp_lib.Group":
    group = tp_lib.current_group()
    if group is None:
        raise RuntimeError("a tensor-parallel shard runs only inside its "
                           "group (distributed.tp.bound)")
    return group


def _reduce_partial(y: torch.Tensor, bias, dtype) -> torch.Tensor:
    """Sum a row split's f32 partials over the group (differentiably where
    a gradient is being taken), then the bias and the cast."""
    y = tp_lib.reduce_from_group(y, _group())
    if bias is not None:
        y = y + bias.to(y.dtype).reshape(1, -1)
    return y.to(dtype)


def region_input(x: torch.Tensor, params: dict) -> torch.Tensor:
    """The input of a column-split region (q/k/v, gate/up, the lm head)
    whose first linear is ``params``: Megatron's f (identity forward, the
    input gradient all-reduced) where a gradient is being taken, so every
    rank's replicated activations get the whole gradient; else ``x``."""
    mark = params.get("tp")
    if tp_lib.mark_part(mark) in ("n", "gather") or tp_lib.is_head_mark(mark):
        return tp_lib.copy_to_group(x, _group())
    return x


def _is_ternary(cfg: ModelConfig, d_in: int, d_out: int) -> bool:
    return (cfg.quantization != "none"
            and min(d_in, d_out) >= cfg.ternary_min_dim)


def gemm_impl(cfg: ModelConfig) -> str:
    """The ``ternary_gemm`` row packed linears dispatch (``repro``'s
    ``gemm_impl``): ``cfg.ternary_kernel="xla"`` pins the plain ``"ref"``
    row wherever the tensors lie; otherwise ``"auto"`` (the kernel on the
    card, its plain version on the CPU)."""
    return "ref" if cfg.ternary_kernel == "xla" else "auto"


def linear_apply(params: dict, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """x: (..., d_in) -> (..., d_out); a rank's shard under its ``"tp"``
    mark (module docstring)."""
    wc = params.get("w_packed")
    mark = params.get("tp")
    part = tp_lib.mark_part(mark)
    if part == "k":
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if wc is not None:
            y = ops.ternary_gemm(x2, wc, impl=gemm_impl(cfg), partition="k",
                                 tp=_group().size)
            bias = wc.bias
        else:
            w, group = params["w"], _group()
            rows = tp_lib.whole_extent(mark, w.shape[-2], group)
            if cfg.quantization == "ternary" and _is_ternary(
                    cfg, rows, w.shape[-1]):
                w = quantize.ste_ternarize_rows(w, cfg.ternary_threshold,
                                                group, rows)
            y, bias = x2.float() @ w.to(x.dtype).float(), params.get("b")
        return _reduce_partial(y, bias, x.dtype).reshape(*lead, -1)
    b = params.get("b")
    if wc is not None:
        lead = x.shape[:-1]
        y = ops.ternary_gemm(x.reshape(-1, x.shape[-1]), wc,
                             impl=gemm_impl(cfg))
        y = y.reshape(*lead, -1)
    else:
        w = params["w"]
        # a column shard ternarizes as its columns of the whole matrix
        n = tp_lib.whole_extent(mark, w.shape[-1], _group()) \
            if part in ("n", "gather") else w.shape[-1]
        if tp_lib.is_head_mark(part):
            n = w.shape[-1] * part[1]
            w = tp_lib.reduce_head_grads(w, part, _group())
            if b is not None:
                b = tp_lib.reduce_head_grads(b, part, _group())
        if cfg.quantization == "ternary" and _is_ternary(cfg, w.shape[-2],
                                                         n):
            w = quantize.ste_ternarize(w, cfg.ternary_threshold)
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    if part == "gather":
        y = tp_lib.gather_from_group(y, _group(), dim=-1)
    return y


def pack_linear(params: dict, cfg: ModelConfig) -> dict:
    """Latent linear -> packed serving format (``Dense2Bit`` carrying the
    per-channel ternarization scales and the bias)."""
    if "w" not in params:
        return params
    w = params["w"]
    if not _is_ternary(cfg, *w.shape[-2:]):
        return params
    return {"w_packed": weights.pack(w, "dense2bit", bias=params.get("b"),
                                     threshold=cfg.ternary_threshold)}


def pack_params(params, cfg: ModelConfig):
    """Walk a param tree (dicts and lists) and pack every ternarizable
    projection and MoE expert bank (``moe.pack_moe``; router and shared
    experts stay latent). Packing runs on the device the weights lie on."""
    from repro_torch.models import moe

    def walk(p):
        if isinstance(p, dict):
            if moe.is_moe_node(p):
                return moe.pack_moe(p, cfg)
            w = p.get("w")
            if w is not None and w.ndim in (2, 3) \
                    and min(w.shape[-2:]) >= cfg.ternary_min_dim:
                return pack_linear(p, cfg)
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, list):
            return [walk(v) for v in p]
        return p

    return walk(params)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(gen: torch.Generator, cfg: ModelConfig, d: int) -> dict:
    params = {"scale": torch.ones((d,), dtype=dtype_of(cfg.param_dtype),
                                  device=gen.device)}
    if cfg.norm_type == "layernorm":
        params["bias"] = torch.zeros_like(params["scale"])
    return params


def norm_apply(params: dict, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "layernorm":
        xf = xf - xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + cfg.norm_eps)
    y = y * params["scale"].float()
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"table": _randn(gen, (cfg.padded_vocab(), cfg.d_model), cfg)
            * 0.02}


def embed_apply(params: dict, tokens: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    # repro casts the table, then gathers; gathering first and casting the
    # gathered rows gives the same values without a full-table cast per call
    table = params["table"]
    if params.get("tp") != "vocab":
        return table[tokens].to(dtype_of(cfg.dtype))
    group = _group()
    rows = table.shape[0]
    local = tokens - group.rank * rows
    inside = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)].to(dtype_of(cfg.dtype))
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return tp_lib.reduce_from_group(x, group)


def tied_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """A tied model's logits from its embedding ``params``: ``x`` times the
    table's transpose; a ``"vocab"`` table's rows are the rank's columns
    of the logits, all-gathered (the lm head's ``"gather"``)."""
    if params.get("tp") != "vocab":
        return x @ params["table"].to(x.dtype).T
    group = _group()
    y = tp_lib.copy_to_group(x, group) @ params["table"].to(x.dtype).T
    return tp_lib.gather_from_group(y, group, dim=-1)


def unembed_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return linear_init(gen, cfg, cfg.d_model, cfg.padded_vocab(),
                       use_bias=False)


def unembed_apply(params: dict, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    return linear_apply(params, region_input(x, params), cfg)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S) -> rotated x (in x.dtype)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs            # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int) -> dict:
    return {"in": linear_init(gen, cfg, cfg.d_model, d_ff),
            "gate": linear_init(gen, cfg, cfg.d_model, d_ff),
            "out": linear_init(gen, cfg, d_ff, cfg.d_model)}


def _fused_mlp_weights(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """The (w_in, w_out, w_gate) containers when this MLP dispatches the
    fused kernel: every projection packed (bias inside the container), the
    kernel path active — here, the activations lie on the card, or on
    ``meta`` for the dry run's trace (``ops.on_card``) — and fusion
    not configured off, nor the plain GEMM row pinned
    (``cfg.ternary_kernel="xla"``)."""
    if cfg.fused_mlp == "off" or not ops.on_card(x) \
            or gemm_impl(cfg) == "ref":
        return None
    ws = []
    for name in ("in", "out", "gate"):
        p = params.get(name, {})
        wc = p.get("w_packed") if isinstance(p, dict) else None
        if wc is None or "b" in p:
            return None
        ws.append(wc)
    return tuple(ws)


def mlp_apply(params: dict, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    fused = _fused_mlp_weights(params, x, cfg)
    if fused is not None:
        w_in, w_out, w_gate = fused
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if params["out"].get("tp") == "k":
            y = ops.fused_mlp(x2, w_in, w_out, w_gate, tp=_group().size)
            y = _reduce_partial(y, w_out.bias, x.dtype)
        else:
            y = ops.fused_mlp(x2, w_in, w_out, w_gate)
        return y.reshape(*lead, -1)
    x = region_input(x, params["gate"])
    h = F.silu(linear_apply(params["gate"], x, cfg)) \
        * linear_apply(params["in"], x, cfg)
    return linear_apply(params["out"], h, cfg)
