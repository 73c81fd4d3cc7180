"""Mixture-of-Experts of the port: token-choice top-k routing with
capacity-bounded expert-side dispatch (GShard-style dropping), the
counterpart of ``repro.models.moe`` with the same rounding points.

Dispatch gathers each expert's top-C tokens by gate, runs the three bank
products as batched ``(E, C, d) x (E, d, f)`` matmuls (``repro`` computes
them outside any Pallas kernel too), scales by the gates and adds the
results back in token order. Packed banks (``Dense2Bit`` of ``(E,
ceil(K/16), N)`` words) are decoded and scaled into the compute dtype
each call, as ``repro``'s are.

Tensor parallelism (a node marked by ``distributed.tp``): every rank
routes the replicated activations alike, then runs its own experts
(``"e"``) or its d_ff slice of every expert (``"ff"``, w_out's latent
rows ternarized with their columns' statistics summed over the group);
its partial output is summed in f32 and all-reduced once, then cast.

Orders that decide bits: top-k and the capacity top-C keep the lower
index first on ties (``jax.lax.top_k``'s order; a stable descending sort
here), and the scatter-add runs one expert at a time in expert order, in
the output dtype, as XLA applies ``.at[].add`` updates, so the sum is the
same on every run and under a CUDA graph.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quantize, weights
from repro_torch.distributed import tp as tp_lib
from repro_torch.models.layers import _group, _is_ternary, _randn

_BANKS = ("w_in", "w_gate", "w_out")


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Latent router, expert banks ``(E, d, f)`` / ``(E, f, d)`` and, with
    ``n_shared_experts``, the always-on shared expert."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    std = 1.0 / math.sqrt(d)
    params = {
        "router": _randn(gen, (d, e), cfg) * std,
        "w_in": _randn(gen, (e, d, f), cfg) * std,
        "w_gate": _randn(gen, (e, d, f), cfg) * std,
        "w_out": _randn(gen, (e, f, d), cfg) / math.sqrt(f),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        params["shared_in"] = _randn(gen, (d, fs), cfg) * std
        params["shared_gate"] = _randn(gen, (d, fs), cfg) * std
        params["shared_out"] = _randn(gen, (fs, d), cfg) / math.sqrt(fs)
    return params


def _expert_weight(w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Per-expert per-channel ternarization (STE) under QAT."""
    if cfg.quantization == "ternary":
        return quantize.ste_ternarize(w, cfg.ternary_threshold)
    return w


def top_k(a: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, descending,
    the lower index first among equal values."""
    vals, idx = torch.sort(a, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _bank(params: dict, name: str, x: torch.Tensor, cfg: ModelConfig,
          rows_group=None) -> torch.Tensor:
    """A bank decoded (packed) or ternarized (latent, QAT) into the
    compute dtype; ``rows_group``: the bank is a row shard of every
    expert, its columns' statistics summed over that group
    (``quantize.ste_ternarize_rows``)."""
    w = params[name]
    if isinstance(w, weights.TernaryWeight):
        return w.materialize(x.dtype, with_scale=True)
    if rows_group is not None and cfg.quantization == "ternary":
        return quantize.ste_ternarize_rows(w, cfg.ternary_threshold,
                                           rows_group).to(x.dtype)
    return _expert_weight(w, cfg).to(x.dtype)


def _bank_len(w) -> int:
    return (w.packed if isinstance(w, weights.TernaryWeight) else w).shape[0]


def _moe_shard(params: dict, mark: tuple, xb, g_sel, tok_sel, rows,
               cfg: ModelConfig):
    """A rank's f32 partial of a split MoE layer (``tp.moe_split``),
    before the all-reduce: its own experts (``"e"``) or its d_ff slice of
    every expert (``"ff"``), and its slice of a split shared expert. The
    dispatched activations and the gates enter through Megatron's f, so
    their partial gradients are summed over the group."""
    _, part, shared, _ = mark
    group = _group()
    nb, tb, d = xb.shape
    xf = tp_lib.copy_to_group(xb, group)
    gf = tp_lib.copy_to_group(g_sel, group)
    el = _bank_len(params["w_in"]) if part == "e" else cfg.num_experts
    lo = group.rank * el if part == "e" else 0
    sel, gl = tok_sel[:, lo:lo + el], gf[:, lo:lo + el]
    xe = xf[rows, sel]                                           # (nb,El,C,d)
    w_in, w_gate = (_bank(params, n, xb, cfg) for n in ("w_in", "w_gate"))
    w_out = _bank(params, "w_out", xb, cfg,
                  rows_group=group if part == "ff" else None)
    h = F.silu(torch.einsum("necd,edf->necf", xe, w_gate)) \
        * torch.einsum("necd,edf->necf", xe, w_in)
    if part == "e":
        # whole experts: each expert's product rounds as on one card
        ye = torch.einsum("necf,efd->necd", h, w_out)
        ye = (ye * gl[..., None].to(ye.dtype)).float()
    else:
        ye = torch.einsum("necf,efd->necd", h.float(), w_out.float()) \
            * gl[..., None]
    y = torch.zeros((nb, tb, d), dtype=torch.float32, device=xb.device)
    brow = rows[:, 0]
    for i in range(el):
        idx = sel[:, i]
        y[brow, idx] = y[brow, idx] + ye[:, i]
    if shared:
        xt = xf.reshape(nb * tb, d)
        hs = F.silu(xt @ params["shared_gate"].to(xb.dtype)) \
            * (xt @ params["shared_in"].to(xb.dtype))
        y = y + (hs.float() @ params["shared_out"].to(xb.dtype).float()
                 ).reshape(nb, tb, d)
    return y


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Capacity C = ceil(T*k/E * cf) per
    routing block (``cfg.moe_route_blocks`` blocks when they divide T)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = b * s
    nb = max(cfg.moe_route_blocks, 1)
    if t % nb != 0:
        nb = 1
    tb = t // nb
    xb = x.reshape(nb, tb, d)

    logits = xb @ params["router"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)                # (nb,Tb,E)
    top_p, top_ids = top_k(probs, k)                             # (nb,Tb,k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)              # renormalize
    gates = torch.zeros((nb, tb, e), dtype=torch.float32,
                        device=x.device).scatter(-1, top_ids, top_p)

    # expert-side capacity truncation: each expert keeps its top-C tokens
    cap = int(math.ceil(tb * k / e * cfg.capacity_factor))
    cap = min(max(cap, 1), tb)
    g_sel, tok_sel = top_k(gates.transpose(1, 2), cap)           # (nb,E,C)
    rows = torch.arange(nb, device=x.device)[:, None, None]
    if _ROUTES.get() is not None:
        _ROUTES.get().append(tok_sel.detach().cpu())

    mark = params.get("tp")
    if mark is not None:
        # tensor parallel: every rank routed the same replicated
        # activations; the partials are summed in f32, then cast
        y = tp_lib.reduce_from_group(
            _moe_shard(params, mark, xb, g_sel, tok_sel, rows, cfg),
            _group())
        if cfg.n_shared_experts and not mark[2]:
            xt = xb.reshape(t, d)
            hs = F.silu(xt @ params["shared_gate"].to(x.dtype)) \
                * (xt @ params["shared_in"].to(x.dtype))
            y = y + (hs @ params["shared_out"].to(x.dtype)).reshape(
                nb, tb, d).float()
        return y.reshape(b, s, d).to(x.dtype), _aux(probs, top_ids, e)

    xe = xb[rows, tok_sel]                                       # (nb,E,C,d)

    w_in, w_gate, w_out = (_bank(params, n, x, cfg) for n in _BANKS)
    h = F.silu(torch.einsum("necd,edf->necf", xe, w_gate)) \
        * torch.einsum("necd,edf->necf", xe, w_in)
    ye = torch.einsum("necf,efd->necd", h, w_out)                # (nb,E,C,d)
    ye = ye * g_sel[..., None].to(ye.dtype)

    # scatter-add back to token order, one expert at a time: an expert's C
    # tokens are distinct, so each write is a plain indexed add
    y = torch.zeros((nb, tb, d), dtype=ye.dtype, device=x.device)
    brow = rows[:, 0]
    for i in range(e):
        idx = tok_sel[:, i]
        y[brow, idx] = y[brow, idx] + ye[:, i]

    if cfg.n_shared_experts:
        xt = xb.reshape(t, d)
        hs = F.silu(xt @ params["shared_gate"].to(x.dtype)) \
            * (xt @ params["shared_in"].to(x.dtype))
        y = y + (hs @ params["shared_out"].to(x.dtype)).reshape(nb, tb, d)

    return y.reshape(b, s, d).to(x.dtype), _aux(probs, top_ids, e)


def _aux(probs: torch.Tensor, top_ids: torch.Tensor, e: int) -> torch.Tensor:
    """The Switch-style load-balancing auxiliary loss."""
    me = probs.mean(dim=(0, 1))                                  # (E,)
    ce = F.one_hot(top_ids[..., 0], e).float().mean(dim=(0, 1))
    return e * torch.sum(me * ce)


_ROUTES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_moe_routes", default=None)


@contextlib.contextmanager
def recorded_routes():
    """Record every MoE layer's capacity pick (``tok_sel``, (nb, E, C)
    token indices, on the host) of the calls in the scope into the list
    it yields: the check that every tensor-parallel rank routes alike."""
    log: list = []
    tok = _ROUTES.set(log)
    try:
        yield log
    finally:
        _ROUTES.reset(tok)


def pack_moe(params: dict, cfg: ModelConfig) -> dict:
    """A latent MoE node's expert banks -> ``Dense2Bit`` containers of
    ``(E, ceil(K/16), N)`` words, each expert matrix ternarized per
    channel. Router and shared experts stay latent. Gated like
    ``layers.pack_linear``: an unquantized config, or experts below
    ``ternary_min_dim``, pass through untouched."""
    if isinstance(params.get("w_in"), weights.TernaryWeight) \
            or "w_in" not in params \
            or not _is_ternary(cfg, *params["w_in"].shape[-2:]):
        return params
    out = {k: v for k, v in params.items() if k not in _BANKS}
    for name in _BANKS:
        out[name] = weights.pack(params[name], "dense2bit",
                                 threshold=cfg.ternary_threshold)
    return out


def is_moe_node(node) -> bool:
    return isinstance(node, dict) and "router" in node and "w_in" in node


__all__ = ["moe_init", "moe_apply", "pack_moe", "top_k", "is_moe_node",
           "recorded_routes"]
