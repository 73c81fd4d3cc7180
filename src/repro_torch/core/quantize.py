"""Ternary quantization: TWN-style absmean thresholding, its exact-sparsity
variant and the straight-through estimator for QAT (the port's copy of
``repro.core.quantize``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ternarize", "ternarize_target_sparsity", "ste_ternarize",
           "ste_ternarize_rows", "effective_weight"]


def ternarize(w: torch.Tensor, threshold_factor: float = 0.7,
              per_channel: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """TWN ternarization of a (..., K, N) weight. Returns (T int8 in
    {-1, 0, 1}, alpha f32), alpha shaped (..., 1, N) per channel (the
    reduction runs over K, axis -2) or (..., 1, 1) per matrix.

    Δ = threshold_factor · mean(|W|);  T = sign(W)·1[|W| > Δ];
    α = mean(|W| over |W| > Δ)  (the L1-optimal scale for the mask).
    """
    w = w.float()
    absw = w.abs()
    dims = (-2,) if per_channel else (-2, -1)
    delta = threshold_factor * absw.mean(dim=dims, keepdim=True)
    mask = absw > delta
    t = torch.sign(w) * mask
    denom = mask.sum(dim=dims, keepdim=True).clamp_min(1)
    alpha = (absw * mask).sum(dim=dims, keepdim=True) / denom
    return t.to(torch.int8), alpha.float()


def _quantile(a: torch.Tensor, q: float, dim) -> torch.Tensor:
    """``jax.numpy.quantile(a, q, axis=dim, keepdims=True)`` (linear
    method) in float32, step for step: sort, position q·(n - 1) in float32,
    then the two neighbours weighted by the position's fraction. (Per
    tensor, ``torch.quantile`` refuses more than 2^24 elements; per channel
    its interpolation rounds otherwise.)"""
    if dim is None:
        s, n = a.reshape(-1).sort().values, a.numel()
        keep = (1,) * a.ndim
    else:
        s, n = a.sort(dim=dim).values, a.shape[dim]
        keep = None
    f32 = dict(dtype=torch.float32, device=a.device)
    pos = torch.tensor(q, **f32) * torch.tensor(float(n), **f32).sub(1)
    low, high = pos.floor(), pos.ceil()
    hw = pos - low
    lw = 1 - hw
    lo, hi = (int(v.clamp(0, n - 1)) for v in (low, high))
    if dim is None:
        return (s[lo] * lw + s[hi] * hw).reshape(keep)
    return (s.narrow(dim, lo, 1) * lw + s.narrow(dim, hi, 1) * hw)


def ternarize_target_sparsity(w: torch.Tensor, sparsity: float,
                              per_channel: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ternarize a (K, N) weight keeping a ``sparsity`` fraction of
    nonzeros (the paper's convention: sparsity = nnz fraction): the
    threshold is the (1 - sparsity) |W|-quantile per column (per channel)
    or over the matrix; ``|W| >= threshold`` survives. Returns (T int8,
    alpha f32 of shape (1, N) or (1, 1))."""
    absw = w.abs()
    dims = (0,) if per_channel else (0, 1)
    delta = _quantile(absw.float(), 1.0 - sparsity,
                      0 if per_channel else None)
    mask = absw >= delta
    t = torch.sign(w) * mask
    denom = mask.sum(dim=dims, keepdim=True).clamp_min(1)
    alpha = (absw * mask).sum(dim=dims, keepdim=True) / denom
    return t.to(torch.int8), alpha.float()


class _SteTernarize(torch.autograd.Function):
    """Forward: the effective ternary weight α·T in ``w.dtype``. Backward:
    straight through, masked to |w| <= 2·(mean|w| per column + 1e-8), as
    ``repro``'s ``_ste_bwd`` (the column mean over K, axis -2)."""

    @staticmethod
    def forward(ctx, w, threshold_factor):
        ctx.save_for_backward(w)
        t, alpha = ternarize(w, threshold_factor)
        return t.to(w.dtype) * alpha.to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        scale = w.abs().mean(dim=-2, keepdim=True) + 1e-8
        passthrough = (w.abs() <= 2.0 * scale).to(g.dtype)
        return g * passthrough, None


def ste_ternarize(w: torch.Tensor,
                  threshold_factor: float = 0.7) -> torch.Tensor:
    """QAT weight of a (..., K, N) latent (one ternarization per matrix, so
    an expert bank ternarizes per expert): ternary forward, straight-through
    backward (see ``_SteTernarize``)."""
    return _SteTernarize.apply(w, threshold_factor)


class _SteTernarizeRows(torch.autograd.Function):
    """``_SteTernarize`` of a row shard: this rank holds K/tp of every
    column's K rows, the group the rest. Δ's mean, α's masked sum and
    count, and the backward's pass-through scale (the same mean) are
    column sums all-reduced over the group: two all-reduces a forward
    ((1, N) sums of |w|, then (2, N) masked sums and counts), none in the
    backward."""

    @staticmethod
    def forward(ctx, w, threshold_factor, group, rows):
        absw = w.float().abs()
        mean = group.all_reduce(absw.sum(dim=-2, keepdim=True)) / rows
        mask = absw > threshold_factor * mean
        t = torch.sign(w.float()) * mask
        stats = group.all_reduce(torch.cat(
            [(absw * mask).sum(dim=-2, keepdim=True),
             mask.sum(dim=-2, keepdim=True).float()], dim=-2))
        alpha = stats.narrow(-2, 0, 1) / stats.narrow(-2, 1, 1).clamp_min(1)
        ctx.save_for_backward(w, mean)
        return t.to(w.dtype) * alpha.to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        w, mean = ctx.saved_tensors
        passthrough = (w.abs() <= 2.0 * (mean + 1e-8)).to(g.dtype)
        return g * passthrough, None, None, None


def ste_ternarize_rows(w: torch.Tensor, threshold_factor: float,
                       group, rows: Optional[int] = None) -> torch.Tensor:
    """QAT weight of a (..., K/tp, N) row shard of a latent whose columns
    ternarize over the whole K, the other rows held by ``group``'s ranks
    (a ``distributed.tp.Group``): the shard's rows of ``ste_ternarize`` of
    the whole matrix, up to the order of the column sums. ``rows``: the
    whole K where the ranks hold unequal shares (default K/tp x tp)."""
    if rows is None:
        rows = w.shape[-2] * group.size
    return _SteTernarizeRows.apply(w, threshold_factor, group, rows)


def effective_weight(w: torch.Tensor, quantization: str,
                     threshold_factor: float = 0.7) -> torch.Tensor:
    """Forward weight under a quantization mode: 'none' | 'ternary'."""
    if quantization == "ternary":
        return ste_ternarize(w, threshold_factor)
    return w
