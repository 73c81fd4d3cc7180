"""Ternary quantization: TWN-style absmean thresholding (the port's copy of
``repro.core.quantize.ternarize``; the straight-through estimator waits for
the training path is ported)."""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ternarize"]


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
