"""Plain PyTorch ternary matmuls over the packed formats (the port's copy of
``repro.kernels.ref``'s packed-format oracles): decode to a float {-1, 0,
+1} matrix, multiply in float32, then the float32 epilogue (scale, bias,
PReLU) and one cast to ``x.dtype`` — where ``repro``'s ``ref`` lowerings
round. They back the registry's ``ref`` rows and the ``base3`` format,
which has no kernel (in ``repro`` neither).

The paper's TCSC algorithms (``tcsc_matmul``, ``tcsc_matmul_blocked``,
``tcsc_matmul_interleaved``) gather X's columns by row index into an
(nnz, M) float32 array and sum it into the output columns with
``index_add_`` (``repro``'s gather + ``segment_sum``), then the same
epilogue. No TPU kernel computes them, so they stay plain PyTorch on the
card too; there ``index_add_`` sums in atomic order, so their outputs
agree with another device's to a tolerance, not bitwise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import formats

__all__ = ["prelu", "ternary_matmul_dense", "tcsc_matmul",
           "tcsc_matmul_blocked", "tcsc_matmul_interleaved",
           "packed2bit_matmul",
           "bitplane_matmul", "bitplane_matmul_factorized", "base3_matmul"]


def prelu(y: torch.Tensor, a: float) -> torch.Tensor:
    return torch.where(y >= 0, y, a * y)


def _epilogue(y: torch.Tensor, alpha: Optional[torch.Tensor],
              bias: Optional[torch.Tensor],
              prelu_alpha: Optional[float]) -> torch.Tensor:
    if alpha is not None:
        y = y * alpha.to(y.dtype).reshape(1, -1)
    if bias is not None:
        y = y + bias.to(y.dtype).reshape(1, -1)
    if prelu_alpha is not None:
        y = prelu(y, prelu_alpha)
    return y


def ternary_matmul_dense(x: torch.Tensor, t: torch.Tensor,
                         alpha: Optional[torch.Tensor] = None,
                         bias: Optional[torch.Tensor] = None,
                         prelu_alpha: Optional[float] = None) -> torch.Tensor:
    """x (M, K) @ t (K, N) {-1, 0, 1} with float32 accumulation and
    epilogue, cast once to ``x.dtype``."""
    y = x.float() @ t.float()
    return _epilogue(y, alpha, bias, prelu_alpha).to(x.dtype)


def _gather_sum(xt: torch.Tensor, rows: torch.Tensor, seg: torch.Tensor,
                y: torch.Tensor, sign: int = 1) -> None:
    """y[seg[i]] += sign * xt[rows[i]] for every entry i (y: (N, M))."""
    y.index_add_(0, seg.long(), xt[rows.long()], alpha=sign)


def tcsc_matmul(x: torch.Tensor, w: formats.TCSC, alpha=None, bias=None,
                prelu_alpha=None) -> torch.Tensor:
    """BaseTCSC: all +1 entries, then all -1 entries, per column."""
    xt = x.float().T
    y = torch.zeros((w.shape[1], x.shape[0]), dtype=torch.float32,
                    device=x.device)
    _gather_sum(xt, w.row_index_pos, w.segment_ids_pos(), y)
    _gather_sum(xt, w.row_index_neg, w.segment_ids_neg(), y, -1)
    return _epilogue(y.T, alpha, bias, prelu_alpha).to(x.dtype)


def tcsc_matmul_blocked(x: torch.Tensor, w: formats.BlockedTCSC, alpha=None,
                        bias=None, prelu_alpha=None) -> torch.Tensor:
    """BlockedTCSC: each K-block's gathers confined to its [0, B) window
    of X."""
    xt = x.float().T
    y = torch.zeros((w.shape[1], x.shape[0]), dtype=torch.float32,
                    device=x.device)
    for b, blk in enumerate(w.blocks):
        window = xt[b * w.block_size:(b + 1) * w.block_size]
        _gather_sum(window, blk.row_index_pos, blk.segment_ids_pos(), y)
        _gather_sum(window, blk.row_index_neg, blk.segment_ids_neg(), y, -1)
    return _epilogue(y.T, alpha, bias, prelu_alpha).to(x.dtype)


def tcsc_matmul_interleaved(x: torch.Tensor, w: formats.InterleavedTCSC,
                            alpha=None, bias=None,
                            prelu_alpha=None) -> torch.Tensor:
    """InterleavedTCSC: one pass over one index array, the signs
    structural."""
    xs = x.float().T[w.all_indices.long()] * w.signs().float()[:, None]
    y = torch.zeros((w.shape[1], x.shape[0]), dtype=torch.float32,
                    device=x.device)
    y.index_add_(0, w.segment_ids().long(), xs)
    return _epilogue(y.T, alpha, bias, prelu_alpha).to(x.dtype)


def packed2bit_matmul(x: torch.Tensor, packed: torch.Tensor, k: int,
                      alpha=None, bias=None, prelu_alpha=None) -> torch.Tensor:
    t = formats.decode_2bit(packed, k, torch.float32)
    return ternary_matmul_dense(x, t, alpha, bias, prelu_alpha)


def bitplane_matmul(x: torch.Tensor, plus: torch.Tensor, minus: torch.Tensor,
                    k: int, alpha=None, bias=None,
                    prelu_alpha=None) -> torch.Tensor:
    t = formats.decode_bitplanes(plus, minus, k, torch.float32)
    return ternary_matmul_dense(x, t, alpha, bias, prelu_alpha)


def bitplane_matmul_factorized(x: torch.Tensor, plus: torch.Tensor,
                               minus: torch.Tensor, k: int, alpha=None,
                               bias=None, prelu_alpha=None) -> torch.Tensor:
    """``Y = (X @ P) - (X @ M)``: each 0/1 plane its own matmul, the
    ternary combine on the float32 accumulator."""
    zeros = torch.zeros_like(plus)
    p = formats.decode_bitplanes(plus, zeros, k, torch.float32)
    m = formats.decode_bitplanes(minus, zeros, k, torch.float32)
    xf = x.float()
    y = xf @ p - xf @ m
    return _epilogue(y, alpha, bias, prelu_alpha).to(x.dtype)


def base3_matmul(x: torch.Tensor, packed: torch.Tensor, k: int, alpha=None,
                 bias=None, prelu_alpha=None) -> torch.Tensor:
    t = formats.decode_base3(packed, k, torch.float32)
    return ternary_matmul_dense(x, t, alpha, bias, prelu_alpha)
