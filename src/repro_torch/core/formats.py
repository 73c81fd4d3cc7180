"""2-bit ternary packing — the format both hand-written kernels read.

Codes: 0 -> 0, 1 -> +1, 2 -> -1 (3 unused); ``decode(c) = (c & 1) -
((c >> 1) & 1)``. Sixteen consecutive K-entries share one 32-bit word: bits
``[2r, 2r+2)`` of ``word[q, n]`` encode ``w[16q + r, n]`` — bit for bit the
layout of ``repro.core.formats.pack_2bit``.

The words are held as an ``int32`` view of the same bits. PyTorch's
``uint32`` has no right shift on the CPU, and ``(w >> 2r) & 3`` on the
``int32`` view is exact for every ``r <= 15`` even though the arithmetic
shift sign-extends (only bits ``2r`` and ``2r+1`` survive the mask). The
CUDA kernels read the same buffer as ``uint32_t``.
"""
from __future__ import annotations

import torch

__all__ = ["K_PER_WORD", "pack_2bit", "decode_2bit"]

K_PER_WORD = 16


def pack_2bit(w: torch.Tensor) -> torch.Tensor:
    """Pack (..., K, N) ternary {-1, 0, +1} into (..., ceil(K/16), N) int32
    words (the uint32 bit pattern of ``repro``'s packer). Runs on the
    tensor's own device."""
    if w.ndim < 2:
        raise ValueError(f"pack_2bit expects (..., K, N), got {tuple(w.shape)}")
    *lead, k, n = w.shape
    kp = -(-k // K_PER_WORD) * K_PER_WORD
    codes = torch.zeros((*lead, kp, n), dtype=torch.int64, device=w.device)
    codes[..., :k, :] = (w == 1).long() + 2 * (w == -1).long()
    shifts = 2 * torch.arange(K_PER_WORD, dtype=torch.int64,
                              device=w.device).view(K_PER_WORD, 1)
    words = (codes.view(*lead, kp // K_PER_WORD, K_PER_WORD, n)
             << shifts).sum(dim=-2)
    # the OR of disjoint bit fields equals their sum; fold the unsigned
    # 32-bit value into int32's range so the bits are unchanged
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def decode_2bit(packed: torch.Tensor, k: int,
                dtype=torch.bfloat16) -> torch.Tensor:
    """(..., K/16, N) int32 words -> (..., k, N) {-1, 0, +1} in ``dtype``."""
    if packed.dtype != torch.int32:
        raise TypeError(f"packed words must be int32, got {packed.dtype}")
    *lead, q, n = packed.shape
    shifts = 2 * torch.arange(K_PER_WORD, dtype=torch.int32,
                              device=packed.device).view(K_PER_WORD, 1)
    c = (packed.unsqueeze(-2) >> shifts) & 3
    vals = (c & 1) - ((c >> 1) & 1)
    return vals.reshape(*lead, q * K_PER_WORD, n)[..., :k, :].to(dtype)
