"""Bitplane ternary GEMM: the wrapper of the hand-written CUDA kernel
(``csrc/ternary_gemm_bitplane.cu``, B7, which replaces ``repro``'s
``ternary_gemm_bitplane``) and its plain PyTorch version.

Both compute ``Y = X @ (P - M)``, or with ``factorized`` ``(X @ P) - (X @
M)`` combined on the f32 accumulators after the K loop, then round where
``repro``'s
bitplane lowering rounds: ``scale`` in f32 and a cast to ``x.dtype``
(inside its Pallas kernel), then ``bias`` cast to ``x.dtype`` and added,
then PReLU with ``prelu_alpha`` in ``x.dtype`` (after it). The plain
version serves CPU tensors and the comparisons, never a CUDA tensor on a
kernel row.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import formats
from repro_torch.kernels import build
from repro_torch.kernels.ternary_gemm import _check_vec, _ptr

__all__ = ["ternary_gemm_bitplane_ref", "ternary_gemm_bitplane_cuda",
           "PLANE_LUT", "TILES", "fragment_byte_rows", "fragment_index"]

# B7's tiles, (block_m, block_n): B7_TILES of csrc/ternary_gemm_bitplane.cu
# (the decode tile 16 x 64, the prefill tile 64 x 128, and the 16- and
# 32-row tiles of 128 columns the tuner's clamp of the prefill tile lands
# on at small M); the block-shape tuner picks one
TILES = ((16, 64), (16, 128), (32, 128), (64, 128))

_BF16 = {0: 0x0000, 1: 0x3F80, -1: 0xBF80}


def _plane_pair(v: int) -> int:
    lo = (v & 1) - ((v >> 2) & 1)
    hi = ((v >> 1) & 1) - ((v >> 3) & 1)
    return _BF16[lo] | (_BF16[hi] << 16)


# B7's register decode (csrc/ternary_gemm_bitplane.cu, kPlaneLut): a
# fragment register holds two K rows of one column; its index v = p_lo |
# p_hi << 1 | m_lo << 2 | m_hi << 3 (the rows' plus and minus bits) picks
# the bf16x2 pair (p_lo - m_lo, p_hi - m_hi), low half first. Entries 0-3
# are one plane's 0/1 pairs (the factorized mode's fragments).
PLANE_LUT = tuple(_plane_pair(v) for v in range(16))


def fragment_byte_rows(kk: int) -> tuple:
    """The plane byte rows (of a 64-deep step's 8) that 16-deep chunk
    ``kk`` reads: register b[0] from the first, b[1] from the second."""
    return 2 * kk, 2 * kk + 1


def fragment_index(p, m, t):
    """The table index of lane quad position ``t`` (lane % 4) from the
    plus and minus bytes ``p``, ``m`` of its column and byte row: bits 2t
    and 2t + 1 of each (ints or integer arrays)."""
    return ((p >> (2 * t)) & 3) | (((m >> (2 * t)) & 3) << 2)


def ternary_gemm_bitplane_ref(x: torch.Tensor, plus: torch.Tensor,
                              minus: torch.Tensor,
                              scale: Optional[torch.Tensor] = None,
                              bias: Optional[torch.Tensor] = None, *,
                              factorized: bool = False,
                              fuse_prelu: bool = False,
                              prelu_alpha: float = 0.25) -> torch.Tensor:
    """Plain version: x (M, K), planes (>= ceil(K/8), N) uint8 -> (M, N)
    in x.dtype."""
    k = x.shape[1]
    xf = x.float()
    if factorized:
        zeros = torch.zeros_like(plus)
        y = (xf @ formats.decode_bitplanes(plus, zeros, k, torch.float32)
             - xf @ formats.decode_bitplanes(minus, zeros, k, torch.float32))
    else:
        y = xf @ formats.decode_bitplanes(plus, minus, k, torch.float32)
    if scale is not None:
        y = y * scale.float()
    y = y.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    if fuse_prelu:
        y = torch.where(y >= 0, y,
                        torch.tensor(prelu_alpha, dtype=y.dtype,
                                     device=y.device) * y)
    return y


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ternary_gemm_bitplane")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ternary_gemm_bitplane_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                               i, ctypes.c_float, i, i, i,
                                               p]
    lib.ternary_gemm_bitplane_bf16.restype = ctypes.c_int
    return lib


def ternary_gemm_bitplane_cuda(x: torch.Tensor, plus: torch.Tensor,
                               minus: torch.Tensor,
                               scale: Optional[torch.Tensor] = None,
                               bias: Optional[torch.Tensor] = None, *,
                               factorized: bool = False,
                               fuse_prelu: bool = False,
                               prelu_alpha: float = 0.25,
                               block_m: int = 64,
                               block_n: int = 128) -> torch.Tensor:
    """Launch B7 on the current stream. x (M, K) bf16 and the planes
    (>= ceil(K/8), N) uint8 must be contiguous CUDA tensors on one device;
    scale/bias, when given, (N,) float32. ``(block_m, block_n)`` is one of
    ``TILES`` (another raises). Returns (M, N) bf16. Raises on
    anything the kernel does not take, and on a failed launch."""
    if not x.is_cuda:
        raise ValueError("ternary_gemm_bitplane_cuda needs a CUDA tensor; "
                         "CPU tensors take the plain version")
    if x.dtype != torch.bfloat16 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D bfloat16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    for name, pl in (("plus", plus), ("minus", minus)):
        if (pl.device != x.device or pl.dtype != torch.uint8 or pl.ndim != 2
                or not pl.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous 2-D uint8 tensor "
                             f"on {x.device}, got {pl.dtype} "
                             f"{tuple(pl.shape)} on {pl.device}")
    if plus.shape != minus.shape:
        raise ValueError(f"plane shapes differ: {tuple(plus.shape)} vs "
                         f"{tuple(minus.shape)}")
    m, k = x.shape
    kb, n = plus.shape
    if kb * formats.K_PER_BYTE < k:
        raise ValueError(f"planes cover K={kb * formats.K_PER_BYTE} < x's "
                         f"K={k}")
    if (block_m, block_n) not in TILES:
        raise ValueError(f"(block_m, block_n)=({block_m}, {block_n}) is not "
                         f"one of B7's tiles {TILES}")
    _check_vec("scale", scale, n, x.device)
    _check_vec("bias", bias, n, x.device)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0 or n == 0:
        return y
    with torch.cuda.device(x.device):
        err = _lib().ternary_gemm_bitplane_bf16(
            x.data_ptr(), plus.data_ptr(), minus.data_ptr(), _ptr(scale),
            _ptr(bias), y.data_ptr(), m, k, n, kb, int(fuse_prelu),
            prelu_alpha, int(factorized), block_m, block_n,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ternary_gemm_bitplane kernel launch failed: "
                           f"cudaError {err}")
    ternary_gemm_bitplane_cuda.launches += 1
    return y


ternary_gemm_bitplane_cuda.launches = 0
