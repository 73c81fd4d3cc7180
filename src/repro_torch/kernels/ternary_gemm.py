"""Packed 2-bit ternary GEMM: the wrapper of the hand-written CUDA kernel
(``csrc/ternary_gemm.cu``, which replaces ``repro``'s
``ternary_gemm_pallas``) and its plain PyTorch version.

Both compute ``Y = X @ decode(W) * scale + bias (+ PReLU)`` with f32
accumulation and the f32 epilogue rounding once, at the cast to ``x.dtype``.
The plain version decodes to f32 and multiplies in f32; it serves CPU
tensors and the comparisons, never a CUDA tensor on the serving path.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import formats
from repro_torch.kernels import build

__all__ = ["ternary_gemm_ref", "ternary_gemm_cuda", "VARIANTS"]

# tile shape of the kernel per serving phase (see csrc/ternary_gemm.cu):
# decode GEMVs take the narrow 16 x 64 tile, prefill the 64 x 128 tile
VARIANTS = {"decode": 0, "prefill": 1}


def ternary_gemm_ref(x: torch.Tensor, words: torch.Tensor,
                     scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None, *,
                     fuse_prelu: bool = False,
                     prelu_alpha: float = 0.25) -> torch.Tensor:
    """Plain version: x (M, K), words (>= ceil(K/16), N) int32 -> (M, N) in
    x.dtype. Decode to f32, f32 matmul, f32 epilogue, one cast."""
    t = formats.decode_2bit(words, x.shape[1], torch.float32)
    y = x.float() @ t
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    if fuse_prelu:
        y = torch.where(y >= 0, y, prelu_alpha * y)
    return y.to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ternary_gemm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ternary_gemm_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                      ctypes.c_float, i, p]
    lib.ternary_gemm_bf16.restype = ctypes.c_int
    return lib


def _check_vec(name: str, v: Optional[torch.Tensor], n: int,
               device: torch.device) -> None:
    if v is None:
        return
    if (v.device != device or v.dtype != torch.float32
            or tuple(v.shape) != (n,) or not v.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 ({n},) tensor "
                         f"on {device}, got {v.dtype} {tuple(v.shape)} on "
                         f"{v.device}")


def _ptr(v: Optional[torch.Tensor]):
    return None if v is None else v.data_ptr()


def ternary_gemm_cuda(x: torch.Tensor, words: torch.Tensor,
                      scale: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None, *,
                      fuse_prelu: bool = False, prelu_alpha: float = 0.25,
                      variant: int = 1) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. x (M, K) bf16 and
    words (>= ceil(K/16), N) int32 must be contiguous CUDA tensors on one
    device; scale/bias, when given, (N,) float32. Returns (M, N) bf16.
    Raises on anything the kernel does not take, and on a failed launch."""
    if not x.is_cuda:
        raise ValueError("ternary_gemm_cuda needs a CUDA tensor; CPU tensors "
                         "take ternary_gemm_ref")
    if x.dtype != torch.bfloat16 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D bfloat16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if (words.device != x.device or words.dtype != torch.int32
            or words.ndim != 2 or not words.is_contiguous()):
        raise ValueError(f"words must be a contiguous 2-D int32 tensor on "
                         f"{x.device}, got {words.dtype} "
                         f"{tuple(words.shape)} on {words.device}")
    m, k = x.shape
    kw, n = words.shape
    if kw * formats.K_PER_WORD < k:
        raise ValueError(f"words cover K={kw * formats.K_PER_WORD} < x's "
                         f"K={k}")
    if variant not in VARIANTS.values():
        raise ValueError(f"unknown tile variant {variant}")
    _check_vec("scale", scale, n, x.device)
    _check_vec("bias", bias, n, x.device)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0 or n == 0:
        return y
    with torch.cuda.device(x.device):
        err = _lib().ternary_gemm_bf16(
            x.data_ptr(), words.data_ptr(), _ptr(scale), _ptr(bias),
            y.data_ptr(), m, k, n, kw, int(fuse_prelu), prelu_alpha, variant,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ternary_gemm kernel launch failed: "
                           f"cudaError {err}")
    ternary_gemm_cuda.launches += 1
    return y


ternary_gemm_cuda.launches = 0
