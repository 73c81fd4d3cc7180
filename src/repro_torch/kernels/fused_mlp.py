"""Fused packed-ternary MLP block: the wrapper of the hand-written CUDA
kernel (``csrc/fused_mlp.cu``, which replaces ``repro``'s
``fused_mlp_pallas``) and its plain PyTorch version.

Both compute ``act(x @ Wg * sg + bg) * (x @ Wi * si + bi) @ Wo * so + bo``
(gate optional) and round where ``repro``'s chain rounds: ``yi`` and ``yg``
to ``x.dtype`` after their epilogues, then ``act(yg)``, then the product,
so ``h`` is held in ``x.dtype``. The plain version is literally the chain
of plain GEMMs; the kernel keeps ``h`` in shared memory.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import formats
from repro_torch.kernels import build
from repro_torch.kernels.ternary_gemm import (_check_vec, _ptr,
                                              ternary_gemm_ref)

__all__ = ["ACTIVATIONS", "VARIANTS", "fused_mlp_ref", "fused_mlp_cuda"]

ACTIVATIONS = ("silu", "relu", "none")

# (tile variant, ff columns per block) per serving phase (csrc/fused_mlp.cu):
# decode spreads ff over 32 blocks of 128 columns, prefill keeps 32-row
# tiles with 1024-column h slices (4 chunks x M/32 row tiles)
VARIANTS = {"decode": (0, 128), "prefill": (1, 1024)}


def _act(name: str, y: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(y)
    if name == "relu":
        return F.relu(y)
    if name == "none":
        return y
    raise ValueError(f"activation must be one of {ACTIVATIONS}, got {name!r}")


def fused_mlp_ref(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                  wg: Optional[torch.Tensor] = None,
                  si=None, bi=None, sg=None, bg=None, so=None, bo=None, *,
                  activation: str = "silu") -> torch.Tensor:
    """Plain version: the chain of plain GEMMs. x (M, K); wi, wg
    (>= ceil(K/16), ff) and wo (>= ceil(ff/16), N) int32 words."""
    yi = ternary_gemm_ref(x, wi, si, bi)
    if wg is not None:
        h = _act(activation, ternary_gemm_ref(x, wg, sg, bg)) * yi
    else:
        h = _act(activation, yi)
    return ternary_gemm_ref(h, wo, so, bo)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("fused_mlp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_bf16.argtypes = [p] * 12 + [i] * 9 + [p]
    lib.fused_mlp_bf16.restype = ctypes.c_int
    return lib


def _check_words(name: str, w: torch.Tensor, device: torch.device) -> None:
    if (w.device != device or w.dtype != torch.int32 or w.ndim != 2
            or not w.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous 2-D int32 tensor on "
                         f"{device}, got {w.dtype} {tuple(w.shape)} on "
                         f"{w.device}")


def fused_mlp_cuda(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                   wg: Optional[torch.Tensor] = None,
                   si=None, bi=None, sg=None, bg=None, so=None, bo=None, *,
                   activation: str = "silu",
                   variant: int = 1, ff_chunk: int = 1024) -> torch.Tensor:
    """Launch the fused kernel (and its fixed-order partial-sum pass) on the
    current stream. x (M, K) bf16; words int32 as in ``fused_mlp_ref``;
    the six vectors float32. ``ff_chunk`` is the hidden width one block
    keeps in shared memory (a multiple of 128). Returns (M, N) bf16."""
    if not x.is_cuda:
        raise ValueError("fused_mlp_cuda needs a CUDA tensor; CPU tensors "
                         "take fused_mlp_ref")
    if x.dtype != torch.bfloat16 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D bfloat16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    dev = x.device
    _check_words("wi", wi, dev)
    _check_words("wo", wo, dev)
    if wg is not None:
        _check_words("wg", wg, dev)
        if wg.shape != wi.shape:
            raise ValueError(f"gate words {tuple(wg.shape)} must match the "
                             f"up projection's {tuple(wi.shape)}")
    m, k = x.shape
    kw1, ff = wi.shape
    kw2, n = wo.shape
    if kw1 * formats.K_PER_WORD < k or kw2 * formats.K_PER_WORD < ff:
        raise ValueError(f"packed words too short: wi covers K="
                         f"{kw1 * formats.K_PER_WORD} for x's K={k}, wo "
                         f"covers {kw2 * formats.K_PER_WORD} for ff={ff}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}")
    if variant not in (0, 1) or ff_chunk <= 0 or ff_chunk % 128:
        raise ValueError(f"bad tile: variant={variant}, ff_chunk={ff_chunk}")
    for name, v, width in (("si", si, ff), ("bi", bi, ff), ("sg", sg, ff),
                           ("bg", bg, ff), ("so", so, n), ("bo", bo, n)):
        _check_vec(name, v, width, dev)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    if m == 0 or n == 0:
        return y
    fc = min(ff_chunk, -(-ff // 128) * 128)
    chunks = -(-ff // fc)
    partial = torch.empty((chunks, m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().fused_mlp_bf16(
            x.data_ptr(), wi.data_ptr(), _ptr(wg), wo.data_ptr(), _ptr(si),
            _ptr(bi), _ptr(sg), _ptr(bg), _ptr(so), _ptr(bo),
            partial.data_ptr(), y.data_ptr(), m, k, ff, n, kw1, kw2, fc,
            ACTIVATIONS.index(activation), variant,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: cudaError {err}")
    fused_mlp_cuda.launches += 1
    return y


fused_mlp_cuda.launches = 0
