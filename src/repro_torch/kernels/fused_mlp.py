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
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import formats
from repro_torch.kernels import build
from repro_torch.kernels.ternary_gemm import (_check_vec, _ptr,
                                              ternary_gemm_ref)

__all__ = ["ACTIVATIONS", "VARIANTS", "BLOCK_M", "STRIP", "FusedPlan",
           "launch_plan", "fused_mlp_ref", "fused_mlp_cuda"]

ACTIVATIONS = ("silu", "relu", "none")

# (tile variant, most ff columns per block) per serving phase
# (csrc/fused_mlp.cu), the fastest of the candidates timed on the H100:
# decode takes 16-row tiles and 64-column ff chunks (64 blocks share ff
# 4096); prefill and evaluation take 64-row tiles and chunks of up to 512
# columns, halved by launch_plan until the grid holds two blocks an SM
# (256 at M 1024, 512 at M 8192 on 132 SMs)
VARIANTS = {"decode": (0, 64), "prefill": (1, 512)}
BLOCK_M = {0: 16, 1: 64}          # variant -> rows per block
STRIP = {0: 64, 1: 128}           # variant -> ff / N columns per strip
BLOCKS_PER_SM = 2                 # the prefill tile's residency at FC <= 512


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """One launch of B4: ``fc`` ff columns per block, ``chunks`` of them,
    a (chunks, row tiles) grid, the (chunks, M, N) f32 partials."""

    variant: int
    fc: int
    chunks: int
    grid: Tuple[int, int]
    partial_numel: int


def launch_plan(m: int, ff: int, n: int, variant: int, ff_chunk: int,
                sm_count: int) -> FusedPlan:
    """The chunk width of one launch: at most ``ff_chunk`` (a multiple of
    the variant's strip) and ff rounded up to a strip, halved (in whole
    strips) while the grid holds fewer blocks than 7/8 of ``BLOCKS_PER_SM``
    x ``sm_count``: more chunks fill the card, fewer keep the partials
    small. Raises when the tile is unknown; a chunk whose h slice does
    not fit in shared memory fails at the launch."""
    if variant not in BLOCK_M:
        raise ValueError(f"unknown tile variant {variant}")
    strip = STRIP[variant]
    if ff_chunk <= 0 or ff_chunk % strip:
        raise ValueError(f"bad tile: variant={variant} takes ff_chunk a "
                         f"positive multiple of {strip}, got {ff_chunk}")
    m_tiles = -(-m // BLOCK_M[variant])
    fc = min(ff_chunk, max(strip, -(-ff // strip) * strip))
    wave = BLOCKS_PER_SM * sm_count
    while m_tiles * -(-ff // fc) < wave - wave // 8:
        half = max(strip, fc // 2 // strip * strip)
        if half == fc:
            break
        fc = half
    chunks = -(-ff // fc)
    return FusedPlan(variant=variant, fc=fc, chunks=chunks,
                     grid=(chunks, m_tiles), partial_numel=chunks * m * n)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
                   variant: int = 1, ff_chunk: int = 512) -> torch.Tensor:
    """Launch the fused kernel (and its fixed-order partial-sum pass) on the
    current stream. x (M, K) bf16; words int32 as in ``fused_mlp_ref``;
    the six vectors float32. ``ff_chunk`` is the most hidden columns one
    block keeps in shared memory (a multiple of the variant's strip,
    ``STRIP``); ``launch_plan`` narrows it to fill the card. Returns (M,
    N) bf16."""
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
    for name, v, width in (("si", si, ff), ("bi", bi, ff), ("sg", sg, ff),
                           ("bg", bg, ff), ("so", so, n), ("bo", bo, n)):
        _check_vec(name, v, width, dev)
    plan = launch_plan(m, ff, n, variant, ff_chunk,
                       _sm_count(dev.index if dev.index is not None
                                 else torch.cuda.current_device()))
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    if m == 0 or n == 0:
        return y
    partial = torch.empty((plan.chunks, m, n), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        err = _lib().fused_mlp_bf16(
            x.data_ptr(), wi.data_ptr(), _ptr(wg), wo.data_ptr(), _ptr(si),
            _ptr(bi), _ptr(sg), _ptr(bg), _ptr(so), _ptr(bo),
            partial.data_ptr(), y.data_ptr(), m, k, ff, n, kw1, kw2, plan.fc,
            ACTIVATIONS.index(activation), variant,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: cudaError {err}")
    fused_mlp_cuda.launches += 1
    return y


fused_mlp_cuda.launches = 0
