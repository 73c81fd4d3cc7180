"""Fused packed-ternary MLP block: the wrapper of the hand-written CUDA
kernel (``csrc/fused_mlp.cu``, which replaces ``repro``'s
``fused_mlp_pallas``) and its plain PyTorch version.

Both compute ``act(x @ Wg * sg + bg) * (x @ Wi * si + bi) @ Wo * so + bo``
(gate optional) and round where ``repro``'s chain rounds: ``yi`` and ``yg``
to ``x.dtype`` after their epilogues, then ``act(yg)``, then the product,
so ``h`` is held in ``x.dtype``. The plain version is literally the chain
of plain GEMMs; the kernel keeps ``h`` in shared memory and sums the down
projection in f32 partials of ``chunk_width(ff)`` hidden columns, added in
a fixed order, so its output for a row does not depend on how many rows
share the call. Both have an f32 form (``out_dtype=torch.float32``) for a
tensor-parallel shard whose ff slice is this rank's: the down projection
scaled, in f32, without its bias, which the ranks sum before the bias and
the cast.
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

__all__ = ["ACTIVATIONS", "TILES", "MAX_CHUNK", "MAX_CLUSTER", "FusedPlan",
           "chunk_width", "tile_for", "launch_plan", "fused_mlp_ref",
           "fused_mlp_cuda"]

ACTIVATIONS = ("silu", "relu", "none")

# the tiles csrc/fused_mlp.cu instantiates, (rows per block, ff / N
# columns per strip), the fastest of the candidates timed on the H100: the
# 16-row tile for GEMV-shaped decode, the 64-row one for prefill and
# evaluation; the block-shape tuner's fused plan names one (tile_for)
TILES = ((16, 64), (64, 128))
MAX_CHUNK = 512                   # the widest ff chunk (h slice) a block holds
MAX_CLUSTER = 8                   # blocks sharing a chunk (portable cluster)
BLOCKS_PER_SM = 2                 # the prefill tile's residency at FC <= 512


def chunk_width(ff: int) -> int:
    """FC, the ff columns whose down-projection products one f32 partial
    sums: ff rounded up to whole 128-column strips (so every tile's
    strips divide it), at most ``MAX_CHUNK``. It depends on the widths
    alone, so a row's sum is grouped the same way whatever M and tile."""
    return min(MAX_CHUNK, max(128, -(-ff // 128) * 128))


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """One launch of B4: ``chunks`` ff chunks of ``fc`` columns, each
    spread over a cluster of ``cluster`` blocks per row tile, a
    (chunks x cluster, row tiles) grid, the (chunks, M, N) f32 partials."""

    tile: Tuple[int, int]
    fc: int
    chunks: int
    cluster: int
    grid: Tuple[int, int]
    partial_numel: int


def tile_for(block_m: int) -> Tuple[int, int]:
    """The B4 tile a fused plan's ``block_m`` names: the tile with the
    smallest ``block_m`` at or above it, else the largest tile. Its strip
    is the tile's own (the composed entry's ``block_n1`` / ``block_n2``
    are B1's or the pack's, which B4 does not take)."""
    for tile in TILES:
        if tile[0] >= block_m:
            return tile
    return TILES[-1]


def launch_plan(m: int, ff: int, n: int, tile: Tuple[int, int],
                sm_count: int) -> FusedPlan:
    """The chunk width comes from ``chunk_width(ff)``; the cluster size
    doubles (up to ``MAX_CLUSTER``, each block keeping whole strips of
    the chunk) while the grid holds fewer blocks than 7/8 of
    ``BLOCKS_PER_SM`` x ``sm_count``. The cluster spreads a chunk's work
    over more SMs and moves no sum. Raises when the tile is not one of
    ``TILES``."""
    tile = tuple(tile)
    if tile not in TILES:
        raise ValueError(f"(block_m, strip)={tile} is not one of B4's tiles "
                         f"{TILES}")
    block_m, strip = tile
    fc = chunk_width(ff)
    chunks = -(-ff // fc)
    m_tiles = -(-m // block_m)
    wave = BLOCKS_PER_SM * sm_count
    cluster = 1
    while (chunks * cluster * m_tiles < wave - wave // 8
           and cluster * 2 <= MAX_CLUSTER
           and fc % (cluster * 2 * strip) == 0):
        cluster *= 2
    return FusedPlan(tile=tile, fc=fc, chunks=chunks, cluster=cluster,
                     grid=(chunks * cluster, m_tiles),
                     partial_numel=chunks * m * n)


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
                  activation: str = "silu",
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version: the chain of plain GEMMs. x (M, K); wi, wg
    (>= ceil(K/16), ff) and wo (>= ceil(ff/16), N) int32 words.
    ``out_dtype=torch.float32``: the last GEMM's f32 form (scale only;
    ``bo`` must be None)."""
    yi = ternary_gemm_ref(x, wi, si, bi)
    if wg is not None:
        h = _act(activation, ternary_gemm_ref(x, wg, sg, bg)) * yi
    else:
        h = _act(activation, yi)
    if out_dtype == torch.float32:
        if bo is not None:
            raise ValueError("the f32 form adds no bias")
        return ternary_gemm_ref(h, wo, so, out_dtype=torch.float32)
    return ternary_gemm_ref(h, wo, so, bo)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("fused_mlp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_bf16.argtypes = [p] * 12 + [i] * 14 + [p]
    lib.fused_mlp_bf16.restype = ctypes.c_int
    lib.fused_mlp_f32.argtypes = [p] * 11 + [i] * 14 + [p]
    lib.fused_mlp_f32.restype = ctypes.c_int
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
                   ff: Optional[int] = None, n: Optional[int] = None,
                   activation: str = "silu", block_m: int = 64,
                   strip: int = 128,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Launch the fused kernel (and its fixed-order partial-sum pass) on the
    current stream. x (M, K) bf16; words int32 as in ``fused_mlp_ref``,
    read in place: the first ``ff`` (default wi's width) columns of wi and
    wg and the first ``n`` (default wo's width) of wo, so a tile-padded
    pack runs without a copy; the six vectors float32. ``(block_m,
    strip)`` is one of ``TILES`` (another raises). ``launch_plan`` fixes
    the chunk width from ff and spreads it to fill the card. Returns (M, n)
    bf16, or with ``out_dtype=torch.float32`` the f32 form (``bo`` must be
    None)."""
    if not x.is_cuda:
        raise ValueError("fused_mlp_cuda needs a CUDA tensor; CPU tensors "
                         "take fused_mlp_ref")
    if x.dtype != torch.bfloat16 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D bfloat16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    dev = x.device
    m, k = x.shape
    ff = wi.shape[1] if ff is None else ff
    n = wo.shape[1] if n is None else n
    for name, w, rows, cols in (("wi", wi, k, ff), ("wg", wg, k, ff),
                                ("wo", wo, ff, n)):
        if w is None:
            continue
        _check_words(name, w, dev)
        if (w.shape[0] * formats.K_PER_WORD < rows or not 0 <= cols
                or w.shape[1] < cols):
            raise ValueError(f"{name} words {tuple(w.shape)} do not cover "
                             f"({rows}, {cols})")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got "
                         f"{out_dtype}")
    f32 = out_dtype == torch.float32
    if f32 and bo is not None:
        raise ValueError("B4's f32 form adds no bias: it follows the ranks' "
                         "all-reduce")
    for name, v, width in (("si", si, ff), ("bi", bi, ff), ("sg", sg, ff),
                           ("bg", bg, ff), ("so", so, n), ("bo", bo, n)):
        _check_vec(name, v, width, dev)
    plan = launch_plan(m, ff, n, (block_m, strip),
                       _sm_count(dev.index if dev.index is not None
                                 else torch.cuda.current_device()))
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return y
    partial = torch.empty((plan.chunks, m, n), dtype=torch.float32,
                          device=dev)
    # word rows past K (ff) meet zero x (h) columns: read only those needed
    kw1, kw2 = -(-k // formats.K_PER_WORD), -(-ff // formats.K_PER_WORD)
    head = (x.data_ptr(), wi.data_ptr(), _ptr(wg), wo.data_ptr(), _ptr(si),
            _ptr(bi), _ptr(sg), _ptr(bg), _ptr(so))
    tail = (partial.data_ptr(), y.data_ptr(), m, k, ff, n, kw1, kw2,
            wi.shape[1], wi.shape[1] if wg is None else wg.shape[1],
            wo.shape[1], plan.fc, plan.cluster,
            ACTIVATIONS.index(activation), block_m, strip,
            torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(dev):
        if f32:
            err = _lib().fused_mlp_f32(*head, *tail)
        else:
            err = _lib().fused_mlp_bf16(*head, _ptr(bo), *tail)
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: cudaError {err}")
    fused_mlp_cuda.launches += 1
    return y


fused_mlp_cuda.launches = 0
