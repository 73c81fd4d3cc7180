"""Packed 2-bit ternary GEMM: the wrappers of the hand-written CUDA kernels
and their plain PyTorch versions.

* ``ternary_gemm_cuda`` -> ``csrc/ternary_gemm.cu`` (B1, replaces
  ``repro``'s ``ternary_gemm_pallas``): every K step of every output tile.
* ``ternary_gemm_skip_cuda`` -> ``csrc/ternary_gemm_skip.cu`` (B2 and, with
  ``db=True``, B3; they replace ``ternary_gemm_skip_pallas`` and
  ``ternary_gemm_skip_db_pallas``): the K walk of each N-tile visits only
  its occupied K-tiles, in ascending order, through B1's register decode;
  B2's stages filled by ``cp.async``, B3's by the Tensor Memory
  Accelerator (TMA) under ``mbarrier``s.

All compute ``Y = X @ decode(W) * scale + bias (+ PReLU)`` with f32
accumulation and the f32 epilogue rounding once, at the cast to
``x.dtype``. B1 also has an f32 form (``out_dtype=torch.float32``) for a
row-split tensor-parallel shard: ``X @ decode(W) * scale`` in f32, no bias,
no cast, which the ranks sum before the bias and the cast. B2 and B3 run B1's 16-deep MMA chunks in B1's order, minus the
chunks of empty tiles, so the three agree bit for bit on the card. The
plain versions decode to f32 and multiply in f32; they serve CPU tensors
and the comparisons, never a CUDA tensor on a kernel row. A ``meta``
tensor (the dry run's trace, which takes the card's dispatch) gets the
kernel's output through the plain version, and no launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import formats
from repro_torch.kernels import build, ref

__all__ = ["ternary_gemm_ref", "ternary_gemm_cuda", "ternary_gemm_skip_ref",
           "ternary_gemm_skip_cuda", "TILES", "BLOCK_K", "SKIP_BLOCK_M",
           "skip_block_n"]

# B1's tiles, (block_m, block_n) -> (warps_m, warps_n, stages): the
# B1_TILES table of csrc/ternary_gemm.cu, every one stepping K by 64. The
# block-shape tuner (autotune.py) picks one per (M, K, N, phase): 16-row
# tiles for decode GEMVs, 32-row ones for windows and prefills up to M
# ~512, 64-row ones above. No tile moves a bit of the output.
TILES = {(16, 64): (1, 4, 8), (16, 128): (1, 4, 8), (32, 64): (1, 4, 6),
         (32, 128): (1, 4, 6), (64, 64): (1, 4, 4), (64, 128): (1, 4, 4)}
BLOCK_K = 64
# rows per block of B2/B3 (the tuner's block_m); their block_n is the
# largest of 128, 64, 32, 16 dividing the pack's tile_n (skip_block_n), at
# most 64 at 16 rows (B1's 16 x 64 decode tile)
SKIP_BLOCK_M = (16, 32, 64)


def skip_block_n(tile_n: int, widest: int = 128) -> int:
    """Columns per block of B2/B3 for a pack's ``tile_n``: each block
    stays inside one N-tile, so its width divides ``tile_n``; at most
    ``widest``."""
    for bn in (128, 64, 32, 16):
        if bn <= widest and tile_n % bn == 0:
            return bn
    raise ValueError(f"tile_n must be a positive multiple of 16, got "
                     f"{tile_n}")


def ternary_gemm_ref(x: torch.Tensor, words: torch.Tensor,
                     scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None, *,
                     fuse_prelu: bool = False,
                     prelu_alpha: float = 0.25,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version: x (M, K), words (>= ceil(K/16), N) int32 -> (M, N) in
    x.dtype. Decode to f32, f32 matmul, f32 epilogue, one cast.
    ``out_dtype=torch.float32`` is the f32 form's plain version: the scale
    alone, no bias, no PReLU, no cast."""
    if out_dtype == torch.float32:
        t = formats.decode_2bit(words, x.shape[1], torch.float32)
        return ref._epilogue(x.float() @ t, scale, None, None)
    return ref.packed2bit_matmul(x, words, x.shape[1], scale, bias,
                                 prelu_alpha if fuse_prelu else None)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ternary_gemm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ternary_gemm_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                      ctypes.c_float, i, i, p]
    lib.ternary_gemm_bf16.restype = ctypes.c_int
    lib.ternary_gemm_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.ternary_gemm_f32.restype = ctypes.c_int
    return lib


@functools.cache
def _skip_lib() -> ctypes.CDLL:
    lib = build.load("ternary_gemm_skip")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ternary_gemm_skip_bf16.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                           i, i, i, i, i, ctypes.c_float, i,
                                           i, i, p]
    lib.ternary_gemm_skip_bf16.restype = ctypes.c_int
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


def _check_x_words(name: str, x: torch.Tensor, words: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor; CPU tensors take the "
                         f"plain version")
    if x.dtype != torch.bfloat16 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D bfloat16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if (words.device != x.device or words.dtype != torch.int32
            or words.ndim != 2 or not words.is_contiguous()):
        raise ValueError(f"words must be a contiguous 2-D int32 tensor on "
                         f"{x.device}, got {words.dtype} "
                         f"{tuple(words.shape)} on {words.device}")
    if words.shape[0] * formats.K_PER_WORD < x.shape[1]:
        raise ValueError(f"words cover K={words.shape[0] * formats.K_PER_WORD}"
                         f" < x's K={x.shape[1]}")


def ternary_gemm_cuda(x: torch.Tensor, words: torch.Tensor,
                      scale: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None, *,
                      n: Optional[int] = None, fuse_prelu: bool = False,
                      prelu_alpha: float = 0.25, block_m: int = 64,
                      block_n: int = 128,
                      out_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """Launch B1 on the current stream. x (M, K) bf16 and words
    (>= ceil(K/16), ldw) int32 must be contiguous CUDA tensors on one
    device; the output has the first ``n`` (default ldw) word columns, so a
    tile-padded pack runs without a copy. scale/bias, when given, (n,)
    float32. ``(block_m, block_n)`` is one of ``TILES``. Returns (M, n)
    bf16, or with ``out_dtype=torch.float32`` the f32 form (scale only: a
    bias or PReLU raises). Raises on anything the kernel does not take (a
    tile that is not built included), and on a failed launch."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got "
                         f"{out_dtype}")
    f32 = out_dtype == torch.float32
    if f32 and (bias is not None or fuse_prelu):
        raise ValueError("B1's f32 form applies the scale alone: the bias "
                         "(and PReLU) follow the ranks' all-reduce")
    if x.is_meta:
        return ternary_gemm_ref(x, words[:, :n], scale, bias,
                                fuse_prelu=fuse_prelu,
                                prelu_alpha=prelu_alpha, out_dtype=out_dtype)
    _check_x_words("ternary_gemm_cuda", x, words)
    m, k = x.shape
    kw, ldw = words.shape
    n = ldw if n is None else n
    if not 0 <= n <= ldw:
        raise ValueError(f"n={n} outside the words' {ldw} columns")
    if (block_m, block_n) not in TILES:
        raise ValueError(f"(block_m, block_n)=({block_m}, {block_n}) is not "
                         f"one of B1's tiles {sorted(TILES)}")
    _check_vec("scale", scale, n, x.device)
    _check_vec("bias", bias, n, x.device)
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if f32:
            err = _lib().ternary_gemm_f32(
                x.data_ptr(), words.data_ptr(), _ptr(scale), y.data_ptr(), m,
                k, n, kw, ldw, block_m, block_n, stream)
        else:
            err = _lib().ternary_gemm_bf16(
                x.data_ptr(), words.data_ptr(), _ptr(scale), _ptr(bias),
                y.data_ptr(), m, k, n, kw, ldw, int(fuse_prelu), prelu_alpha,
                block_m, block_n, stream)
    if err != 0:
        raise RuntimeError(f"ternary_gemm kernel launch failed: "
                           f"cudaError {err}")
    ternary_gemm_cuda.launches += 1
    return y


ternary_gemm_cuda.launches = 0


def ternary_gemm_skip_ref(x: torch.Tensor, words: torch.Tensor,
                          kt_indices: torch.Tensor, kt_counts: torch.Tensor,
                          scale: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None, *, n: int,
                          tile_k: int, tile_n: int, fuse_prelu: bool = False,
                          prelu_alpha: float = 0.25) -> torch.Tensor:
    """Plain version of B2/B3: x (M, K); words (Kp/16, Np) int32 of a
    tile-padded pack; for N-tile j, multiply only the decoded tiles
    ``kt_indices[j, :kt_counts[j]]`` into its columns (a wrong occupancy
    list gives a wrong answer here too). f32 matmuls and epilogue, one
    cast; the first ``n`` columns."""
    m, k = x.shape
    kp = words.shape[0] * formats.K_PER_WORD
    xf = torch.zeros((m, kp), dtype=torch.float32, device=x.device)
    xf[:, :k] = x.float()
    y = torch.zeros((m, words.shape[1]), dtype=torch.float32, device=x.device)
    tkw = tile_k // formats.K_PER_WORD
    for j, (row, cnt) in enumerate(zip(kt_indices.tolist(),
                                       kt_counts.tolist())):
        cols = slice(j * tile_n, (j + 1) * tile_n)
        for kt in row[:cnt]:
            t = formats.decode_2bit(words[kt * tkw:(kt + 1) * tkw, cols],
                                    tile_k, torch.float32)
            y[:, cols] += xf[:, kt * tile_k:(kt + 1) * tile_k] @ t
    return ref._epilogue(y[:, :n], scale, bias,
                         prelu_alpha if fuse_prelu else None).to(x.dtype)


def ternary_gemm_skip_cuda(x: torch.Tensor, words: torch.Tensor,
                           kt_indices: torch.Tensor, kt_counts: torch.Tensor,
                           scale: Optional[torch.Tensor] = None,
                           bias: Optional[torch.Tensor] = None, *, n: int,
                           tile_k: int, tile_n: int, fuse_prelu: bool = False,
                           prelu_alpha: float = 0.25, block_m: int = 64,
                           db: bool = False) -> torch.Tensor:
    """Launch B2 (``db=False``) or B3 (``db=True``) on the current stream.
    x (M, K) bf16, words (Kp/16, Np) int32 of a pack with (tile_k, tile_n)
    tiles (multiples of 16), kt_indices (Np/tile_n, max_occ) and kt_counts
    (Np/tile_n,) int32, all contiguous on one CUDA device; scale/bias (n,)
    float32. ``block_m`` is one of ``SKIP_BLOCK_M``. Returns (M, n) bf16. Raises on
    anything the kernel does not take, and on a failed launch. Launches
    are counted in ``.launches`` (B2) and ``.launches_db`` (B3). A meta
    tensor's output comes through B1's plain version (the skip walk's
    plain version reads the occupancy lists' values)."""
    if x.is_meta:
        return ternary_gemm_ref(x, words[:, :n], scale, bias,
                                fuse_prelu=fuse_prelu,
                                prelu_alpha=prelu_alpha)
    _check_x_words("ternary_gemm_skip_cuda", x, words)
    m, k = x.shape
    kw, ldw = words.shape
    if (tile_k <= 0 or tile_k % formats.K_PER_WORD or tile_n <= 0
            or tile_n % 16):
        raise ValueError(f"tile_k and tile_n must be positive multiples of "
                         f"16, got ({tile_k}, {tile_n})")
    if (kw * formats.K_PER_WORD) % tile_k or ldw % tile_n:
        raise ValueError(f"words {tuple(words.shape)} are not padded to "
                         f"whole ({tile_k}, {tile_n}) tiles")
    if not 0 <= n <= ldw:
        raise ValueError(f"n={n} outside the words' {ldw} columns")
    n_ntiles = ldw // tile_n
    for name, t, ndim in (("kt_indices", kt_indices, 2),
                          ("kt_counts", kt_counts, 1)):
        if (t.device != x.device or t.dtype != torch.int32 or t.ndim != ndim
                or t.shape[0] != n_ntiles or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {ndim}-D int32 "
                             f"tensor with {n_ntiles} rows on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if block_m not in SKIP_BLOCK_M:
        raise ValueError(f"block_m must be one of {SKIP_BLOCK_M}, got "
                         f"{block_m}")
    _check_vec("scale", scale, n, x.device)
    _check_vec("bias", bias, n, x.device)
    bn = skip_block_n(tile_n, 64 if block_m == 16 else 128)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0 or n == 0:
        return y
    with torch.cuda.device(x.device):
        err = _skip_lib().ternary_gemm_skip_bf16(
            x.data_ptr(), words.data_ptr(), kt_indices.data_ptr(),
            kt_counts.data_ptr(), _ptr(scale), _ptr(bias), y.data_ptr(), m, k,
            n, kw, ldw, tile_k, tile_n, kt_indices.shape[1], int(fuse_prelu),
            prelu_alpha, block_m, bn, int(db),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ternary_gemm_skip kernel launch failed: "
                           f"cudaError {err}")
    if db:
        ternary_gemm_skip_cuda.launches_db += 1
    else:
        ternary_gemm_skip_cuda.launches += 1
    return y


ternary_gemm_skip_cuda.launches = 0
ternary_gemm_skip_cuda.launches_db = 0
