"""Paged decode attention: the wrapper of the hand-written CUDA kernel
(``kernels/csrc/paged_attention.cu``, which replaces ``repro``'s
``paged_decode_attention_pallas``) and its plain PyTorch version.

One query token per row attends that row's sequence, read through a block
table (``block_table[b, t]`` is the page id of the t-th page of row
``b``) and masked by ``lengths`` (valid tokens, the current one included)
and an optional sliding window. GQA: the ``H`` query heads split into
``KV`` groups. Pages are bf16 (or f32 on the CPU) tensors
``(P, ps, KV, hd)`` or ``Int8Pages``, dequantized to ``q.dtype``.

The plain version is the gather plus the port's ``naive_attention``, the
same lines the dense decode runs, so on the CPU a paged step does the
dense step's math over the gathered view. It serves CPU tensors and the
comparisons, never a CUDA tensor on the serving path.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Union

import torch

from repro_torch.kernels import build
from repro_torch.models.attention import naive_attention
from repro_torch.paging.quant import Int8Pages, dequantize_rows

__all__ = ["paged_decode_attention_ref", "paged_decode_attention_cuda",
           "gather_pages", "MAX_SMEM_BYTES", "THREADS"]

Pages = Union[torch.Tensor, Int8Pages]

MAX_SMEM_BYTES = 232448         # the H100's per-block shared-memory limit
THREADS = 256                   # threads per block (csrc/paged_attention.cu)


def gather_pages(pages: Pages, block_table: torch.Tensor,
                 dtype) -> torch.Tensor:
    """(B, T) block table -> (B, T*ps, KV, hd) gathered sequence view.
    int8 pages dequantize to ``dtype``; raw pages keep their dtype."""
    if isinstance(pages, Int8Pages):
        seq = dequantize_rows(pages.codes[block_table],
                              pages.scales[block_table], dtype)
    else:
        seq = pages[block_table]
    b, t, ps, kv, hd = seq.shape
    return seq.reshape(b, t * ps, kv, hd)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: Pages,
                               v_pages: Pages, block_table: torch.Tensor,
                               lengths: torch.Tensor, *,
                               window: int = 0) -> torch.Tensor:
    """Plain version: q (B, H, hd) -> (B, H, hd) in q.dtype. Gathers every
    table entry (padding entries included; ``lengths`` masks them) and runs
    ``naive_attention`` as the dense decode does."""
    ks = gather_pages(k_pages, block_table, q.dtype)
    vs = gather_pages(v_pages, block_table, q.dtype)
    return naive_attention(q[:, None], ks, vs, causal=False, window=window,
                           q_offset=lengths - 1, kv_valid_len=lengths)[:, 0]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_decode_attention_bf16.argtypes = [
        p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float,
        i, p]
    lib.paged_decode_attention_bf16.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ', not contiguous'}")


def smem_bytes(group: int, head_dim: int, table_width: int,
               page_size: int) -> int:
    """Dynamic shared memory of one block: the group's q and scores, the
    PV partial sums and the warp scratch (f32), and its table row."""
    return 4 * (group * head_dim + group * table_width * page_size
                + THREADS + 32 + table_width)


def paged_decode_attention_cuda(q: torch.Tensor, k_pages: Pages,
                                v_pages: Pages, block_table: torch.Tensor,
                                lengths: torch.Tensor, *,
                                window: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. q (B, H, hd) bf16;
    pages bf16 (P, ps, KV, hd) or ``Int8Pages`` (int8 codes of that shape,
    f32 scales (P, ps, KV)), K and V of one kind; block_table (B, T) and
    lengths (B,) int32; all contiguous on q's device. Every ``lengths[b]``
    must lie in [1, T*ps] and the table entries a row reads (its first
    ceil(lengths[b]/ps)) in [0, P); the kernel writes NaN for a row that
    breaks either. Returns (B, H, hd) bf16. Raises on anything the kernel
    does not take, and on a failed launch."""
    if not q.is_cuda:
        raise ValueError("paged_decode_attention_cuda needs CUDA tensors; "
                         "CPU tensors take paged_decode_attention_ref")
    if q.dtype != torch.bfloat16 or q.ndim != 3 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous 3-D bfloat16 tensor, got "
                         f"{q.dtype} {tuple(q.shape)}")
    dev = q.device
    b, h, hd = q.shape
    quant = isinstance(k_pages, Int8Pages)
    if quant != isinstance(v_pages, Int8Pages):
        raise ValueError("k_pages and v_pages must both be Int8Pages or "
                         "both be tensors")
    geom = k_pages.shape
    if len(geom) != 4 or geom[3] != hd:
        raise ValueError(f"pages must be (P, ps, KV, {hd}), got {geom}")
    n_pages, ps, kv, _ = geom
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not split into {kv} kv heads")
    if quant:
        for name, pg in (("k_pages", k_pages), ("v_pages", v_pages)):
            _check(f"{name}.codes", pg.codes, torch.int8, geom, dev)
            _check(f"{name}.scales", pg.scales, torch.float32, geom[:3], dev)
        args = (k_pages.codes, k_pages.scales, v_pages.codes, v_pages.scales)
    else:
        _check("k_pages", k_pages, torch.bfloat16, geom, dev)
        _check("v_pages", v_pages, torch.bfloat16, geom, dev)
        args = (k_pages, None, v_pages, None)
    if block_table.ndim != 2 or block_table.shape[0] != b:
        raise ValueError(f"block_table must be ({b}, T), got "
                         f"{tuple(block_table.shape)}")
    t = block_table.shape[1]
    _check("block_table", block_table, torch.int32, (b, t), dev)
    _check("lengths", lengths, torch.int32, (b,), dev)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    group = h // kv
    smem = smem_bytes(group, hd, t, ps)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"a row of {t * ps} tokens over {group} query heads "
                         f"needs {smem} bytes of shared memory, more than "
                         f"the {MAX_SMEM_BYTES} a block has")
    out = torch.empty((b, h, hd), dtype=torch.bfloat16, device=dev)
    if b == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib().paged_decode_attention_bf16(
            q.data_ptr(), *(None if a is None else a.data_ptr()
                            for a in args),
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, h, kv, hd, ps, t, n_pages, window, smem,
            1.0 / math.sqrt(hd), int(quant),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cudaError {err}")
    paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0
