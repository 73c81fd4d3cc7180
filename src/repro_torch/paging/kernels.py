"""Paged decode attention: the wrapper of the hand-written CUDA kernel
(``kernels/csrc/paged_attention.cu``, which replaces ``repro``'s
``paged_decode_attention_pallas``) and its plain PyTorch version.

One query token per row attends that row's sequence, read through a block
table (``block_table[b, t]`` is the page id of the t-th page of row
``b``) and masked by ``lengths`` (valid tokens, the current one included)
and an optional sliding window. GQA: the ``H`` query heads split into
``KV`` groups. Pages are bf16 (or f32 on the CPU) tensors
``(P, ps, KV, hd)`` or ``Int8Pages``, dequantized to ``q.dtype``.

The kernel splits each row's valid tokens over a thread-block cluster of
``split_plan(T, ps, window).splits`` blocks: a function of the table width,
the page size and the window alone, so a row's bits never depend on the
batch or the other rows' lengths, and the host never reads ``lengths``.

The plain version is the gather plus the port's ``naive_attention``, the
same lines the dense decode runs, so a paged step does the dense step's
math over the gathered view. Both register in ``ops``' paged-attention
registry as ``repro``'s lowerings do: the kernel as ``"pallas"``
(priority 20, admitted when q lies on the card; on a CPU tensor it runs
the plain version) and the plain version as ``"jax"`` (priority 10). It
serves CPU tensors and the comparisons, and meets a CUDA tensor on the
serving path only when ``"jax"`` is named (``cfg.paged_attn_impl``, the
engine's ``paged_attn=``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ops import register_paged_attn
from repro_torch.models.attention import naive_attention
from repro_torch.paging.quant import Int8Pages, dequantize_rows

__all__ = ["paged_decode_attention_ref", "paged_decode_attention_cuda",
           "gather_pages", "split_plan", "launch_plan", "smem_bytes",
           "SplitPlan"]

Pages = Union[torch.Tensor, Int8Pages]

MAX_SPLITS = 4                  # blocks of a cluster (csrc: MAX_SPLITS)
SPLIT_TOKENS = 32               # fewest tokens a split is planned for
CHUNK_TOKENS = 64               # K or V rows of one stage of the ring
RING = 4                        # stages of a block's K/V ring


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


@register_paged_attn("jax", priority=10)
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
        p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i,
        i, i, i, i, p]
    lib.paged_decode_attention_bf16.restype = ctypes.c_int
    lib.paged_attention_smem_bytes.argtypes = [i] * 7
    lib.paged_attention_smem_bytes.restype = ctypes.c_int
    lib.paged_attention_smem_limit.argtypes = [i]
    lib.paged_attention_smem_limit.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ', not contiguous'}")


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the kernel splits a row: ``splits`` blocks (one cluster) per
    (row, kv head), each holding at most ``tokens`` of the row's valid
    tokens and reading their K, then their V, ``chunk`` rows at a time
    through a ring of ``buffers`` stages (``tokens`` and ``chunk``
    multiples of 4)."""
    splits: int
    tokens: int
    chunk: int
    buffers: int


@functools.cache
def split_plan(table_width: int, page_size: int,
               window: int = 0) -> SplitPlan:
    """The split of every row of a launch, from the most tokens a row can
    attend (``table_width * page_size``, or the window when it is
    shorter) alone: a split per ``SPLIT_TOKENS`` of them, at most
    ``MAX_SPLITS``. Never from the batch, the lengths or the card."""
    span = table_width * page_size
    if window > 0:
        span = min(span, window)
    splits = max(1, min(MAX_SPLITS, -(-span // SPLIT_TOKENS)))
    tokens = max(4, -(-span // (4 * splits)) * 4)      # a multiple of 4
    chunk = min(CHUNK_TOKENS, tokens)
    return SplitPlan(splits, tokens, chunk,
                     min(RING, 2 * -(-tokens // chunk)))


@functools.cache
def smem_bytes(group: int, head_dim: int, table_width: int,
               page_size: int, *, quant: bool = False,
               window: int = 0) -> int:
    """Dynamic shared memory of one block of a launch with these widths,
    as the kernel lays it out (csrc/paged_attention.cu ``layout``, asked
    through its library, so the card's build must be at hand)."""
    plan = split_plan(table_width, page_size, window)
    return _lib().paged_attention_smem_bytes(
        group, head_dim, page_size, plan.tokens, plan.chunk, plan.buffers,
        int(quant))


@functools.cache
def _smem_limit(device_index: int) -> int:
    """The most dynamic shared memory a block may take on that card."""
    limit = _lib().paged_attention_smem_limit(device_index)
    if limit < 0:
        raise RuntimeError(f"cannot read the shared-memory limit of "
                           f"cuda:{device_index}")
    return limit


def launch_plan(heads: int, kv_heads: int, head_dim: int, table_width: int,
                page_size: int, *, window: int = 0,
                quant: bool = False) -> SplitPlan:
    """The kernel's split of a launch with these widths, after the checks
    that need no tensor and no card: raises ``ValueError`` on a geometry
    the kernel does not take (heads that do not split into kv heads, hd
    not a multiple of 8 with bf16 pages or of 16 with int8 codes, whose
    rows the kernel copies 16 bytes at a time, a negative window). Whether
    a block's share fits in shared memory the wrapper asks the kernel's
    library (``smem_bytes``)."""
    if kv_heads < 1 or heads % kv_heads:
        raise ValueError(f"{heads} query heads do not split into "
                         f"{kv_heads} kv heads")
    align = 16 if quant else 8
    if head_dim < align or head_dim % align:
        raise ValueError(f"head_dim must be a positive multiple of {align} "
                         f"with {'int8' if quant else 'bf16'} pages (the "
                         f"kernel's 16-byte copies of a row), got "
                         f"{head_dim}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return split_plan(table_width, page_size, window)


def paged_decode_attention_cuda(q: torch.Tensor, k_pages: Pages,
                                v_pages: Pages, block_table: torch.Tensor,
                                lengths: torch.Tensor, *,
                                window: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. q (B, H, hd) bf16,
    hd a multiple of 8 (of 16 with int8 pages); pages bf16 (P, ps, KV, hd) or ``Int8Pages``
    (int8 codes of that shape, f32 scales (P, ps, KV)), K and V of one
    kind; block_table (B, T) and lengths (B,) int32; all contiguous on q's
    device, the pages 16-byte aligned. Every ``lengths[b]`` must lie in
    [1, T*ps] and the table entries a row reads (those holding its valid
    positions) in [0, P); the kernel writes NaN for a row that breaks
    either. Returns (B, H, hd) bf16. Raises on anything the kernel does
    not take, and on a failed launch."""
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
    if quant:
        for name, pg in (("k_pages", k_pages), ("v_pages", v_pages)):
            _check(f"{name}.codes", pg.codes, torch.int8, geom, dev)
            _check(f"{name}.scales", pg.scales, torch.float32, geom[:3], dev)
        args = (k_pages.codes, k_pages.scales, v_pages.codes, v_pages.scales)
    else:
        _check("k_pages", k_pages, torch.bfloat16, geom, dev)
        _check("v_pages", v_pages, torch.bfloat16, geom, dev)
        args = (k_pages, None, v_pages, None)
    if any(a is not None and a.data_ptr() % 16 for a in args[::2]):
        raise ValueError("the pages must start 16-byte aligned")
    if block_table.ndim != 2 or block_table.shape[0] != b:
        raise ValueError(f"block_table must be ({b}, T), got "
                         f"{tuple(block_table.shape)}")
    t = block_table.shape[1]
    _check("block_table", block_table, torch.int32, (b, t), dev)
    _check("lengths", lengths, torch.int32, (b,), dev)
    plan = launch_plan(h, kv, hd, t, ps, window=window, quant=quant)
    smem = smem_bytes(h // kv, hd, t, ps, quant=quant, window=window)
    limit = _smem_limit(dev.index)
    if smem > limit:
        raise ValueError(f"a row of {t * ps} tokens over {h // kv} query "
                         f"heads needs {smem} bytes of shared memory a "
                         f"block, more than the {limit} a block has")
    out = torch.empty((b, h, hd), dtype=torch.bfloat16, device=dev)
    if b == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib().paged_decode_attention_bf16(
            q.data_ptr(), *(None if a is None else a.data_ptr()
                            for a in args),
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, h, kv, hd, ps, t, n_pages, window, 1.0 / math.sqrt(hd),
            int(quant), plan.splits, plan.tokens, plan.chunk, plan.buffers,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cudaError {err}")
    paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0


@register_paged_attn("pallas", priority=20,
                     predicate=lambda q, *a, **k: q.is_cuda)
def _paged_pallas(q: torch.Tensor, k_pages: Pages, v_pages: Pages,
                  block_table: torch.Tensor, lengths: torch.Tensor, *,
                  window: int = 0) -> torch.Tensor:
    """The ``"pallas"`` row: the kernel on a CUDA tensor, its plain version
    on a CPU tensor."""
    if q.is_cuda:
        return paged_decode_attention_cuda(q.contiguous(), k_pages, v_pages,
                                           block_table, lengths,
                                           window=window)
    return paged_decode_attention_ref(q, k_pages, v_pages, block_table,
                                      lengths, window=window)
