"""Flash attention over full sequences: the wrapper of the hand-written CUDA
kernel (``csrc/flash_attention.cu``, B6, which replaces ``repro``'s
``flash_attention_pallas``) and its plain PyTorch version.

Both take q (BH, Sq, hd) and k, v (BH, Skv, hd) (batch and heads
flattened; GQA callers repeat K/V first) and compute causal or full
softmax attention with f32 scores and statistics, the probabilities
rounded to ``v.dtype`` before the PV product and the output rounded once
to ``q.dtype``. Query and key positions both count from 0.

Like ``repro``'s Pallas kernel, this op has no gradient: ``repro`` gives
``flash_attention_pallas`` no VJP, and its training step attends with
``attn_impl="flash"`` (the differentiable blockwise version in
``models/attention.py``). Differentiating the output here raises
``NotImplementedError``; it neither detaches silently nor grows a backward
``repro`` lacks.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import build

__all__ = ["NEG_INF", "HEAD_DIMS", "BLOCK_M", "CONSUMER_WARPGROUPS",
           "THREADS", "BOX_COLS", "TILES", "FlashPlan", "launch_plan",
           "flash_attention", "flash_attention_ref", "flash_attention_cuda"]

NEG_INF = -1e30
HEAD_DIMS = (64, 128)           # the kernel's compiled head widths

# The launch of csrc/flash_attention.cu (its constants of the same names):
# 128 query rows a block, 64 to each of two consumer warpgroups, plus one
# producer warp; per head dim its FLASH_TILES entry (K/V tile, ring
# stages, blocks an SM), copied in boxes of 64 columns (128-byte rows).
BLOCK_M = 128
CONSUMER_WARPGROUPS = 2
THREADS = (CONSUMER_WARPGROUPS * 4 + 1) * 32
BOX_COLS = 64
# hd -> (keys a tile, stages, blocks an SM)
TILES = {64: (64, 3, 2), 128: (128, 2, 1)}
MAX_GRID_Y = 65_535


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """One launch of B6: a (BH, query tiles) grid of ``threads``-thread
    blocks, ``block_m`` query rows and ``block_n``-key K/V tiles through a
    ring of ``stages``, ``smem_bytes`` of dynamic shared memory each."""

    hd: int
    sq: int
    skv: int
    causal: bool
    block_m: int
    block_n: int
    stages: int
    blocks_per_sm: int
    grid: Tuple[int, int]
    threads: int
    smem_bytes: int

    def q_tile(self, block_y: int) -> int:
        """First query row of the tile that blocks ``(*, block_y)`` run:
        the last tile first (the kernel's heavy-first order)."""
        return (self.grid[1] - 1 - block_y) * self.block_m

    def kv_tiles(self, block_y: int) -> int:
        """K/V tiles the block loads: causal tiles stop at the tile's last
        row."""
        q0 = self.q_tile(block_y)
        end = min(self.skv, q0 + self.block_m) if self.causal else self.skv
        return -(-end // self.block_n)


def launch_plan(bh: int, sq: int, skv: int, hd: int,
                causal: bool) -> FlashPlan:
    """The launch ``flash_attention_cuda`` makes for these shapes, with the
    head dim's ``TILES`` entry. Shared memory: the q tile, ``stages`` K and
    V tiles, 1 + 3 x stages barriers and 1024 bytes to align the base.
    Raises for a head dim the kernel was not built for."""
    if hd not in TILES:
        raise ValueError(f"head dim {hd} not one of the kernel's {HEAD_DIMS}")
    bn, stages, blocks = TILES[hd]
    smem = (BLOCK_M * hd * 2 + 2 * stages * bn * hd * 2
            + (1 + 3 * stages) * 8 + 1024)
    return FlashPlan(hd=hd, sq=sq, skv=skv, causal=bool(causal),
                     block_m=BLOCK_M, block_n=bn, stages=stages,
                     blocks_per_sm=blocks,
                     grid=(bh, -(-sq // BLOCK_M)), threads=THREADS,
                     smem_bytes=smem)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Plain version: the kernel's math over one KV block. ``s = q k^T /
    sqrt(hd)`` in f32, masked to ``k_pos < Skv`` (and ``q_pos >= k_pos``
    when causal) with ``NEG_INF``; ``p = exp(s - rowmax)``, ``l = sum p``
    in f32; ``o = (p in v.dtype) @ v`` in f32 over ``max(l, 1e-30)``."""
    sq, skv, hd = q.shape[1], k.shape[1], q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(hd))
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = k_pos < skv
    if causal:
        mask = mask & (q_pos >= k_pos)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    return (o / l.clamp_min(1e-30)).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bf16.argtypes = [p, p, p, p, i, i, i, i, i,
                                         ctypes.c_float, p]
    lib.flash_attention_bf16.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Launch B6 on the current stream as ``launch_plan`` says. q (BH, Sq,
    hd), k and v (BH, Skv, hd): contiguous, 16-byte aligned bfloat16 CUDA
    tensors on one device, hd in ``HEAD_DIMS``. Returns (BH, Sq, hd)
    bf16. Raises on anything the kernel does not take, and on a failed
    launch."""
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda needs CUDA tensors; CPU "
                         "tensors take flash_attention_ref")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != torch.bfloat16 or t.ndim != 3
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"3-D bfloat16 tensor on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    bh, sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not one of the kernel's {HEAD_DIMS}")
    skv = k.shape[1]
    o = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return o
    if skv == 0:
        raise ValueError("attention over an empty key sequence")
    plan = launch_plan(bh, sq, skv, hd, causal)
    if plan.grid[1] > MAX_GRID_Y:
        raise ValueError(f"{sq} query rows need {plan.grid[1]} query tiles, "
                         f"more than the grid's {MAX_GRID_Y}")
    _launch(q, k, v, o, plan)
    flash_attention_cuda.launches += 1
    return o


def _launch(q, k, v, o, plan: FlashPlan) -> None:
    """Launch the kernel on checked tensors as ``plan`` says; raises when
    the launch fails."""
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            plan.grid[0], plan.sq, plan.skv, plan.hd, int(plan.causal),
            1.0 / math.sqrt(plan.hd),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")


flash_attention_cuda.launches = 0


class _NoVjp(torch.autograd.Function):
    """Forward-only: the output joins the graph so that differentiating it
    raises instead of silently dropping the inputs' gradients."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.is_cuda:
            return flash_attention_cuda(q, k, v, causal=causal)
        return flash_attention_ref(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "flash_attention (B6) has no gradient: repro's Pallas flash "
            "kernel has no VJP, and training attends with "
            "attn_impl='flash' (the blockwise version in models/attention.py)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 512,
                    block_kv: int = 512) -> torch.Tensor:
    """q (BH, Sq, hd), k and v (BH, Skv, hd) -> (BH, Sq, hd) in q's dtype.
    A CUDA tensor launches B6 (or its wrapper raises), a CPU tensor takes
    the plain version. ``block_q``/``block_kv`` are ``repro``'s Pallas
    block sizes; they change no result, and the CUDA kernel keeps its own
    tiles (``launch_plan``)."""
    del block_q, block_kv
    return _NoVjp.apply(q, k, v, causal)
