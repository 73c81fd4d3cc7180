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
import functools
import math

import torch

from repro_torch.kernels import build

__all__ = ["NEG_INF", "HEAD_DIMS", "flash_attention",
           "flash_attention_ref", "flash_attention_cuda"]

NEG_INF = -1e30
HEAD_DIMS = (64, 128)           # the kernel's compiled head widths


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
    """Launch B6 on the current stream. q (BH, Sq, hd), k and v (BH, Skv,
    hd): contiguous, 16-byte aligned bfloat16 CUDA tensors on one device,
    hd in ``HEAD_DIMS``. Returns (BH, Sq, hd) bf16. Raises on anything the
    kernel does not take, and on a failed launch."""
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
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, sq,
            skv, hd, int(causal), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_cuda.launches += 1
    return o


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
    64 x 64 tiles."""
    del block_q, block_kv
    return _NoVjp.apply(q, k, v, causal)
