"""Public ops of the port: ``ternary_gemm``, ``fused_mlp`` and
``paged_decode_attention``, plus the serving-phase tag (``serving_phase``
/ ``current_phase``).

Dispatch is by the device the activations lie on: a CUDA tensor launches
the hand-written kernel (or the wrapper raises), a CPU tensor takes the
plain PyTorch version. Of ``repro``'s registry only the ``dense2bit`` rows
are ported so far. Tile shapes are fixed per serving phase (the kernels'
``VARIANTS``); outside a phase scope, M <= 16 counts as decode-shaped.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.core.weights import Dense2Bit
from repro_torch.kernels import fused_mlp as fused_lib
from repro_torch.kernels import ternary_gemm as gemm_lib

__all__ = ["ternary_gemm", "fused_mlp", "paged_decode_attention",
           "serving_phase", "current_phase", "SERVING_PHASES"]

SERVING_PHASES = ("prefill", "decode")

_SERVING_PHASE: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("repro_torch_serving_phase", default=None)


@contextlib.contextmanager
def serving_phase(phase: Optional[str]):
    """Tag the ternary ops called inside this scope with one of
    ``SERVING_PHASES``; the tag picks the kernels' tile shapes."""
    if phase is not None and phase not in SERVING_PHASES:
        raise ValueError(f"phase must be one of {SERVING_PHASES}, got "
                         f"{phase!r}")
    token = _SERVING_PHASE.set(phase)
    try:
        yield
    finally:
        _SERVING_PHASE.reset(token)


def current_phase() -> Optional[str]:
    return _SERVING_PHASE.get()


def _phase(m: int) -> str:
    phase = current_phase()
    if phase is None:
        phase = "decode" if m <= 16 else "prefill"
    return phase


def _container(w, what: str) -> Dense2Bit:
    if not isinstance(w, Dense2Bit):
        raise TypeError(f"{what} must be a Dense2Bit container (the only "
                        f"format ported so far), got {type(w).__name__}")
    if w.packed.ndim != 2:
        raise ValueError(f"{what} has stacked words {tuple(w.packed.shape)};"
                         f" pass one layer's 2-D words")
    return w


def ternary_gemm(x: torch.Tensor, w: Dense2Bit,
                 scale: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None, *,
                 fuse_prelu: bool = False,
                 prelu_alpha: float = 0.25) -> torch.Tensor:
    """Y = X @ decode(w) * scale + bias (+PReLU) for x (M, K). ``scale`` and
    ``bias`` default to the container's own."""
    w = _container(w, "w")
    if x.ndim != 2 or x.shape[1] != w.k:
        raise ValueError(f"x {tuple(x.shape)} does not match the weight's "
                         f"logical K={w.k} (shape {w.shape})")
    scale = w.scale if scale is None else scale
    bias = w.bias if bias is None else bias
    if x.is_cuda:
        return gemm_lib.ternary_gemm_cuda(
            x.contiguous(), w.packed, scale, bias, fuse_prelu=fuse_prelu,
            prelu_alpha=prelu_alpha,
            variant=gemm_lib.VARIANTS[_phase(x.shape[0])])
    return gemm_lib.ternary_gemm_ref(x, w.packed, scale, bias,
                                     fuse_prelu=fuse_prelu,
                                     prelu_alpha=prelu_alpha)


def fused_mlp(x: torch.Tensor, w_in: Dense2Bit, w_out: Dense2Bit,
              w_gate: Optional[Dense2Bit] = None, *,
              activation: str = "silu") -> torch.Tensor:
    """Fused ternary MLP block ``act(x @ Wg) * (x @ Wi) @ Wo`` (gate
    optional), each projection's scale and bias from its container."""
    w_in = _container(w_in, "w_in")
    w_out = _container(w_out, "w_out")
    if w_gate is not None:
        w_gate = _container(w_gate, "w_gate")
        if w_gate.shape != w_in.shape:
            raise ValueError(f"gate shape {w_gate.shape} must match the up "
                             f"projection's {w_in.shape}")
    if w_out.k != w_in.n:
        raise ValueError(f"down projection expects K={w_in.n} (the up "
                         f"projection's N) but encodes K={w_out.k}")
    if x.ndim != 2 or x.shape[1] != w_in.k:
        raise ValueError(f"x {tuple(x.shape)} does not match the up "
                         f"projection's K={w_in.k}")
    g = w_gate
    args = (x.contiguous(), w_in.packed, w_out.packed,
            None if g is None else g.packed, w_in.scale, w_in.bias,
            None if g is None else g.scale, None if g is None else g.bias,
            w_out.scale, w_out.bias)
    if x.is_cuda:
        variant, ff_chunk = fused_lib.VARIANTS[_phase(x.shape[0])]
        return fused_lib.fused_mlp_cuda(*args, activation=activation,
                                        variant=variant, ff_chunk=ff_chunk)
    return fused_lib.fused_mlp_ref(*args, activation=activation)


def paged_decode_attention(q: torch.Tensor, k_pages, v_pages,
                           block_table: torch.Tensor, lengths: torch.Tensor,
                           *, window: int = 0) -> torch.Tensor:
    """Decode attention over block-table-indexed KV pages: q (B, H, hd);
    k_pages/v_pages (P, ps, KV, hd) tensors or ``paging.Int8Pages``;
    block_table (B, T) int32; lengths (B,) int32 valid-token counts (the
    current token included). Returns (B, H, hd) in q's dtype."""
    # imported here: repro_torch.paging imports the models, which import
    # this module
    from repro_torch.paging import kernels as paged_lib
    if q.is_cuda:
        return paged_lib.paged_decode_attention_cuda(
            q.contiguous(), k_pages, v_pages, block_table, lengths,
            window=window)
    return paged_lib.paged_decode_attention_ref(q, k_pages, v_pages,
                                                block_table, lengths,
                                                window=window)
