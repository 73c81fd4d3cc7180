"""Ternary-weight containers of the port: plain dataclasses of tensors.

Only ``Dense2Bit`` (16 weights per 32-bit word, the format of both
hand-written kernels) is ported so far. It keeps ``repro``'s
fields (``packed``, ``scale``, ``bias``, ``shape``, ``nnz``); packing
accepts stacked leading dims, while the ops take one 2-D matrix.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import formats, quantize

__all__ = ["Dense2Bit", "ternarize_stacked", "pack"]


@dataclasses.dataclass(frozen=True, eq=False)
class Dense2Bit:
    packed: torch.Tensor              # (..., ceil(K/16), N) int32 words
    scale: Optional[torch.Tensor]     # (..., N) f32 or None
    bias: Optional[torch.Tensor]      # (..., N) f32 or None
    shape: Tuple[int, int]            # logical (K, N)
    nnz: int = -1

    @property
    def k(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @classmethod
    def from_dense(cls, t: torch.Tensor, scale=None, bias=None) -> "Dense2Bit":
        """Pack a {-1, 0, +1} (..., K, N) tensor on its own device. ``nnz``
        is the mean per-matrix count, as in ``repro``."""
        n_stack = max(math.prod(t.shape[:-2]), 1)
        return cls(packed=formats.pack_2bit(t), scale=scale, bias=bias,
                   shape=tuple(t.shape[-2:]),
                   nnz=int(round(int(torch.count_nonzero(t)) / n_stack)))

    @classmethod
    def from_packed(cls, packed: torch.Tensor, k: int, scale=None, bias=None,
                    nnz: int = -1) -> "Dense2Bit":
        """Wrap existing int32 words; ``k`` is the logical K (the words may
        cover more)."""
        kw, n = packed.shape[-2:]
        if kw * formats.K_PER_WORD < k:
            raise ValueError(f"packed words cover K={kw * formats.K_PER_WORD}"
                             f" < logical k={k}")
        return cls(packed=packed, scale=scale, bias=bias, shape=(k, n),
                   nnz=nnz)

    def materialize(self, dtype=torch.float32,
                    with_scale: bool = False) -> torch.Tensor:
        t = formats.decode_2bit(self.packed, self.k, dtype)[..., :self.n]
        if with_scale and self.scale is not None:
            t = t * self.scale.to(dtype).unsqueeze(-2)
        return t

    def to(self, device) -> "Dense2Bit":
        def move(v):
            return None if v is None else v.to(device)
        return dataclasses.replace(self, packed=move(self.packed),
                                   scale=move(self.scale),
                                   bias=move(self.bias))


def ternarize_stacked(w: torch.Tensor, threshold: float = 0.7):
    """(..., K, N) float -> ((..., K, N) int8 ternary, (..., N) f32 scales),
    one TWN ternarization per matrix."""
    t, alpha = quantize.ternarize(w, threshold)
    return t, alpha.squeeze(-2)


def pack(w: torch.Tensor, format: str = "dense2bit", *, scale=None,
         bias=None, threshold: float = 0.7) -> Dense2Bit:
    """Pack a weight into a ternary container. A float ``w`` is first
    ternarized per matrix and its per-channel scale becomes the container's
    ``scale`` unless one is passed; an integer ``w`` is taken as already
    ternary."""
    if format != "dense2bit":
        raise ValueError(f"format {format!r} is not ported yet; the port "
                         f"packs 'dense2bit' only")
    if w.is_floating_point():
        t, scales = ternarize_stacked(w, threshold)
        if scale is None:
            scale = scales
    else:
        t = w
    return Dense2Bit.from_dense(t, scale=scale, bias=bias)
