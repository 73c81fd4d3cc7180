"""Ternary-weight containers of the port: plain dataclasses of tensors, one
per storage format, registered by name in ``FORMATS`` (the port's copy of
``repro.core.weights``).

* ``Dense2Bit`` -- 2-bit codes, 16 weights per word (B1 and B4). Packing
  accepts stacked leading dims; the ops take one 2-D matrix.
* ``Tiled``     -- 2-bit codes + per-(K-tile, N-tile) occupancy (B2, B3).
* ``Bitplane``  -- plus/minus uint8 bit masks (B7).
* ``Base3``     -- 5 trits per byte (plain version only, as in ``repro``).

Every field a planner reads (logical shape, tile shapes, ``nnz``,
``occupied_tiles``) is a host-side Python int recorded at pack time, so
planning never reads a device tensor. Uniform interface::

    wc = weights.pack(w, "tiled", tile_k=256)   # float or ternary in
    wc.shape, wc.k, wc.n          # logical (K, N)
    wc.occupancy()                # nnz / tile-occupancy fraction
    wc.nbytes                     # payload bytes
    wc.materialize(torch.float32) # decoded {-1, 0, +1} matrix
    kernels.ops.ternary_gemm(x, wc)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Type

import torch

from repro_torch.core import formats, quantize

__all__ = ["TernaryWeight", "Dense2Bit", "Tiled", "Bitplane", "Base3",
           "FORMATS", "register_format", "ternarize_stacked", "pack"]

# name -> container class; the one place a new layout registers
FORMATS: Dict[str, Type["TernaryWeight"]] = {}


def register_format(name: str):
    """Class decorator: register a ``TernaryWeight`` subclass under
    ``name``. Its array fields are listed in ``_leaves``."""

    def deco(cls):
        cls.format_name = name
        FORMATS[name] = cls
        return cls

    return deco


class TernaryWeight:
    """Base of the containers: frozen dataclasses whose ``_leaves`` are
    tensors and whose other fields are host-side metadata. All carry
    ``shape`` (logical (K, N)), ``nnz`` (pack-time nonzero count, -1 when
    unknown) and optional per-output-channel ``scale`` / ``bias`` that
    ``ternary_gemm`` uses when the caller passes none."""

    format_name = "abstract"
    _leaves: Tuple[str, ...] = ()

    @property
    def k(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nbytes(self) -> int:
        """Payload bytes over the tensor fields (codes, metadata, scale,
        bias)."""
        return sum(v.numel() * v.element_size() for v in
                   (getattr(self, f) for f in self._leaves) if v is not None)

    def occupancy(self) -> float:
        """Nonzero fraction recorded at pack time (1.0 when unknown).
        ``Tiled`` overrides it with the occupied-tile fraction."""
        if self.nnz < 0:
            return 1.0
        return self.nnz / max(self.k * self.n, 1)

    def materialize(self, dtype=torch.float32,
                    with_scale: bool = False) -> torch.Tensor:
        """The decoded {-1, 0, +1} (K, N) matrix; ``with_scale`` multiplies
        the per-channel scale in."""
        raise NotImplementedError

    def to(self, device) -> "TernaryWeight":
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in self._leaves
            if getattr(self, f) is not None})

    def _apply_scale(self, t: torch.Tensor, with_scale: bool, dtype):
        if with_scale and self.scale is not None:
            t = t * self.scale.to(dtype).unsqueeze(-2)
        return t

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(shape={self.shape}, nnz={self.nnz}, "
                f"nbytes={self.nbytes})")


@register_format("dense2bit")
@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class Dense2Bit(TernaryWeight):
    packed: torch.Tensor              # (..., ceil(K/16), N) int32 words
    scale: Optional[torch.Tensor]     # (..., N) f32 or None
    bias: Optional[torch.Tensor]      # (..., N) f32 or None
    shape: Tuple[int, int]            # logical (K, N)
    nnz: int = -1

    _leaves = ("packed", "scale", "bias")

    @classmethod
    def from_dense(cls, t: torch.Tensor, scale=None, bias=None) -> "Dense2Bit":
        """Pack a {-1, 0, +1} (..., K, N) tensor on its own device. ``nnz``
        is the mean per-matrix count, as in ``repro``."""
        t = formats._as_tensor(t)
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
        return self._apply_scale(t, with_scale, dtype)


@register_format("tiled")
@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class Tiled(TernaryWeight):
    packed: torch.Tensor              # (Kp/16, Np) int32 (K/N tile-padded)
    kt_indices: torch.Tensor          # (n_ntiles, max_occ) int32
    kt_counts: torch.Tensor           # (n_ntiles,) int32
    scale: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    shape: Tuple[int, int]            # logical (K, N)
    tile_k: int = 256
    tile_n: int = 128
    nnz: int = -1
    occupied_tiles: int = 0           # pack-time occupied-tile count

    _leaves = ("packed", "kt_indices", "kt_counts", "scale", "bias")

    @classmethod
    def from_tiled(cls, tt: formats.TiledTernary, scale=None,
                   bias=None) -> "Tiled":
        return cls(packed=tt.packed, kt_indices=tt.kt_indices,
                   kt_counts=tt.kt_counts, scale=scale, bias=bias,
                   shape=tt.shape, tile_k=tt.tile_k, tile_n=tt.tile_n,
                   nnz=int(tt.tile_nnz.sum()),
                   occupied_tiles=tt.occupied_tiles())

    @classmethod
    def from_dense(cls, t, scale=None, bias=None, tile_k: int = 256,
                   tile_n: int = 128) -> "Tiled":
        tt = formats.TiledTernary.from_dense(t, tile_k=tile_k, tile_n=tile_n)
        return cls.from_tiled(tt, scale=scale, bias=bias)

    @property
    def n_ktiles(self) -> int:
        return self.packed.shape[-2] * formats.K_PER_WORD // self.tile_k

    @property
    def n_ntiles(self) -> int:
        return self.packed.shape[-1] // self.tile_n

    @property
    def max_occ(self) -> int:
        return self.kt_indices.shape[-1]

    def total_tiles(self) -> int:
        return self.n_ktiles * self.n_ntiles

    def visited_tiles(self) -> int:
        """``repro``'s static skip-grid bound: N-tiles x max occupancy."""
        return self.n_ntiles * self.max_occ

    def occupancy(self) -> float:
        """Occupied-tile fraction: the skip/dense planning signal."""
        return self.occupied_tiles / max(self.total_tiles(), 1)

    def materialize(self, dtype=torch.float32,
                    with_scale: bool = False) -> torch.Tensor:
        kp = self.packed.shape[-2] * formats.K_PER_WORD
        t = formats.decode_2bit(self.packed, kp, dtype)[:self.k, :self.n]
        return self._apply_scale(t, with_scale, dtype)


@register_format("bitplane")
@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class Bitplane(TernaryWeight):
    plus: torch.Tensor                # (ceil(K/8), N) uint8
    minus: torch.Tensor               # (ceil(K/8), N) uint8
    scale: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    shape: Tuple[int, int]
    nnz: int = -1

    _leaves = ("plus", "minus", "scale", "bias")

    @classmethod
    def from_dense(cls, t, scale=None, bias=None) -> "Bitplane":
        t = formats._as_tensor(t)
        plus, minus = formats.pack_bitplanes(t)
        return cls(plus=plus, minus=minus, scale=scale, bias=bias,
                   shape=tuple(t.shape), nnz=int(torch.count_nonzero(t)))

    @classmethod
    def from_planes(cls, plus: torch.Tensor, minus: torch.Tensor, k: int,
                    scale=None, bias=None, nnz: int = -1) -> "Bitplane":
        if plus.shape != minus.shape:
            raise ValueError(f"plane shapes differ: {tuple(plus.shape)} vs "
                             f"{tuple(minus.shape)}")
        kb, n = plus.shape[-2:]
        if kb * formats.K_PER_BYTE < k:
            raise ValueError(f"bitplanes cover K={kb * formats.K_PER_BYTE} "
                             f"< logical k={k}")
        return cls(plus=plus, minus=minus, scale=scale, bias=bias,
                   shape=(k, n), nnz=nnz)

    def materialize(self, dtype=torch.float32,
                    with_scale: bool = False) -> torch.Tensor:
        t = formats.decode_bitplanes(self.plus, self.minus, self.k, dtype)
        return self._apply_scale(t[..., :self.n], with_scale, dtype)


@register_format("base3")
@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class Base3(TernaryWeight):
    packed: torch.Tensor              # (ceil(K/5), N) uint8
    scale: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    shape: Tuple[int, int]
    nnz: int = -1

    _leaves = ("packed", "scale", "bias")

    @classmethod
    def from_dense(cls, t, scale=None, bias=None) -> "Base3":
        t = formats._as_tensor(t)
        return cls(packed=formats.pack_base3(t), scale=scale, bias=bias,
                   shape=tuple(t.shape), nnz=int(torch.count_nonzero(t)))

    def materialize(self, dtype=torch.float32,
                    with_scale: bool = False) -> torch.Tensor:
        t = formats.decode_base3(self.packed, self.k, dtype)
        return self._apply_scale(t[..., :self.n], with_scale, dtype)


def ternarize_stacked(w: torch.Tensor, threshold: float = 0.7):
    """(..., K, N) float -> ((..., K, N) int8 ternary, (..., N) f32 scales),
    one TWN ternarization per matrix."""
    t, alpha = quantize.ternarize(w, threshold)
    return t, alpha.squeeze(-2)


def pack(w, format: str = "dense2bit", *, scale=None, bias=None,
         threshold: float = 0.7, **opts) -> TernaryWeight:
    """Pack a weight into the ``format`` container. A float ``w`` is first
    ternarized per matrix and its per-channel scale becomes the container's
    ``scale`` unless one is passed; an integer ``w`` is taken as already
    ternary. ``**opts`` are format-specific (``tile_k``/``tile_n`` for
    ``"tiled"``)."""
    if format not in FORMATS:
        raise ValueError(f"unknown ternary format {format!r}; registered: "
                         f"{sorted(FORMATS)}")
    w = formats._as_tensor(w)
    if w.is_floating_point():
        t, scales = ternarize_stacked(w, threshold)
        if scale is None:
            scale = scales
    else:
        t = w
    return FORMATS[format].from_dense(t, scale=scale, bias=bias, **opts)
