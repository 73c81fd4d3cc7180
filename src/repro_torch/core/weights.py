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

Tensor parallelism (``repro``'s pack-boundary rule): ``shard_constraints``
names each logical axis's physical extent and the value count of one
indivisible pack unit, ``validate_spec_twin`` rejects a spec whose shard
boundaries would split one, and ``shard_weight`` cuts one rank's slice out
of a container along K (a row split) or N (a column split), re-packed so
that it equals ``pack`` of the sliced matrix (a ``Tiled`` shard's
``kt_indices``/``kt_counts`` recomputed over its own tiles).

A ``meta`` tensor (the dry run's shapes, allocated nowhere) packs and
shards too: its count is unknown (``nnz=-1``) where a pack reads it, and
a shard of a meta container carries its share of the parent's ``nnz``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Type

import torch

from repro_torch.core import formats, quantize

__all__ = ["TernaryWeight", "Dense2Bit", "Tiled", "Bitplane", "Base3",
           "FORMATS", "register_format", "ternarize_stacked", "pack",
           "validate_spec_twin", "shard_weight", "select_columns"]

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


def _count(t: torch.Tensor, n_stack: int = 1) -> int:
    """The mean nonzero count of ``n_stack`` stacked matrices (-1 for a
    meta tensor, whose values do not exist)."""
    if t.is_meta:
        return -1
    return int(round(int(torch.count_nonzero(t)) / n_stack))


def _meta_share(out: "TernaryWeight", wc: "TernaryWeight") -> "TernaryWeight":
    """A meta shard ``out`` of ``wc`` with its share of ``wc``'s nnz (the
    count a real shard would read, in expectation)."""
    if out.nnz >= 0 or wc.nnz < 0 \
            or not getattr(out, out._leaves[0]).is_meta:
        return out
    share = out.k * out.n / max(wc.k * wc.n, 1)
    return dataclasses.replace(out, nnz=int(round(wc.nnz * share)))


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

    def shard_constraints(self) -> Dict[str, Tuple[int, int]]:
        """``{"k": (extent, multiple), "n": (extent, multiple)}``: the
        physical size of each logical axis as stored (tile-padded for
        ``Tiled``) and the values one indivisible pack unit covers (a
        2-bit word 16 K values, a bitplane byte 8, a base-3 byte 5, a skip
        tile ``tile_k`` / ``tile_n``). A shard boundary off ``multiple``
        would split a pack unit across ranks (``repro``'s rule)."""
        return {"k": (self.k, 1), "n": (self.n, 1)}

    def pack_opts(self) -> Dict[str, int]:
        """The format options ``pack`` needs to re-pack a slice alike."""
        return {}

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
                   nnz=_count(t, n_stack))

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

    def shard_constraints(self) -> Dict[str, Tuple[int, int]]:
        return {"k": (self.k, formats.K_PER_WORD), "n": (self.n, 1)}


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

    def shard_constraints(self) -> Dict[str, Tuple[int, int]]:
        # the occupancy lists are per (K-tile, N-tile): boundaries land on
        # whole tiles of the padded grid
        return {"k": (self.n_ktiles * self.tile_k, self.tile_k),
                "n": (self.n_ntiles * self.tile_n, self.tile_n)}

    def pack_opts(self) -> Dict[str, int]:
        return {"tile_k": self.tile_k, "tile_n": self.tile_n}


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
                   shape=tuple(t.shape), nnz=_count(t))

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

    def shard_constraints(self) -> Dict[str, Tuple[int, int]]:
        return {"k": (self.k, formats.K_PER_BYTE), "n": (self.n, 1)}


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
                   shape=tuple(t.shape), nnz=_count(t))

    def materialize(self, dtype=torch.float32,
                    with_scale: bool = False) -> torch.Tensor:
        t = formats.decode_base3(self.packed, self.k, dtype)
        return self._apply_scale(t[..., :self.n], with_scale, dtype)

    def shard_constraints(self) -> Dict[str, Tuple[int, int]]:
        return {"k": (self.k, 5), "n": (self.n, 1)}


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


# ---------------------------------------------------------------------------
# Tensor-parallel shards: the pack-boundary rule and the slicer
# ---------------------------------------------------------------------------

def _mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a mesh (anything with a ``shape`` mapping, as
    ``distributed.tp.Mesh``) or of a plain ``{name: size}`` dict."""
    return dict(getattr(mesh, "shape", mesh))


def _resolve_split(ax, sizes: Dict[str, int], used: set, fsdp: bool):
    """``repro``'s axis-name resolution of one spec entry (logical
    ``"fsdp"`` / ``"expert"``, tuples, literal names, no reuse) without the
    replicate-on-indivisible fallback: (split size, resolved names)."""
    if ax is None:
        return 1, ()
    if ax == "fsdp":
        axes = (tuple(a for a in ("pod", "data") if a in sizes)
                if fsdp else ())
    elif ax == "expert":
        axes = ("model",) if "model" in sizes else ()
    elif isinstance(ax, (tuple, list)):
        axes = tuple(a for a in ax if a in sizes)
    else:
        axes = (ax,) if ax in sizes else ()
    axes = tuple(a for a in axes if a not in used)
    size = 1
    for a in axes:
        size *= sizes[a]
    used.update(axes)
    return size, axes


def _twin_spec(twin):
    """The (K, N) spec of a container's spec twin: the twin itself when it
    is a tuple of axis entries, else its ``packed`` / ``plus`` entry (a
    dict or an object, as ``repro``'s container twins)."""
    if twin is None or isinstance(twin, tuple):
        return twin
    for name in ("packed", "plus"):
        cand = (twin.get(name) if isinstance(twin, dict)
                else getattr(twin, name, None))
        if cand is not None and not isinstance(cand, TernaryWeight):
            return tuple(cand)
    return None


def validate_spec_twin(wc: TernaryWeight, twin, mesh, *,
                       fsdp: bool = False) -> None:
    """Raise ``ValueError`` (``repro``'s message) when the container's spec
    twin puts a K (or N) shard boundary off the format's pack multiple
    (``shard_constraints``); return None when it is legal. ``twin``: the
    (K, N) spec as a tuple of axis entries (leading stack entries allowed)
    or a twin with a ``packed`` / ``plus`` spec; ``mesh``: axis sizes."""
    spec = _twin_spec(twin)
    if spec is None:
        return
    sizes = _mesh_axis_sizes(mesh)
    cons = wc.shard_constraints()
    entries = tuple(spec)
    if len(entries) < 2:
        entries = (None,) * (2 - len(entries)) + entries
    used: set = set()
    for ax in entries[:-2]:               # leading stack dims burn axes too
        _resolve_split(ax, sizes, used, fsdp)
    splits = [_resolve_split(ax, sizes, used, fsdp) for ax in entries[-2:]]
    for (tp, axes), dim in zip(splits, ("k", "n")):
        if tp <= 1:
            continue
        extent, multiple = cons[dim]
        if extent % (tp * multiple) == 0:
            continue
        per_shard = extent / tp
        legal = max(multiple, int(round(per_shard / multiple)) * multiple)
        raise ValueError(
            f"{wc.format_name} spec twin: sharding {dim.upper()} over mesh "
            f"axis {axes if len(axes) > 1 else axes[0]!r} ({tp}-way) puts "
            f"shard boundaries every {per_shard:g} of {extent} values — "
            f"off the {multiple}-value pack multiple of {wc!r}. Per-shard "
            f"{dim.upper()} must be a multiple of {multiple} that divides "
            f"{extent}; nearest legal boundary is {legal}.")


def shard_weight(wc: TernaryWeight, partition: str, rank: int,
                 tp: int) -> TernaryWeight:
    """Rank ``rank``'s slice of ``wc`` split ``tp`` ways along K
    (``partition="k"``, a row split: the scale and bias stay whole, for
    the epilogue after the all-reduce), N (``"n"``, a column split: the
    scale and bias sliced with the columns), or, for a stacked bank of
    ``(E, ...)`` matrices, E (``"e"``: whole experts, each with its scale
    and bias). K and N boundaries fall every ``extent / tp`` physical
    values and must land on the format's pack multiple (else
    ``ValueError``); a shard holds the logical values of its range. The
    slice is decoded and re-packed in the same format, so it equals
    ``pack`` of the sliced matrix (or bank) bit for bit."""
    if partition not in ("k", "n", "e"):
        raise ValueError(f"partition must be 'k', 'n' or 'e', got "
                         f"{partition!r}")
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside a {tp}-way split")
    t = None
    if partition == "e":
        t = wc.materialize(torch.float32).to(torch.int8)
        if t.ndim < 3 or t.shape[0] % tp != 0:
            raise ValueError(f"{wc.format_name} shard: {tp}-way expert "
                             f"split of a bank of shape {tuple(t.shape)}")
    else:
        extent, multiple = wc.shard_constraints()[partition]
        if extent % (tp * multiple) != 0:
            raise ValueError(
                f"{wc.format_name} shard: {partition.upper()}-partitioning "
                f"{tp}-way puts shard boundaries every {extent / tp:g} of "
                f"{extent} values — off the {multiple}-value pack multiple")
    if tp == 1:
        return wc
    if t is None:
        t = wc.materialize(torch.float32).to(torch.int8)
    scale, bias = wc.scale, wc.bias
    if partition == "e":
        step = t.shape[0] // tp
        t = t[rank * step:(rank + 1) * step]
        scale, bias = (None if v is None else
                       v[rank * step:(rank + 1) * step].contiguous()
                       for v in (scale, bias))
        return _meta_share(FORMATS[wc.format_name].from_dense(
            t.contiguous(), scale=scale, bias=bias, **wc.pack_opts()), wc)
    step = wc.shard_constraints()[partition][0] // tp
    logical = wc.k if partition == "k" else wc.n
    lo, hi = min(rank * step, logical), min((rank + 1) * step, logical)
    if partition == "k":
        t = t[..., lo:hi, :]
    else:
        t = t[..., lo:hi]
        scale = None if scale is None else scale[..., lo:hi].contiguous()
        bias = None if bias is None else bias[..., lo:hi].contiguous()
    return _meta_share(FORMATS[wc.format_name].from_dense(
        t.contiguous(), scale=scale, bias=bias, **wc.pack_opts()), wc)


def select_columns(wc: TernaryWeight, cols: torch.Tensor) -> TernaryWeight:
    """The columns ``cols`` (an index tensor, in that order) of ``wc``,
    with their scale and bias: decoded, selected and re-packed in the same
    format, so it equals ``pack`` of the selected matrix bit for bit (a
    column set that no contiguous ``shard_weight`` range covers)."""
    cols = torch.as_tensor(cols, dtype=torch.long)
    t = wc.materialize(torch.float32).to(torch.int8)
    idx = cols.to(t.device)
    scale, bias = (None if v is None else
                   v.index_select(-1, idx.to(v.device)).contiguous()
                   for v in (wc.scale, wc.bias))
    return _meta_share(FORMATS[wc.format_name].from_dense(
        t.index_select(-1, idx).contiguous(), scale=scale, bias=bias,
        **wc.pack_opts()), wc)
