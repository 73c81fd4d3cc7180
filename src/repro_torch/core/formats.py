"""Ternary weight formats of the port: the paper's TCSC baselines (``TCSC``,
``BlockedTCSC``, ``InterleavedTCSC``), 2-bit words, tile-occupancy packs,
bitplanes and base-3 bytes (the port's copy of ``repro.core.formats``).

TCSC arrays are ``int32`` tensors on the weight's device, element for
element ``repro``'s numpy arrays; the builders are vectorized (``nonzero``
over the transposed sign masks lists entries column-major, each column's
rows ascending: ``repro``'s per-column loop order).

2-bit codes: 0 -> 0, 1 -> +1, 2 -> -1 (3 unused); ``decode(c) = (c & 1) -
((c >> 1) & 1)``. Sixteen consecutive K-entries share one 32-bit word: bits
``[2r, 2r+2)`` of ``word[q, n]`` encode ``w[16q + r, n]`` — bit for bit the
layout of ``repro.core.formats.pack_2bit``.

The words are held as an ``int32`` view of the same bits. PyTorch's
``uint32`` has no right shift on the CPU, and ``(w >> 2r) & 3`` on the
``int32`` view is exact for every ``r <= 15`` even though the arithmetic
shift sign-extends (only bits ``2r`` and ``2r+1`` survive the mask). The
CUDA kernels read the same buffer as ``uint32_t``. Bitplanes and base-3
codes are ``uint8`` as in ``repro``.

Packers run on the tensor's own device; the occupancy bookkeeping of
``TiledTernary`` (one small ``(n_ktiles, n_ntiles)`` count matrix) is read
back to the host once, at pack time.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = ["TCSC", "BlockedTCSC", "InterleavedTCSC",
           "K_PER_WORD", "K_PER_BYTE", "pack_2bit", "decode_2bit",
           "TiledTernary", "pack_bitplanes", "decode_bitplanes",
           "base3_lut", "pack_base3", "decode_base3", "random_ternary",
           "random_tile_ternary"]

K_PER_WORD = 16
K_PER_BYTE = 8


# ---------------------------------------------------------------------------
# Random ternary matrices (the paper's benchmark inputs; numpy, so one seed
# gives the same matrix here and in ``repro``)
# ---------------------------------------------------------------------------

def random_ternary(rng: np.random.Generator, k: int, n: int,
                   sparsity: float) -> np.ndarray:
    """Random ternary (K, N) int8 matrix with ``sparsity`` nnz fraction,
    split evenly between +1 and -1 (the paper's convention). The same draws
    as ``repro``'s."""
    nnz = int(round(k * n * sparsity))
    w = np.zeros(k * n, dtype=np.int8)
    idx = rng.choice(k * n, size=nnz, replace=False)
    signs = rng.integers(0, 2, size=nnz, dtype=np.int8) * 2 - 1
    w[idx] = signs
    return w.reshape(k, n)


def random_tile_ternary(rng: np.random.Generator, k: int, n: int,
                        tile_k: int, tile_n: int, sparsity: float,
                        inner_density: float = 0.5) -> np.ndarray:
    """Tile-structured sparse ternary (K, N): each N-tile column gets
    ``round(min(1, sparsity/inner_density) * n_ktiles)`` occupied K-tiles
    chosen at random, filled so the overall nnz fraction is ``sparsity``.
    The same draws as ``repro``'s."""
    if k % tile_k or n % tile_n:
        raise ValueError(f"({k}, {n}) is not a multiple of the tile "
                         f"({tile_k}, {tile_n})")
    nkt, nnt = k // tile_k, n // tile_n
    w = np.zeros((k, n), dtype=np.int8)
    if sparsity <= 0:
        return w
    frac = min(1.0, sparsity / inner_density)
    per_col = max(1, int(round(frac * nkt)))
    inner = sparsity * nkt / per_col
    for j in range(nnt):
        for r in rng.choice(nkt, size=per_col, replace=False):
            w[r * tile_k:(r + 1) * tile_k, j * tile_n:(j + 1) * tile_n] = \
                random_ternary(rng, tile_k, tile_n, inner)
    return w


def _as_tensor(w) -> torch.Tensor:
    return w if isinstance(w, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(w))


def _pad_rows(w: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad axis -2 of (..., K, N) up to a multiple of ``mult``."""
    k = w.shape[-2]
    kp = -(-k // mult) * mult
    if kp == k:
        return w
    out = torch.zeros((*w.shape[:-2], kp, w.shape[-1]), dtype=w.dtype,
                      device=w.device)
    out[..., :k, :] = w
    return out


def _segments(counts: torch.Tensor, total: int) -> torch.Tensor:
    """Segment id of every entry: ``i`` repeated ``counts[i]`` times
    (``total`` entries, given so the card needs no sync)."""
    ids = torch.arange(len(counts), dtype=torch.int32, device=counts.device)
    return torch.repeat_interleave(ids, counts, output_size=total)


def _starts(counts: torch.Tensor) -> torch.Tensor:
    """(len + 1,) int32 exclusive prefix sum: the segments' offsets."""
    out = torch.zeros(len(counts) + 1, dtype=torch.int64,
                      device=counts.device)
    out[1:] = torch.cumsum(counts, 0)
    return out.to(torch.int32)


def _column_entries(mask: torch.Tensor):
    """Entries of a (K, N) bool mask, column-major, rows ascending: (rows
    int32, columns int64, per-column counts int64)."""
    col, row = torch.nonzero(mask.T, as_tuple=True)
    counts = torch.bincount(col, minlength=mask.shape[1])
    return row.to(torch.int32), col, counts


# ---------------------------------------------------------------------------
# TCSC -- the paper's baseline format
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class TCSC:
    """Ternary Compressed Sparse Column. Column j's +1 rows are
    ``row_index_pos[col_start_pos[j]:col_start_pos[j+1]]``, its -1 rows
    ``row_index_neg[col_start_neg[j]:col_start_neg[j+1]]``; the sign is
    the array, no value array exists."""

    col_start_pos: torch.Tensor  # (N+1,) int32
    col_start_neg: torch.Tensor  # (N+1,) int32
    row_index_pos: torch.Tensor  # (nnz_pos,) int32
    row_index_neg: torch.Tensor  # (nnz_neg,) int32
    shape: Tuple[int, int]       # (K, N)

    @classmethod
    def from_dense(cls, w) -> "TCSC":
        """From a (K, N) ternary matrix (a tensor, or numpy for the CPU)."""
        w = _as_tensor(w)
        rows_p, _, counts_p = _column_entries(w > 0)
        rows_n, _, counts_n = _column_entries(w < 0)
        return cls(_starts(counts_p), _starts(counts_n), rows_p, rows_n,
                   tuple(w.shape))

    def segment_ids_pos(self) -> torch.Tensor:
        return _segments(torch.diff(self.col_start_pos),
                         len(self.row_index_pos))

    def segment_ids_neg(self) -> torch.Tensor:
        return _segments(torch.diff(self.col_start_neg),
                         len(self.row_index_neg))

    def to_dense(self) -> torch.Tensor:
        w = torch.zeros(self.shape, dtype=torch.int8,
                        device=self.row_index_pos.device)
        w[self.row_index_pos.long(), self.segment_ids_pos().long()] = 1
        w[self.row_index_neg.long(), self.segment_ids_neg().long()] = -1
        return w

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.col_start_pos, self.col_start_neg, self.row_index_pos,
            self.row_index_neg))


@dataclasses.dataclass(frozen=True, eq=False)
class BlockedTCSC:
    """TCSC block by block along K (block size B): ``blocks[b]`` is the
    TCSC of rows [b·B, (b+1)·B), its row indices relative to the block's
    base, so each block's gather window is [0, B) (the paper's locality
    property)."""

    block_size: int
    blocks: Tuple[TCSC, ...]
    shape: Tuple[int, int]

    @classmethod
    def from_dense(cls, w, block_size: int = 4096) -> "BlockedTCSC":
        w = _as_tensor(w)
        k, n = w.shape
        return cls(block_size,
                   tuple(TCSC.from_dense(w[b0:b0 + block_size])
                         for b0 in range(0, k, block_size)), (k, n))

    def to_dense(self) -> torch.Tensor:
        return torch.cat([b.to_dense() for b in self.blocks], dim=0)

    def nbytes(self) -> int:
        return sum(b.nbytes() for b in self.blocks)


@dataclasses.dataclass(frozen=True, eq=False)
class InterleavedTCSC:
    """One index vector with the signs interleaved in groups of G. Each
    column holds three segments: G +1 rows then G -1 rows, repeated while
    both signs have G left; the remaining +1 rows; the remaining -1 rows.
    ``col_segment_ptr`` (3N+1,) ends each column's three segments."""

    group: int
    all_indices: torch.Tensor      # (nnz,) int32
    col_segment_ptr: torch.Tensor  # (3N+1,) int32
    shape: Tuple[int, int]

    @classmethod
    def from_dense(cls, w, group: int = 4) -> "InterleavedTCSC":
        w = _as_tensor(w)
        rows_p, col_p, cnt_p = _column_entries(w > 0)
        rows_n, col_n, cnt_n = _column_entries(w < 0)
        dev = rows_p.device
        base = _starts(cnt_p + cnt_n).long()          # each column's start
        gg = torch.minimum(cnt_p, cnt_n) // group * group  # interleaved / 2
        # rank of each entry among its column's entries of its sign
        rank_p = (torch.arange(len(rows_p), device=dev)
                  - _starts(cnt_p).long()[col_p])
        rank_n = (torch.arange(len(rows_n), device=dev)
                  - _starts(cnt_n).long()[col_n])
        # a ranked entry inside the interleaved groups sits in group pair
        # rank // G, first half (+1) or second half (-1); past them, in
        # its sign's remainder segment
        at_p = torch.where(
            rank_p < gg[col_p],
            2 * group * (rank_p // group) + rank_p % group,
            gg[col_p] + rank_p)
        at_n = torch.where(
            rank_n < gg[col_n],
            2 * group * (rank_n // group) + group + rank_n % group,
            cnt_p[col_n] + rank_n)
        idx = torch.empty(len(rows_p) + len(rows_n), dtype=torch.int32,
                          device=dev)
        idx[base[:-1][col_p] + at_p] = rows_p
        idx[base[:-1][col_n] + at_n] = rows_n
        ends = torch.stack([base[:-1] + 2 * gg, base[:-1] + gg + cnt_p,
                            base[1:]], dim=1).reshape(-1)
        ptr = torch.cat([base[:1], ends]).to(torch.int32)
        return cls(group, idx, ptr, tuple(w.shape))

    def segment_ids(self) -> torch.Tensor:
        ptr = self.col_segment_ptr
        return _segments(ptr[3::3] - ptr[:-1:3], len(self.all_indices))

    def signs(self) -> torch.Tensor:
        """+1/-1 (int8) of every entry of ``all_indices``, from its
        segment and its place in the interleaved groups."""
        ptr = self.col_segment_ptr
        seg = _segments(torch.diff(ptr), len(self.all_indices)).long()
        offset = (torch.arange(len(self.all_indices), device=ptr.device)
                  - ptr.long()[seg])
        kind = seg % 3
        inter = torch.where((offset // self.group) % 2 == 0, 1, -1)
        return torch.where(kind == 0, inter,
                           torch.where(kind == 1, 1, -1)).to(torch.int8)

    def to_dense(self) -> torch.Tensor:
        w = torch.zeros(self.shape, dtype=torch.int8,
                        device=self.all_indices.device)
        w[self.all_indices.long(), self.segment_ids().long()] = self.signs()
        return w

    def nbytes(self) -> int:
        return (self.all_indices.numel() * self.all_indices.element_size()
                + self.col_segment_ptr.numel()
                * self.col_segment_ptr.element_size())


# ---------------------------------------------------------------------------
# 2-bit words: the format of B1, B2, B3 and B4
# ---------------------------------------------------------------------------

def pack_2bit(w: torch.Tensor) -> torch.Tensor:
    """Pack (..., K, N) ternary {-1, 0, +1} into (..., ceil(K/16), N) int32
    words (the uint32 bit pattern of ``repro``'s packer). Runs on the
    tensor's own device."""
    if w.ndim < 2:
        raise ValueError(f"pack_2bit expects (..., K, N), got {tuple(w.shape)}")
    *lead, k, n = w.shape
    kp = -(-k // K_PER_WORD) * K_PER_WORD
    codes = torch.zeros((*lead, kp, n), dtype=torch.int64, device=w.device)
    codes[..., :k, :] = (w == 1).long() + 2 * (w == -1).long()
    shifts = 2 * torch.arange(K_PER_WORD, dtype=torch.int64,
                              device=w.device).view(K_PER_WORD, 1)
    words = (codes.view(*lead, kp // K_PER_WORD, K_PER_WORD, n)
             << shifts).sum(dim=-2)
    # the OR of disjoint bit fields equals their sum; fold the unsigned
    # 32-bit value into int32's range so the bits are unchanged
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def decode_2bit(packed: torch.Tensor, k: int,
                dtype=torch.bfloat16) -> torch.Tensor:
    """(..., K/16, N) int32 words -> (..., k, N) {-1, 0, +1} in ``dtype``."""
    if packed.dtype != torch.int32:
        raise TypeError(f"packed words must be int32, got {packed.dtype}")
    *lead, q, n = packed.shape
    shifts = 2 * torch.arange(K_PER_WORD, dtype=torch.int32,
                              device=packed.device).view(K_PER_WORD, 1)
    c = (packed.unsqueeze(-2) >> shifts) & 3
    vals = (c & 1) - ((c >> 1) & 1)
    return vals.reshape(*lead, q * K_PER_WORD, n)[..., :k, :].to(dtype)


# ---------------------------------------------------------------------------
# TiledTernary: 2-bit words + per-(K-tile, N-tile) occupancy (B2, B3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class TiledTernary:
    """2-bit words of the K/N tile-padded matrix plus the occupancy that
    the tile-skipping kernels walk, recorded at pack time:

    * ``tile_nnz``   -- (n_ktiles, n_ntiles) int32 nnz per tile;
    * ``kt_indices`` -- (n_ntiles, max_occ) int32: per N-tile column the
                        occupied K-tile ids in ascending order, padded to
                        ``max_occ`` with the id of an unoccupied tile;
    * ``kt_counts``  -- (n_ntiles,) int32 valid prefix of each row.

    ``packed`` is (Kp/16, Np) int32. ``tile_k`` and ``tile_n`` are
    multiples of 16. Bit for bit ``repro``'s ``TiledTernary``.
    """

    packed: torch.Tensor
    kt_indices: torch.Tensor
    kt_counts: torch.Tensor
    tile_nnz: torch.Tensor
    tile_k: int
    tile_n: int
    shape: Tuple[int, int]           # logical (K, N) before padding

    @classmethod
    def from_dense(cls, w, tile_k: int = 256,
                   tile_n: int = 128) -> "TiledTernary":
        """Pack a (K, N) {-1, 0, +1} tensor (or numpy array) on its own
        device."""
        if tile_k % K_PER_WORD or tile_n % 16 or tile_k <= 0 or tile_n <= 0:
            raise ValueError(f"tile_k and tile_n must be positive multiples "
                             f"of 16, got ({tile_k}, {tile_n})")
        w = _as_tensor(w)
        if w.ndim != 2:
            raise ValueError(f"TiledTernary packs one (K, N) matrix, got "
                             f"{tuple(w.shape)}")
        k, n = w.shape
        kp = -(-k // tile_k) * tile_k
        npad = -(-n // tile_n) * tile_n
        wp = torch.zeros((kp, npad), dtype=torch.int8, device=w.device)
        wp[:k, :n] = w
        nkt, nnt = kp // tile_k, npad // tile_n
        tile_nnz = (wp.view(nkt, tile_k, nnt, tile_n) != 0).sum(
            dim=(1, 3)).to(torch.int32)
        occ = tile_nnz.cpu().numpy() > 0
        counts = occ.sum(axis=0).astype(np.int32)
        max_occ = max(int(counts.max(initial=0)), 1)
        idx = np.zeros((nnt, max_occ), dtype=np.int32)
        for j in range(nnt):
            ks = np.nonzero(occ[:, j])[0].astype(np.int32)
            idx[j, :len(ks)] = ks
            if len(ks) < max_occ:
                free = np.setdiff1d(np.arange(nkt, dtype=np.int32), ks)
                idx[j, len(ks):] = free[0] if len(free) else 0
        return cls(pack_2bit(wp), torch.from_numpy(idx).to(w.device),
                   torch.from_numpy(counts).to(w.device), tile_nnz,
                   tile_k, tile_n, (k, n))

    @property
    def n_ktiles(self) -> int:
        return self.tile_nnz.shape[0]

    @property
    def n_ntiles(self) -> int:
        return self.tile_nnz.shape[1]

    @property
    def max_occ(self) -> int:
        return self.kt_indices.shape[1]

    def occupancy(self) -> torch.Tensor:
        """(n_ktiles, n_ntiles) bool bitmap."""
        return self.tile_nnz > 0

    def occupied_tiles(self) -> int:
        return int(self.kt_counts.sum())

    def total_tiles(self) -> int:
        return self.n_ktiles * self.n_ntiles

    def occupancy_fraction(self) -> float:
        return self.occupied_tiles() / max(self.total_tiles(), 1)

    def visited_tiles(self) -> int:
        """Tiles ``repro``'s skip grid steps through per M-tile row (the
        static ``max_occ`` bound x N-tiles). The port's kernels visit only
        ``occupied_tiles()``."""
        return self.n_ntiles * self.max_occ

    def to_dense(self) -> torch.Tensor:
        k, n = self.shape
        return decode_2bit(self.packed, self.n_ktiles * self.tile_k,
                           torch.int8)[:k, :n]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.packed, self.kt_indices, self.kt_counts,
                    self.tile_nnz))


# ---------------------------------------------------------------------------
# Bitplanes: structural sign encoding, 8 weights per byte per plane (B7)
# ---------------------------------------------------------------------------

def _bit_weights(n: int, device) -> torch.Tensor:
    return (2 ** torch.arange(n, dtype=torch.int32, device=device)).view(n, 1)


def pack_bitplanes(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack (K, N) ternary into two uint8 planes of shape (ceil(K/8), N):
    bit ``r`` of ``plus[q, n]`` is 1 iff ``w[8q + r, n] == +1`` (``minus``
    likewise for -1)."""
    w = _pad_rows(_as_tensor(w), K_PER_BYTE)
    kp, n = w.shape
    bits = _bit_weights(K_PER_BYTE, w.device)

    def plane(mask):
        return (mask.to(torch.int32).view(kp // K_PER_BYTE, K_PER_BYTE, n)
                * bits).sum(dim=1).to(torch.uint8)

    return plane(w == 1), plane(w == -1)


def _plane_bits(plane: torch.Tensor) -> torch.Tensor:
    """(q, N) uint8 -> (q*8, N) int32 0/1, bit r of byte q at row 8q + r."""
    q, n = plane.shape
    shifts = torch.arange(K_PER_BYTE, dtype=torch.int32,
                          device=plane.device).view(K_PER_BYTE, 1)
    return ((plane.to(torch.int32).unsqueeze(1) >> shifts) & 1).reshape(
        q * K_PER_BYTE, n)


def decode_bitplanes(plus: torch.Tensor, minus: torch.Tensor, k: int,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """Two (K/8, N) uint8 planes -> (k, N) {-1, 0, +1} in ``dtype``."""
    return (_plane_bits(plus) - _plane_bits(minus))[:k].to(dtype)


# ---------------------------------------------------------------------------
# Base-3: five trits per byte (the paper's value compression)
# ---------------------------------------------------------------------------

def base3_lut() -> torch.Tensor:
    """(243, 5) int8 lookup: code -> five {-1, 0, +1} values (digit 0
    first)."""
    codes = torch.arange(243).view(243, 1)
    digits = (codes // 3 ** torch.arange(5)) % 3
    return (digits - 3 * (digits == 2)).to(torch.int8)


def pack_base3(w) -> torch.Tensor:
    """Pack (K, N) ternary into (ceil(K/5), N) uint8 base-3 codes."""
    w = _pad_rows(_as_tensor(w), 5)
    kp, n = w.shape
    trits = (w == 1).to(torch.int32) + 2 * (w == -1).to(torch.int32)
    powers = (3 ** torch.arange(5, dtype=torch.int32,
                                device=w.device)).view(5, 1)
    return (trits.view(kp // 5, 5, n) * powers).sum(dim=1).to(torch.uint8)


def decode_base3(packed: torch.Tensor, k: int,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """(K/5, N) uint8 codes -> (k, N) {-1, 0, +1} in ``dtype``, through the
    243-entry lookup table (a gather)."""
    q, n = packed.shape
    vals = base3_lut().to(packed.device)[packed.long()]     # (q, n, 5)
    return vals.permute(0, 2, 1).reshape(q * 5, n)[:k].to(dtype)
