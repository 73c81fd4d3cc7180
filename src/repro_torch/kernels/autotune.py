"""Block-shape autotuner of the port's ternary kernels (``repro``'s
``kernels/autotune.py`` on the H100).

For a (M, K, N, sparsity, impl, phase) problem it sweeps the candidate
tiles of the kernel the impl names and keeps the winner:

* ``dense`` — B1 (``csrc/ternary_gemm.cu``), every tile of
  ``ternary_gemm.TILES``, K stepped by 64;
* ``skip`` / ``skip_db`` — B2 / B3 (``csrc/ternary_gemm_skip.cu``): the
  rows per block (``ternary_gemm.SKIP_BLOCK_M``); ``block_n`` / ``block_k``
  are the pack's ``tile_n`` / ``tile_k`` (``fixed_n`` / ``fixed_k``);
* ``bitplane`` / ``bitplane_factorized`` — B7's two tiles.

``decode`` and ``verify`` add GEMV-shaped 16-row tiles to the grid (as
``repro``'s ``DECODE_CANDIDATE_BLOCKS``); every phase clamps ``block_m`` to
M's power-of-two bucket, never below ``MIN_BLOCK_M`` (the mma's 16 rows),
so every candidate is a tile its kernel instantiates. Two scoring modes:

* ``measure`` — each candidate launched through ``run(cfg)`` and timed with
  CUDA events on the current stream after a warm call, the L2 flushed
  before each timed call (the median of ``repeats``). Only when a ``run``
  is given, a card is present and the stream is not being captured into a
  CUDA graph; the engine never passes one, so no serving step measures;
* ``model`` — ``repro``'s analytic score (tile traffic over ``HBM_BW``,
  a per-step grid overhead, a capacity-pressure term) with the H100's
  constants, plus a wave term (below). Deterministic, so CPU runs plan as
  the card does.

Winners are cached in-process and in a JSON file whose layout and keys are
``repro``'s bit for bit (``{"version": 1, "entries": {"dense:m8:k1024:
n1024:s1.0:pdecode": [16, 64, 64], ...}}``; three ints for a GEMM, five for
a fused pair; a malformed entry drops alone). The file is the port's own:
``$REPRO_TORCH_AUTOTUNE_CACHE``, by default
``experiments/autotune_cache_torch.json``; ``repro``'s file holds TPU
blocks and is never read. ``save()`` writes a temporary file named after
the process and renames it, so processes that save at once never leave a
torn file.

**The wave term** (not in ``repro``; zero there). A block walks its
64-deep K steps one after another, so a step costs a block the latency of
its dependent chain (ldmatrix, the register decode, the MMAs), which grows
with the fragments each warp holds, and once the SMs hold several blocks
each, their issue slots: ``t_wave = (steps + PIPE_STEPS) * max(lat, blocks
/ SM_COUNT * thr)`` with ``f = (min(bm, 64) / 16) * (bn / 32)`` fragments
a warp, ``warps = 4 * ceil(bm / 64)``, ``lat = STEP_LAT_S +
STEP_LAT_FRAG_S * f`` and ``thr = warps * (STEP_THR_S + STEP_THR_FRAG_S *
f)``. ``repro``'s traffic term counts every re-read of x and of the words
at device-memory rate; on the H100 most of them hit the 50 MB L2, so the
port counts re-reads beyond the first at ``REREAD`` of it (1.0 in
``repro``).

**Calibration** (``chip_smoke.py``'s tune phase, every B1 key the served
ternary-paper engine plans plus jamba's in_proj and lm head, each
candidate timed with the L2 flushed; H100 80GB HBM3 at 700 W; PERF.md
§6). ``repro``'s formula alone, with the H100's constants, ranks the
wider tile first wherever x is re-read (16 x 128 over 16 x 64 at decode,
where 16 x 64 is 12–18% faster, and 128 x 128 over 64 x 128 at M >= 512 on
the lm head, where it is 5–12% slower). The readings fix a lone block's
step at 0.44 us (16 x 64) to 0.94 us (64 x 128), and a full card's at
0.22 us (32 x 64) to 0.51 us (64 x 128) a block. The constants below were
searched to rank those readings: the model's pick is within 1.7% of the
fastest candidate at every key (0.07% on average) and never slower than
the tile each phase took before the tuner. 128 x 128 was slower than
64 x 128 at every key but one (0.5% faster), so it is not instantiated.

**Fused pairs.** ``lookup_fused`` composes a fused entry from the two
per-GEMM lookups under ``repro``'s key: ``(min(up.block_m,
down.block_m), up.block_n, up.block_k, down.block_n, down.block_k)``.
B4 has tiles of its own (``fused_mlp.TILES``, (block_m, strip)), so
``fused_mlp.tile_for`` names the B4 tile of a composed entry: the tile
whose ``block_m`` is the smallest at or above the entry's (the largest
tile past them all); its strip is the tile's own.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.formats import K_PER_WORD

__all__ = ["BlockConfig", "FusedBlockConfig", "Autotuner", "get_tuner",
           "cache_key", "fused_cache_key", "DEFAULT_CACHE_PATH", "CACHE_ENV",
           "HBM_BW", "PEAK_FLOPS", "SMEM_BYTES", "SM_COUNT", "SPARSITY_GRID",
           "CANDIDATE_BLOCKS", "DECODE_CANDIDATE_BLOCKS"]

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
DEFAULT_CACHE_PATH = os.path.join("experiments", "autotune_cache_torch.json")

# The H100 SXM (NVIDIA's data sheet) — the port's single source for these
# numbers (chip_smoke.py's bounds import them from here).
HBM_BW = 3.35e12               # bytes/s of HBM3
PEAK_FLOPS = 989e12            # dense bf16 tensor-core operations/s
SMEM_BYTES = 227 * 1024        # shared memory one block may opt in to
SM_COUNT = 132

# repro's score, its constants named: per-step grid overhead and the
# weight of the capacity-pressure term
STEP_OVERHEAD_S = 1e-9
PRESSURE = 0.25
# the share of re-reads that reach device memory, and the wave term
# (module docstring); REREAD 1 and the others 0 are repro's score
REREAD = 0.175
PIPE_STEPS = 15
STEP_LAT_S = 0.72e-6
STEP_LAT_FRAG_S = 0.06e-6
STEP_THR_S = 0.036e-6
STEP_THR_FRAG_S = 0.0077e-6
STEP_K = 64                     # the K depth of one step of the kernels
# the smallest block_m a candidate clamps to, and the fallback tile's
# block_n / block_k (repro: 8, 128, 256 — the TPU's sublane and MXU)
MIN_BLOCK_M = 16
FALLBACK_BLOCK_N = 64
FALLBACK_BLOCK_K = 64

# Candidate grids per impl: (block_m, block_n, block_k) tiles the kernel
# instantiates (ternary_gemm.TILES, SKIP_BLOCK_M, ternary_gemm_bitplane.
# TILES). The skip rows' block_n / block_k are replaced by the pack's.
_B1 = ((32, 64, 64), (32, 128, 64), (64, 64, 64), (64, 128, 64))
_B1_DECODE = ((16, 64, 64), (16, 128, 64))
_SKIP = ((32, 128, 64), (64, 128, 64))
_SKIP_DECODE = ((16, 64, 64),)
# B7's 16-row tile in every phase: its 64 x 128 tile clamped to a small
# M's 16 rows keeps 128 columns, 1.3-1.4x slower than 16 x 64 there
_B7 = ((16, 64, 64), (64, 128, 64))
_B7_DECODE = ()
CANDIDATE_BLOCKS: Dict[str, Tuple[Tuple[int, int, int], ...]] = {
    "dense": _B1, "skip": _SKIP, "skip_db": _SKIP, "bitplane": _B7,
    "bitplane_factorized": _B7}
# decode GEMVs (M = slots) and speculative verify windows (M = slots *
# (k + 1)) widen the grid towards GEMV-shaped tiles, as repro's do
DECODE_CANDIDATE_BLOCKS: Dict[str, Tuple[Tuple[int, int, int], ...]] = {
    "dense": _B1_DECODE, "skip": _SKIP_DECODE, "skip_db": _SKIP_DECODE,
    "bitplane": _B7_DECODE, "bitplane_factorized": _B7_DECODE}

SPARSITY_GRID = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125)


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    block_m: int
    block_n: int
    block_k: int

    def as_list(self) -> List[int]:
        return [self.block_m, self.block_n, self.block_k]

    def smem_bytes(self, dtype_bytes: int = 2) -> int:
        """``repro``'s working-set size of one tile (x, words, decoded
        tile, accumulator, output): the capacity-pressure term's
        numerator."""
        x = self.block_m * self.block_k * dtype_bytes
        w = (self.block_k // K_PER_WORD) * self.block_n * 4
        dec = self.block_k * self.block_n * dtype_bytes
        acc = self.block_m * self.block_n * 4
        out = self.block_m * self.block_n * dtype_bytes
        return x + w + dec + acc + out


@dataclasses.dataclass(frozen=True)
class FusedBlockConfig:
    """Block plan for one fused MLP pair: a shared M tile plus the up- and
    down-projection's own (N, K) tiles; a five-int cache entry."""

    block_m: int
    block_n1: int
    block_k1: int
    block_n2: int
    block_k2: int

    def as_list(self) -> List[int]:
        return [self.block_m, self.block_n1, self.block_k1,
                self.block_n2, self.block_k2]

    def up(self) -> BlockConfig:
        return BlockConfig(self.block_m, self.block_n1, self.block_k1)

    def down(self) -> BlockConfig:
        return BlockConfig(self.block_m, self.block_n2, self.block_k2)


def _pow2_bucket(v: int) -> int:
    return 1 << max(0, int(v - 1).bit_length())


def _sparsity_bucket(s: float) -> float:
    return min(SPARSITY_GRID, key=lambda g: abs(g - max(min(s, 1.0), 0.0)))


def cache_key(m: int, k: int, n: int, sparsity: float = 1.0,
              impl: str = "dense", fixed_n: Optional[int] = None,
              fixed_k: Optional[int] = None,
              phase: Optional[str] = None) -> str:
    """``repro``'s key: M bucketed to a power of two, sparsity to
    ``SPARSITY_GRID``, the pack's pinned tile and the serving phase part of
    the problem's identity."""
    key = (f"{impl}:m{_pow2_bucket(m)}:k{k}:n{n}"
           f":s{_sparsity_bucket(sparsity)}")
    if fixed_n is not None:
        key += f":bn{fixed_n}"
    if fixed_k is not None:
        key += f":bk{fixed_k}"
    if phase is not None:
        key += f":p{phase}"
    return key


def fused_cache_key(m: int, k: int, ff: int, n: int,
                    sparsity_up: float = 1.0, sparsity_down: float = 1.0,
                    phase: Optional[str] = None) -> str:
    """``repro``'s key of a fused pair: both weights' shapes and
    occupancies under the per-GEMM keys' phase suffix."""
    key = (f"fused:m{_pow2_bucket(m)}:k{k}:f{ff}:n{n}"
           f":s{_sparsity_bucket(sparsity_up)}"
           f"x{_sparsity_bucket(sparsity_down)}")
    if phase is not None:
        key += f":p{phase}"
    return key


def _card_present() -> bool:
    import torch
    if not torch.cuda.is_available():
        return False
    return not torch.cuda.is_current_stream_capturing()


class Autotuner:
    """Process-wide block-shape cache with JSON persistence."""

    def __init__(self, path: Optional[str] = None, mode: str = "auto"):
        self._path = path if path is not None else os.environ.get(
            CACHE_ENV, DEFAULT_CACHE_PATH)
        self._mode = mode          # auto | model | measure
        self._cache: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._loaded = False
        self._flush = None          # measure mode's L2 flush buffer

    @property
    def path(self) -> str:
        return self._path

    # --- persistence ------------------------------------------------------
    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self._path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return            # unreadable or torn file: tune again
        entries = data.get("entries", {}) if isinstance(data, dict) else {}
        for key, blk in entries.items():
            # arity decides the type: 3 ints a GEMM, 5 a fused pair; a
            # malformed entry drops alone
            try:
                ints = [int(v) for v in blk]
            except (ValueError, TypeError):
                continue
            if len(ints) == 3:
                self._cache[key] = BlockConfig(*ints)
            elif len(ints) == 5:
                self._cache[key] = FusedBlockConfig(*ints)

    def save(self) -> None:
        entries = {key: cfg.as_list() for key, cfg in sorted(
            self._cache.items())}
        d = os.path.dirname(self._path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{self._path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "entries": entries}, f, indent=1)
        os.replace(tmp, self._path)

    # --- candidate generation / scoring ----------------------------------
    def candidates(self, m: int, k: int, n: int,
                   fixed_n: Optional[int] = None,
                   fixed_k: Optional[int] = None,
                   phase: Optional[str] = None,
                   impl: str = "dense") -> List[BlockConfig]:
        """The impl's kernel's tiles that fit ``SMEM_BYTES``, ``block_m``
        clamped to M's bucket; fixed_n/fixed_k pin the blocks the pack's
        layout dictates. ``decode``/``verify`` widen the grid."""
        if impl not in CANDIDATE_BLOCKS:
            raise ValueError(f"no candidate tiles for impl {impl!r}; known: "
                             f"{sorted(CANDIDATE_BLOCKS)}")
        grid = CANDIDATE_BLOCKS[impl]
        if phase in ("decode", "verify"):
            grid = grid + DECODE_CANDIDATE_BLOCKS[impl]
        out, seen = [], set()
        for bm, bn, bk in grid:
            bm = min(bm, _pow2_bucket(max(m, MIN_BLOCK_M)))
            bn = fixed_n if fixed_n is not None else bn
            bk = fixed_k if fixed_k is not None else bk
            cfg = BlockConfig(bm, bn, bk)
            if cfg in seen or cfg.smem_bytes() > SMEM_BYTES:
                continue
            seen.add(cfg)
            out.append(cfg)
        if not out:   # degenerate fallback: the smallest tile
            out.append(BlockConfig(
                min(MIN_BLOCK_M, _pow2_bucket(max(m, MIN_BLOCK_M))),
                fixed_n or FALLBACK_BLOCK_N, fixed_k or FALLBACK_BLOCK_K))
        return out

    def _model_score(self, cfg: BlockConfig, m: int, k: int, n: int,
                     sparsity: float) -> float:
        """Modelled seconds of one GEMM pass, lower is better: ``repro``'s
        traffic, grid and pressure terms plus the wave term. The occupied
        fraction scales the K steps (the skip rows' lever)."""
        occ = max(min(sparsity, 1.0), 1.0 / 64)
        mp = -(-m // cfg.block_m) * cfg.block_m
        npad = -(-n // cfg.block_n) * cfg.block_n
        kp = -(-k // cfg.block_k) * cfg.block_k
        n_tiles = npad // cfg.block_n
        m_tiles = mp // cfg.block_m
        k_steps = max(1, round((kp // cfg.block_k) * occ))
        x_bytes = m_tiles * n_tiles * k_steps * cfg.block_m * cfg.block_k * 2
        w_bytes = (m_tiles * n_tiles * k_steps
                   * (cfg.block_k // K_PER_WORD) * cfg.block_n * 4)
        if REREAD != 1.0:
            # the first read of x and of the words from device memory,
            # their re-reads (other N / M tiles) mostly from the L2
            x_once = mp * k_steps * cfg.block_k * 2
            w_once = k_steps * (cfg.block_k // K_PER_WORD) * npad * 4
            x_bytes = x_once + REREAD * (x_bytes - x_once)
            w_bytes = w_once + REREAD * (w_bytes - w_once)
        out_bytes = mp * npad * 2
        t_mem = (x_bytes + w_bytes + out_bytes) / HBM_BW
        grid = m_tiles * n_tiles * k_steps
        t_grid = grid * STEP_OVERHEAD_S
        t_vmem = t_mem * PRESSURE * (cfg.smem_bytes() / SMEM_BYTES)
        return t_mem + t_grid + t_vmem + self._wave_term(
            cfg, m_tiles * n_tiles, k_steps * cfg.block_k / STEP_K)

    @staticmethod
    def _wave_term(cfg: BlockConfig, blocks: int, steps: float) -> float:
        frags = (min(cfg.block_m, 64) / 16) * (cfg.block_n / 32)
        warps = 4 * -(-cfg.block_m // 64)
        lat = STEP_LAT_S + STEP_LAT_FRAG_S * frags
        thr = warps * (STEP_THR_S + STEP_THR_FRAG_S * frags)
        return (steps + PIPE_STEPS) * max(lat, blocks / SM_COUNT * thr)

    def _measure(self, cfg: BlockConfig, run: Callable[[BlockConfig], None],
                 repeats: int = 10) -> float:
        """Median seconds of ``run(cfg)`` over ``repeats`` calls after a
        warm one (which also builds the kernel), each between two CUDA
        events on the current stream and after a write of four times the
        card's L2: the weights come from device memory, as they do when a
        model's layers take turns (an L2-warm reading favours other tiles),
        and the write outlasts the host's time to enqueue the call, so no
        host time lands between the events."""
        import torch
        run(cfg)
        if self._flush is None:
            l2 = torch.cuda.get_device_properties(
                torch.cuda.current_device()).L2_cache_size
            self._flush = torch.empty(max(l2, 1 << 20), dtype=torch.int32,
                                      device="cuda")
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(repeats)]
        for start, end in events:
            self._flush.zero_()
            start.record()
            run(cfg)
            end.record()
        events[-1][1].synchronize()
        times = sorted(s.elapsed_time(e) for s, e in events)
        return times[len(times) // 2] / 1e3

    # --- the public entry -------------------------------------------------
    def lookup(self, m: int, k: int, n: int, sparsity: float = 1.0,
               impl: str = "dense", fixed_n: Optional[int] = None,
               fixed_k: Optional[int] = None,
               run: Optional[Callable[[BlockConfig], None]] = None,
               phase: Optional[str] = None) -> BlockConfig:
        """Best tile for the problem; tunes and persists on a miss.
        ``run``, given in measure mode (or in ``auto`` with a card present
        and no capture under way), times each candidate; otherwise the
        model decides."""
        key = cache_key(m, k, n, sparsity, impl, fixed_n=fixed_n,
                        fixed_k=fixed_k, phase=phase)
        with self._lock:
            self._load()
            hit = self._cache.get(key)
        if isinstance(hit, BlockConfig) \
                and (fixed_n is None or hit.block_n == fixed_n) \
                and (fixed_k is None or hit.block_k == fixed_k):
            return hit

        mode = self._mode
        if mode == "auto":
            mode = ("measure" if run is not None and _card_present()
                    else "model")
        cands = self.candidates(m, k, n, fixed_n=fixed_n, fixed_k=fixed_k,
                                phase=phase, impl=impl)
        if mode == "measure" and run is not None:
            scored = [(self._measure(c, run), c) for c in cands]
        else:
            scored = [(self._model_score(c, m, k, n, sparsity), c)
                      for c in cands]
        best = min(scored, key=lambda sc: sc[0])[1]
        with self._lock:
            self._cache[key] = best
            try:
                self.save()
            except OSError:
                pass      # read-only file system: the in-process cache holds
        return best

    def lookup_fused(self, m: int, k: int, ff: int, n: int,
                     sparsity_up: float = 1.0, sparsity_down: float = 1.0,
                     fixed_n1: Optional[int] = None,
                     fixed_k1: Optional[int] = None,
                     fixed_n2: Optional[int] = None,
                     fixed_k2: Optional[int] = None,
                     phase: Optional[str] = None) -> FusedBlockConfig:
        """Block plan of a fused ``(K -> FF) -> act -> (FF -> N)`` pair.
        On a miss it is composed from the two per-GEMM ``lookup``s (the
        shared M tile the smaller of theirs) and persisted under the fused
        key. ``fixed_*`` pin a pack's tiles (``skip`` keys then). The
        composed entry names a B4 tile through ``fused_mlp.tile_for``
        (module docstring)."""
        key = fused_cache_key(m, k, ff, n, sparsity_up, sparsity_down,
                              phase=phase)
        with self._lock:
            self._load()
            hit = self._cache.get(key)
        if isinstance(hit, FusedBlockConfig) \
                and (fixed_n1 is None or hit.block_n1 == fixed_n1) \
                and (fixed_k1 is None or hit.block_k1 == fixed_k1) \
                and (fixed_n2 is None or hit.block_n2 == fixed_n2) \
                and (fixed_k2 is None or hit.block_k2 == fixed_k2):
            return hit
        up = self.lookup(m, k, ff, sparsity=sparsity_up,
                         impl="skip" if fixed_n1 is not None else "dense",
                         fixed_n=fixed_n1, fixed_k=fixed_k1, phase=phase)
        down = self.lookup(m, ff, n, sparsity=sparsity_down,
                           impl="skip" if fixed_n2 is not None else "dense",
                           fixed_n=fixed_n2, fixed_k=fixed_k2, phase=phase)
        best = FusedBlockConfig(min(up.block_m, down.block_m),
                                up.block_n, up.block_k,
                                down.block_n, down.block_k)
        with self._lock:
            self._cache[key] = best
            try:
                self.save()
            except OSError:
                pass
        return best

    def entries(self) -> Dict[str, object]:
        with self._lock:
            self._load()
            return dict(self._cache)


_GLOBAL: Optional[Autotuner] = None
_GLOBAL_LOCK = threading.Lock()


def get_tuner() -> Autotuner:
    """The process-wide tuner (path from ``$REPRO_TORCH_AUTOTUNE_CACHE``)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = Autotuner()
        return _GLOBAL
