"""Public ops of the port: ``ternary_gemm`` through a kernel registry and
planner, ``fused_mlp`` and ``paged_decode_attention`` through registries
of their own, the plans an engine warms (``precompute_plans``,
``precompute_fused_plans``), the serving-phase tag (``serving_phase`` /
``current_phase``) and the timing probe (``kernel_probe``).

``ternary_gemm(x, w)`` takes a ``repro_torch.core.weights`` container and
runs in two stages, as ``repro``'s does:

1. **plan** — ``ternary_gemm_plan`` consults the registry: each lowering
   registers ``(format, impl)`` with a priority and a predicate over
   pack-time metadata, and ``impl="auto"`` picks the highest-priority row
   that admits the weight (so the skipping kernels only at or below
   ``SKIP_OCCUPANCY_CUTOFF`` tile occupancy). The result is an
   inspectable ``GemmPlan``. Planning reads host-side metadata only.
2. **lower** — the row's lowering runs. Dispatch is by the device the
   activations lie on: on a CUDA tensor a kernel row launches its
   hand-written kernel (or its wrapper raises; it never falls back), on a
   CPU tensor it runs the kernel's plain PyTorch version. ``ref`` rows run
   the plain versions wherever the tensors lie. A ``meta`` tensor (the
   dry run's trace, ``launch.dryrun``) takes the card's choice at every
   such branch (``on_card``) and its wrapper computes the output through
   the plain version, launching nothing.

Gradients. A kernel row on a CUDA tensor runs through
``_PackedGemm`` (and ``fused_mlp`` through ``_FusedMlp``), whose forward
launches the kernel and whose backward is ``repro``'s ``custom_vjp``
formula in plain PyTorch: ``gx = (g * s) @ T^T``, ``gscale = sum_m g *
(x @ T)``, ``gbias = sum_m g``, PReLU's slope applied to ``g`` first; the
words and occupancy lists get none. ``repro`` computes these backwards in
XLA, outside its Pallas kernels, so ``torch.matmul`` is their port. The
plain versions on CPU tensors differentiate through their own torch ops.

Rows (priority), as ``repro`` registers them:

* ``dense2bit``: ``dense`` 10 (B1), ``ref``;
* ``tiled``:     ``skip_db`` 12 (B3) and ``skip`` 10 (B2), both only at
                 ``occupancy() <= 0.875``; ``dense`` 5 (B1 on the padded
                 words); ``ref``;
* ``bitplane``:  ``bitplane`` 10 and ``bitplane_factorized`` 5 (B7), ``ref``;
* ``base3``:     ``ref`` 10 — no kernel, as in ``repro`` (XLA there even on
                 a TPU), so its plain version runs on the card too.

The fused-MLP registry has ``repro``'s two rows: ``"pallas"`` (priority
10, B4, admitted by ``_fusable``: 2-D ``dense2bit``/``tiled`` packs whose
gate plans the up projection's blocks) and ``"chain"`` (0, one
``ternary_gemm`` per projection). The paged-attention registry has
``"pallas"`` (20, B5, admitted when q lies on the card) and ``"jax"`` (10,
the page gather and the dense decode's attention lines, B5's plain
version); its rows register when ``repro_torch.paging.kernels`` is
imported. On a CPU tensor every kernel row runs its plain version; a row
named explicitly runs wherever the tensors lie, and nothing falls back to
another row.

Blocks come from the block-shape tuner (``autotune.get_tuner()``), as
``repro``'s do: the dense rows under the dense key at ``sparsity=1.0`` (so
a restored checkpoint plans as the packing run did), the skip rows'
``block_m`` under the skip key with the pack's ``tile_n``/``tile_k``
pinned, the bitplane rows under their own key, the fused row through
``lookup_fused`` (its composed entry names a B4 tile,
``fused_mlp.tile_for``). An explicit ``block_m``/``block_n`` that names one
of the kernel's tiles wins; any other raises, as does a tuner entry that
names none (a hand-edited cache file). Each answer is memoized per tuner
key, and ``ternary_gemm`` memoizes its plan per (weight, M, phase,
arguments), so a repeated dispatch is a dictionary hit, not a lookup.
``GemmPlan.roofline()`` and ``FusedMlpPlan.roofline()`` place a plan on
the H100's roofline with the tuner's constants and score.

Tensor parallelism (``repro``'s plan fields): ``ternary_gemm_plan(w, m,
partition=, tp=)`` plans one shard of the full container ``w`` —
``"k"`` a row split whose partial products need the f32 all-reduce
(``collective="psum"``, its bytes in ``roofline()``), ``"n"`` a column
split with none — and the tuner keys the shard's own (K, N).
``ternary_gemm(x, shard, partition="k", tp=)`` dispatches a rank's shard:
B1's f32 form on the card (the plain f32 partial on the CPU and on the
``ref`` rows), the scale applied and no bias, for the caller's all-reduce;
``fused_mlp(..., tp=)`` likewise through B4's f32 form.
``precompute_plans(shard=)`` / ``precompute_fused_plans(tp=)`` warm a
rank's shards' plans with their collectives recorded.

``kernel_probe(cb)`` times each eager ``ternary_gemm`` / ``fused_mlp``
dispatch in its scope and calls ``cb(plan, seconds)``: with CUDA events
on the card, with the host clock on the CPU. A dispatch while the stream
is being captured into a CUDA graph is not timed (nothing runs then), as
``repro``'s probe skips dispatch under jit tracing.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import formats, weights
from repro_torch.kernels import autotune as autotune_lib
from repro_torch.kernels import fused_mlp as fused_lib
from repro_torch.kernels import ref
from repro_torch.kernels import ternary_gemm as gemm_lib
from repro_torch.kernels import ternary_gemm_bitplane as bitplane_lib
from repro_torch.obs import clock as obs_clock

__all__ = ["ternary_gemm", "ternary_gemm_plan", "GemmPlan", "KernelImpl",
           "register_kernel", "kernel_registry", "SKIP_OCCUPANCY_CUTOFF",
           "precompute_plans", "FUSED_FORMATS", "FusedMlpPlan", "FusedImpl",
           "register_fused", "fused_registry", "fused_mlp_plan",
           "fused_mlp", "precompute_fused_plans", "PagedAttnImpl",
           "register_paged_attn", "paged_attention_registry",
           "paged_decode_attention", "serving_phase", "current_phase",
           "SERVING_PHASES", "kernel_probe", "dispatch_hook", "on_card"]

# prefill GEMMs are M = B*L, decode GEMVs M = slots, speculative verify
# windows M = slots*(k+1) and chunked-prefill windows M = slots*S in
# between; each phase keys its own tiles
SERVING_PHASES = ("prefill", "decode", "verify", "chunk")

# Above this occupied-tile fraction the skip walk saves too little;
# "auto" takes the dense kernel (repro's constant).
SKIP_OCCUPANCY_CUTOFF = 0.875

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


_KERNEL_PROBE: contextvars.ContextVar[Optional[Callable]] = \
    contextvars.ContextVar("repro_torch_kernel_probe", default=None)


@contextlib.contextmanager
def kernel_probe(cb: Callable[[Any, float], None]):
    """``with kernel_probe(lambda plan, dt: ...):`` times every eager
    ``ternary_gemm`` / ``fused_mlp`` dispatch in the scope."""
    token = _KERNEL_PROBE.set(cb)
    try:
        yield
    finally:
        _KERNEL_PROBE.reset(token)


_DISPATCH_HOOK: contextvars.ContextVar[Optional[Callable]] = \
    contextvars.ContextVar("repro_torch_dispatch_hook", default=None)


@contextlib.contextmanager
def dispatch_hook(hook: Callable[[Any], Any]):
    """``with dispatch_hook(lambda plan: cm):`` enters the context manager
    ``hook(plan)`` around the lowering of every eager ``ternary_gemm`` /
    ``fused_mlp`` dispatch in the scope and, when entering it gives a
    callable, hands that the dispatch's output (``launch.hlo_cost``
    charges a dispatch's plan there in place of the ops its lowering
    runs, and counts its output as the kernel's)."""
    token = _DISPATCH_HOOK.set(hook)
    try:
        yield
    finally:
        _DISPATCH_HOOK.reset(token)


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the card's lowering: a CUDA tensor, or a
    ``meta`` tensor of the dry run's trace, which follows the card's
    dispatch (its kernel wrappers compute through the plain versions)."""
    return x.is_cuda or x.is_meta


def _dispatch(plan, tag: str, x: torch.Tensor, lower: Callable):
    """Run one dispatch's ``lower()`` under the probe and the hook in
    scope (neither while a graph is being captured)."""
    hook, probe = _DISPATCH_HOOK.get(), _KERNEL_PROBE.get()
    if (hook is None and probe is None) or _capturing():
        return lower()
    with hook(plan) if hook is not None else contextlib.nullcontext() \
            as output:
        y = (_probe_dispatch(probe, plan, tag, x, lower) if probe is not None
             else lower())
        if output is not None:
            output(y)
        return y


def _capturing() -> bool:
    """Whether the current CUDA stream is being captured into a graph."""
    try:
        return torch.cuda.is_current_stream_capturing()
    except RuntimeError:      # a build without CUDA: nothing can capture
        return False


def _probe_dispatch(probe: Callable, plan, tag: str, x: torch.Tensor,
                    lower: Callable):
    """Run ``lower()`` timed (CUDA events on the card, the host clock on
    the CPU) inside a profiler range named ``tag``; report to ``probe``."""
    with torch.profiler.record_function(tag):
        if x.is_meta:             # a dry-run trace: nothing runs
            y, dt = lower(), 0.0
        elif x.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y = lower()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = obs_clock.now()
            y = lower()
            dt = obs_clock.now() - t0
    probe(plan, dt)
    return y


# ---------------------------------------------------------------------------
# The kernel registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """Inspectable dispatch decision for one ternary GEMM, produced by
    ``ternary_gemm_plan`` and consumed by the row's lowering. ``block_*``
    are ``None`` for ``ref`` rows."""

    format: str
    impl: str
    m: int
    k: int
    n: int
    block_m: Optional[int]
    block_n: Optional[int]
    block_k: Optional[int]
    phase: Optional[str]
    occupancy: float
    fuse_prelu: bool = False
    prelu_alpha: float = 0.25
    partition: Optional[str] = None      # None | "k" | "n"
    collective: Optional[str] = None     # None | "psum"
    tp: int = 1

    def traffic(self) -> Dict[str, float]:
        """Modeled operations and device-memory bytes of one pass, from the
        plan's blocks and the pack-time occupancy (``repro``'s formula):
        the skip rows scale the K steps by the occupied-tile fraction."""
        skipping = self.impl in ("skip", "skip_db")
        occ = self.occupancy if skipping else 1.0
        bm = self.block_m or min(128, max(8, 1 << (self.m - 1).bit_length()))
        bn = self.block_n or 128
        bk = self.block_k or 256
        mp = -(-self.m // bm) * bm
        npad = -(-self.n // bn) * bn
        kp = -(-self.k // bk) * bk
        m_tiles, n_tiles = mp // bm, npad // bn
        k_steps = max(1, round((kp // bk) * occ))
        flops = 2.0 * mp * npad * (k_steps * bk)
        x_bytes = m_tiles * n_tiles * k_steps * bm * bk * 2
        w_bytes = (m_tiles * n_tiles * k_steps
                   * (bk // formats.K_PER_WORD) * bn * 4)
        out_bytes = mp * npad * 2
        # ring all-reduce over the K-split partial products: each shard
        # sends and receives 2 (tp - 1) / tp of the (m, n) f32 output
        coll = (2.0 * (self.tp - 1) / self.tp * self.m * self.n * 4
                if self.collective == "psum" and self.tp > 1 else 0.0)
        return {"flops": flops,
                "bytes": float(x_bytes + w_bytes + out_bytes),
                "collective_bytes": coll}

    def roofline(self) -> Dict[str, Any]:
        """The plan on the H100's roofline (``autotune.HBM_BW`` /
        ``PEAK_FLOPS``), ``repro``'s keys: the ceiling at the plan's
        arithmetic intensity, the tuner's modelled time of its tile and the
        rate that time achieves, with the shard's collective and its bytes
        under tensor parallelism."""
        t = self.traffic()
        ai = t["flops"] / max(t["bytes"], 1.0)
        ceiling = min(autotune_lib.PEAK_FLOPS, ai * autotune_lib.HBM_BW)
        cfg = autotune_lib.BlockConfig(
            self.block_m or 128, self.block_n or 128, self.block_k or 256)
        t_model = autotune_lib.Autotuner()._model_score(
            cfg, self.m, self.k, self.n,
            self.occupancy if self.impl in ("skip", "skip_db") else 1.0)
        achieved = t["flops"] / max(t_model, 1e-12)
        return {"flops": t["flops"], "bytes": t["bytes"],
                "arithmetic_intensity": ai,
                "ceiling_flops": ceiling,
                "achieved_flops": achieved,
                "peak_flops": autotune_lib.PEAK_FLOPS,
                "model_time_s": t_model,
                "headroom": max(0.0, 1.0 - achieved / max(ceiling, 1.0)),
                "bound": ("memory" if ceiling < autotune_lib.PEAK_FLOPS
                          else "compute"),
                "collective": self.collective,
                "collective_bytes": t["collective_bytes"],
                "tp": self.tp}


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One registered lowering ``(format, impl)``: ``predicate(w, m,
    phase)`` gates ``impl="auto"`` (highest admissible ``priority`` wins),
    ``plan_blocks(w, m, phase, bm, bn, bk)`` resolves the block shape,
    ``lower(plan, x, w, scale, bias)`` runs."""

    format: str
    impl: str
    priority: int
    predicate: Callable[[weights.TernaryWeight, int, Optional[str]], bool]
    plan_blocks: Callable
    lower: Callable


_KERNELS: Dict[Tuple[str, str], KernelImpl] = {}
_REGISTRY_VERSION = [0]           # bumped by register_kernel / _fused
# ternary_gemm's plans per weight (module docstring)
_PLANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def register_kernel(fmt: str, impl: str, *, priority: int = 0,
                    predicate: Optional[Callable] = None,
                    plan_blocks: Optional[Callable] = None):
    """Decorator registering the lowering ``fn(plan, x, w, scale, bias)``
    for ``(format, impl)``; dispatch, ``impl="auto"`` and
    ``ternary_gemm_plan`` pick it up with no call-site change."""

    def deco(fn):
        _REGISTRY_VERSION[0] += 1
        _KERNELS[(fmt, impl)] = KernelImpl(
            format=fmt, impl=impl, priority=priority,
            predicate=predicate or (lambda w, m, phase: True),
            plan_blocks=plan_blocks or (lambda w, m, phase, bm, bn, bk:
                                        (bm, bn, bk)),
            lower=fn)
        return fn

    return deco


def kernel_registry() -> Dict[Tuple[str, str], KernelImpl]:
    """Snapshot of the registered ``(format, impl) -> KernelImpl`` table."""
    return dict(_KERNELS)


# --- block planning ---------------------------------------------------------

_TUNED: Dict[tuple, Any] = {}
_TUNED_BY: list = [None]          # the tuner _TUNED's answers came from


def _tuned(key: tuple, lookup: Callable[[autotune_lib.Autotuner], Any]):
    """The process-wide tuner's answer ``lookup(tuner)`` for ``key`` (what
    its cache key holds, M bucketed), memoized while the tuner stays the
    same: the tuner's own hit formats a key and takes a lock."""
    tuner = autotune_lib.get_tuner()
    if _TUNED_BY[0] is not tuner:
        _TUNED.clear()
        _TUNED_BY[0] = tuner
    hit = _TUNED.get(key)
    if hit is None:
        hit = _TUNED[key] = lookup(tuner)
    return hit


def _pick_tile(kind, tiles, bm, bn, cfg_of):
    """``(block_m, block_n)`` of ``tiles`` (a kernel's instantiated tiles):
    the explicit one when both are given, the first tile agreeing with a
    lone explicit one, else the tuner's (``cfg_of()``). Raises when the
    answer is not one of ``tiles``."""
    if bm is None and bn is None:
        cfg = cfg_of()
        bm, bn = cfg.block_m, cfg.block_n
        if (bm, bn) not in tiles:
            raise ValueError(
                f"the tuner's tile ({bm}, {bn}) for {kind} is not one of its "
                f"tiles {sorted(tiles)} (cache file "
                f"{autotune_lib.get_tuner().path})")
        return bm, bn
    for tbm, tbn in sorted(tiles):
        if bm in (None, tbm) and bn in (None, tbn):
            return tbm, tbn
    raise ValueError(f"(block_m, block_n)=({bm}, {bn}) is not one of "
                     f"{kind}'s tiles {sorted(tiles)}")


def _check_bk(bk):
    if bk is not None and bk != gemm_lib.BLOCK_K:
        raise ValueError(f"block_k={bk}: this kernel steps K by "
                         f"{gemm_lib.BLOCK_K} only")


def _blocks_dense(w, m, phase, bm, bn, bk):
    """B1's tile: the tuner's under the dense key at ``sparsity=1.0``
    (repro's ``_blocks_dense``: a restored checkpoint plans as the packing
    run did), unless the caller names one of ``ternary_gemm.TILES``."""
    _check_bk(bk)
    key = ("dense", autotune_lib._pow2_bucket(m), w.k, w.n, phase)
    bm, bn = _pick_tile("B1", gemm_lib.TILES, bm, bn, lambda: _tuned(
        key, lambda t: t.lookup(m, w.k, w.n, sparsity=1.0, impl="dense",
                                phase=phase)))
    return bm, bn, gemm_lib.BLOCK_K


def _blocks_skip_impl(impl):
    def plan(w, m, phase, bm, bn, bk):
        # pack-time tile shapes dictate the kernel's K/N blocks
        if bn is not None and bn != w.tile_n:
            raise ValueError(f"impl={impl!r}: block_n={bn} must equal the "
                             f"pack's tile_n={w.tile_n}")
        if bk is not None and bk != w.tile_k:
            raise ValueError(f"impl={impl!r}: block_k={bk} must equal the "
                             f"pack's tile_k={w.tile_k}")
        if bm is None:
            occ = w.occupancy()
            key = (impl, autotune_lib._pow2_bucket(m), w.k, w.n,
                   autotune_lib._sparsity_bucket(occ), w.tile_n, w.tile_k,
                   phase)
            bm = _tuned(key, lambda t: t.lookup(
                m, w.k, w.n, sparsity=occ, impl=impl, fixed_n=w.tile_n,
                fixed_k=w.tile_k, phase=phase)).block_m
        if bm not in gemm_lib.SKIP_BLOCK_M:
            raise ValueError(f"impl={impl!r}: block_m={bm} must be one of "
                             f"{gemm_lib.SKIP_BLOCK_M}")
        return bm, w.tile_n, w.tile_k
    return plan


def _blocks_bitplane(impl):
    def plan(w, m, phase, bm, bn, bk):
        _check_bk(bk)
        key = (impl, autotune_lib._pow2_bucket(m), w.k, w.n, phase)
        bm, bn = _pick_tile("B7", bitplane_lib.TILES, bm, bn, lambda: _tuned(
            key, lambda t: t.lookup(m, w.k, w.n, impl=impl, phase=phase)))
        return bm, bn, gemm_lib.BLOCK_K
    return plan


def _no_blocks(w, m, phase, bm, bn, bk):
    return None, None, None


def _require_2d(w, *leaves):
    for leaf in leaves:
        if leaf.ndim != 2:
            raise ValueError(
                f"{w.format_name} weight has stacked leaves "
                f"{tuple(leaf.shape)}; pass one layer's 2-D weight")


def _prelu(plan: GemmPlan) -> Optional[float]:
    return plan.prelu_alpha if plan.fuse_prelu else None


# --- gradients of the kernel rows --------------------------------------------

class _PackedGemm(torch.autograd.Function):
    """``y = launch(x, scale, bias)`` — a kernel computing ``epilogue(x @ T
    * scale + bias)``, PReLU last when ``prelu_alpha`` is set — with the
    backward of ``repro``'s ``_gemm_2bit`` / ``_gemm_bitplane`` VJPs.
    ``decode(dtype)`` gives the (K, N) {-1, 0, +1} matrix T."""

    @staticmethod
    def forward(ctx, x, scale, bias, launch, decode, prelu_alpha):
        y = launch(x, scale, bias)
        ctx.decode, ctx.prelu_alpha = decode, prelu_alpha
        ctx.save_for_backward(x, scale, bias,
                              y if prelu_alpha is not None else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, y = ctx.saved_tensors
        if ctx.prelu_alpha is not None:
            g = torch.where(y >= 0, g, ctx.prelu_alpha * g)
        gbias = gscale = None
        if bias is not None and ctx.needs_input_grad[2]:
            gbias = g.float().sum(0).to(bias.dtype)
        t = ctx.decode(x.dtype).float()
        if scale is not None:
            if ctx.needs_input_grad[1]:
                gscale = (g.float() * (x.float() @ t)).sum(0).to(scale.dtype)
            g = g * scale.to(g.dtype)
        gx = (g.float() @ t.T).to(x.dtype) if ctx.needs_input_grad[0] \
            else None
        return gx, gscale, gbias, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _kernel_row(x, w, scale, bias, prelu_alpha, launch):
    """Run a kernel row's ``launch(x, scale, bias)`` with its gradient. When
    no input needs one (serving), launch directly: ``Function.apply``
    costs ~10 µs of host time a call and would build no graph anyway."""
    if not _needs_grad(x, scale, bias):
        return launch(x, scale, bias)
    return _PackedGemm.apply(x, scale, bias, launch, w.materialize,
                             prelu_alpha)


# --- 2-bit rows (dense2bit, tiled) -------------------------------------------

@register_kernel("dense2bit", "dense", priority=10,
                 plan_blocks=_blocks_dense)
@register_kernel("tiled", "dense", priority=5, plan_blocks=_blocks_dense)
def _lower_dense(plan, x, w, scale, bias):
    # B1 reads the first n word columns in place (a tiled pack is N-padded)
    _require_2d(w, w.packed)
    if on_card(x):
        return _kernel_row(
            x.contiguous(), w, scale, bias, _prelu(plan),
            lambda x, s, b: gemm_lib.ternary_gemm_cuda(
                x, w.packed, s, b, n=w.n, fuse_prelu=plan.fuse_prelu,
                prelu_alpha=plan.prelu_alpha, block_m=plan.block_m,
                block_n=plan.block_n))
    return gemm_lib.ternary_gemm_ref(x, w.packed[:, :w.n], scale, bias,
                                     fuse_prelu=plan.fuse_prelu,
                                     prelu_alpha=plan.prelu_alpha)


@register_kernel("dense2bit", "ref", plan_blocks=_no_blocks)
@register_kernel("tiled", "ref", plan_blocks=_no_blocks)
def _lower_2bit_ref(plan, x, w, scale, bias):
    _require_2d(w, w.packed)
    return ref.packed2bit_matmul(x, w.packed[:, :w.n], w.k, scale, bias,
                                 _prelu(plan))


def _lower_skip_common(plan, x, w, scale, bias, db):
    args = (w.packed, w.kt_indices, w.kt_counts, scale, bias)
    kw = dict(n=w.n, tile_k=w.tile_k, tile_n=w.tile_n,
              fuse_prelu=plan.fuse_prelu, prelu_alpha=plan.prelu_alpha)
    if on_card(x):
        return _kernel_row(
            x.contiguous(), w, scale, bias, _prelu(plan),
            lambda x, s, b: gemm_lib.ternary_gemm_skip_cuda(
                x, *args[:3], s, b, block_m=plan.block_m, db=db, **kw))
    return gemm_lib.ternary_gemm_skip_ref(x, *args, **kw)


@register_kernel("tiled", "skip_db", priority=12,
                 predicate=lambda w, m, phase:
                     w.occupancy() <= SKIP_OCCUPANCY_CUTOFF,
                 plan_blocks=_blocks_skip_impl("skip_db"))
def _lower_skip_db(plan, x, w, scale, bias):
    # B2's walk with its stages copied by the TMA under mbarriers; bitwise
    # equal to skip and dense on the card
    return _lower_skip_common(plan, x, w, scale, bias, db=True)


@register_kernel("tiled", "skip", priority=10,
                 predicate=lambda w, m, phase:
                     w.occupancy() <= SKIP_OCCUPANCY_CUTOFF,
                 plan_blocks=_blocks_skip_impl("skip"))
def _lower_skip(plan, x, w, scale, bias):
    return _lower_skip_common(plan, x, w, scale, bias, db=False)


# --- bitplane rows ------------------------------------------------------------

def _lower_bitplane_common(plan, x, w, scale, bias, factorized):
    _require_2d(w, w.plus)
    kw = dict(factorized=factorized, fuse_prelu=plan.fuse_prelu,
              prelu_alpha=plan.prelu_alpha)
    if on_card(x):
        return _kernel_row(
            x.contiguous(), w, scale, bias, _prelu(plan),
            lambda x, s, b: bitplane_lib.ternary_gemm_bitplane_cuda(
                x, w.plus, w.minus, s, b, block_m=plan.block_m,
                block_n=plan.block_n, **kw))
    return bitplane_lib.ternary_gemm_bitplane_ref(x, w.plus, w.minus, scale,
                                                  bias, **kw)


@register_kernel("bitplane", "bitplane", priority=10,
                 plan_blocks=_blocks_bitplane("bitplane"))
def _lower_bitplane(plan, x, w, scale, bias):
    return _lower_bitplane_common(plan, x, w, scale, bias, factorized=False)


@register_kernel("bitplane", "bitplane_factorized", priority=5,
                 plan_blocks=_blocks_bitplane("bitplane_factorized"))
def _lower_bitplane_fact(plan, x, w, scale, bias):
    return _lower_bitplane_common(plan, x, w, scale, bias, factorized=True)


@register_kernel("bitplane", "ref", plan_blocks=_no_blocks)
def _lower_bitplane_ref(plan, x, w, scale, bias):
    _require_2d(w, w.plus)
    return ref.bitplane_matmul(x, w.plus, w.minus, w.k, scale, bias,
                               _prelu(plan))


# --- base3 (the paper's value compression; no kernel) -------------------------

@register_kernel("base3", "ref", priority=10, plan_blocks=_no_blocks)
def _lower_base3_ref(plan, x, w, scale, bias):
    _require_2d(w, w.packed)
    return ref.base3_matmul(x, w.packed, w.k, scale, bias, _prelu(plan))


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

def _coerce_weight(w: Any) -> weights.TernaryWeight:
    """Accept only typed containers; name the container a raw operand
    belongs in (``repro``'s hints)."""
    if isinstance(w, weights.TernaryWeight):
        return w
    if isinstance(w, formats.TiledTernary):
        hint = "weights.Tiled.from_tiled(w) or re-pack via weights.pack"
    elif isinstance(w, (tuple, list)) and len(w) == 2:
        hint = "weights.Bitplane.from_planes(plus, minus, k=K)"
    elif getattr(w, "ndim", 0) == 2:
        hint = "weights.Dense2Bit.from_packed(w, k=K)"
    else:
        hint = "repro_torch.core.weights.pack(w, format)"
    raise TypeError(
        f"ternary_gemm does not accept raw weight operands (got "
        f"{type(w).__name__}). Pack into a typed container: {hint}.")


def _validate_k(w: weights.TernaryWeight, x: torch.Tensor,
                k: Optional[int]) -> None:
    if k is not None and k != w.k:
        raise ValueError(
            f"k={k} does not match the {w.format_name} weight's logical "
            f"K={w.k} (shape {w.shape})")
    if x.ndim != 2 or x.shape[1] != w.k:
        raise ValueError(
            f"x {tuple(x.shape)} does not match the {w.format_name} "
            f"weight's logical K={w.k} (shape {w.shape})")


def _check_partition(partition: Optional[str], tp: int) -> Optional[str]:
    if partition not in (None, "k", "n"):
        raise ValueError(f"partition must be 'k', 'n' or None, "
                         f"got {partition!r}")
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    return None if tp == 1 else partition


def _shard_view(w: weights.TernaryWeight, k: int,
                n: int) -> weights.TernaryWeight:
    """``w``'s metadata as one shard's (logical (k, n), nnz in proportion)
    for the predicates and the tuner, which read no payload."""
    if (k, n) == (w.k, w.n):
        return w
    nnz = w.nnz if w.nnz < 0 else round(w.nnz * k * n
                                        / max(w.k * w.n, 1))
    return dataclasses.replace(w, shape=(k, n), nnz=nnz)


def ternary_gemm_plan(w: Any, m: int, *, k: Optional[int] = None,
                      impl: str = "auto",
                      phase: Optional[str] = "__current__",
                      block_m: Optional[int] = None,
                      block_n: Optional[int] = None,
                      block_k: Optional[int] = None,
                      fuse_prelu: bool = False,
                      prelu_alpha: float = 0.25,
                      partition: Optional[str] = None,
                      tp: int = 1) -> GemmPlan:
    """Plan (but do not run) a ternary GEMM of M rows. ``phase`` defaults
    to the ambient ``serving_phase`` scope; ``k``, if given, is checked
    against the container. Reads only host-side pack-time metadata.

    ``partition``/``tp`` plan one shard of a tensor-parallel GEMM
    (``repro``'s fields): ``"k"`` row splits K ``tp`` ways and records the
    ``psum`` its partial products need, ``"n"`` column splits N with no
    collective; ``m``/``k``/``n`` are the shard's, and its blocks are the
    tuner's for the shard's (K, N). Shard boundaries must land on the
    container's pack multiples (``shard_constraints``)."""
    w = _coerce_weight(w)
    if k is not None and k != w.k:
        raise ValueError(
            f"k={k} does not match the {w.format_name} weight's logical "
            f"K={w.k} (shape {w.shape})")
    if phase == "__current__":
        phase = current_phase()
    elif phase is not None and phase not in SERVING_PHASES:
        raise ValueError(f"phase must be one of {SERVING_PHASES} or None, "
                         f"got {phase!r}")
    partition = _check_partition(partition, tp)
    if partition is not None:
        extent, multiple = w.shard_constraints()[partition]
        if extent % (tp * multiple) != 0:
            raise ValueError(
                f"{w.format_name} GEMM: {partition.upper()}-partitioning "
                f"{tp}-way puts shard boundaries every {extent / tp:g} of "
                f"{extent} values — off the {multiple}-value pack multiple; "
                f"repack or choose tp dividing {extent // multiple}")
    occupancy = w.occupancy()
    w = _shard_view(w, w.k // tp if partition == "k" else w.k,
                    w.n // tp if partition == "n" else w.n)
    fmt = w.format_name
    if impl == "auto":
        # ties keep registration order (repro's stable sort)
        cands = sorted((ki for ki in _KERNELS.values() if ki.format == fmt),
                       key=lambda ki: -ki.priority)
        if not cands:
            raise ValueError(f"no kernel registered for format {fmt!r}")
        chosen = next((ki for ki in cands if ki.predicate(w, m, phase)),
                      cands[-1])
    else:
        chosen = _KERNELS.get((fmt, impl))
        if chosen is None:
            avail = sorted(i for f, i in _KERNELS if f == fmt)
            raise ValueError(f"no impl {impl!r} registered for format "
                             f"{fmt!r}; available: {avail}")
    bm, bn, bk = chosen.plan_blocks(w, m, phase, block_m, block_n, block_k)
    return GemmPlan(format=fmt, impl=chosen.impl, m=m, k=w.k, n=w.n,
                    block_m=bm, block_n=bn, block_k=bk, phase=phase,
                    occupancy=occupancy, fuse_prelu=fuse_prelu,
                    prelu_alpha=prelu_alpha, partition=partition,
                    collective="psum" if partition == "k" else None, tp=tp)


def _lower_partial(plan: GemmPlan, x: torch.Tensor,
                   w: weights.TernaryWeight, scale: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor]) -> torch.Tensor:
    """A row-split shard's f32 partial ``x @ T * scale``, ``bias`` left
    for after the all-reduce: B1's f32 form on the ``dense`` row on the
    card; the plain version on the CPU and on the ``ref`` rows. The other
    kernel rows have no f32 form and raise."""
    if on_card(x) and plan.impl == "dense":
        _require_2d(w, w.packed)
        return gemm_lib.ternary_gemm_cuda(
            x.contiguous(), w.packed, scale, n=w.n, block_m=plan.block_m,
            block_n=plan.block_n, out_dtype=torch.float32)
    if on_card(x) and plan.impl != "ref":
        raise NotImplementedError(
            f"the {plan.format}/{plan.impl} row has no f32 partial form: a "
            f"row-split shard runs B1 (dense2bit) or a ref row")
    return ref._epilogue(x.float() @ w.materialize(torch.float32), scale,
                         None, None)


def ternary_gemm(x: torch.Tensor, w: Any,
                 scale: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None, *,
                 k: Optional[int] = None, block_m: Optional[int] = None,
                 block_n: Optional[int] = None, block_k: Optional[int] = None,
                 fuse_prelu: bool = False, prelu_alpha: float = 0.25,
                 impl: str = "auto", partition: Optional[str] = None,
                 tp: int = 1) -> torch.Tensor:
    """Y = X @ decode(w) * scale + bias (+PReLU) for x (M, K). ``w`` is a
    ``TernaryWeight`` (raw operands raise ``TypeError``); ``scale`` and
    ``bias`` default to the container's own. ``impl`` names a registered
    row ("auto" plans by format, occupancy and phase); ``block_*`` must
    agree with the row's kernel tiles.

    ``partition``/``tp``: ``w`` is this rank's shard of a ``tp``-way split
    (``weights.shard_weight``). A ``"k"`` shard returns its f32 partial
    product, the scale applied and no bias (``_lower_partial``), which
    the ranks sum before the bias and the cast; an ``"n"`` shard runs as
    any container. The plan records the collective."""
    w = _coerce_weight(w)
    _validate_k(w, x, k)
    partition = _check_partition(partition, tp)
    scale = w.scale if scale is None else scale
    bias = w.bias if bias is None else bias
    if partition == "k" and (fuse_prelu or bias is not w.bias):
        raise ValueError("a row-split shard's partial takes no bias or "
                         "PReLU: they follow the all-reduce")
    # the plan is a function of these (the registry and the tuner fixed),
    # so a repeated dispatch takes it from the weight's memo
    key = (x.shape[0], current_phase(), impl, block_m, block_n, block_k,
           fuse_prelu, prelu_alpha, partition, tp, _REGISTRY_VERSION[0],
           autotune_lib._GLOBAL)
    memo = _PLANS.get(w)
    if memo is None:
        memo = _PLANS[w] = {}
    plan = memo.get(key)
    if plan is None:
        plan = ternary_gemm_plan(
            w, x.shape[0], impl=impl, block_m=block_m, block_n=block_n,
            block_k=block_k, fuse_prelu=fuse_prelu, prelu_alpha=prelu_alpha)
        if partition is not None:
            plan = dataclasses.replace(
                plan, partition=partition, tp=tp,
                collective="psum" if partition == "k" else None)
        memo[key] = plan
    lower = (_lower_partial if plan.collective == "psum"
             else _KERNELS[(plan.format, plan.impl)].lower)
    return _dispatch(plan, f"ternary_gemm[{plan.format}/{plan.impl} "
                     f"m={plan.m} k={plan.k} n={plan.n}]", x,
                     lambda: lower(plan, x, w, scale, bias))


# ---------------------------------------------------------------------------
# Plans warmed at engine build
# ---------------------------------------------------------------------------

def _phase_ms(prefill_ms, decode_ms, verify_ms, chunk_ms):
    return (("prefill", prefill_ms), ("decode", decode_ms),
            ("verify", verify_ms), ("chunk", chunk_ms))


def _weight_leaves(node, path=()):
    """``(path, TernaryWeight)`` in ``jax.tree_util``'s flatten order (dict
    keys sorted, lists in order), so leaf indices match ``repro``'s on a
    tree of the same shape."""
    if isinstance(node, weights.TernaryWeight):
        yield path, node
    elif isinstance(node, dict):
        for key in sorted(node):
            yield from _weight_leaves(node[key], path + (key,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _weight_leaves(v, path + (i,))


def precompute_plans(params, *, prefill_ms=(), decode_ms=(), verify_ms=(),
                     chunk_ms=(), select: Optional[Callable] = None,
                     impl: str = "auto", shard: Optional[Callable] = None,
                     ) -> Dict[Tuple[Any, ...], GemmPlan]:
    """Plan every (weight, M, phase) the serving loop will dispatch, keyed
    ``(leaf index, m, phase)`` as ``repro``'s are. ``select(path, w)``
    filters the containers (``path`` the tuple of dict keys and list
    indices down to the leaf); ``impl`` should be the row the apply path
    dispatches. ``shard(path, w) -> (partition, tp)`` (a rank's tree under
    tensor parallelism, ``distributed.tp.gemm_shard_fn``): each container
    is that rank's shard, planned as the shard it is with its collective
    recorded — the plan ``repro`` makes from the whole weight with
    ``partition=``/``tp=``."""
    ws = [(path, w) for path, w in _weight_leaves(params)
          if select is None or select(path, w)]
    plans: Dict[Tuple[Any, ...], GemmPlan] = {}
    for i, (path, w) in enumerate(ws):
        part, ntp = shard(path, w) if shard is not None else (None, 1)
        part = _check_partition(part, ntp)
        for phase, ms in _phase_ms(prefill_ms, decode_ms, verify_ms,
                                   chunk_ms):
            for m in ms:
                plan = ternary_gemm_plan(w, m, impl=impl, phase=phase)
                if part is not None:
                    plan = dataclasses.replace(
                        plan, partition=part, tp=ntp,
                        collective="psum" if part == "k" else None)
                plans[(i, m, phase)] = plan
    return plans


# ---------------------------------------------------------------------------
# The fused-MLP registry
# ---------------------------------------------------------------------------

# The formats B4 reads in place (repro's _FUSED_FORMATS); every other
# format, and stacked leaves, take the chain of ternary_gemm calls.
FUSED_FORMATS = ("dense2bit", "tiled")


@dataclasses.dataclass(frozen=True)
class FusedMlpPlan:
    """Dispatch decision for one fused MLP block (``repro``'s fields but
    the TPU-only ``interpret`` and the tensor-parallel ones). ``impl`` is a
    registered row: ``"pallas"`` (B4 on the card, its plain version on the
    CPU) or ``"chain"`` (one ``ternary_gemm`` per projection). The
    ``"pallas"`` row's blocks are the B4 tile that the tuner's fused entry
    names (``fused_mlp.tile_for``): ``block_m`` rows, strips of
    ``block_n1`` ff and ``block_n2`` output columns, K stepped by
    ``block_k1`` / ``block_k2``; the chain's are ``None``, as in
    ``repro``."""

    impl: str
    format_up: str
    format_down: str
    m: int
    k: int
    ff: int
    n: int
    gated: bool
    activation: str
    block_m: Optional[int]
    block_n1: Optional[int]
    block_k1: Optional[int]
    block_n2: Optional[int]
    block_k2: Optional[int]
    phase: Optional[str]
    occupancy_up: float
    occupancy_down: float
    collective: Optional[str] = None     # None | "psum"
    tp: int = 1

    def sub_plans(self) -> Tuple[GemmPlan, GemmPlan]:
        """The two chained ``GemmPlan``s this fusion replaces (the gate
        shares the up plan): the roofline's baseline."""
        up = GemmPlan(format=self.format_up, impl="dense", m=self.m,
                      k=self.k, n=self.ff, block_m=self.block_m,
                      block_n=self.block_n1, block_k=self.block_k1,
                      phase=self.phase, occupancy=self.occupancy_up,
                      partition="n" if self.tp > 1 else None, tp=self.tp)
        down = GemmPlan(format=self.format_down, impl="dense", m=self.m,
                        k=self.ff, n=self.n, block_m=self.block_m,
                        block_n=self.block_n2, block_k=self.block_k2,
                        phase=self.phase, occupancy=self.occupancy_down,
                        partition="k" if self.tp > 1 else None,
                        collective=self.collective, tp=self.tp)
        return up, down

    def roofline(self) -> Dict[str, Any]:
        """``repro``'s fused vs unfused roofline with the H100's constants:
        the chain's device-memory traffic (both GEMMs and the hidden
        activation's round trip), the fused kernel's (x and each weight
        once per M tile, h never leaves the SM), and the modelled speedup."""
        up, down = self.sub_plans()
        n_up = 2 if self.gated else 1
        unfused_bytes = n_up * up.traffic()["bytes"] \
            + down.traffic()["bytes"]
        bm = self.block_m or 128
        mp = -(-self.m // bm) * bm
        m_tiles = mp // bm
        k1p = -(-self.k // (self.block_k1 or 256)) * (self.block_k1 or 256)
        ff1 = -(-self.ff // (self.block_n1 or 128)) * (self.block_n1 or 128)
        k2p = -(-self.ff // (self.block_k2 or 256)) * (self.block_k2 or 256)
        n2p = -(-self.n // (self.block_n2 or 128)) * (self.block_n2 or 128)
        w_up = (k1p // formats.K_PER_WORD) * ff1 * 4
        w_down = (k2p // formats.K_PER_WORD) * n2p * 4
        fused_bytes = float(
            mp * k1p * 2                        # x: once per M tile
            + m_tiles * (n_up * w_up + w_down)  # weights streamed per tile
            + mp * n2p * 2)                     # the output's write
        nf1 = ff1 // (self.block_n1 or 128)
        nf2 = n2p // (self.block_n2 or 128)
        t_fused = (fused_bytes / autotune_lib.HBM_BW
                   + m_tiles * (nf1 + nf2) * autotune_lib.STEP_OVERHEAD_S)
        tuner = autotune_lib.Autotuner()
        t_unfused = n_up * tuner._model_score(
            autotune_lib.BlockConfig(bm, self.block_n1 or 128,
                                     self.block_k1 or 256),
            self.m, self.k, self.ff, 1.0) \
            + tuner._model_score(
                autotune_lib.BlockConfig(bm, self.block_n2 or 128,
                                         self.block_k2 or 256),
                self.m, self.ff, self.n, 1.0)
        flops = 2.0 * self.m * self.ff * (n_up * self.k + self.n)
        ai = flops / max(fused_bytes, 1.0)
        ceiling = min(autotune_lib.PEAK_FLOPS, ai * autotune_lib.HBM_BW)
        achieved = flops / max(t_fused, 1e-12)
        return {"flops": flops,
                "bytes": fused_bytes,
                "unfused_bytes": float(unfused_bytes),
                "collective": self.collective,
                "collective_bytes": down.traffic()["collective_bytes"],
                "tp": self.tp,
                "arithmetic_intensity": ai,
                "ceiling_flops": ceiling,
                "achieved_flops": achieved,
                "peak_flops": autotune_lib.PEAK_FLOPS,
                "model_time_s": t_fused,
                "unfused_model_time_s": t_unfused,
                "fused_speedup": t_unfused / max(t_fused, 1e-12),
                "headroom": max(0.0, 1.0 - achieved / max(ceiling, 1.0)),
                "bound": ("memory" if ceiling < autotune_lib.PEAK_FLOPS
                          else "compute")}


@dataclasses.dataclass(frozen=True)
class FusedImpl:
    """One registered fused-MLP lowering: ``predicate(w_in, w_out, w_gate,
    m, phase)`` gates ``impl="auto"``, ``fn(plan, x, w_in, w_out,
    w_gate)`` runs."""

    impl: str
    priority: int
    predicate: Callable[..., bool]
    fn: Callable


_FUSED: Dict[str, FusedImpl] = {}


def register_fused(impl: str, *, priority: int = 0,
                   predicate: Optional[Callable] = None):
    """Decorator registering a fused-MLP lowering under ``impl``; the
    highest-priority admissible row wins ``impl="auto"``."""

    def deco(fn):
        _REGISTRY_VERSION[0] += 1
        _FUSED[impl] = FusedImpl(impl=impl, priority=priority,
                                 predicate=predicate or (lambda *a: True),
                                 fn=fn)
        return fn

    return deco


def fused_registry() -> Dict[str, FusedImpl]:
    """Snapshot of the registered fused-MLP rows."""
    return dict(_FUSED)


def _fusable(w_in, w_out, w_gate, m: int, phase: Optional[str]) -> bool:
    """``repro``'s fused-row predicate: every projection a 2-D pack of a
    fused format, and a gate of the up projection's shape whose own plan
    under ``phase`` resolves the up projection's K/N blocks."""
    for w in (w_in, w_out) + (() if w_gate is None else (w_gate,)):
        if w.format_name not in FUSED_FORMATS or w.packed.ndim != 2:
            return False
    if w_gate is not None:
        if (w_gate.k, w_gate.n) != (w_in.k, w_in.n):
            return False
        up = ternary_gemm_plan(w_in, m, phase=phase)
        gate = ternary_gemm_plan(w_gate, m, phase=phase)
        if (up.block_n, up.block_k) != (gate.block_n, gate.block_k):
            return False
    return True


def _fused_operands(w_in, w_out, w_gate):
    """Coerce the containers and check that they chain (``repro``'s
    messages)."""
    w_in, w_out = _coerce_weight(w_in), _coerce_weight(w_out)
    if w_gate is not None:
        w_gate = _coerce_weight(w_gate)
        if (w_gate.k, w_gate.n) != (w_in.k, w_in.n):
            raise ValueError(f"gate shape {w_gate.shape} must match the up "
                             f"projection's {w_in.shape}")
    if w_out.k != w_in.n:
        raise ValueError(f"down projection expects K={w_in.n} (the up "
                         f"projection's N) but encodes K={w_out.k}")
    return w_in, w_out, w_gate


def fused_mlp_plan(w_in: Any, w_out: Any, w_gate: Any = None, *, m: int,
                   impl: str = "auto", activation: str = "silu",
                   phase: Optional[str] = "__current__",
                   tp: int = 1) -> FusedMlpPlan:
    """Plan (but do not run) a fused MLP block of M rows: ``impl="auto"``
    takes the highest-priority row whose predicate admits the containers
    under ``phase`` (by default the ambient scope's). ``tp > 1`` plans one
    Megatron-MLP shard of the whole containers (``repro``'s rule): the
    hidden dimension column split on the way up and row split on the way
    down, ``ff`` the shard's, with the trailing ``psum``."""
    w_in, w_out, w_gate = _fused_operands(w_in, w_out, w_gate)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp > 1:
        for which, wgt, dim in (("up N", w_in, "n"), ("down K", w_out, "k")):
            extent, multiple = wgt.shard_constraints()[dim]
            if extent % (tp * multiple) != 0:
                raise ValueError(
                    f"fused_mlp: {tp}-way TP splits the {which} axis every "
                    f"{extent / tp:g} of {extent} values — off the "
                    f"{multiple}-value pack multiple of {wgt.format_name}")
        ff = w_in.n // tp
        w_in = _shard_view(w_in, w_in.k, ff)
        w_out = _shard_view(w_out, ff, w_out.n)
        if w_gate is not None:
            w_gate = _shard_view(w_gate, w_gate.k, ff)
    if activation not in fused_lib.ACTIVATIONS:
        raise ValueError(f"activation must be one of "
                         f"{fused_lib.ACTIVATIONS}, got {activation!r}")
    if phase == "__current__":
        phase = current_phase()
    if impl == "auto":
        cands = sorted(_FUSED.values(), key=lambda fi: -fi.priority)
        chosen = next((fi for fi in cands
                       if fi.predicate(w_in, w_out, w_gate, m, phase)),
                      cands[-1])
    else:
        chosen = _FUSED.get(impl)
        if chosen is None:
            raise ValueError(f"no fused-MLP impl {impl!r} registered; "
                             f"available: {sorted(_FUSED)}")
    bm = bn = bk = None
    if chosen.impl == "pallas":
        # repro's composition: the fused key pinned to the chain plans'
        # tiles; the composed block_m names B4's tile
        up = ternary_gemm_plan(w_in, m, phase=phase)
        down = ternary_gemm_plan(w_out, m, phase=phase)
        occ_up, occ_down = w_in.occupancy(), w_out.occupancy()
        pins = (up.block_n, up.block_k, down.block_n, down.block_k)
        key = ("fused", autotune_lib._pow2_bucket(m), w_in.k, w_in.n,
               w_out.n, autotune_lib._sparsity_bucket(occ_up),
               autotune_lib._sparsity_bucket(occ_down), pins, phase)
        cfg = _tuned(key, lambda t: t.lookup_fused(
            m, w_in.k, w_in.n, w_out.n, sparsity_up=occ_up,
            sparsity_down=occ_down, fixed_n1=pins[0], fixed_k1=pins[1],
            fixed_n2=pins[2], fixed_k2=pins[3], phase=phase))
        bm, bn = fused_lib.tile_for(cfg.block_m)
        bk = gemm_lib.BLOCK_K
    return FusedMlpPlan(
        impl=chosen.impl, format_up=w_in.format_name,
        format_down=w_out.format_name, m=m, k=w_in.k, ff=w_in.n, n=w_out.n,
        gated=w_gate is not None, activation=activation, block_m=bm,
        block_n1=bn, block_k1=bk, block_n2=bn, block_k2=bk, phase=phase,
        occupancy_up=w_in.occupancy(), occupancy_down=w_out.occupancy(),
        collective="psum" if tp > 1 else None, tp=tp)


def _lower_fused_pallas(plan, x, w_in, w_out, w_gate):
    """B4 on a CUDA tensor, reading the words in place; its plain version
    (the chain of plain GEMMs) on a CPU tensor. Only 2-D packs of
    ``FUSED_FORMATS`` reach it. A tensor-parallel shard's plan
    (``collective="psum"``) takes B4's f32 form: no output bias."""
    g = w_gate
    ff, n = w_in.n, w_out.n
    partial = plan.collective == "psum"
    out_dtype = torch.float32 if partial else torch.bfloat16
    if on_card(x):
        words = (w_in.packed, w_out.packed, None if g is None else g.packed)
        if partial:
            vecs = (w_in.scale, w_in.bias, None if g is None else g.scale,
                    None if g is None else g.bias, w_out.scale, None)
            return fused_lib.fused_mlp_cuda(
                x.contiguous(), *words, *vecs, ff=ff, n=n,
                activation=plan.activation, block_m=plan.block_m,
                strip=plan.block_n1, out_dtype=out_dtype)
        return _fused_row(
            x.contiguous(), w_in, w_out, w_gate, plan.activation,
            lambda x, *vecs: fused_lib.fused_mlp_cuda(
                x, *words, *vecs, ff=ff, n=n, activation=plan.activation,
                block_m=plan.block_m, strip=plan.block_n1))
    words = (w_in.packed[:, :ff], w_out.packed[:, :n],
             None if g is None else g.packed[:, :ff])
    vecs = (w_in.scale, w_in.bias, None if g is None else g.scale,
            None if g is None else g.bias, w_out.scale,
            None if partial else w_out.bias)
    return fused_lib.fused_mlp_ref(x, *words, *vecs,
                                   activation=plan.activation,
                                   out_dtype=out_dtype if partial else None)


def _lower_fused_chain(plan, x, w_in, w_out, w_gate):
    """The literal chain of ``ternary_gemm`` calls (``repro``'s
    ``_lower_fused_chain``): each projection rounds to ``x.dtype``, then
    the activation and the product in ``x.dtype``, then the down
    projection. On the card each GEMM launches its format's kernel. It
    covers every format B4 does not."""
    yi = ternary_gemm(x, w_in)
    if w_gate is not None:
        h = fused_lib._act(plan.activation, ternary_gemm(x, w_gate)) * yi
    else:
        h = fused_lib._act(plan.activation, yi)
    if plan.collective == "psum":
        return ternary_gemm(h, w_out, partition="k", tp=plan.tp)
    return ternary_gemm(h, w_out)


register_fused("pallas", priority=10, predicate=_fusable)(
    _lower_fused_pallas)
register_fused("chain", priority=0)(_lower_fused_chain)


def fused_mlp(x: torch.Tensor, w_in: Any, w_out: Any, w_gate: Any = None,
              *, activation: str = "silu", impl: str = "auto", tp: int = 1
              ) -> torch.Tensor:
    """Fused ternary MLP block ``act(x @ Wg) * (x @ Wi) @ Wo`` (gate
    optional), each projection's scale and bias from its container.
    ``impl`` names a registered row; ``"auto"`` fuses ``dense2bit`` and
    ``tiled`` packs (``"pallas"``: B4 on the card, its plain version on the
    CPU) and sends every other format to ``"chain"``, as in ``repro``.
    ``tp > 1``: the containers are this rank's shards of a ``tp``-way
    Megatron MLP (up and gate column split, down row split); the result
    is the f32 partial, the down projection's scale applied and not its
    bias, for the caller's all-reduce."""
    w_in, w_out, w_gate = _fused_operands(w_in, w_out, w_gate)
    if x.ndim != 2 or x.shape[1] != w_in.k:
        raise ValueError(f"x {tuple(x.shape)} does not match the up "
                         f"projection's K={w_in.k}")
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    key = (x.shape[0], current_phase(), impl, activation, tp,
           _REGISTRY_VERSION[0], autotune_lib._GLOBAL)
    memo = _PLANS.get(w_in)
    if memo is None:
        memo = _PLANS[w_in] = {}
    hit = memo.get(("fused",) + key)
    if hit is None or hit[1] is not w_out or hit[2] is not w_gate:
        plan = fused_mlp_plan(w_in, w_out, w_gate, m=x.shape[0], impl=impl,
                              activation=activation)
        if tp > 1:
            plan = dataclasses.replace(plan, collective="psum", tp=tp)
        hit = memo[("fused",) + key] = (plan, w_out, w_gate)
    plan = hit[0]
    lower = _FUSED[plan.impl].fn
    return _dispatch(plan, f"fused_mlp[{plan.impl} m={plan.m} k={plan.k} "
                     f"ff={plan.ff}]", x,
                     lambda: lower(plan, x, w_in, w_out, w_gate))


def _mlp_containers(node):
    """The packed (in, out, gate) of an MLP-shaped dict, or None."""
    def packed(name):
        p = node.get(name)
        w = p.get("w_packed") if isinstance(p, dict) else None
        return w if isinstance(w, weights.TernaryWeight) else None

    wi, wo = packed("in"), packed("out")
    if wi is None or wo is None or wo.k != wi.n:
        return None
    return wi, wo, packed("gate"), node["out"].get("tp") == "k"


def precompute_fused_plans(params, *, prefill_ms=(), decode_ms=(),
                           verify_ms=(), chunk_ms=(), impl: str = "auto",
                           tp: int = 1) -> Dict[Tuple[Any, ...], FusedMlpPlan]:
    """Plan every MLP-shaped subtree (a dict with packed ``"in"`` /
    ``"out"`` and optionally ``"gate"`` linears) at every (M, phase),
    keyed ``(block index, m, phase)`` as ``repro``'s are; the blocks in
    the order of a walk over dict values and list items. ``tp > 1``: a
    rank's tree, whose MLPs with a row-split ``"out"`` (its ``"tp"`` mark
    ``"k"``) are shards, planned as the shards they are with the
    ``psum`` recorded; the rest plan whole."""
    found = []

    def walk(node):
        if isinstance(node, dict):
            mlp = _mlp_containers(node)
            if mlp is not None:
                found.append(mlp)
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(params)
    plans: Dict[Tuple[Any, ...], FusedMlpPlan] = {}
    for i, (wi, wo, wg, sharded) in enumerate(found):
        for phase, ms in _phase_ms(prefill_ms, decode_ms, verify_ms,
                                   chunk_ms):
            for m in ms:
                plan = fused_mlp_plan(wi, wo, wg, m=m, impl=impl,
                                      phase=phase)
                if sharded and tp > 1:
                    plan = dataclasses.replace(plan, collective="psum",
                                               tp=tp)
                plans[(i, m, phase)] = plan
    return plans


def _fused_row(x, w_in, w_out, w_gate, activation, launch):
    """Run the fused kernel's ``launch(x, si, bi, sg, bg, so, bo)`` with
    its gradient (``_FusedMlp``), or directly when none is needed."""
    g = w_gate
    vecs = (w_in.scale, w_in.bias, None if g is None else g.scale,
            None if g is None else g.bias, w_out.scale, w_out.bias)
    if not _needs_grad(x, *vecs):
        return launch(x, *vecs)

    def decode(dtype):
        return tuple(None if c is None else c.materialize(dtype)
                     for c in (w_in, w_gate, w_out))

    return _FusedMlp.apply(x, launch, decode, activation, *vecs)


class _FusedMlp(torch.autograd.Function):
    """The fused kernel's forward with the backward of ``repro``'s
    ``_fused_2bit`` VJP: the gradient of the decoded float chain
    ``epi(x @ Ti) [* act(epi(x @ Tg))] -> h in x.dtype -> epi(h @ To)``
    (f32 products and epilogues), taken by autograd on a recomputation.
    The six vectors are (si, bi, sg, bg, so, bo); ``None`` where absent."""

    @staticmethod
    def forward(ctx, x, launch, decode, activation, *vecs):
        ctx.decode, ctx.activation = decode, activation
        ctx.save_for_backward(x, *vecs)
        return launch(x, *vecs)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors                # x, then the vectors
        ti, tg, to = ctx.decode(inputs[0].dtype)
        needs = ctx.needs_input_grad[:1] + ctx.needs_input_grad[4:]
        wanted = [i for i, (t, need) in enumerate(zip(inputs, needs))
                  if t is not None and need]
        leaves = [None if t is None else t.detach().requires_grad_(i in wanted)
                  for i, t in enumerate(inputs)]
        with torch.enable_grad():
            y = _fused_chain(leaves[0], ti, tg, to, *leaves[1:],
                             activation=ctx.activation)
            grads = torch.autograd.grad(y, [leaves[i] for i in wanted], g)
        out = [None] * 7
        for i, gr in zip(wanted, grads):
            out[i] = gr
        return (out[0], None, None, None, *out[1:])


def _fused_chain(x, ti, tg, to, si, bi, sg, bg, so, bo, *, activation):
    """The float chain ``repro``'s fused-MLP VJP differentiates."""
    def epi(y, s, b):
        if s is not None:
            y = y * s.reshape(1, -1).to(y.dtype)
        if b is not None:
            y = y + b.reshape(1, -1).to(y.dtype)
        return y

    yi = epi(x.float() @ ti.float(), si, bi)
    if tg is not None:
        h = fused_lib._act(activation, epi(x.float() @ tg.float(), sg, bg)) \
            * yi
    else:
        h = fused_lib._act(activation, yi)
    h = h.to(x.dtype)
    return epi(h.float() @ to.float(), so, bo).to(x.dtype)


# ---------------------------------------------------------------------------
# The paged-attention registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PagedAttnImpl:
    """One registered paged decode-attention lowering:
    ``predicate(q, k_pages, v_pages, block_table, lengths)`` gates
    ``impl="auto"``, ``fn(q, k_pages, v_pages, block_table, lengths, *,
    window)`` runs."""

    impl: str
    priority: int
    predicate: Callable[..., bool]
    fn: Callable


_PAGED_ATTN: Dict[str, PagedAttnImpl] = {}


def register_paged_attn(impl: str, *, priority: int = 0,
                        predicate: Optional[Callable] = None):
    """Decorator registering a paged decode-attention lowering under
    ``impl``; the highest-priority admissible row wins ``impl="auto"``."""

    def deco(fn):
        _PAGED_ATTN[impl] = PagedAttnImpl(
            impl=impl, priority=priority,
            predicate=predicate or (lambda *a, **k: True), fn=fn)
        return fn

    return deco


def _ensure_paged_impls() -> None:
    # the rows register when repro_torch.paging.kernels is imported; it is
    # imported here, lazily, so that this module stays importable without
    # the paging package (which imports the models, which import this)
    import repro_torch.paging.kernels  # noqa: F401


def paged_attention_registry() -> Dict[str, PagedAttnImpl]:
    """Snapshot of the registered paged-attention rows: ``"pallas"`` (B5)
    and ``"jax"`` (the gather and the dense decode's attention lines)."""
    _ensure_paged_impls()
    return dict(_PAGED_ATTN)


def paged_decode_attention(q: torch.Tensor, k_pages, v_pages,
                           block_table: torch.Tensor, lengths: torch.Tensor,
                           *, window: int = 0,
                           impl: str = "auto") -> torch.Tensor:
    """Decode attention over block-table-indexed KV pages: q (B, H, hd);
    k_pages/v_pages (P, ps, KV, hd) tensors or ``paging.Int8Pages``;
    block_table (B, T) int32; lengths (B,) int32 valid-token counts (the
    current token included). Returns (B, H, hd) in q's dtype. ``impl``
    names a registered row; ``"auto"`` takes B5 for q on the card and the
    gather (``"jax"``) for q on the CPU."""
    _ensure_paged_impls()
    if impl == "auto":
        cands = sorted(_PAGED_ATTN.values(), key=lambda pi: -pi.priority)
        chosen = next((pi for pi in cands
                       if pi.predicate(q, k_pages, v_pages, block_table,
                                       lengths)), cands[-1])
    else:
        chosen = _PAGED_ATTN.get(impl)
        if chosen is None:
            raise ValueError(f"no paged-attention impl {impl!r} registered; "
                             f"available: {sorted(_PAGED_ATTN)}")
    return chosen.fn(q, k_pages, v_pages, block_table, lengths,
                     window=window)
