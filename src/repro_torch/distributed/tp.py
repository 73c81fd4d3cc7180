"""Tensor parallelism over ``torch.distributed``, serving and training
(the port's counterpart of ``repro.distributed.tp``).

``repro`` is single-controller GSPMD: it places the whole parameter tree
on a ``("model",)`` mesh by its logical specs and XLA inserts the
all-reduce after each row-split projection. PyTorch has no GSPMD, so the
port runs Megatron-style tensor parallelism explicitly, one process per
rank:

* ``shard_params`` keeps one rank's slices: the q/k/v, up and gate
  projections column split (each rank computes its own heads and ff
  columns, no collective), o and down row split (each rank's f32 partial
  product is summed by an all-reduce, then the bias, then the cast, where
  XLA does the same for ``repro``'s f32 ``psum``), the lm head column
  split with its logits all-gathered, so every rank sees the same argmax,
  and the embedding table split by vocabulary rows where tp divides them
  (``repro``'s ``P(MODEL, FSDP)``): a rank looks up the tokens in its
  rows, zeros for the rest, and an all-reduce sums the ranks' rows (one
  nonzero term a row: exact in any dtype); a tied model's logits are its
  rows' columns, all-gathered. Norms and rope stay whole on every rank.
  Packed containers are sliced by ``weights.shard_weight`` after
  ``validate_spec_twin``;
* the head rule (``attention_split``), ``repro``'s resolution over whole
  heads: the query heads (padded ones counted) split contiguously where
  tp divides them; the K/V heads split too where tp divides them, and
  where their count divides tp each rank keeps the one K/V head its query
  heads read (``repro`` groups query heads contiguously: head i reads K/V
  head i // g), that head's k/v columns held again by tp / KV ranks
  (``kv_heads``; marked ``("kv", KV, tp)``), whose partial gradients are
  summed over those ranks (``reduce_head_grads``). Where tp does not
  divide the query heads but every K/V group of g heads has at least its
  tp / KV ranks, each group's heads split over its ranks by whole heads,
  the larger shares first (``query_heads``: deepseek-coder-33b's 7 a
  group 4 + 3 at tp 16); q's columns and o's rows are then the rank's
  head range (marked ``("qo", part, H, KV, tp)``, cut by
  ``weights.shard_range``). Otherwise attention stays whole on every
  rank, where ``repro``'s resolver would still split a q or K/V
  projection whose width divides (ROADMAP C15);
* the other families, as ``repro`` resolves their specs: a MoE layer's
  banks by whole experts where tp divides E (``"expert"`` -> ``"model"``),
  else by every expert's d_ff (w_in and w_gate columns, w_out rows), the
  router whole and routing computed on the replicated activations on
  every rank (``moe_split``; one f32 all-reduce of the layer's output);
  a Mamba2 mixer by SSM heads where tp divides them (``ssm_split``): a
  rank's in_proj columns are its heads' z, x and dt and all of B and C
  (``ssm_columns``, re-packed by ``weights.select_columns``; ``repro``'s
  GSPMD splits the concatenation contiguously instead, C18), its conv
  channels and per-head vectors with them, out_proj by rows, and the
  gated norm's sum of squares all-reduced; else the mixer stays whole;
* ``local_config``: a rank's model is the config with its local head
  counts (its own where the heads split unevenly; and a
  ``ShardConfig``'s local d_inner where SSM mixers split),
  so attention, caches and page pools hold the local KV heads and SSM
  rows (``device_put_cache``'s placement);
* ``Group``: a rank's process group — the data collectives (all-reduce,
  all-gather) on NCCL where each rank has a card of its own and on gloo
  otherwise (on the CPU, and where ranks share one card: NCCL refuses two
  ranks on a device), plus a gloo group of control messages;
  ``bound(group)`` makes it the current group of a model call;
* ``start_followers``: the engine's leader (rank 0) spawns ranks
  1..tp-1 as processes running ``ContinuousScheduler.follow()``, which
  repeat the leader's device steps on their shards (the leader/follower
  protocol of ``serving.engine``).

Training (``launch.train.DistTrainer``) shards latent params with
``shard_params(..., latent=True)`` and keeps the marks apart from the
trees the optimizer walks (``strip_marks`` / ``attach_marks``;
``split_mask``, ``shard_tree`` and ``gather_tree`` for norms, AdamW's
moments and checkpoints); its collectives are differentiable —
Megatron's f/g pair and the gather (``copy_to_group``,
``reduce_from_group``, ``gather_from_group``), which are serving's
in-place collectives where no gradient is taken, ``sum_over_group``
(summed both ways: the SSM norm's statistic),
``reduce_grad_columns`` (the replicated B and C columns' partial
gradients summed) and ``reduce_head_grads`` (a K/V head's partial
gradients summed over the ranks that hold it).

Serving topology is dp x tp, as ``repro``'s: ``replica_meshes`` carves
``dp`` disjoint tp-sized ``("model",)`` meshes out of a device list, one
per engine replica, and ``distributed.router.Router`` places requests
across them.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import types
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import formats, weights
from repro_torch.distributed import sharding

__all__ = ["Mesh", "parse_mesh", "replica_meshes", "validate_param_specs",
           "shard_params", "cache_sharding", "replicated_sharding",
           "device_put_cache", "mesh_axis_sizes", "gemm_shard_fn",
           "attention_split", "local_config", "Group", "bound",
           "current_group", "start_followers", "copy_to_group",
           "reduce_from_group", "gather_from_group", "strip_marks",
           "attach_marks", "split_mask", "shard_tree", "gather_tree",
           "spawn_ranks", "keep_spares", "ShardConfig", "ssm_split",
           "moe_split", "ssm_columns", "ssm_replicated", "sum_over_group",
           "reduce_grad_columns", "kv_heads", "is_head_mark",
           "reduce_head_grads", "vocab_split", "head_replicas",
           "query_heads", "mark_part", "whole_extent"]

MODEL = sharding.MODEL


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named grid of ranks: ``axis_names`` and ``sizes`` (row-major),
    ``devices`` one per rank (``"cuda:i"`` or ``"cpu"``; a device may
    repeat). ``shape`` maps names to sizes, as a ``jax.sharding.Mesh``'s
    does. ``timeout_s`` bounds every collective of its groups."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[str, ...]
    timeout_s: float = 600.0

    def __post_init__(self):
        n = 1
        for s in self.sizes:
            n *= s
        if len(self.axis_names) != len(self.sizes) or n != len(self.devices):
            raise ValueError(f"mesh {dict(zip(self.axis_names, self.sizes))}"
                             f" needs {n} devices, got {len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return self.shape.get(MODEL, 1)

    @property
    def backend(self) -> str:
        """``"nccl"`` when every rank has a card of its own, else
        ``"gloo"``."""
        cuda = all(d.startswith("cuda") for d in self.devices)
        return "nccl" if cuda and len(set(self.devices)) == len(
            self.devices) else "gloo"


def parse_mesh(arg: str) -> Tuple[int, int]:
    """``"dp,tp"`` -> (dp, tp). A bare ``"tp"`` means dp=1."""
    parts = [p.strip() for p in str(arg).split(",") if p.strip()]
    if len(parts) == 1:
        parts = ["1"] + parts
    if len(parts) != 2:
        raise ValueError(f"--mesh expects 'dp,tp', got {arg!r}")
    dp, tp = (int(p) for p in parts)
    if dp < 1 or tp < 1:
        raise ValueError(f"--mesh sizes must be >= 1, got dp={dp} tp={tp}")
    return dp, tp


def _default_devices() -> List[str]:
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def replica_meshes(dp: int, tp: int, devices: Optional[Sequence] = None,
                   *, timeout_s: float = 600.0) -> List[Mesh]:
    """``dp`` disjoint single-axis ``("model",)`` meshes of ``tp`` devices
    each, one per data-parallel engine replica: replica r owns devices
    ``[r*tp, (r+1)*tp)`` of ``devices`` (default: every card). Raises
    when there are fewer than dp*tp devices. ``devices=["cuda:0"] * n``
    puts n ranks on one card (over gloo), as ``repro``'s tests force host
    devices."""
    devices = [str(d) for d in (_default_devices() if devices is None
                                else devices)]
    need = dp * tp
    if len(devices) < need:
        raise ValueError(
            f"mesh dp={dp} x tp={tp} needs {need} devices, have "
            f"{len(devices)} — pass devices= to put several ranks on one "
            f"card or on the CPU")
    return [Mesh((MODEL,), (tp,), tuple(devices[r * tp:(r + 1) * tp]),
                 timeout_s=timeout_s) for r in range(dp)]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(getattr(mesh, "shape", mesh))


# ---------------------------------------------------------------------------
# The rank's process group
# ---------------------------------------------------------------------------

class Group:
    """One rank's view of a process group: ``all_reduce`` (sum, in place),
    ``all_gather`` and ``reduce_scatter`` of tensors on the rank's device
    over the data group, ``send`` (rank 0) / ``recv`` (the others) of picklable control
    messages and ``gather_objects`` over a gloo group. ``calls`` and
    ``bytes`` count the data collectives and the bytes this rank puts in;
    with ``timed`` set, each is bracketed by device synchronizations and
    its host wall added to ``seconds``."""

    def __init__(self, rank: int, size: int, data, ctrl, backend: str):
        self.rank, self.size, self.backend = rank, size, backend
        self._data, self._ctrl = data, ctrl
        self.calls, self.bytes, self.seconds = 0, 0, 0.0
        self.timed = False

    def _run(self, t: torch.Tensor, op):
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        if not self.timed:
            return op()
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = op()
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.seconds += time.perf_counter() - t0
        return out

    @classmethod
    def join(cls, store_path: str, rank: int, size: int, backend: str,
             timeout_s: float) -> "Group":
        """Rendezvous through a ``FileStore`` at ``store_path`` (every rank
        the same path); blocks until all ``size`` ranks joined."""
        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.FileStore(store_path, size)
        store.set_timeout(timeout)
        ctrl = dist.ProcessGroupGloo(dist.PrefixStore("ctrl", store), rank,
                                     size, timeout)
        if backend == "nccl":
            data = dist.ProcessGroupNCCL(dist.PrefixStore("data", store),
                                         rank, size)
        else:
            data = dist.ProcessGroupGloo(dist.PrefixStore("data", store),
                                         rank, size, timeout)
        return cls(rank, size, data, ctrl, backend)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; every rank gets the same
        bits."""
        self._run(t, lambda: self._data.allreduce([t]).wait())
        return t

    def all_reduce_flat(self, flat: torch.Tensor,
                        bucket: int = 1 << 25) -> torch.Tensor:
        """``all_reduce`` of a 1-D tensor in buckets of ``bucket`` elements
        (in place): the staging buffers a collective of CUDA tensors takes
        stay bucket-sized whatever the model's size."""
        for piece in flat.split(bucket):
            self.all_reduce(piece)
        return flat

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim``, in rank order."""
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(self.size)]
        self._run(t, lambda: self._data.allgather([outs], [t]).wait())
        return torch.cat(outs, dim=dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of the ranks' ``t`` summed: ``dim`` cut in
        ``size`` equal blocks, block r to rank r (``all_gather``'s
        inverse)."""
        parts = [p.contiguous() for p in t.chunk(self.size, dim=dim)]
        out = torch.empty_like(parts[self.rank])
        self._run(t, lambda: self._data.reduce_scatter([out],
                                                       [parts]).wait())
        return out

    def _bcast(self, t: torch.Tensor) -> None:
        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        self._ctrl.broadcast([t], opts).wait()

    def send(self, obj: Any) -> None:
        """Rank 0: broadcast one control message."""
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        self._bcast(torch.tensor([len(data)], dtype=torch.int64))
        self._bcast(torch.frombuffer(bytearray(data), dtype=torch.uint8))

    def recv(self) -> Any:
        """Ranks > 0: the next control message of rank 0."""
        n = torch.zeros(1, dtype=torch.int64)
        self._bcast(n)
        buf = torch.empty(int(n[0]), dtype=torch.uint8)
        self._bcast(buf)
        return pickle.loads(buf.numpy().tobytes())

    def gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's picklable ``obj``, in rank order, on every rank
        (over the control group)."""
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        n = torch.tensor([len(data)], dtype=torch.int64)
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(self.size)]
        self._ctrl.allgather([sizes], [n]).wait()
        top = max(int(t[0]) for t in sizes)
        buf = torch.zeros(top, dtype=torch.uint8)
        buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        outs = [torch.empty(top, dtype=torch.uint8) for _ in range(self.size)]
        self._ctrl.allgather([outs], [buf]).wait()
        return [pickle.loads(o[:int(k[0])].numpy().tobytes())
                for o, k in zip(outs, sizes)]


# ---------------------------------------------------------------------------
# Collectives under autograd (training): Megatron's f / g pair
# ---------------------------------------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    """f: the input of a column-split region. Identity forward; the
    backward all-reduces the ranks' partial input gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(
            g.clone(memory_format=torch.contiguous_format)), None


class _ReduceFromGroup(torch.autograd.Function):
    """g: a row split's partial products summed over the group. The
    backward is the identity (every rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """The lm head's column shards concatenated along ``dim``; the
    backward keeps this rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return group.all_gather(x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.group.rank * ctx.width,
                        ctx.width).contiguous(), None, None


class _SumOverGroup(torch.autograd.Function):
    """A sum of the ranks' partials that each rank then uses for its own
    slice (the SSM gated norm's sum of squares): all-reduced forward, and
    the ranks' partial gradients all-reduced backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(
            g.clone(memory_format=torch.contiguous_format)), None


class _ReduceGradColumns(torch.autograd.Function):
    """Identity forward on a rank's parameter slice whose columns ``cols``
    are replicated on every rank but used only by the rank's own heads
    (the SSM in_proj's B and C columns, their conv channels): the backward
    all-reduces those columns' partial gradients, so every rank gets the
    whole gradient of the replicated columns."""

    @staticmethod
    def forward(ctx, w, cols, group):
        ctx.cols, ctx.group = cols, group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        cols = ctx.cols.to(g.device)
        part = g.index_select(-1, cols).contiguous()
        g.index_copy_(-1, cols, ctx.group.all_reduce(part))
        return g, None, None


class _ReduceHeadGrads(torch.autograd.Function):
    """Identity forward on a rank's k or v columns of the one K/V head
    its query heads read (``("kv", KV, tp)``), held again by the other
    ranks of that head: the backward writes the rank's partial gradient
    at the head's place in a (..., KV * hd) buffer of zeros, all-reduces
    it over the group and takes back the head's columns — the sum over
    the head's ranks alone (the other heads' columns do not mix in)."""

    @staticmethod
    def forward(ctx, w, mark, rank, group):
        ctx.mark, ctx.rank, ctx.group = mark, rank, group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        _, kv, tp = ctx.mark
        hd = g.shape[-1]
        head = kv_heads(kv, ctx.rank, tp)[0]
        buf = g.new_zeros(*g.shape[:-1], kv * hd)
        buf[..., head * hd:(head + 1) * hd] = g
        ctx.group.all_reduce(buf)
        return buf[..., head * hd:(head + 1) * hd].contiguous(), None, \
            None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """f (``_CopyToGroup``) where a gradient is being taken, else ``x``."""
    return _CopyToGroup.apply(x, group) if _tracked(x) else x


def reduce_from_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``x`` over the group: g (``_ReduceFromGroup``) where a gradient
    is being taken, else in place (serving's bits)."""
    return _ReduceFromGroup.apply(x, group) if _tracked(x) \
        else group.all_reduce(x)


def gather_from_group(x: torch.Tensor, group: Group,
                      dim: int = -1) -> torch.Tensor:
    """All-gather ``x`` along ``dim``, differentiably where a gradient is
    being taken."""
    return _GatherFromGroup.apply(x, group, dim) if _tracked(x) \
        else group.all_gather(x, dim=dim)


def sum_over_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``x`` over the group, the gradient summed too where one is
    being taken (``_SumOverGroup``), else in place."""
    return _SumOverGroup.apply(x, group) if _tracked(x) \
        else group.all_reduce(x)


def reduce_grad_columns(w: torch.Tensor, cols: torch.Tensor,
                        group: Group) -> torch.Tensor:
    """``w``, whose columns ``cols`` get their gradient all-reduced over
    the group (``_ReduceGradColumns``) where one is being taken."""
    return _ReduceGradColumns.apply(w, cols, group) if _tracked(w) else w


def reduce_head_grads(w: torch.Tensor, mark, group: Group) -> torch.Tensor:
    """``w``, a rank's k or v columns of a K/V head held by several ranks
    (``mark`` ``("kv", KV, tp)``), whose gradient is summed over those
    ranks (``_ReduceHeadGrads``) where one is being taken."""
    return _ReduceHeadGrads.apply(w, mark, group.rank, group) \
        if _tracked(w) else w


_GROUP: contextvars.ContextVar[Optional[Group]] = contextvars.ContextVar(
    "repro_torch_tp_group", default=None)


@contextlib.contextmanager
def bound(group: Optional[Group]):
    """Make ``group`` the current tensor-parallel group of the model calls
    in the scope (``models.layers`` reduces and gathers over it)."""
    tok = _GROUP.set(group)
    try:
        yield group
    finally:
        _GROUP.reset(tok)


def current_group() -> Optional[Group]:
    return _GROUP.get()


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def attention_split(cfg, tp: int) -> Optional[str]:
    """The head rule, with H = ``num_heads + head_pad`` (``repro`` counts
    padded heads as heads) and KV the K/V heads: ``"heads"`` where tp
    divides both (each rank H/tp query heads and KV/tp K/V heads),
    ``"replicate"`` where KV divides tp and each K/V group's g = H/KV
    query heads are at least its tp/KV ranks (each rank its
    ``query_heads``, H/tp of them where tp divides H, and the one K/V
    head they read, ``kv_heads``), else None (attention whole on every
    rank)."""
    kv, h = cfg.num_kv_heads, cfg.num_heads + cfg.head_pad
    if tp <= 1 or not cfg.num_heads or not kv:
        return None
    if kv % tp == 0:
        return "heads" if h % tp == 0 else None
    if tp % kv == 0 and h % kv == 0 and h // kv >= tp // kv:
        return "replicate"
    return None


def _query_range(h: int, kv: int, rank: int, tp: int) -> range:
    """``query_heads`` from the counts (the split is the head rule's)."""
    if h % tp == 0:
        return range(rank * (h // tp), (rank + 1) * (h // tp))
    n, g = tp // kv, h // kv
    grp, j = divmod(rank, n)
    q, r = divmod(g, n)
    return range(grp * g + j * q + min(j, r),
                 grp * g + (j + 1) * q + min(j + 1, r))


def query_heads(cfg, rank: int, tp: int) -> range:
    """The query heads (padded ones counted) rank ``rank`` of ``tp``
    holds under the head rule: its block of H/tp where tp divides H;
    else the rank sits at place j = rank % n of K/V group rank // n (n =
    tp/KV ranks a group of g = H/KV heads) and holds the group's heads
    [j (g // n) + min(j, g % n), (j + 1) (g // n) + min(j + 1, g % n)),
    the larger shares first. The ranges are contiguous, in rank order,
    and cover range(H); every head of a rank reads its ``kv_heads``.
    All of range(H) where attention stays whole."""
    h = cfg.num_heads + cfg.head_pad
    if attention_split(cfg, tp) is None:
        return range(h)
    return _query_range(h, cfg.num_kv_heads, rank, tp)


def kv_heads(kv: int, rank: int, tp: int) -> range:
    """The K/V heads rank ``rank`` of ``tp`` holds under the head rule:
    its block of KV/tp where tp divides KV, else the one head ``rank //
    (tp / KV)`` (its query heads' group; held by tp/KV ranks)."""
    if kv % tp == 0:
        return range(rank * (kv // tp), (rank + 1) * (kv // tp))
    head = rank // (tp // kv)
    return range(head, head + 1)


def is_head_mark(mark) -> bool:
    """Whether ``mark`` is a replicated K/V head's, ``("kv", KV, tp)``."""
    return isinstance(mark, tuple) and mark[:1] == ("kv",)


def _is_qo_mark(mark) -> bool:
    return isinstance(mark, tuple) and mark[:1] == ("qo",)


def mark_part(mark):
    """How a linear's shard splits: its mark, or for a q or o projection
    cut by unequal head ranges (``("qo", part, H, KV, tp)``) its
    ``part``, ``"n"`` (q's columns) or ``"k"`` (o's rows)."""
    return mark[1] if _is_qo_mark(mark) else mark


def _head_span(mark, width: int, rank: int) -> Tuple[int, int]:
    """The values [lo, hi) of a q or o axis of ``width`` = H x hd that
    rank ``rank`` holds under its ``("qo", part, H, KV, tp)`` mark."""
    _, _, h, kv, tp = mark
    heads, hd = _query_range(h, kv, rank, tp), width // h
    return heads.start * hd, heads.stop * hd


def whole_extent(mark, extent: int, group) -> int:
    """The whole width of the split axis of a shard of ``extent`` under
    ``mark`` on ``group``'s rank: ``extent`` x tp for an even split,
    H x hd for unequal head ranges."""
    if _is_qo_mark(mark):
        _, _, h, kv, tp = mark
        return extent // len(_query_range(h, kv, group.rank, tp)) * h
    return extent * group.size


def vocab_split(table_shape, spec, mesh, fsdp: bool = False) -> bool:
    """Whether the embedding table splits by vocabulary rows on ``mesh``:
    ``resolve_spec`` of its ``(MODEL, FSDP)`` spec puts the model axis on
    its rows (tp divides ``padded_vocab()``)."""
    res = sharding.resolve_spec(tuple(spec), tuple(table_shape), mesh, fsdp)
    return len(res) > 0 and _has_model(res[0])


def ssm_split(cfg, tp: int) -> bool:
    """The SSM rule: a Mamba2 mixer splits by SSM heads where tp divides
    the head count, its groups are one (every rank keeps all of B and C)
    and each rank's d_inner rows of out_proj land on the 2-bit word;
    otherwise the mixer stays whole on every rank, as attention does under
    the head rule."""
    return (tp > 1 and cfg.ssm_state > 0 and cfg.ssm_groups == 1
            and cfg.ssm_heads % tp == 0
            and (cfg.d_inner // tp) % formats.K_PER_WORD == 0)


def moe_split(cfg, tp: int) -> Optional[str]:
    """How a MoE layer's expert banks split, as ``repro`` resolves
    ``P("expert", "fsdp", "model")``: ``"e"`` (expert parallelism, whole
    experts a rank) where tp divides the expert count, else ``"ff"`` (every
    expert's d_ff split: w_in and w_gate by columns, w_out by rows) where
    each rank's rows land on the 2-bit word, else None (whole)."""
    if tp <= 1 or not cfg.num_experts:
        return None
    if cfg.num_experts % tp == 0:
        return "e"
    if cfg.d_ff_expert % (tp * formats.K_PER_WORD) == 0:
        return "ff"
    return None


@dataclasses.dataclass(frozen=True)
class ShardConfig(ModelConfig):
    """A rank's config where the SSM mixers split by heads
    (``ssm_split``): ``ssm_tp`` ranks share the d_inner, so ``d_inner``,
    ``ssm_heads``, the conv width and the in_proj width are the rank's."""

    ssm_tp: int = 1

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model // self.ssm_tp


def local_config(cfg, tp: int, rank: int = 0):
    """Rank ``rank``'s model config: where attention splits
    (``attention_split``) its ``query_heads`` (H/tp where tp divides H),
    no padding and max(KV/tp, 1) K/V heads — the attention, its caches,
    page pools and B5's grid at those counts —,
    the local SSM heads and d_inner where the SSM mixers split
    (``ssm_split``: a ``ShardConfig``), else ``cfg``. Expert banks need
    nothing here: the router sees every expert on every rank and a MoE
    layer reads its local experts from its banks; nor does the split
    embedding (a rank's rows are its table's)."""
    if tp <= 1:
        return cfg
    out = cfg
    if attention_split(cfg, tp):
        out = dataclasses.replace(
            out, num_heads=len(query_heads(cfg, rank, tp)), head_pad=0,
            num_kv_heads=max(cfg.num_kv_heads // tp, 1))
    if ssm_split(cfg, tp):
        fields = {f.name: getattr(out, f.name)
                  for f in dataclasses.fields(ModelConfig)}
        out = ShardConfig(**fields, ssm_tp=tp)
    return out


def ssm_columns(cfg, rank: int, tp: int
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """A rank's columns of a split SSM mixer (``ssm_split``), as index
    tensors into the whole: (in_proj columns — its heads' z and x, all of
    B and C, its heads' dt —, conv channels — its x, all of B and C —,
    the rank's d_inner). ``repro``'s GSPMD splits the in_proj's
    concatenation contiguously instead (ROADMAP C18)."""
    di, gs, h = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    dl, hl = di // tp, h // tp
    inner = torch.arange(rank * dl, (rank + 1) * dl)
    bc = torch.arange(2 * di, 2 * di + 2 * gs)
    in_cols = torch.cat([inner, di + inner, bc,
                         2 * di + 2 * gs + torch.arange(rank * hl,
                                                        (rank + 1) * hl)])
    conv_cols = torch.cat([inner, torch.arange(di, di + 2 * gs)])
    return in_cols, conv_cols, dl


def _ssm_mark(cfg, tp: int) -> tuple:
    """A split SSM mixer's mark: ``("ssm", d_inner, groups * state,
    heads, tp)`` of the whole mixer, all ``shard_tree`` and
    ``gather_tree`` need to place its columns."""
    return ("ssm", cfg.d_inner, cfg.ssm_groups * cfg.ssm_state,
            cfg.ssm_heads, tp)


def _mark_cfg(mark):
    _, di, gs, h, _ = mark
    return types.SimpleNamespace(d_inner=di, ssm_groups=1, ssm_state=gs,
                                 ssm_heads=h)


def ssm_replicated(mark) -> Tuple[torch.Tensor, torch.Tensor]:
    """The local indices of a split SSM mixer's replicated columns (B and
    C) in its in_proj and in its conv channels."""
    _, di, gs, _, tp = mark
    dl = di // tp
    return (torch.arange(2 * dl, 2 * dl + 2 * gs),
            torch.arange(dl, dl + 2 * gs))


def _walk_specs(params, specs, fn, path=()):
    """Call ``fn(path, linear_params, linear_spec)`` on every linear (a
    dict holding ``"w"`` or ``"w_packed"``) of a param tree and its spec
    twin."""
    if isinstance(params, dict):
        if "w" in params or "w_packed" in params:
            fn(path, params, specs)
            return
        for k, v in params.items():
            if k == "tp":
                continue
            _walk_specs(v, specs[k] if specs is not None else None, fn,
                        path + (k,))
    elif isinstance(params, list):
        for i, v in enumerate(params):
            _walk_specs(v, specs[i] if specs is not None else None, fn,
                        path + (i,))


def _is_attn(path) -> bool:
    return len(path) >= 2 and path[-1] in ("q", "k", "v", "o") \
        and path[-2] in ("mixer", "cross")


def _qo_mark(cfg, tp: int, path) -> Optional[tuple]:
    """The mark ``("qo", part, H, KV, tp)`` of a q (``"n"``) or o
    (``"k"``) projection at ``path`` where the head rule splits the query
    heads and tp does not divide them (unequal head ranges), else None."""
    if cfg is None or not _is_attn(path) or path[-1] not in ("q", "o"):
        return None
    h = cfg.num_heads + cfg.head_pad
    if h % tp == 0 or attention_split(cfg, tp) is None:
        return None
    return ("qo", "n" if path[-1] == "q" else "k", h, cfg.num_kv_heads, tp)


def validate_param_specs(params, specs, mesh, *, fsdp: bool = False,
                         cfg=None) -> int:
    """Validate every packed container's spec twin against the mesh
    (``weights.validate_spec_twin``); returns the number checked, raises
    ``ValueError`` on the first bad twin. An SSM in_proj is left out: it
    is placed by its column set (``ssm_columns``), not by its twin's
    contiguous range (ROADMAP C18). With ``cfg``, a q or o projection the
    head rule cuts by unequal head ranges is checked at every rank's
    range instead (``weights.validate_range``)."""
    checked = [0]
    tp = mesh_axis_sizes(mesh).get(MODEL, 1)

    def check(path, p, spec):
        wc = p.get("w_packed")
        if path[-1:] == ("in_proj",):
            return
        if not isinstance(wc, weights.TernaryWeight):
            return
        mark = _qo_mark(cfg, tp, path)
        if mark is None:
            weights.validate_spec_twin(wc, spec["w_packed"], mesh,
                                       fsdp=fsdp)
        else:
            width = wc.k if mark[1] == "k" else wc.n
            for r in range(tp):
                weights.validate_range(wc, mark[1],
                                       *_head_span(mark, width, r))
        checked[0] += 1

    _walk_specs(params, specs, check)
    return checked[0]


def _has_model(entry) -> bool:
    return entry == MODEL or (isinstance(entry, tuple) and MODEL in entry)


def _linear_partition(p: dict, spec: dict, mesh, fsdp: bool) -> Optional[str]:
    wc = p.get("w_packed")
    if wc is not None:
        shape, wspec = (wc.k, wc.n), weights._twin_spec(spec["w_packed"])
    else:
        shape, wspec = tuple(p["w"].shape), spec["w"]
    res = sharding.resolve_spec(tuple(wspec or ())[-2:], shape[-2:], mesh,
                                fsdp)
    res = tuple(res) + (None,) * (2 - len(res))
    if _has_model(res[0]):
        return "k"
    if _has_model(res[1]):
        return "n"
    return None


def _slice(t, part: str, rank: int, tp: int):
    """Rank ``rank``'s slice of a tensor or packed container: ``"k"`` the
    rows (axis -2), ``"n"`` the columns (axis -1), ``"e"`` the experts
    (axis 0)."""
    if isinstance(t, weights.TernaryWeight):
        return weights.shard_weight(t, part, rank, tp)
    ax = {"k": -2, "n": -1, "e": 0}[part]
    step = t.shape[ax] // tp
    return t.narrow(ax, rank * step, step).contiguous()


def _shard_linear(p: dict, part: str, rank: int, tp: int) -> dict:
    out = {k: v for k, v in p.items() if k not in ("w", "b", "w_packed")}
    wc = p.get("w_packed")
    if wc is not None:
        out["w_packed"] = weights.shard_weight(wc, part, rank, tp)
        return out
    out["w"] = _slice(p["w"], part, rank, tp)
    if "b" in p:
        out["b"] = p["b"] if part == "k" else _slice(p["b"], "n", rank, tp)
    return out


def _is_moe(p: dict) -> bool:
    return "router" in p and "w_in" in p


def _is_ssm(p: dict) -> bool:
    return "in_proj" in p and "conv_w" in p


# a MoE node's leaves by how each splits: (leaf, "e" split, "ff" split)
_MOE_SPLITS = (("w_in", "e", "n"), ("w_gate", "e", "n"),
               ("w_out", "e", "k"), ("shared_in", "n", "n"),
               ("shared_gate", "n", "n"), ("shared_out", "k", "k"))


def _moe_mark(p: dict, part: str, tp: int) -> tuple:
    """A split MoE node's mark: ``("moe", part, shared, tp)``, ``shared``
    whether its shared expert splits as an MLP (tp divides its d_ff; else
    it stays whole on every rank)."""
    return ("moe", part, "shared_in" in p
            and p["shared_in"].shape[-1] % tp == 0, tp)


def _moe_leaves(p: dict, mark: tuple):
    """(leaf name, how it splits) of a split MoE node's split leaves."""
    _, part, shared, _ = mark
    for name, e_part, ff_part in _MOE_SPLITS:
        if name in p and (shared or not name.startswith("shared")):
            yield name, e_part if part == "e" else ff_part


def _shard_moe(p: dict, mark: tuple, rank: int) -> dict:
    """A MoE node's rank slices under its mark (``_moe_mark``); the router
    whole."""
    out = dict(p, tp=mark)
    for name, part in _moe_leaves(p, mark):
        out[name] = _slice(p[name], part, rank, mark[3])
    return out


def _shard_kv(p: dict, mark: tuple, rank: int) -> dict:
    """A k or v projection's columns of the one K/V head rank ``rank``
    holds (``kv_heads``; re-packed when packed:
    ``weights.select_columns``), with its bias."""
    _, kv, tp = mark
    wc = p.get("w_packed")
    width = wc.n if wc is not None else p["w"].shape[-1]
    hd, head = width // kv, kv_heads(kv, rank, tp)[0]
    cols = torch.arange(head * hd, (head + 1) * hd)
    out = {k: v for k, v in p.items() if k not in ("w", "b", "w_packed")}
    if wc is not None:
        out["w_packed"] = weights.select_columns(wc, cols)
    else:
        for name in ("w", "b"):
            if name in p:
                out[name] = p[name][..., head * hd:(head + 1) * hd] \
                    .contiguous()
    return out


def _shard_heads(p: dict, mark: tuple, rank: int) -> dict:
    """A q or o projection's head range of rank ``rank`` under its
    ``("qo", part, H, KV, tp)`` mark (``_head_span``): q's columns with
    their bias, o's rows (its bias whole, after the all-reduce); a packed
    container cut by ``weights.shard_range``."""
    part = mark[1]
    out = {k: v for k, v in p.items() if k not in ("w", "b", "w_packed")}
    wc = p.get("w_packed")
    if wc is not None:
        span = _head_span(mark, wc.k if part == "k" else wc.n, rank)
        out["w_packed"] = weights.shard_range(wc, part, *span)
        return out
    ax = -2 if part == "k" else -1
    lo, hi = _head_span(mark, p["w"].shape[ax], rank)
    out["w"] = p["w"].narrow(ax, lo, hi - lo).contiguous()
    if "b" in p:
        out["b"] = p["b"] if part == "k" else p["b"][..., lo:hi].contiguous()
    return out


def _shard_table(p: dict, rank: int, tp: int) -> dict:
    """The embedding's vocabulary rows of rank ``rank``."""
    return dict(p, table=_slice(p["table"], "k", rank, tp))


def _shard_ssm(p: dict, mark: tuple, rank: int) -> dict:
    """A split SSM mixer's rank slices (``ssm_columns``): in_proj its
    column set (re-packed when packed: ``weights.select_columns``),
    out_proj its d_inner rows, conv and the per-head and per-channel
    vectors with them."""
    cfg, tp = _mark_cfg(mark), mark[4]
    in_cols, conv_cols, dl = ssm_columns(cfg, rank, tp)
    hl = cfg.ssm_heads // tp
    ip = p["in_proj"]
    if "w_packed" in ip:
        new_in = {"w_packed": weights.select_columns(ip["w_packed"],
                                                     in_cols)}
    else:
        new_in = {k: v.index_select(-1, in_cols.to(v.device))
                  for k, v in ip.items() if k in ("w", "b")}
    out = dict(p, in_proj=dict(new_in, tp="cols"),
               out_proj=dict(_shard_linear(p["out_proj"], "k", rank, tp),
                             tp="k"),
               tp=mark)
    for name in ("conv_w", "conv_b"):
        out[name] = p[name].index_select(-1, conv_cols.to(p[name].device))
    for name in ("a_log", "dt_bias", "d_skip"):
        out[name] = p[name][..., rank * hl:(rank + 1) * hl].contiguous()
    out["norm_scale"] = p["norm_scale"][
        ..., rank * dl:(rank + 1) * dl].contiguous()
    return out


def shard_params(params, specs, mesh, *, rank: int = 0, cfg=None,
                 fsdp: bool = False, validate: bool = True,
                 latent: bool = False):
    """Rank ``rank``'s slices of a param tree under its logical spec twin
    (``LM.param_specs``), resolved against the mesh (module docstring).
    Packed twins are validated first unless ``validate=False``. Every
    split linear gains a ``"tp"`` mark: ``"n"`` column split, ``"k"``
    row split (its partial product all-reduced), ``"gather"`` the lm
    head's column split (its logits all-gathered), ``("kv", KV, tp)`` a
    k or v projection's columns of a K/V head held by tp/KV ranks,
    ``("qo", part, H, KV, tp)`` a q (``"n"``) or o (``"k"``) projection
    cut at the rank's ``query_heads`` where tp does not divide them; a
    split embedding table's node the mark ``"vocab"``. ``cfg`` (the
    model's) applies the head rule, and places the other families'
    nodes: a MoE node under ``moe_split`` (marked ``"e"`` or ``"ff"``),
    an SSM mixer under ``ssm_split`` (marked ``_ssm_mark``, its in_proj
    ``"cols"`` and its out_proj ``"k"``); without ``cfg`` attention
    splits as resolved and a MoE or SSM node raises.
    A latent ternary weight ternarizes per column over the whole K, so
    it is refused unless ``latent=True``: the training path, whose row
    splits reduce their column statistics over the group
    (``quantize.ste_ternarize_rows``)."""
    tp = mesh_axis_sizes(mesh).get(MODEL, 1)
    if validate:
        validate_param_specs(params, specs, mesh, fsdp=fsdp, cfg=cfg)
    if tp <= 1:
        return params
    place = "heads" if cfg is None else attention_split(cfg, tp)
    kv_mark = None if cfg is None else ("kv", cfg.num_kv_heads, tp)

    def family_node(p):
        if cfg is None:
            raise ValueError("sharding a MoE or SSM node needs the "
                             "model's cfg")
        if _is_moe(p):
            part = moe_split(cfg, tp)
            return dict(p) if part is None else _shard_moe(
                p, _moe_mark(p, part, tp), rank)
        if not ssm_split(cfg, tp):
            return dict(p)
        return _shard_ssm(p, _ssm_mark(cfg, tp), rank)

    def walk(p, s, path):
        if isinstance(p, dict):
            if _is_moe(p) or _is_ssm(p):
                return family_node(p)
            if path == ("embed",):
                if not vocab_split(p["table"].shape, s["table"], mesh,
                                   fsdp):
                    return dict(p)
                return dict(_shard_table(p, rank, tp), tp="vocab")
            if "w" in p or "w_packed" in p:
                part = _linear_partition(p, s, mesh, fsdp)
                attn = _is_attn(path)
                if attn and place is None:
                    return dict(p)
                if attn and place == "replicate" and path[-1] in ("k", "v"):
                    part = "kv"
                qo = _qo_mark(cfg, tp, path)
                if qo is not None:
                    part = qo
                if part is None:
                    return dict(p)
                if "w" in p and cfg is not None and not latent \
                        and cfg.quantization == "ternary" \
                        and min(p["w"].shape[-2:]) >= cfg.ternary_min_dim:
                    raise ValueError(
                        "a latent ternary weight ternarizes as a whole "
                        "matrix: pack the params before sharding them "
                        "(training shards them with latent=True)")
                if part == "kv":
                    return dict(_shard_kv(p, kv_mark, rank), tp=kv_mark)
                if qo is not None:
                    return dict(_shard_heads(p, qo, rank), tp=qo)
                out = _shard_linear(p, part, rank, tp)
                out["tp"] = ("gather" if part == "n" and path[:1]
                             == ("unembed",) else part)
                return out
            return {k: walk(v, s[k], path + (k,)) for k, v in p.items()}
        if isinstance(p, list):
            return [walk(v, s[i], path + (i,)) for i, v in enumerate(p)]
        return p

    return walk(params, specs, ())


# ---------------------------------------------------------------------------
# Training: marks kept apart from the trees the optimizer walks
# ---------------------------------------------------------------------------

def strip_marks(params) -> Tuple[Any, Dict[tuple, Any]]:
    """(the tree without its ``"tp"`` marks, {path of a marked node: its
    mark}): the optimizer, the error state and checkpoints walk plain
    trees of tensors. A split SSM mixer's marks nest (the mixer's, its
    in_proj's and its out_proj's)."""
    marks: Dict[tuple, Any] = {}

    def walk(p, path):
        if isinstance(p, dict):
            if "tp" in p:
                marks[path] = p["tp"]
            return {k: walk(v, path + (k,)) for k, v in p.items()
                    if k != "tp"}
        if isinstance(p, list):
            return [walk(v, path + (i,)) for i, v in enumerate(p)]
        return p

    return walk(params, ()), marks


def _map_linears(tree, marks, fn, path=()):
    """``tree`` with ``fn(node, mark)`` in place of every outermost marked
    node (the other nodes rebuilt, leaves shared)."""
    if isinstance(tree, dict):
        if path in marks:
            return fn(tree, marks[path])
        return {k: _map_linears(v, marks, fn, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_linears(v, marks, fn, path + (i,))
                for i, v in enumerate(tree)]
    return tree


def attach_marks(params, marks: Dict[tuple, Any]):
    """The rank's tree as the model reads it: every marked node (nested
    ones too) with its ``"tp"`` mark."""
    def walk(p, path):
        if isinstance(p, dict):
            out = {k: walk(v, path + (k,)) for k, v in p.items()}
            if path in marks:
                out["tp"] = marks[path]
            return out
        if isinstance(p, list):
            return [walk(v, path + (i,)) for i, v in enumerate(p)]
        return p

    return walk(params, ())


def _family_mark(m) -> Optional[str]:
    """``"ssm"`` or ``"moe"`` for a family node's mark, else None."""
    return m[0] if isinstance(m, tuple) else None


def _col_mask(t: torch.Tensor, replicated: torch.Tensor) -> torch.Tensor:
    mask = torch.ones(t.shape[-1], dtype=torch.bool, device=t.device)
    mask[replicated.to(t.device)] = False
    return mask


def split_mask(params, marks: Dict[tuple, Any]):
    """A tree like ``params`` saying which leaves are slices: True where
    the leaf is a slice (every leaf of a column split, a split expert
    bank; a row split's ``"w"``, not its whole bias), False where every
    rank holds the whole leaf (a MoE router, a whole shared expert), and
    for a split SSM mixer's in_proj and conv a bool tensor over the last
    axis, False at the replicated B and C columns, and for a K/V head's
    columns held by tp/KV ranks (``("kv", KV, tp)``) the float KV/tp: the
    share of the leaf's squares a rank counts in a norm summed over the
    group (the head's ranks hold equal gradients once they are summed)."""
    def node(p, m):
        kind = _family_mark(m)
        if kind == "kv":
            return {k: m[1] / m[2] for k in p}
        m = mark_part(m)
        if kind == "ssm":
            rep_in, rep_conv = ssm_replicated(m)
            out = {k: True for k in p}
            out["in_proj"] = {k: _col_mask(v, rep_in)
                              for k, v in p["in_proj"].items()}
            out["out_proj"] = {k: k == "w" for k in p["out_proj"]}
            for name in ("conv_w", "conv_b"):
                out[name] = _col_mask(p[name], rep_conv)
            return out
        if kind == "moe":
            split = {name for name, _ in _moe_leaves(p, m)}
            return {k: k in split for k in p}
        return {k: (k == "w" or m != "k") for k in p}

    def mark(tree, path=()):
        if isinstance(tree, dict):
            if path in marks:
                return node(tree, marks[path])
            return {k: mark(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [mark(v, path + (i,)) for i, v in enumerate(tree)]
        return False

    return mark(params)


def shard_tree(tree, marks: Dict[tuple, Any], rank: int, tp: int):
    """Rank ``rank``'s slices of a whole tree shaped like the params (the
    params, AdamW's m or v): each marked node sliced as ``shard_params``
    slices it, the rest shared."""
    def cut(p, m):
        kind = _family_mark(m)
        if kind == "ssm":
            return strip_marks(_shard_ssm(p, m, rank))[0]
        if kind == "moe":
            return strip_marks(_shard_moe(p, m, rank))[0]
        if kind == "kv":
            return _shard_kv(p, m, rank)
        if kind == "qo":
            return _shard_heads(p, m, rank)
        if m == "vocab":
            return _shard_table(p, rank, tp)
        return _shard_linear(p, "n" if m == "gather" else m, rank, tp)

    return _map_linears(tree, marks, cut)


def _gather_cols(group: Group, t: torch.Tensor, cols_of, n: int):
    """The whole last axis (width ``n``) from every rank's columns
    ``cols_of(rank)`` of it (the replicated ones written by each rank,
    with the same bits)."""
    parts = group.all_gather(t, dim=-1).chunk(group.size, dim=-1)
    whole = torch.empty(*t.shape[:-1], n, dtype=t.dtype, device=t.device)
    for r, piece in enumerate(parts):
        whole[..., cols_of(r).to(t.device)] = piece
    return whole


def _gather_spans(group: Group, t: torch.Tensor, dim: int,
                  sizes: Sequence[int]) -> torch.Tensor:
    """The ranks' pieces of ``t`` along ``dim``, ``sizes[r]`` wide on rank
    r, concatenated in rank order: each padded to the largest and
    all-gathered (the collective takes equal shapes), then cut back — the
    bits as they were."""
    top = max(sizes)
    pad = list(t.shape)
    pad[dim] = top - t.shape[dim]
    t = torch.cat([t, t.new_zeros(pad)], dim=dim)
    parts = group.all_gather(t, dim=dim).chunk(group.size, dim=dim)
    return torch.cat([piece.narrow(dim, 0, n)
                      for piece, n in zip(parts, sizes)], dim=dim)


def gather_tree(tree, marks: Dict[tuple, Any], group: Optional[Group]):
    """The whole tree from every rank's slices (``shard_tree``'s inverse):
    each marked node's split leaves all-gathered over ``group`` in rank
    order (a split SSM mixer's in_proj and conv columns put back at their
    places; a replicated K/V head's columns taken once, from the first of
    its ranks; unequal head ranges of q and o padded for the gather and
    cut back, ``_gather_spans``)."""
    if group is None or not marks:
        return tree

    def ssm_whole(p, m):
        cfg, tp = _mark_cfg(m), m[4]
        di, gs, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        out = dict(p)
        out["in_proj"] = {k: _gather_cols(
            group, v, lambda r: ssm_columns(cfg, r, tp)[0],
            2 * di + 2 * gs + h) for k, v in p["in_proj"].items()}
        for name in ("conv_w", "conv_b"):
            out[name] = _gather_cols(group, p[name],
                                     lambda r: ssm_columns(cfg, r, tp)[1],
                                     di + 2 * gs)
        out["out_proj"] = dict(p["out_proj"], w=group.all_gather(
            p["out_proj"]["w"], dim=-2))
        for name in ("a_log", "dt_bias", "d_skip", "norm_scale"):
            out[name] = group.all_gather(p[name], dim=-1)
        return out

    def kv_whole(p, m):
        _, kv, tp = m
        out = dict(p)
        for name in ("w", "b"):
            if name in p:
                parts = group.all_gather(p[name], dim=-1).chunk(tp, dim=-1)
                out[name] = torch.cat(parts[::tp // kv], dim=-1)
        return out

    def heads_whole(p, m):
        _, part, h, kv, tp = m
        dim = -2 if part == "k" else -1
        out = dict(p)
        for name in ("w", "b") if part == "n" else ("w",):
            if name in p:
                hd = p[name].shape[dim] // len(
                    _query_range(h, kv, group.rank, tp))
                out[name] = _gather_spans(
                    group, p[name], dim,
                    [len(_query_range(h, kv, r, tp)) * hd
                     for r in range(tp)])
        return out

    def whole(p, m):
        kind = _family_mark(m)
        if kind == "ssm":
            return ssm_whole(p, m)
        if kind == "kv":
            return kv_whole(p, m)
        if kind == "qo":
            return heads_whole(p, m)
        if m == "vocab":
            return dict(p, table=group.all_gather(p["table"], dim=-2))
        out = dict(p)
        if kind == "moe":
            for name, part in _moe_leaves(p, m):
                out[name] = group.all_gather(
                    p[name], dim={"k": -2, "n": -1, "e": 0}[part])
            return out
        out["w"] = group.all_gather(p["w"], dim=-2 if m == "k" else -1)
        if "b" in p and m != "k":
            out["b"] = group.all_gather(p["b"], dim=-1)
        return out

    return _map_linears(tree, marks, whole)


def head_replicas(tree, marks: Dict[tuple, Any], rank: int):
    """A tree like ``tree`` holding, at every leaf of a replicated K/V
    head's node (``("kv", KV, tp)``), the head rank ``rank`` holds, and
    None elsewhere: the leaves equal only within a head's ranks."""
    def walk(t, path=(), head=None):
        m = marks.get(path) if head is None else None
        if is_head_mark(m):
            head = kv_heads(m[1], rank, m[2])[0]
        if isinstance(t, dict):
            return {k: walk(v, path + (k,), head) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path + (i,), head) for i, v in enumerate(t)]
        return head

    return walk(tree)


def gemm_shard_fn(mesh, params) -> Callable:
    """``shard(path, w) -> (partition, tp)`` for ``ops.precompute_plans``
    over a rank's tree: it reads the partition ``shard_params`` recorded
    beside each packed shard (the lm head's gather is a column split; an
    SSM in_proj's column set plans as the whole GEMM it is), so each
    plan's collective follows where the bits actually live."""
    tp = mesh_axis_sizes(mesh).get(MODEL, 1)
    marks: Dict[int, str] = {}

    def note(path, p, spec):
        part = mark_part(p.get("tp"))
        if isinstance(p.get("w_packed"), weights.TernaryWeight) \
                and part in ("n", "k", "gather"):
            marks[id(p["w_packed"])] = "n" if part == "gather" else part

    _walk_specs(params, None, note)

    def shard(path, w):
        part = marks.get(id(w))
        return (part, tp) if part is not None and tp > 1 else (None, 1)

    return shard


def cache_sharding(layers, cfg, mesh):
    """The placement of a serving cache tree (dense slot rows, page
    tensors, int8 pages), as ``repro``'s: the KV-head axis of every
    ``(..., KV, hd)`` leaf split over ``"model"`` wherever tp divides the
    head count (matching the column-split K/V projections), the int8
    page scales ``(..., KV)`` with their pages; where the SSM mixers
    split (``ssm_split``), an SSM state ``(B, H, P, S)`` by heads and a
    conv row ``(B, w-1, C)`` by the rank's channels (``ssm_columns``:
    its x channels and all of B and C, not a contiguous range — C18);
    everything else whole. Returns the tree with a spec (a tuple of axis
    entries, trailing ``None``s dropped) for each tensor."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    tp = mesh_axis_sizes(mesh).get(MODEL, 1)
    shardable = tp > 1 and kv % tp == 0
    ssm = ssm_split(cfg, tp)
    state = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    conv = (cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_groups
            * cfg.ssm_state)

    def spec(x):
        shp = tuple(getattr(x, "shape", ()))
        if ssm and len(shp) == 4 and shp[1:] == state:
            return (None, MODEL)
        if ssm and len(shp) == 3 and shp[1:] == conv:
            return (None, None, MODEL)
        if shardable and len(shp) >= 2 and shp[-1] == hd and shp[-2] == kv:
            return (None,) * (len(shp) - 2) + (MODEL,)
        if shardable and len(shp) >= 1 and shp[-1] == kv:
            return (None,) * (len(shp) - 1) + (MODEL,)
        return ()

    return _map_cache(layers, spec)


def _map_cache(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_cache(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_cache(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_cache(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree)})
    return fn(tree)


def replicated_sharding(tree, mesh):
    """Every leaf whole on every rank (small device mirrors: positions,
    tokens, block tables, masks)."""
    return _map_cache(tree, lambda _: ())


def device_put_cache(layers, cfg, mesh, *, rank: int = 0):
    """A rank's slice of a whole cache tree under ``cache_sharding`` (no
    mesh: the tree itself); where the head rule replicates K/V heads
    (``attention_split``), the rank's one head (``kv_heads``) of every
    ``(..., KV, hd)`` and ``(..., KV)`` leaf — a placement no spec holds."""
    if mesh is None:
        return layers
    tp = mesh_axis_sizes(mesh).get(MODEL, 1)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    one = kv_heads(kv, rank, tp)[0] \
        if attention_split(cfg, tp) == "replicate" else None

    def put(x):
        shp = tuple(getattr(x, "shape", ()))
        if one is not None and (shp[-2:] == (kv, hd) or shp[-1:] == (kv,)):
            ax = len(shp) - (2 if shp[-2:] == (kv, hd) else 1)
            return x.narrow(ax, one, 1).contiguous()
        spec = cache_sharding(x, cfg, mesh)
        if MODEL not in spec:
            return x
        ax = spec.index(MODEL)
        if ssm_split(cfg, tp) and ax == 2 and x.ndim == 3:   # conv row
            cols = ssm_columns(cfg, rank, tp)[1].to(x.device)
            return x.index_select(-1, cols).contiguous()
        step = x.shape[ax] // tp
        return x.narrow(ax, rank * step, step).contiguous()

    return _map_cache(layers, put)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    if isinstance(tree, (torch.Tensor, weights.TernaryWeight)):
        return tree.to(device)
    return tree


# ---------------------------------------------------------------------------
# Followers
# ---------------------------------------------------------------------------

def start_followers(mesh: Mesh, params, engine_kwargs: Dict[str, Any]):
    """Start ranks 1..tp-1 of ``mesh``, each a Python process (``python -c``,
    so nothing of the caller's main module runs again) that joins the
    group, builds ``ContinuousScheduler(**engine_kwargs, mesh=mesh)`` on
    its device, loads ``params`` — the whole tree, which it shards itself
    — and follows rank 0's steps; then join the group as rank 0. Returns
    ``(group, processes, workdir)``; ``stop_followers`` ends them."""
    workdir = tempfile.mkdtemp(prefix="repro_torch_tp_")
    job = {"store": os.path.join(workdir, "store"),
           "params": os.path.join(workdir, "params.pt"),
           "mesh": mesh, "engine": engine_kwargs,
           "threads": torch.get_num_threads()}
    job_path = os.path.join(workdir, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    # the followers start while the params are written: a follower reads
    # them only after the group is up, and rank 0 joins once they are
    procs = spawn_ranks("repro_torch.distributed.tp", "_follower_main",
                        job_path, range(1, mesh.tp))
    try:
        torch.save(_tree_to(params, "cpu"), job["params"])
        group = Group.join(job["store"], 0, mesh.tp, mesh.backend,
                           mesh.timeout_s)
    except Exception:
        stop_followers(None, procs, workdir)
        raise
    return group, procs, workdir


def _rank_env() -> Dict[str, str]:
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))


# idle rank processes started ahead (``keep_spares``)
_SPARES: List[subprocess.Popen] = []
_KEEP = [0]


def keep_spares(n: int) -> None:
    """Keep ``n`` idle rank processes started ahead of ``spawn_ranks``:
    each has imported torch, the engine and the trainer and waits for a
    job on its stdin, so a rank taken from them reaches its group in about
    the time of its CUDA context, where a fresh Python spends seconds on
    its imports first. Every call that takes some starts as many anew.
    0 (the default) ends the idle ones."""
    _KEEP[0] = n
    while len(_SPARES) > n:
        p = _SPARES.pop()           # idle: nothing of it to keep
        p.kill()
        p.wait()
    while len(_SPARES) < n:
        _SPARES.append(subprocess.Popen(
            [sys.executable, "-c", "from repro_torch.distributed.tp import "
             "_spare_main; _spare_main()"], env=_rank_env(),
            stdin=subprocess.PIPE))


def _spare_main() -> None:
    """An idle rank process (``keep_spares``): the imports, then the one
    job its stdin brings, ``[module, fn, job_path, rank]`` as JSON."""
    import importlib
    import json
    import repro_torch.launch.train       # noqa: F401  (imports ahead)
    import repro_torch.serving.engine     # noqa: F401
    line = sys.stdin.readline()
    if line:
        module, fn, job_path, rank = json.loads(line)
        getattr(importlib.import_module(module), fn)(job_path, rank)


def spawn_ranks(module: str, fn: str, job_path: str, ranks):
    """One Python process a rank (``python -c``, so nothing of the
    caller's main module runs again), each calling ``module.fn(job_path,
    rank)`` with the port's ``src`` first on its PYTHONPATH; an idle one
    of ``keep_spares`` where there is one (then as many started anew)."""
    import json
    procs = []
    for r in ranks:
        while _SPARES:
            p = _SPARES.pop(0)
            try:
                p.stdin.write((json.dumps([module, fn, job_path, r])
                               + "\n").encode())
                p.stdin.close()
            except OSError:            # a spare that is gone
                p.kill()
                p.wait()
                continue
            procs.append(p)
            break
        else:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", f"import sys; from {module} import "
                 f"{fn}; {fn}(sys.argv[1], int(sys.argv[2]))", job_path,
                 str(r)], env=_rank_env()))
    keep_spares(_KEEP[0])
    return procs


def stop_followers(group: Optional[Group], procs, workdir: Optional[str],
                   timeout_s: float = 30.0) -> None:
    """Send the stop message (when the group is up), wait for the
    followers, kill any still running, and remove the work directory."""
    if group is not None:
        try:
            group.send({"op": "stop", "pre": []})
        except Exception:          # a follower already gone
            pass
    for p in procs:
        try:
            p.wait(timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(5.0)
    if workdir is not None:
        shutil.rmtree(workdir, ignore_errors=True)


def _follower_main(job_path: str, rank: int) -> None:
    """A follower rank's process: join, load, follow until stopped."""
    from repro_torch.serving.engine import ContinuousScheduler

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(job["threads"])
    mesh = job["mesh"]
    device = torch.device(mesh.devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    group = Group.join(job["store"], rank, mesh.tp, mesh.backend,
                       mesh.timeout_s)
    params = torch.load(job["params"], map_location="cpu",
                        weights_only=False)
    eng = ContinuousScheduler(**job["engine"], mesh=mesh,
                              device=str(device), tp_rank=rank)
    eng._attach_group(group, rank)
    eng.load(_tree_to(params, device))
    del params
    eng.follow()
