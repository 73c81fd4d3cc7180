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
  split with its logits all-gathered, so every rank sees the same argmax.
  Norms, rope and the embedding table stay whole on every rank (a
  replicated lookup where ``repro`` splits the table's vocabulary rows).
  Packed containers are sliced by ``weights.shard_weight`` after
  ``validate_spec_twin``;
* the head rule: attention splits by heads only where both the query
  and the K/V heads divide by tp (and no head padding). Otherwise the
  whole attention block stays whole on every rank — replication is
  always correct — where ``repro``'s resolver would still split a q or
  K/V projection whose width divides (ROADMAP C15);
* ``local_config``: a rank's model is the config with its local head
  counts, so attention, caches and page pools hold the local KV heads
  (``cache_sharding``'s placement);
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
in-place collectives where no gradient is taken.

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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import weights
from repro_torch.distributed import sharding

__all__ = ["Mesh", "parse_mesh", "replica_meshes", "validate_param_specs",
           "shard_params", "cache_sharding", "replicated_sharding",
           "device_put_cache", "mesh_axis_sizes", "gemm_shard_fn",
           "attention_split", "local_config", "Group", "bound",
           "current_group", "start_followers", "copy_to_group",
           "reduce_from_group", "gather_from_group", "strip_marks",
           "attach_marks", "split_mask", "shard_tree", "gather_tree",
           "spawn_ranks"]

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
    """One rank's view of a process group: ``all_reduce`` (sum, in place)
    and ``all_gather`` of tensors on the rank's device over the data
    group, ``send`` (rank 0) / ``recv`` (the others) of picklable control
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

def attention_split(cfg, tp: int) -> bool:
    """The head rule: attention splits by heads only where tp divides both
    the query and the K/V head counts and no heads are padded."""
    return (tp > 1 and cfg.num_heads % tp == 0
            and cfg.num_kv_heads % tp == 0 and not cfg.head_pad)


def local_config(cfg, tp: int):
    """A rank's model config: the local head counts where attention splits
    (``attention_split``), else ``cfg``. Families other than dense raise:
    their tensor-parallel forward (serving and training) is ROADMAP
    A12d."""
    if tp <= 1:
        return cfg
    if cfg.family != "dense":
        raise ValueError(
            f"tensor parallelism (tp={tp}) serves and trains the dense "
            f"family only; family {cfg.family!r} comes with ROADMAP A12d "
            f"(split out of A12b)")
    if not attention_split(cfg, tp):
        return cfg
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp)


def _walk_specs(params, specs, fn, path=()):
    """Call ``fn(path, linear_params, linear_spec)`` on every linear (a
    dict holding ``"w"`` or ``"w_packed"``) of a param tree and its spec
    twin."""
    if isinstance(params, dict):
        if "w" in params or "w_packed" in params:
            fn(path, params, specs)
            return
        for k, v in params.items():
            _walk_specs(v, specs[k] if specs is not None else None, fn,
                        path + (k,))
    elif isinstance(params, list):
        for i, v in enumerate(params):
            _walk_specs(v, specs[i] if specs is not None else None, fn,
                        path + (i,))


def validate_param_specs(params, specs, mesh, *, fsdp: bool = False) -> int:
    """Validate every packed container's spec twin against the mesh
    (``weights.validate_spec_twin``); returns the number checked, raises
    ``ValueError`` on the first bad twin."""
    checked = [0]

    def check(path, p, spec):
        wc = p.get("w_packed")
        if isinstance(wc, weights.TernaryWeight):
            weights.validate_spec_twin(wc, spec["w_packed"], mesh,
                                       fsdp=fsdp)
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


def _shard_linear(p: dict, part: str, rank: int, tp: int) -> dict:
    out = {k: v for k, v in p.items() if k not in ("w", "b", "w_packed")}
    wc = p.get("w_packed")
    if wc is not None:
        out["w_packed"] = weights.shard_weight(wc, part, rank, tp)
        return out
    w = p["w"]
    if part == "k":
        step = w.shape[-2] // tp
        out["w"] = w[..., rank * step:(rank + 1) * step, :].contiguous()
        if "b" in p:
            out["b"] = p["b"]
    else:
        step = w.shape[-1] // tp
        out["w"] = w[..., rank * step:(rank + 1) * step].contiguous()
        if "b" in p:
            out["b"] = p["b"][..., rank * step:(rank + 1) * step].contiguous()
    return out


def shard_params(params, specs, mesh, *, rank: int = 0, cfg=None,
                 fsdp: bool = False, validate: bool = True,
                 latent: bool = False):
    """Rank ``rank``'s slices of a param tree under its logical spec twin
    (``LM.param_specs``), resolved against the mesh (module docstring).
    Packed twins are validated first unless ``validate=False``. Every
    split linear gains a ``"tp"`` mark: ``"n"`` column split, ``"k"``
    row split (its partial product all-reduced), ``"gather"`` the lm
    head's column split (its logits all-gathered). ``cfg`` (the model's)
    applies the head rule; without it attention splits as resolved.
    A latent ternary weight ternarizes per column over the whole K, so
    it is refused unless ``latent=True``: the training path, whose row
    splits reduce their column statistics over the group
    (``quantize.ste_ternarize_rows``)."""
    tp = mesh_axis_sizes(mesh).get(MODEL, 1)
    if validate:
        validate_param_specs(params, specs, mesh, fsdp=fsdp)
    if tp <= 1:
        return params
    if cfg is not None:
        local_config(cfg, tp)                 # the family check
    split_attn = cfg is None or attention_split(cfg, tp)

    def walk(p, s, path):
        if isinstance(p, dict):
            if "w" in p or "w_packed" in p:
                part = _linear_partition(p, s, mesh, fsdp)
                attn = len(path) >= 2 and path[-1] in ("q", "k", "v", "o") \
                    and path[-2] in ("mixer", "cross")
                if part is None or (attn and not split_attn):
                    return dict(p)
                if "w" in p and cfg is not None and not latent \
                        and cfg.quantization == "ternary" \
                        and min(p["w"].shape[-2:]) >= cfg.ternary_min_dim:
                    raise ValueError(
                        "a latent ternary weight ternarizes as a whole "
                        "matrix: pack the params before sharding them "
                        "(training shards them with latent=True)")
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

def strip_marks(params) -> Tuple[Any, Dict[tuple, str]]:
    """(the tree without its ``"tp"`` marks, {path of a marked linear:
    its mark}): the optimizer, the error state and checkpoints walk plain
    trees of tensors."""
    marks: Dict[tuple, str] = {}

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
    """``tree`` with ``fn(linear_dict, mark)`` in place of every marked
    linear (the other nodes rebuilt, leaves shared)."""
    if isinstance(tree, dict):
        if path in marks:
            return fn(tree, marks[path])
        return {k: _map_linears(v, marks, fn, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_linears(v, marks, fn, path + (i,))
                for i, v in enumerate(tree)]
    return tree


def attach_marks(params, marks: Dict[tuple, str]):
    """The rank's tree as the model reads it: each marked linear with its
    ``"tp"`` mark."""
    return _map_linears(params, marks, lambda p, m: dict(p, tp=m))


def split_mask(params, marks: Dict[tuple, str]):
    """A tree of bools like ``params``: True where the leaf is a slice
    (every leaf of a column split; a row split's ``"w"``, not its whole
    bias), False where every rank holds the whole leaf."""
    def node(p, m):
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


def shard_tree(tree, marks: Dict[tuple, str], rank: int, tp: int):
    """Rank ``rank``'s slices of a whole tree shaped like the params (the
    params, AdamW's m or v): each marked linear sliced as ``shard_params``
    slices it, the rest shared."""
    return _map_linears(tree, marks, lambda p, m: _shard_linear(
        p, "n" if m == "gather" else m, rank, tp))


def gather_tree(tree, marks: Dict[tuple, str], group: Optional[Group]):
    """The whole tree from every rank's slices (``shard_tree``'s inverse):
    each marked linear's ``"w"`` (and a column split's ``"b"``)
    all-gathered over ``group`` in rank order."""
    if group is None or not marks:
        return tree

    def whole(p, m):
        out = dict(p)
        out["w"] = group.all_gather(p["w"], dim=-2 if m == "k" else -1)
        if "b" in p and m != "k":
            out["b"] = group.all_gather(p["b"], dim=-1)
        return out

    return _map_linears(tree, marks, whole)


def gemm_shard_fn(mesh, params) -> Callable:
    """``shard(path, w) -> (partition, tp)`` for ``ops.precompute_plans``
    over a rank's tree: it reads the partition ``shard_params`` recorded
    beside each packed shard (the lm head's gather is a column split), so
    each plan's collective follows where the bits actually live."""
    tp = mesh_axis_sizes(mesh).get(MODEL, 1)
    marks: Dict[int, str] = {}

    def note(path, p, spec):
        if isinstance(p.get("w_packed"), weights.TernaryWeight) \
                and p.get("tp"):
            marks[id(p["w_packed"])] = "n" if p["tp"] == "gather" \
                else p["tp"]

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
    page scales ``(..., KV)`` with their pages, everything else whole.
    Returns the tree with a spec (a tuple of axis entries, trailing
    ``None``s dropped) for each tensor."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    tp = mesh_axis_sizes(mesh).get(MODEL, 1)
    shardable = tp > 1 and kv % tp == 0

    def spec(x):
        shp = tuple(getattr(x, "shape", ()))
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
    mesh: the tree itself)."""
    if mesh is None:
        return layers
    tp = mesh_axis_sizes(mesh).get(MODEL, 1)

    def put(x):
        spec = cache_sharding(x, cfg, mesh)
        if MODEL not in spec:
            return x
        ax = spec.index(MODEL)
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
    torch.save(_tree_to(params, "cpu"), job["params"])
    job_path = os.path.join(workdir, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    procs = spawn_ranks("repro_torch.distributed.tp", "_follower_main",
                        job_path, range(1, mesh.tp))
    try:
        group = Group.join(job["store"], 0, mesh.tp, mesh.backend,
                           mesh.timeout_s)
    except Exception:
        stop_followers(None, procs, workdir)
        raise
    return group, procs, workdir


def spawn_ranks(module: str, fn: str, job_path: str, ranks):
    """One Python process a rank (``python -c``, so nothing of the
    caller's main module runs again), each calling ``module.fn(job_path,
    rank)`` with the port's ``src`` first on its PYTHONPATH."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    return [subprocess.Popen(
        [sys.executable, "-c", f"import sys; from {module} import {fn}; "
         f"{fn}(sys.argv[1], int(sys.argv[2]))", job_path, str(r)], env=env)
        for r in ranks]


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
                              device=str(device))
    eng._attach_group(group, rank)
    eng.load(_tree_to(params, device))
    del params
    eng.follow()
