"""Sharded training state over the data group (``cfg.fsdp``).

``repro`` places each parameter by its logical spec under GSPMD: where
``cfg.fsdp`` is set, the dimension a spec names ``"fsdp"`` is split over
the data axes (``sharding.resolve_spec``), AdamW's ``m`` and ``v`` follow
their parameter and the step is whole (``opt_state_shardings``); XLA
gathers a weight before its use and reduce-scatters its gradient. The
port runs one process a rank, so it does that itself:

* ``data_marks``: for each leaf the dimension that ``resolve_spec`` puts
  on the data axes, or None (the leaf stays whole: no ``"fsdp"`` entry,
  ``fsdp`` off, or a dimension the data axes do not divide), from the
  whole tree's shapes and its spec twin;
* ``shard_data`` / ``gather_data``: a rank's contiguous slice of each
  marked leaf (rank ``d`` of ``dp`` keeps block ``d``), and the whole
  leaf from the ranks' slices. A tensor-parallel rank is cut over the
  model axis first (``tp.shard_tree``), then over the data axes; the
  two splits never share a dimension;
* ``gather_data`` under autograd is ``_GatherShard``: the forward
  all-gathers, the backward reduce-scatters the whole gradient summed in
  f32 and divides it by the group's size — the mean that
  ``steps.mean_all_reduce`` takes, so at two ranks its bits are the
  all-reduce's;
* ``Shards``: the marks and the data group of a model whose parameters
  are shards (``LM.shards``): the model gathers each block inside the
  call that remat recomputes, so one block's weights are whole at a
  time and the backward gathers them again.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.distributed import sharding

__all__ = ["Shards", "data_marks", "shard_data", "gather_data",
           "state_bytes"]


@dataclasses.dataclass(frozen=True)
class Shards:
    """A model's data-axis placement: ``marks`` (``data_marks``: a tree
    like the parameters, the split dimension or None at each leaf) and
    ``group`` (the rank's ``tp.Group`` over the data ranks)."""

    marks: Any
    group: Any

    def sub(self, *path):
        """The marks under ``path`` (keys and list indices)."""
        node = self.marks
        for k in path:
            node = node[k]
        return node


def _data_entry(mesh):
    axes = sharding.batch_axes(mesh)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def data_marks(shapes, specs, mesh, fsdp: bool):
    """The data-axis split of every leaf of a whole parameter tree
    (``shapes``: tensors or ``meta`` stand-ins; ``specs``: its logical
    spec twin, ``LM.param_specs``) on ``mesh``: the index of the
    dimension whose resolved entry is the data axes, else None. A packed
    container stays whole (training holds latent weights)."""
    entry = _data_entry(mesh)

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(v, s[k] if s is not None else None)
                    for k, v in p.items()}
        if isinstance(p, list):
            return [walk(v, s[i] if s is not None else None)
                    for i, v in enumerate(p)]
        if not isinstance(p, torch.Tensor) or s is None or entry is None:
            return None
        res = sharding.resolve_spec(s, tuple(p.shape), mesh, fsdp)
        for i, e in enumerate(res):
            if e == entry:
                return i
        return None

    return walk(shapes, specs)


def _zip_map(fn, tree, marks):
    """``fn(leaf, mark)`` at every marked leaf of ``tree``; keys the marks
    lack (a tensor-parallel ``"tp"`` mark) and unmarked leaves kept."""
    if isinstance(tree, dict):
        return {k: (_zip_map(fn, v, marks[k]) if k in marks else v)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, m) for v, m in zip(tree, marks)]
    return tree if marks is None else fn(tree, marks)


def shard_data(tree, marks, d: int, dp: int):
    """Rank ``d`` of ``dp``'s slices of a tree shaped like the parameters
    (the params, AdamW's m or v): each marked leaf's block ``d`` along its
    dimension, in storage of its own (the whole can be freed)."""
    def cut(t, dim):
        step = t.shape[dim] // dp
        return t.narrow(dim, d * step, step).clone(
            memory_format=torch.contiguous_format)
    return _zip_map(cut, tree, marks)


class _GatherShard(torch.autograd.Function):
    """A data shard made whole: all-gathered along ``dim``; the backward
    reduce-scatters the whole gradient summed in f32, / the group's size,
    in the gradient's dtype."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim=dim)

    @staticmethod
    def backward(ctx, g):
        part = ctx.group.reduce_scatter(g.float(), dim=ctx.dim)
        return (part / ctx.group.size).to(g.dtype), None, None


def gather_data(tree, marks, group):
    """The whole tree from every data rank's slices (``shard_data``'s
    inverse): each marked leaf all-gathered over ``group`` in rank order,
    differentiably (``_GatherShard``) where a gradient is being taken.
    No group or no marks: the tree itself."""
    if group is None or marks is None:
        return tree

    def whole(t, dim):
        if torch.is_grad_enabled() and t.requires_grad:
            return _GatherShard.apply(t, group, dim)
        return group.all_gather(t, dim=dim)
    return _zip_map(whole, tree, marks)


def state_bytes(params, opt: Optional[dict] = None) -> int:
    """The bytes of a rank's parameters and AdamW's ``m`` and ``v`` (the
    step left out)."""
    from repro_torch.optim.optimizers import tree_leaves
    trees = [params] + ([opt["m"], opt["v"]] if opt is not None else [])
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))
