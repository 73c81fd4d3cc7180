"""Optimizers over parameter trees (nested dicts and lists of tensors), the
port's copy of ``repro.optim.optimizers``: ``adamw`` and ``sgd_momentum``
as ``(init, update)`` pairs, and global-norm clipping.

The state keeps ``repro``'s layout, ``{"m", "v", "step"}`` with ``m`` and
``v`` mirroring the parameter tree, so it carries across checkpoints of
either package (``checkpoint.convert``), and each update runs ``repro``'s
operations in its order, in float32 (``torch.optim.AdamW`` rounds in
another order). Weight decay applies to every floating leaf, as in
``repro``.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

__all__ = ["adamw", "sgd_momentum", "clip_by_global_norm", "global_norm",
           "tree_map", "tree_leaves"]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of
    ``rest``), keeping its structure: dicts and lists are nodes, anything
    else (a tensor, a tuple) is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    out = []
    tree_map(out.append, tree)
    return out


def global_norm(tree, split=None, group=None, data=None,
                data_group=None) -> torch.Tensor:
    """The L2 norm of every floating leaf. Under tensor parallelism
    (``group`` a ``distributed.tp.Group``, ``split`` a tree of bools like
    ``tree``: ``tp.split_mask``) a rank holds slices of the split leaves
    and the whole of the rest: the split leaves' squares are summed over
    the group, the replicated leaves' counted once, so every rank gets the
    same norm. A ``split`` leaf may also be a bool tensor over the leaf's
    last axis (a split SSM in_proj's columns: False at the replicated
    ones), or a float: the share of the leaf's squares this rank counts
    in the group's sum (a K/V head held by several ranks). ``data`` (``fsdp.data_marks``, not None where a leaf is a data
    shard) and ``data_group``: the shards' squares are summed over the
    data group as well, so every leaf counts once. The squares go in four
    sums by (tensor-parallel slice, data shard); the data shards' two are
    all-reduced over the data group in one call, then the slices' over
    the model group (a sum with nothing in it adds an exact 0)."""
    xs = tree_leaves(tree)
    splits = tree_leaves(split) if split is not None else [False] * len(xs)
    shards = tree_leaves(tree_map(lambda _, m: m is not None, tree, data)) \
        if data is not None else [False] * len(xs)
    sums = {(t, d): [] for t in (True, False) for d in (True, False)}
    for x, s, d in zip(xs, splits, shards):
        if not x.is_floating_point():
            continue
        sq = x.float().square()
        if isinstance(s, torch.Tensor):
            sums[True, d].append((sq * s).sum())
            sums[False, d].append((sq * ~s).sum())
        elif isinstance(s, float):
            sums[True, d].append(sq.sum() * s)
        else:
            sums[bool(s), d].append(sq.sum())
    zero = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    tot = {k: torch.stack(v).sum() if v else zero for k, v in sums.items()}
    both = torch.stack([tot[True, True], tot[False, True]])
    if data_group is not None:
        both = data_group.all_reduce(both)
    part = tot[True, False] + both[0]
    if group is not None:
        part = group.all_reduce(part)
    return torch.sqrt(part + tot[False, False] + both[1])


def clip_by_global_norm(grads, max_norm: float, split=None, group=None,
                        data=None, data_group=None):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), norm);
    ``split``, ``group``, ``data`` and ``data_group`` as
    ``global_norm``'s."""
    norm = global_norm(grads, split, group, data, data_group)
    factor = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g * factor).to(g.dtype)
                    if g.is_floating_point() else g, grads), norm


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, state_dtype: str = "float32"
          ) -> Tuple[Callable, Callable]:
    sdt = getattr(torch, state_dtype)

    def init(params):
        def zeros(p):
            if p.is_floating_point():
                return torch.zeros_like(p, dtype=sdt)
            return torch.zeros((), dtype=sdt, device=p.device)
        device = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        step = state["step"] + 1
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

        def upd(g, m, v, p):
            if not p.is_floating_point():
                return p, m, v
            gf = g.float()
            m_new = b1 * m.float() + (1 - b1) * gf
            v_new = b2 * v.float() + (1 - b2) * gf.square()
            mhat = m_new / c1
            vhat = v_new / c2
            delta = mhat / (torch.sqrt(vhat) + eps) \
                + weight_decay * p.float()
            p_new = p.float() - lr * delta
            return p_new.to(p.dtype), m_new.to(sdt), v_new.to(sdt)

        out = tree_map(upd, grads, state["m"], state["v"], params)
        # out has the params' structure with (p, m, v) triples as leaves
        pick = (lambda i: tree_map(lambda o, _: o[i], out, params))
        return pick(0), {"m": pick(1), "v": pick(2), "step": step}

    return init, update


def sgd_momentum(momentum: float = 0.9) -> Tuple[Callable, Callable]:
    def init(params):
        device = tree_leaves(params)[0].device
        return {"m": tree_map(torch.zeros_like, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        new_m = tree_map(lambda m, g: momentum * m + g, state["m"], grads)
        new_p = tree_map(lambda p, m: (p - lr * m).to(p.dtype), params,
                         new_m)
        return new_p, {"m": new_m, "step": state["step"] + 1}

    return init, update
