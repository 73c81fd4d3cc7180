"""Logical-axis spec resolution (the port's copy of
``repro.distributed.sharding``'s rules).

Model code names each parameter axis with a *logical* name (``"fsdp"``,
``"model"``, ``"expert"``, or a literal mesh axis such as ``"data"``) in a
spec: a tuple with one entry per axis (``None``: not split; a tuple of
names: split over their product). ``resolve_spec`` turns one into the
mesh axes that really split each dimension, against a mesh given by its
axis names and sizes (``distributed.tp.Mesh``, anything with
``axis_names`` and a ``shape`` mapping, or a plain ``{name: size}``
dict), with ``repro``'s rules:

* divisibility: a dimension the axis (product) does not divide is
  replicated;
* no axis reuse within one spec (``"expert"`` takes the ``"model"`` axis,
  so an expert-parallel bank's d_ff dimension does not get it again);
* ``fsdp`` off: ``"fsdp"`` resolves to ``None``.

The result is a tuple of per-dimension entries (a name, a tuple of
names, or ``None``) with trailing ``None``s dropped, as ``PartitionSpec``
prints them. ``batch_sharding``, ``replicated`` and
``opt_state_shardings`` give the data-parallel trainer's placements in
the same form (``repro``'s ``NamedSharding`` trees as resolved spec
tuples).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

__all__ = ["FSDP", "MODEL", "EXPERT", "batch_axes", "resolve_spec",
           "resolve_specs", "batch_sharding", "replicated",
           "opt_state_shardings"]

FSDP = "fsdp"
MODEL = "model"
EXPERT = "expert"


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    return tuple(names) if names is not None else tuple(_sizes(mesh))


def _sizes(mesh) -> Dict[str, int]:
    return dict(getattr(mesh, "shape", mesh))


def _axes_size(sizes: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def batch_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a mesh, outermost first."""
    names = _axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def resolve_spec(spec: Sequence[Any], shape: Sequence[int], mesh,
                 fsdp: bool) -> Tuple[Any, ...]:
    """The mesh axes splitting each dimension of an array of ``shape``
    under the logical ``spec`` (module docstring), trailing ``None``s
    dropped."""
    names = set(_axis_names(mesh))
    sizes = _sizes(mesh)
    used: set = set()
    out = []
    spec = tuple(spec)
    entries = spec + (None,) * (len(shape) - len(spec))
    for dim, ax in zip(shape, entries):
        resolved: Any = None
        candidates: Tuple = ()
        if ax is None:
            candidates = ()
        elif ax == FSDP:
            candidates = (batch_axes(mesh),) if fsdp else ()
        elif ax == EXPERT:
            candidates = (MODEL,)
        elif isinstance(ax, (tuple, list)):
            kept = tuple(a for a in ax if a in names and a not in used)
            candidates = (kept,) if kept else ()
        else:
            candidates = (ax,) if ax in names else ()
        for cand in candidates:
            cand_t = (cand,) if isinstance(cand, str) else tuple(cand)
            if not cand_t or any(c in used for c in cand_t):
                continue
            if dim % _axes_size(sizes, cand_t) == 0:
                # a one-name tuple reads as the name (PartitionSpec's form)
                resolved = cand_t[0] if len(cand_t) == 1 else cand_t
                used.update(cand_t)
                break
        out.append(resolved)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def resolve_specs(spec_tree, shape_tree, mesh, fsdp: bool):
    """Resolve a spec tree against the matching tree of arrays (dicts and
    lists; a leaf is anything with a ``shape``; a packed container's spec
    twin is a dict of its fields): the same structure with each spec
    resolved. A ``None`` spec leaf (an absent bias) stays ``None``."""
    if isinstance(spec_tree, dict):
        def sub(k):
            return shape_tree[k] if isinstance(shape_tree, dict) \
                else getattr(shape_tree, k)
        return {k: resolve_specs(v, sub(k), mesh, fsdp)
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [resolve_specs(s, a, mesh, fsdp)
                for s, a in zip(spec_tree, shape_tree)]
    if spec_tree is None:
        return None
    shape = tuple(getattr(shape_tree, "shape", ()))
    return resolve_spec(spec_tree, shape, mesh, fsdp)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def batch_sharding(batch_tree, mesh):
    """The spec of every leaf of a batch: dimension 0 (the global batch)
    split over the data axes (``("pod", "data")`` present in the mesh)
    where their product divides it, else whole (``()``)."""
    axes = batch_axes(mesh)
    size = _axes_size(_sizes(mesh), axes)
    entry = axes[0] if len(axes) == 1 else axes

    def spec(x):
        shape = tuple(getattr(x, "shape", ()))
        if axes and shape and shape[0] % size == 0:
            return (entry,)
        return ()
    return _map(spec, batch_tree)


def replicated(tree, mesh):
    """Every leaf whole on every rank."""
    return _map(lambda _: (), tree)


def opt_state_shardings(param_shardings, opt_state_shape, mesh):
    """AdamW's ``{"m", "v", "step"}`` placements: m and v mirror the
    parameters' specs, a scalar (0-d) moment and the step are whole."""
    def like(params, shapes):
        if isinstance(params, dict):
            return {k: like(params[k], shapes[k]) for k in params}
        if isinstance(params, list):
            return [like(p, s) for p, s in zip(params, shapes)]
        return params if len(getattr(shapes, "shape", ())) > 0 else ()

    return {"m": like(param_shardings, opt_state_shape["m"]),
            "v": like(param_shardings, opt_state_shape["v"]),
            "step": ()}
