"""Weight bridge: ``repro``'s parameter tree, as nested dicts of numpy
arrays, into the port's per-layer parameters — so both packages compute
the same function from the same weights.

Input layout (what ``repro``'s ``LM.init`` + ``layers.pack_params`` give,
with every array leaf converted to numpy): ``{"embed": {"table"},
"block{j}": {...}, "final_norm": {...}, "unembed": {...}}`` where each
``block{j}`` leaf is stacked ``(n_groups, ...)`` over the layers
``g * period + j``. A packed linear arrives as ``{"w_packed": {"packed"
(uint32 words), "scale", "bias", "shape"}}``; a latent one as ``{"w"}``.
A node may also be a port container already (``weight_from_numpy``
builds one of any registered format from a ``repro`` container's leaves
and static fields); it is moved to the device and, inside a stacked
block, its leaves are sliced per layer like every other leaf. The port never imports ``repro``: turning
``repro``'s containers into those dicts or leaves is the caller's business.
"""
from __future__ import annotations

from typing import Optional

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.weights import FORMATS, Dense2Bit, TernaryWeight
from repro_torch.device import resolve_device

__all__ = ["params_from_numpy", "weight_from_numpy"]

_PACKED_KEYS = {"packed", "scale", "bias", "shape"}


def _tensor(arr, i: Optional[int], device) -> torch.Tensor:
    a = np.asarray(arr)
    if i is not None:
        a = a[i]
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)          # same bits, the port's word dtype
    return torch.from_numpy(a.copy()).to(device)


def weight_from_numpy(format_name: str, leaves: dict, shape, *,
                      device="cuda", **aux) -> TernaryWeight:
    """The port's ``format_name`` container from a ``repro`` container's
    array leaves as numpy (``packed`` / ``kt_indices`` / ``kt_counts`` /
    ``plus`` / ``minus``, ``scale``, ``bias``; a missing or ``None`` scale
    or bias stays ``None``) and its static fields (``shape`` and, as
    ``aux``, ``tile_k``, ``tile_n``, ``nnz``, ``occupied_tiles``). uint32
    words become the int32 view of the same bits."""
    if format_name not in FORMATS:
        raise ValueError(f"unknown ternary format {format_name!r}; "
                         f"registered: {sorted(FORMATS)}")
    cls = FORMATS[format_name]
    dev = resolve_device(device)
    kw = {f: (None if leaves.get(f) is None
              else _tensor(leaves[f], None, dev)) for f in cls._leaves}
    return cls(**kw, shape=tuple(int(d) for d in shape), **aux)


def _convert(node, i: Optional[int], device):
    if node is None:
        return None
    if isinstance(node, TernaryWeight):
        if i is not None:
            node = dataclasses.replace(node, **{
                f: getattr(node, f)[i] for f in node._leaves
                if getattr(node, f) is not None})
        return node.to(device)
    if isinstance(node, dict):
        if set(node) == _PACKED_KEYS:
            return Dense2Bit.from_packed(
                _tensor(node["packed"], i, device), k=int(node["shape"][0]),
                scale=_convert(node["scale"], i, device),
                bias=_convert(node["bias"], i, device))
        return {k: _convert(v, i, device) for k, v in node.items()}
    return _tensor(node, i, device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Convert ``repro``'s (numpy) parameter tree into the port's params on
    ``device``, slicing the stacked blocks per layer."""
    dev = resolve_device(device)
    period = sum(1 for k in tree if k.startswith("block"))
    if period == 0 or cfg.num_layers % period:
        raise ValueError(f"tree has {period} stacked blocks for "
                         f"{cfg.num_layers} layers")
    n_groups = cfg.num_layers // period
    layers = [None] * cfg.num_layers
    for j in range(period):
        for g in range(n_groups):
            layers[g * period + j] = _convert(tree[f"block{j}"], g, dev)
    out = {"embed": _convert(tree["embed"], None, dev), "layers": layers,
           "final_norm": _convert(tree["final_norm"], None, dev)}
    if "unembed" in tree:
        out["unembed"] = _convert(tree["unembed"], None, dev)
    return out
