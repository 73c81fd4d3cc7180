"""Weight and training-state bridge between ``repro``'s layout and the
port's, so both packages compute the same function from the same weights
and a checkpoint of either restores in the other.

``params_from_numpy`` turns ``repro``'s parameter tree into the port's
per-layer parameters and ``params_to_numpy`` goes back; the
``opt_state_*`` pair does the same for AdamW's ``{"m", "v", "step"}``.

Input layout (what ``repro``'s ``LM.init`` + ``layers.pack_params`` give,
with every array leaf converted to numpy): ``{"embed": {"table"},
"block{j}": {...}, "final_norm": {...}, "unembed": {...}}`` where each
``block{j}`` leaf is stacked ``(n_groups, ...)`` over the layers
``g * period + j`` (``period`` is ``repro``'s: 1 for a uniform stack, 8
for jamba). A packed linear arrives as ``{"w_packed": {"packed" (uint32
words), "scale", "bias", "shape"}}``; a latent one as ``{"w"}``. A MoE
node is ``{"router", "w_in", "w_gate", "w_out"}`` (plus ``shared_*``)
with each bank latent ``(n_groups, E, K, N)`` or packed in the same dict
form, words ``(n_groups, E, ceil(K/16), N)``; an SSM mixer is its plain
arrays and packed or latent ``in_proj`` / ``out_proj``. A node may also
be a port container already (``weight_from_numpy``
builds one of any registered format from a ``repro`` container's leaves
and static fields); it is moved to the device and, inside a stacked
block, its leaves are sliced per layer like every other leaf. The port never imports ``repro``: turning
``repro``'s containers into those dicts or leaves is the caller's business.
Leaves may also be torch tensors (what ``checkpoint.restore`` gives).

An encoder-decoder's tree also holds ``enc_block`` (stacked over the
``cfg.enc_layers`` encoder blocks: the port's ``enc_layers`` list, one
entry a block) and ``enc_norm``; its decoder blocks carry ``norm_cross``
and ``cross`` inside ``block{j}``, like every other block leaf.

``params_to_numpy`` writes the port's parameters, latent or packed
(``Dense2Bit`` linears and banks, as the dicts above), in that layout
with ``repro``'s period. numpy has no bfloat16, so a bfloat16 leaf stays
a CPU tensor there; ``checkpoint.save`` stores it as ``repro`` does.
"""
from __future__ import annotations

from typing import Optional

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.weights import FORMATS, Dense2Bit, TernaryWeight
from repro_torch.device import resolve_device
from repro_torch.models.transformer import layer_period

__all__ = ["params_from_numpy", "params_to_numpy", "weight_from_numpy",
           "opt_state_from_numpy", "opt_state_to_numpy"]

_PACKED_KEYS = {"packed", "scale", "bias", "shape"}


def _tensor(arr, i: Optional[int], device) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return (arr if i is None else arr[i]).contiguous().clone().to(device)
    a = np.asarray(arr)
    if i is not None:
        a = a[i]
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)          # same bits, the port's word dtype
    if str(a.dtype) == "bfloat16":    # an ml_dtypes array (bf16 params)
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
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
        if _PACKED_KEYS - {"bias"} <= set(node) <= _PACKED_KEYS:
            return Dense2Bit.from_packed(
                _tensor(node["packed"], i, device), k=int(node["shape"][0]),
                scale=_convert(node["scale"], i, device),
                bias=_convert(node.get("bias"), i, device))
        return {k: _convert(v, i, device) for k, v in node.items()}
    return _tensor(node, i, device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Convert ``repro``'s (numpy) parameter tree into the port's params on
    ``device``, slicing the stacked blocks per layer."""
    dev = resolve_device(device)
    period = sum(1 for k in tree if k.startswith("block"))
    if period != layer_period(cfg):
        raise ValueError(f"tree has {period} stacked blocks; "
                         f"{cfg.name}'s {cfg.num_layers} layers repeat with "
                         f"period {layer_period(cfg)}")
    n_groups = cfg.num_layers // period
    layers = [None] * cfg.num_layers
    for j in range(period):
        for g in range(n_groups):
            layers[g * period + j] = _convert(tree[f"block{j}"], g, dev)
    out = {"embed": _convert(tree["embed"], None, dev), "layers": layers,
           "final_norm": _convert(tree["final_norm"], None, dev)}
    if cfg.is_encdec:
        out["enc_layers"] = [_convert(tree["enc_block"], i, dev)
                             for i in range(cfg.enc_layers)]
        out["enc_norm"] = _convert(tree["enc_norm"], None, dev)
    if "unembed" in tree:
        out["unembed"] = _convert(tree["unembed"], None, dev)
    return out


def _numpy(t: torch.Tensor):
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _words(t: torch.Tensor) -> np.ndarray:
    """int32 words -> ``repro``'s uint32 words, same bits."""
    return t.detach().cpu().numpy().view(np.uint32)


def _container(w: Dense2Bit, leaf) -> dict:
    return {"packed": _words(leaf("packed")),
            "scale": None if w.scale is None else _numpy(leaf("scale")),
            "bias": None if w.bias is None else _numpy(leaf("bias")),
            "shape": tuple(w.shape)}


def _tree(node):
    """A node outside the blocks -> numpy leaves (containers as dicts)."""
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    if isinstance(node, Dense2Bit):
        return _container(node, lambda f: getattr(node, f))
    return _numpy(node)


def _stack(layers):
    """Per-layer trees of tensors and ``Dense2Bit`` containers -> one tree
    of (G, ...) stacks, a container as ``{"packed", "scale", "bias",
    "shape"}``."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lay[k] for lay in layers]) for k in first}
    if isinstance(first, Dense2Bit):
        return _container(first, lambda f: torch.stack(
            [getattr(w, f).detach() for w in layers]))
    if not isinstance(first, torch.Tensor):
        raise TypeError(f"params_to_numpy takes tensors and Dense2Bit "
                        f"containers; got a {type(first).__name__} leaf")
    return _numpy(torch.stack([t.detach() for t in layers]))


def params_to_numpy(params: dict, cfg: ModelConfig) -> dict:
    """The port's parameters -> ``repro``'s tree (numpy leaves,
    ``block{j}`` stacked over the layers ``g * period + j``);
    ``params_from_numpy`` inverts it."""
    if len(params["layers"]) != cfg.num_layers:
        raise ValueError(f"{len(params['layers'])} layers for a "
                         f"{cfg.num_layers}-layer config")
    if len(params.get("enc_layers", ())) != cfg.enc_layers:
        raise ValueError(f"{len(params.get('enc_layers', ()))} encoder "
                         f"layers for a config with {cfg.enc_layers}")
    period = layer_period(cfg)
    out = {"embed": _tree(params["embed"])}
    for j in range(period):
        out[f"block{j}"] = _stack(params["layers"][j::period])
    if cfg.is_encdec:
        out["enc_block"] = _stack(params["enc_layers"])
        out["enc_norm"] = _tree(params["enc_norm"])
    out["final_norm"] = _tree(params["final_norm"])
    if "unembed" in params:
        out["unembed"] = _tree(params["unembed"])
    return out


def opt_state_to_numpy(state: dict, cfg: ModelConfig) -> dict:
    """AdamW's ``{"m", "v", "step"}`` in ``repro``'s layout."""
    return {"m": params_to_numpy(state["m"], cfg),
            "v": params_to_numpy(state["v"], cfg),
            "step": np.asarray(int(state["step"]), dtype=np.int32)}


def opt_state_from_numpy(tree: dict, cfg: ModelConfig,
                         device="cuda") -> dict:
    """``repro``'s AdamW state -> the port's, on ``device``."""
    dev = resolve_device(device)
    return {"m": params_from_numpy(tree["m"], cfg, dev),
            "v": params_from_numpy(tree["v"], cfg, dev),
            "step": torch.tensor(int(tree["step"]), dtype=torch.int32,
                                 device=dev)}
