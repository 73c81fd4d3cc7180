"""Checkpoints in ``repro``'s on-disk format, so a checkpoint written by
either package restores in the other.

A save is one directory ``step_%08d/`` under the checkpoint directory,
renamed into place from a temporary one (a torn save never looks like a
checkpoint), holding ``state.npz`` — every leaf of the state tree under its
``/``-joined key path with ``/`` written as ``|`` — and ``manifest.json``
with each leaf's shape, true dtype and the crc32 of its stored bytes.
bfloat16 leaves, which numpy lacks, are stored as ``uint16`` with
``"bfloat16"`` in the manifest, as ``repro`` stores them. Restoring checks
every crc and raises ``CheckpointCorruptError`` on a mismatch;
``latest_step(verify=True)`` skips corrupt steps.

Trees are nested dicts and lists (list indices become keys ``"0"``,
``"1"``, ...) of torch tensors, numpy arrays, Python numbers and
``TernaryWeight`` containers. A container is stored leaf-wise, as
``repro`` stores its pytree (``.../w_packed/packed``, ``scale``, ``bias``;
a ``None`` leaf is not stored), its words as ``repro``'s uint32, and its
format and static fields (logical shape, ``nnz``, tile sizes) go into the
manifest's ``"containers"``, so a packed tree (MoE banks included)
restores bitwise with no skeleton. Restored leaves are CPU torch tensors;
unsigned integer arrays wider than a byte come back as the signed tensor
of the same bits, the port's convention for packed words. A ``repro``-
saved packed tree has no ``"containers"``: restore it into a port
skeleton (``target``: the config's model drawn, packed and written in
``repro``'s layout by ``convert.params_to_numpy``, its containers the
port's), which gives the static fields. The model's layout (``repro``'s
stacked ``block{j}`` leaves against the port's ``layers`` list) is
``checkpoint.convert``'s business.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
import tempfile
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.weights import FORMATS, TernaryWeight

__all__ = ["save", "restore", "latest_step", "unflatten",
           "CheckpointCorruptError"]

log = logging.getLogger("repro_torch.checkpoint")

SEP = "/"
_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
           np.dtype(np.uint64): np.int64}


class CheckpointCorruptError(RuntimeError):
    """A stored leaf's bytes no longer match the manifest's checksum;
    names the file and the leaf."""

    def __init__(self, path: str, key: str, expected: int, got: int):
        self.path = path
        self.key = key
        super().__init__(
            f"checkpoint corrupt: {os.path.join(path, 'state.npz')} leaf "
            f"{key!r} crc32 {got:#010x} != manifest {expected:#010x}")


def _join(prefix: str, k) -> str:
    return f"{prefix}{SEP}{k}" if prefix else str(k)


def _static(w: TernaryWeight) -> Dict[str, Any]:
    """A container's format and non-array fields, JSON-ready."""
    meta = {"format": w.format_name}
    for f in dataclasses.fields(w):
        if f.name not in w._leaves:
            v = getattr(w, f.name)
            meta[f.name] = list(v) if isinstance(v, tuple) else v
    return meta


def _flatten(tree, prefix: str, containers: Dict[str, Any]
             ) -> Dict[str, Any]:
    """Leaves by key path; a container's array leaves under its own path
    (its words viewed as uint32), its static fields into ``containers``."""
    if isinstance(tree, TernaryWeight):
        containers[prefix] = _static(tree)
        flat = {}
        for f in tree._leaves:
            v = getattr(tree, f)
            if v is None:
                continue
            if f == "packed" and v.dtype == torch.int32:
                v = v.detach().cpu().numpy().view(np.uint32)
            flat[_join(prefix, f)] = v
        return flat
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, _join(prefix, k), containers))
    return flat


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}`` (list indices stay keys)."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        *parents, last = key.split(SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def _stored(leaf) -> Tuple[np.ndarray, str]:
    """(the array as stored, its true dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    if str(a.dtype) == "bfloat16":          # an ml_dtypes array from repro
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).data)


def save(ckpt_dir: str, step: int, state: Any) -> str:
    """Atomically write ``state`` under ``ckpt_dir/step_<n>/``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    containers: Dict[str, Any] = {}
    flat = {k: _stored(v) for k, v in _flatten(state, "",
                                                containers).items()}
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "state.npz"),
                 **{k.replace(SEP, "|"): a for k, (a, _) in flat.items()})
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(a.shape), "dtype": dt,
                           "crc32": _crc(a)}
                       for k, (a, dt) in flat.items()},
        }
        if containers:
            manifest["containers"] = containers
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _step_corrupt(path: str) -> bool:
    """True when a step directory fails its integrity check: unreadable
    npz or manifest, or a leaf whose stored bytes miss their crc. Leaves
    without a recorded crc pass."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "state.npz")) as data:
            for k in data.files:
                want = manifest["leaves"].get(
                    k.replace("|", SEP), {}).get("crc32")
                if want is not None and _crc(data[k]) != want:
                    return True
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return True
    return False


def latest_step(ckpt_dir: str, verify: bool = False) -> Optional[int]:
    """Newest step under ``ckpt_dir``; with ``verify`` the newest one whose
    leaves all pass their checksums (corrupt steps are skipped with a
    warning), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted((int(m.group(1)) for d in os.listdir(ckpt_dir)
                    if (m := re.fullmatch(r"step_(\d+)", d))), reverse=True)
    if not verify:
        return steps[0] if steps else None
    for s in steps:
        path = os.path.join(ckpt_dir, f"step_{s:08d}")
        if _step_corrupt(path):
            log.warning("skipping corrupt checkpoint %s", path)
            continue
        return s
    return None


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype in _SIGNED:
        a = a.view(_SIGNED[a.dtype])
    return torch.from_numpy(a.copy())


def restore(ckpt_dir: str, step: Optional[int] = None,
            target: Any = None) -> Tuple[int, Any]:
    """(step, state) of ``step`` (default: the newest), as CPU tensors.
    Without ``target`` the state is the flat ``{key: tensor}`` dict, each
    container the manifest names rebuilt under its own key; a ``target``
    tree fixes the structure, and each leaf takes the dtype of the
    target's leaf (anything with a ``dtype``); a container in the target
    is rebuilt from its stored leaves, with the manifest's static fields
    or, for a checkpoint without them (``repro``'s), the target's. Every
    leaf's checksum is checked before use: a mismatch raises
    ``CheckpointCorruptError``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    with np.load(os.path.join(path, "state.npz")) as data:
        for k in data.files:
            key = k.replace("|", SEP)
            a = data[k]
            meta = manifest["leaves"].get(key, {})
            want = meta.get("crc32")
            if want is not None:
                got = _crc(a)
                if got != want:
                    raise CheckpointCorruptError(path, key, want, got)
            flat[key] = _tensor(a, meta.get("dtype", str(a.dtype)))
    containers = manifest.get("containers", {})
    if target is None:
        for prefix in containers:
            flat[prefix] = _container(flat, prefix, containers[prefix])
        return step, flat

    def pick(key, leaf):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = flat[key]
        want = getattr(leaf, "dtype", None)
        if isinstance(want, torch.dtype) and t.dtype != want:
            t = t.to(want)
        return t

    def build(node, prefix):
        if isinstance(node, TernaryWeight):
            return _container(flat, prefix,
                              containers.get(prefix, _static(node)))
        if isinstance(node, dict):
            return {k: build(v, _join(prefix, k)) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, _join(prefix, i)) for i, v in enumerate(node)]
        return pick(prefix, node)

    return step, build(target, "")


def _container(flat: Dict[str, Any], prefix: str,
               meta: Dict[str, Any]) -> TernaryWeight:
    """The ``meta["format"]`` container at ``prefix``: its array leaves
    taken (and removed) from ``flat``, its static fields from ``meta``."""
    cls = FORMATS[meta["format"]]
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in meta.items() if k != "format"}
    for f in cls._leaves:
        kw[f] = flat.pop(_join(prefix, f), None)
    return cls(**kw)
