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
``"1"``, ...) of torch tensors, numpy arrays or Python numbers. Restored
leaves are CPU torch tensors; unsigned integer arrays
wider than a byte come back as the signed tensor of the same bits, the
port's convention for packed words. The model's layout (``repro``'s
stacked ``block0`` leaves against the port's ``layers`` list) is
``checkpoint.convert``'s business.
"""
from __future__ import annotations

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


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
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
    flat = {k: _stored(v) for k, v in _flatten(state).items()}
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
    Without ``target`` the state is the flat ``{key: tensor}`` dict; a
    ``target`` tree fixes
    the structure, and each leaf takes the dtype of the target's leaf
    (anything with a ``dtype``). Every leaf's checksum is checked before
    use: a mismatch raises ``CheckpointCorruptError``."""
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
    if target is None:
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
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{SEP}{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, f"{prefix}{SEP}{i}" if prefix else str(i))
                    for i, v in enumerate(node)]
        return pick(prefix, node)

    return step, build(target, "")
