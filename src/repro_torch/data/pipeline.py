"""Deterministic synthetic token streams — the port's copy of
``repro.data.pipeline.SyntheticLM``.

Per-sequence affine recurrences ``x_{t+1} = (a*x_t + b) mod V`` plus
noise; a batch is a pure function of (seed, step), so both packages draw
the same prompts and training batches from the same seed, and a restarted
trainer regenerates any step without pipeline state. A VLM's batch also
holds ``vision_embeds`` and an encoder-decoder's ``enc_embeds``: (B,
``n_front``, d) float32 frontend rows drawn from the same generator after
the tokens; the text then takes the last ``text_len`` positions of the
``seq_len`` (at least 16), as ``repro``'s does.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, noise: float = 0.05):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.noise = noise
        # frontend split (vlm / encdec): text tokens occupy the tail
        self.n_front = cfg.frontend_seq if cfg.frontend or cfg.is_encdec \
            else 0
        if cfg.family == "vlm" or cfg.is_encdec:
            self.text_len = max(seq_len - self.n_front, 16)
        else:
            self.text_len = seq_len

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        v = cfg.vocab_size
        b, s = self.batch, self.text_len + 1
        a = rng.integers(1, 8, size=(b, 1))
        c = rng.integers(0, v, size=(b, 1))
        x = np.empty((b, s), dtype=np.int64)
        x[:, 0] = rng.integers(0, v, size=b)
        for t in range(1, s):
            x[:, t] = (a[:, 0] * x[:, t - 1] + c[:, 0]) % v
        flip = rng.random((b, s)) < self.noise
        x[flip] = rng.integers(0, v, size=int(flip.sum()))
        batch = {"tokens": x[:, :-1].astype(np.int32),
                 "targets": x[:, 1:].astype(np.int32)}
        front = (b, self.n_front, cfg.d_model)
        if cfg.family == "vlm":
            batch["vision_embeds"] = rng.standard_normal(front).astype(
                np.float32) * 0.02
        if cfg.is_encdec:
            batch["enc_embeds"] = rng.standard_normal(front).astype(
                np.float32) * 0.02
        return batch

    def sharded_batch(self, step: int, mesh=None, device="cpu", *,
                      rank: int = 0) -> Dict[str, torch.Tensor]:
        """The batch of ``step`` as tensors on ``device``: the global batch
        without a mesh; with one (a ``distributed.tp.Mesh``, ranks row
        major over its axes), rank ``rank``'s rows: each leaf's rows split
        evenly over the data axes (``("pod", "data")`` present in the mesh)
        where their product divides the batch, else the whole leaf (as
        ``repro``'s ``batch_sharding`` replicates it). Ranks that differ
        only in the ``"model"`` coordinate get the same rows."""
        arrs = self.global_batch(step)
        if mesh is not None:
            arrs = {k: _rank_rows(a, mesh, rank) for k, a in arrs.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for k, a in arrs.items()}


def _rank_rows(a: np.ndarray, mesh, rank: int) -> np.ndarray:
    """Rank ``rank``'s slice of ``a``'s rows over the mesh's data axes."""
    names, sizes = tuple(mesh.axis_names), tuple(mesh.sizes)
    coords = dict(zip(names, np.unravel_index(rank, sizes)))
    n, index = 1, 0
    for ax in ("pod", "data"):
        if ax in coords:
            n, index = n * mesh.shape[ax], index * mesh.shape[ax] + int(
                coords[ax])
    if n == 1 or a.shape[0] % n:
        return a
    rows = a.shape[0] // n
    return a[index * rows:(index + 1) * rows]
