"""The port's copy of the ``RunningStat`` / ``percentiles`` part of
``repro.obs.metrics``: O(1) running aggregates and the one percentile
definition the engine's latency aggregates use."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["RunningStat", "percentiles"]


def percentiles(values) -> Optional[Dict[str, float]]:
    """Exact p50/p90/p99 (+ mean/max/n) over the non-None values, or None
    when nothing was measured."""
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    a = np.asarray(vals, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean()), "max": float(a.max()),
            "n": int(a.size)}


class RunningStat:
    """count/sum/peak in O(1) state: ``mean`` and ``peak`` are exact over
    every pushed sample."""

    __slots__ = ("name", "n", "total", "peak")

    def __init__(self, name: str = ""):
        self.name = name
        self.n = 0
        self.total = 0
        self.peak = 0

    def push(self, v: int) -> None:
        v = int(v)
        self.n += 1
        self.total += v
        self.peak = max(self.peak, v)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0
