"""The port's copy of ``repro.obs.metrics``' primitives: O(1) running
aggregates and the one percentile definition the engine's latency
aggregates use; counters, gauges and the step-time EWMA the straggler
watchdog keeps, in a name-keyed registry."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["Counter", "Gauge", "Ewma", "RunningStat", "MetricsRegistry",
           "percentiles"]


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


class Counter:
    """Monotonically growing event count (``value`` is writable)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> int:
        self.value += n
        return self.value


class Gauge:
    """Last-written level."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> float:
        self.value = float(v)
        return self.value


class Ewma:
    """Exponentially weighted moving average, seeded by the first
    observation (``value`` is None until then)."""

    __slots__ = ("name", "alpha", "value")

    def __init__(self, name: str, alpha: float = 0.1):
        # alpha=0 freezes the value at the seed; alpha=1 tracks the newest
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must lie in [0, 1], got {alpha}")
        self.name = name
        self.alpha = alpha
        self.value: Optional[float] = None

    def update(self, v: float) -> float:
        self.value = (float(v) if self.value is None
                      else (1.0 - self.alpha) * self.value
                      + self.alpha * float(v))
        return self.value


class MetricsRegistry:
    """Name-keyed get-or-create store of the primitives above; a name is
    bound to one kind for the registry's lifetime."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, kind, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = kind(name, **kw)
        if type(m) is not kind:
            raise TypeError(f"metric {name!r} is a {type(m).__name__}, not "
                            f"{kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def ewma(self, name: str, alpha: float = 0.1) -> Ewma:
        return self._get(name, Ewma, alpha=alpha)

    def snapshot(self) -> Dict[str, object]:
        """Every metric's current value, by name."""
        return {name: m.value for name, m in sorted(self._metrics.items())}
