"""The port's copy of ``repro.obs.metrics``' primitives: the one
percentile definition the engine's latency aggregates use; counters,
gauges, windowed histograms, the step-time EWMA the engine and the
straggler watchdog keep, and bounded running aggregates, in a name-keyed
registry. Every primitive holds bounded memory."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "Ewma", "RunningStat",
           "MetricsRegistry", "percentiles"]


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


class Histogram:
    """Value distribution with exact percentiles over a bounded window: the
    newest ``cap`` observations are kept (a ring), the count stays exact."""

    __slots__ = ("name", "n", "_ring", "_cap", "_i")

    def __init__(self, name: str, cap: int = 4096):
        self.name = name
        self.n = 0
        self._ring: List[float] = []
        self._cap = cap
        self._i = 0

    def observe(self, v: float) -> None:
        self.n += 1
        if len(self._ring) < self._cap:
            self._ring.append(float(v))
        else:
            self._ring[self._i] = float(v)
            self._i = (self._i + 1) % self._cap

    def percentiles(self) -> Optional[Dict[str, float]]:
        p = percentiles(self._ring)
        if p is not None:
            p["n"] = self.n            # exact count, windowed detail
        return p


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


class RunningStat:
    """count/sum/peak in O(1) state (``mean`` and ``peak`` exact over every
    pushed sample) plus a ring of the newest ``cap`` samples."""

    __slots__ = ("name", "n", "total", "peak", "ring", "_cap", "_i")

    def __init__(self, name: str = "", cap: int = 1024):
        self.name = name
        self.n = 0
        self.total = 0
        self.peak = 0
        self.ring: List[int] = []
        self._cap = cap
        self._i = 0

    def push(self, v: int) -> None:
        v = int(v)
        self.n += 1
        self.total += v
        self.peak = max(self.peak, v)
        if len(self.ring) < self._cap:
            self.ring.append(v)
        else:
            self.ring[self._i] = v
            self._i = (self._i + 1) % self._cap

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0


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

    def histogram(self, name: str, cap: int = 4096) -> Histogram:
        return self._get(name, Histogram, cap=cap)

    def ewma(self, name: str, alpha: float = 0.1) -> Ewma:
        return self._get(name, Ewma, alpha=alpha)

    def stat(self, name: str, cap: int = 1024) -> RunningStat:
        return self._get(name, RunningStat, cap=cap)

    def reset(self, name: str) -> None:
        """Drop a metric so the next get-or-create starts it afresh."""
        self._metrics.pop(name, None)

    def snapshot(self) -> Dict[str, object]:
        """Counters, gauges and EWMAs by value; histograms by their
        percentiles; running stats as ``{"n", "mean", "peak"}``."""
        out: Dict[str, object] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out[name] = m.percentiles()
            elif isinstance(m, RunningStat):
                out[name] = {"n": m.n, "mean": m.mean, "peak": m.peak}
            else:
                out[name] = m.value
        return out

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)
