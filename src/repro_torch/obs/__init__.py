"""Observability of the port, as in ``repro.obs``: one clock, one tracer,
one metrics registry.

``obs.clock``   — the monotonic clock every serving timestamp reads,
                  fakeable in tests (``FakeClock``, ``fake_clock``).
``obs.trace``   — the ring-buffer ``Tracer`` exporting Chrome trace-event
                  JSON (Perfetto, ``scripts/trace_report.py``).
``obs.metrics`` — counters, gauges, histograms, EWMAs and running stats
                  in a registry, and the percentile helper behind the
                  engine's metrics JSON.

The disabled path costs nothing: call sites hold ``tracer=None`` and test
it once.
"""
from repro_torch.obs import clock
from repro_torch.obs.metrics import (Counter, Ewma, Gauge, Histogram,
                                     MetricsRegistry, RunningStat,
                                     percentiles)
from repro_torch.obs.trace import Tracer, load_trace, validate_events

__all__ = [
    "clock", "trace", "metrics",
    "Tracer", "load_trace", "validate_events",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "Ewma",
    "RunningStat", "percentiles",
]
