"""The single monotonic clock source for every serving-path timestamp of
the port (the ``now()`` of ``repro.obs.clock``). Deadlines, latency metrics
and trace stamps are compared with one another, so they all come from this
one function; ``time.time()`` (steppable by NTP) is never a substitute for
durations.
"""
from __future__ import annotations

import time

__all__ = ["now"]


def now() -> float:
    """Seconds from the process-wide monotonic source."""
    return time.monotonic()
