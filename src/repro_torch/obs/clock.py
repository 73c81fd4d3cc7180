"""The single monotonic clock source for every serving-path timestamp of
the port (``repro.obs.clock``'s counterpart). Deadlines, latency metrics
and trace stamps are compared with one another, so they all come from this
one function; ``time.time()`` (steppable by NTP) is never a substitute for
durations. Tests swap the source with ``set_clock`` / ``fake_clock`` so
trace and metrics output is deterministic.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

__all__ = ["now", "set_clock", "reset_clock", "FakeClock", "fake_clock"]

_clock: Callable[[], float] = time.monotonic


def now() -> float:
    """Seconds from the process-wide monotonic source (or the installed
    fake)."""
    return _clock()


def set_clock(fn: Callable[[], float]) -> Callable[[], float]:
    """Install ``fn`` as the clock source; returns the previous source so
    the caller can restore it (prefer ``fake_clock``)."""
    global _clock
    prev = _clock
    _clock = fn
    return prev


def reset_clock() -> None:
    """Restore the real ``time.monotonic`` source."""
    global _clock
    _clock = time.monotonic


class FakeClock:
    """Deterministic test clock: starts at ``t0`` and advances only by
    ``advance()``, plus ``tick`` added on every read so code that waits on
    the clock still sees it move."""

    def __init__(self, t0: float = 0.0, tick: float = 0.0):
        self.t = float(t0)
        self.tick = float(tick)

    def __call__(self) -> float:
        self.t += self.tick
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0.0:
            raise ValueError(f"monotonic clocks cannot rewind ({dt})")
        self.t += dt
        return self.t


@contextlib.contextmanager
def fake_clock(clock: Optional[FakeClock] = None, **kw):
    """``with fake_clock(tick=0.01) as fc: ...`` installs a ``FakeClock``
    for the scope and always restores the previous source."""
    fc = clock if clock is not None else FakeClock(**kw)
    prev = set_clock(fc)
    try:
        yield fc
    finally:
        set_clock(prev)
