"""Ring-buffer tracer exporting Chrome trace-event JSON: the port's
counterpart of ``repro.obs.trace``, with the same ring entries, the same
event JSON and the same track layout, so ``scripts/trace_report.py`` and
Perfetto read the port's files as they read ``repro``'s.

- **Low overhead when on.** One event is one tuple appended to a
  ``deque(maxlen=capacity)``; nothing is formatted until ``export()``. The
  ring drops the oldest events (counted in ``dropped``); track names live
  outside the ring and survive overflow.
- **Zero cost when off.** Call sites hold ``tracer=None`` and test it once:
  the disabled path reads no clock and builds no event.
- **Perfetto-loadable.** ``export()`` writes ``{"traceEvents": [...]}``
  with complete ("X"), instant ("i"), counter ("C") and metadata ("M")
  events; timestamps are integer microseconds from the tracer's epoch.

Tracks: each engine registers a process (``new_pid``); its scheduler spans
live on ``tid=0`` and each request has its own track ``tid = rid + 1``.
Spans whose ends are known only afterwards (queue wait, prefill) are
emitted by ``complete()`` from the clock stamps the request metrics use,
so TTFT and TPOT rebuilt from a trace match ``Request.metrics()``.
"""
from __future__ import annotations

import collections
import contextlib
import json
from typing import Any, Dict, List, Optional

from repro_torch.obs import clock as obs_clock

__all__ = ["Tracer", "load_trace", "validate_events"]

# one ring entry: (ph, name, cat, ts_us, dur_us, pid, tid, args)
_COMPLETE, _INSTANT, _COUNTER = "X", "i", "C"


class Tracer:
    def __init__(self, capacity: int = 65536, clock=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._clock = clock if clock is not None else obs_clock.now
        self.t0 = self._clock()
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._process_names: Dict[int, str] = {}
        self._thread_names: Dict[tuple, str] = {}
        self._next_pid = 0

    # -- track naming (survives ring overflow) -------------------------
    def new_pid(self, name: str) -> int:
        pid = self._next_pid
        self._next_pid += 1
        self._process_names[pid] = name
        return pid

    def thread_name(self, pid: int, tid: int, name: str) -> None:
        self._thread_names[(pid, tid)] = name

    # -- events ---------------------------------------------------------
    def _ts(self, t: Optional[float]) -> int:
        return round(((self._clock() if t is None else t) - self.t0) * 1e6)

    def _push(self, ev: tuple) -> None:
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(ev)

    def complete(self, name: str, t_start: float, t_end: float, *,
                 cat: str = "engine", pid: int = 0, tid: int = 0,
                 args: Optional[dict] = None) -> None:
        """A span from two absolute clock stamps (request phases, whose
        ends the engine stamps on the request)."""
        self._push((_COMPLETE, name, cat, self._ts(t_start),
                    max(self._ts(t_end) - self._ts(t_start), 0),
                    pid, tid, args))

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "engine", pid: int = 0,
             tid: int = 0, args: Optional[dict] = None):
        """A span around a code region; ``args`` is read at its end, so the
        region may fill it in."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.complete(name, t0, self._clock(), cat=cat, pid=pid,
                          tid=tid, args=args)

    def instant(self, name: str, *, t: Optional[float] = None,
                cat: str = "engine", pid: int = 0, tid: int = 0,
                args: Optional[dict] = None) -> None:
        self._push((_INSTANT, name, cat, self._ts(t), 0, pid, tid, args))

    def counter(self, name: str, values: Dict[str, float], *,
                t: Optional[float] = None, pid: int = 0) -> None:
        """One sample of a multi-series counter (each key is a series)."""
        self._push((_COUNTER, name, "counter", self._ts(t), 0, pid, 0,
                    dict(values)))

    # -- export ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self._ring)

    def __bool__(self) -> bool:
        # an empty tracer is still a tracer: guards test `is not None`
        return True

    def events(self) -> List[Dict[str, Any]]:
        """The ring as trace-event dicts (no metadata), sorted by time:
        retrospective spans are pushed after later events."""
        out = []
        for ph, name, cat, ts, dur, pid, tid, args in self._ring:
            ev: Dict[str, Any] = {"ph": ph, "name": name, "cat": cat,
                                  "ts": ts, "pid": pid, "tid": tid}
            if ph == _COMPLETE:
                ev["dur"] = dur
            if ph == _INSTANT:
                ev["s"] = "t"          # thread-scoped instant
            if args is not None:
                ev["args"] = args
            out.append(ev)
        out.sort(key=lambda e: e["ts"])
        return out

    def to_dict(self) -> Dict[str, Any]:
        meta: List[Dict[str, Any]] = []
        for pid, name in sorted(self._process_names.items()):
            meta.append({"ph": "M", "name": "process_name", "pid": pid,
                         "tid": 0, "args": {"name": name}})
        for (pid, tid), name in sorted(self._thread_names.items()):
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tid, "args": {"name": name}})
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "capacity": self.capacity}}

    def export(self, path: str) -> int:
        """Write Perfetto-loadable JSON; returns the event count."""
        doc = self.to_dict()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc.get("traceEvents"), list):
        raise ValueError(f"{path} is not a Chrome trace-event object file")
    return doc


def validate_events(events: List[Dict[str, Any]]) -> None:
    """Raise ``ValueError`` unless every event has the trace-event fields,
    complete spans have integer durations >= 0, and every event tagged
    with a rid sits on that rid's track."""
    for ev in events:
        if not {"ph", "name", "pid", "tid"} <= set(ev):
            raise ValueError(f"event lacks a trace-event field: {ev}")
        if ev["ph"] == "M":
            continue
        if not isinstance(ev.get("ts"), int):
            raise ValueError(f"event without an integer ts: {ev}")
        if ev["ph"] == _COMPLETE and not (isinstance(ev.get("dur"), int)
                                          and ev["dur"] >= 0):
            raise ValueError(f"span without a duration >= 0: {ev}")
        rid = (ev.get("args") or {}).get("rid")
        if rid is not None and ev["tid"] != rid + 1:
            raise ValueError(f"rid {rid} event on track tid={ev['tid']}: "
                             f"{ev}")
