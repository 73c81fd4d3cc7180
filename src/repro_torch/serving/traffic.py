"""Open-loop traffic harness of the port (``repro.serving.traffic``'s
counterpart).

Serving latency means something only under offered load: a closed loop
(submit everything, then drain, as ``run()`` does) lets the system set its
own arrival rate and hides the queueing that p99 TTFT exists to show. This
module draws a seeded arrival schedule (Poisson or bursty) ahead of time
and drives the engine from it open-loop: arrivals happen at their
scheduled times whether or not the engine keeps up, so saturation shows as
growing queue wait.

``make_schedule`` is pure and seeded, and draws from numpy exactly as
``repro``'s does: one configuration gives the same schedule, byte for
byte, in both packages, so an A/B (chunked against whole-prompt
admission) replays one workload against both engines. ``run_open_loop``
wraps the engine's ``begin_metrics``/``collect_metrics`` span and adds a
``traffic`` block to the JSON ``run()`` gives.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import clock as obs_clock

__all__ = ["Arrival", "TrafficConfig", "make_schedule", "run_open_loop"]


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Arrival process and workload shape.

    kind: "poisson" (exponential inter-arrivals at ``rate``) or "bursty"
        (bursts of ~``burst_size`` simultaneous arrivals, burst times
        Poisson at ``rate / burst_size``: the same mean rate, a worse
        tail).
    rate: mean offered load, requests a second.
    prompt_lens / prompt_weights: the prompt-length distribution (uniform
        weights by default). gen_lens: output budgets, drawn uniformly.
    """
    kind: str = "poisson"
    rate: float = 8.0
    n_requests: int = 64
    prompt_lens: Tuple[int, ...] = (16,)
    prompt_weights: Tuple[float, ...] = ()
    gen_lens: Tuple[int, ...] = (16,)
    burst_size: int = 8
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ("poisson", "bursty"):
            raise ValueError(f"kind must be 'poisson' or 'bursty', got "
                             f"{self.kind!r}")
        if not self.rate > 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if self.n_requests < 1 or self.burst_size < 1:
            raise ValueError("n_requests and burst_size must be >= 1")
        if not (self.prompt_lens and self.gen_lens):
            raise ValueError("prompt_lens and gen_lens must be non-empty")
        if self.prompt_weights and (len(self.prompt_weights)
                                    != len(self.prompt_lens)):
            raise ValueError("prompt_weights must match prompt_lens")


@dataclasses.dataclass
class Arrival:
    """One scheduled request: its offset in seconds from the start."""
    t: float
    prompt: np.ndarray
    max_new: int
    slo: Optional[object] = None


def make_schedule(tc: TrafficConfig, vocab_size: int,
                  classes: Sequence = (),
                  class_weights: Sequence[float] = ()) -> List[Arrival]:
    """A deterministic arrival schedule. ``classes`` (``SLOClass``es) are
    drawn per request by ``class_weights`` (uniform when omitted); none =
    all best effort."""
    rng = np.random.default_rng(tc.seed)
    n = tc.n_requests
    if tc.kind == "poisson":
        times = np.cumsum(rng.exponential(1.0 / tc.rate, size=n))
    else:
        # bursts arrive Poisson at rate / burst_size; a burst's members
        # share its instant (one admission round sees them together)
        times_l: List[float] = []
        t = 0.0
        while len(times_l) < n:
            t += float(rng.exponential(tc.burst_size / tc.rate))
            size = int(rng.geometric(1.0 / tc.burst_size))
            times_l.extend([t] * min(size, n - len(times_l)))
        times = np.asarray(times_l)

    pw = None
    if tc.prompt_weights:
        pw = np.asarray(tc.prompt_weights, np.float64)
        pw = pw / pw.sum()
    plens = rng.choice(np.asarray(tc.prompt_lens), size=n, p=pw)
    glens = rng.choice(np.asarray(tc.gen_lens), size=n)
    cls: List[Optional[object]] = [None] * n
    if classes:
        cw = None
        if class_weights:
            cw = np.asarray(class_weights, np.float64)
            cw = cw / cw.sum()
        picks = rng.choice(len(classes), size=n, p=cw)
        cls = [classes[int(i)] for i in picks]
    return [Arrival(t=float(times[i]),
                    prompt=rng.integers(0, vocab_size, size=int(plens[i]),
                                        dtype=np.int32),
                    max_new=int(glens[i]), slo=cls[i])
            for i in range(n)]


def run_open_loop(engine, schedule: Sequence[Arrival], *,
                  time_scale: float = 1.0,
                  deadline_s: Optional[float] = None,
                  ) -> Tuple[List[Any], Dict[str, Any]]:
    """Drive ``engine`` from ``schedule``: submit each arrival at (or as
    soon as possible after) its time, stepping the engine in between,
    until the schedule is spent and the engine drained. ``time_scale``
    compresses the schedule (0: everything at t = 0, a closed-loop
    drain); ``deadline_s`` is every request's wall-clock budget from its
    arrival (``engine.submit``'s). Returns ``(requests, metrics)``: the
    engine's JSON plus a ``traffic`` block."""
    if engine.params is None:
        raise RuntimeError("load(params) first")
    snap = engine.begin_metrics()
    t0 = obs_clock.now()
    reqs: List[Any] = []
    i, n = 0, len(schedule)
    late = 0.0
    while i < n or engine.has_work():
        now = obs_clock.now() - t0
        while i < n and schedule[i].t * time_scale <= now:
            a = schedule[i]
            late = max(late, now - a.t * time_scale)
            # stamp the intended arrival: a blocking step delays this loop,
            # and a late stamp would erase the head-of-line delay the open
            # loop exists to show
            reqs.append(engine.submit(a.prompt, a.max_new, slo=a.slo,
                                      deadline_s=deadline_s,
                                      submit_t=t0 + a.t * time_scale))
            i += 1
        if engine.has_work():
            engine.step()
        elif i < n:
            # idle until the next arrival, in short naps
            time.sleep(min(max(schedule[i].t * time_scale - now, 0.0),
                           0.005))
    metrics = engine.collect_metrics(snap)
    makespan = obs_clock.now() - t0
    span = schedule[-1].t - schedule[0].t if n > 1 else 0.0
    # one arrival, a zero span or time_scale 0 has no arrival rate: report
    # 0.0 and flag it
    degenerate = n <= 1 or span <= 0 or time_scale <= 0
    metrics["traffic"] = {
        "n": n,
        "time_scale": time_scale,
        "offered_rate": 0.0 if degenerate else round((n - 1) / span, 3),
        "degenerate_schedule": degenerate,
        "makespan_s": round(makespan, 4),
        # how far submission lagged the schedule at worst: a large value
        # means an engine step outran the arrival spacing
        "max_submit_lag_s": round(late, 4),
    }
    return reqs, metrics
