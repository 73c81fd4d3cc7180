"""The serving fault model of the port (``repro.serving.faults``'s
counterpart, numpy only): two config objects and one seeded injector.

* ``FaultConfig`` + ``FaultInjector``: a deterministic chaos schedule.
  Each scheduler step the injector draws four uniforms from its own
  ``np.random.default_rng(seed)`` stream, whatever fires, so the schedule
  depends only on the seed and the step count and is byte-equal to
  ``repro``'s. A step can corrupt one live slot's decode logits with NaN,
  arm page-pool allocation failures, sleep, or fail a draft round.
  ``*_at`` tuples pin exact (1-based) steps; rates give soak runs a storm.
* ``ResilienceConfig``: the engine's response: per-request deadlines, a
  retry budget with exponential backoff for quarantined requests, the
  acceptance floor below which speculation is switched off, and
  admission pauses under page-pool pressure. Its defaults are inert.

The draft fields (``draft_fail_rate``, ``draft_fail_at``,
``spec_accept_floor``, ``spec_floor_window``) act on a speculative engine
(``ContinuousScheduler(spec=...)``) only, as in ``repro``; the draft
uniform is drawn every step either way, which keeps the draw order.

Failure semantics: every submitted request ends ``done`` or ``failed``
with a reason code; a quarantined request replays from its prompt to the
tokens an undisturbed run gives (greedy decode is deterministic); a fault
in one slot leaves the other slots' outputs unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["FaultConfig", "ResilienceConfig", "FaultInjector", "StepFaults",
           "FAIL_DEADLINE", "FAIL_NUMERIC", "FAIL_CANCELLED"]

# terminal failure reason codes (``Request.fail_reason``)
FAIL_DEADLINE = "deadline"            # wall-clock deadline exceeded
FAIL_NUMERIC = "nan_logits"           # non-finite logits, retries exhausted
FAIL_CANCELLED = "cancelled"          # explicit user cancellation


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded chaos schedule for ``ContinuousScheduler(faults=...)``.

    Rates are per-step probabilities; ``*_at`` tuples name step numbers
    (1-based, the engine's step counter, empty steps included) that fire
    unconditionally. A NaN fault corrupts every logit of one live slot
    (drawn from the same stream) inside the decode step, ahead of the
    finite guard; an OOM fault makes the next ``oom_burst`` page
    allocations fail (paged cache only); a slow fault sleeps ``slow_s``;
    a draft fault (speculative engines only) turns that step's round into
    one plain decode step, counted in ``draft_fallbacks``."""

    seed: int = 0
    nan_rate: float = 0.0
    oom_rate: float = 0.0
    oom_burst: int = 2
    slow_rate: float = 0.0
    slow_s: float = 0.02
    draft_fail_rate: float = 0.0
    nan_at: Tuple[int, ...] = ()
    oom_at: Tuple[int, ...] = ()
    slow_at: Tuple[int, ...] = ()
    draft_fail_at: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """The engine's response policy (``ContinuousScheduler(resilience=)``).

    * ``deadline_s``: default wall-clock budget of a request from submit
      (None: none). A request past it is cancelled wherever it is (queued,
      mid-prefill or decoding), its slot and pages are released, and it
      ends ``failed`` with reason ``"deadline"``.
    * ``max_retries``: quarantine replays a request may take before it
      ends ``failed`` with reason ``"nan_logits"``.
    * ``retry_backoff_s``: attempt n waits ``retry_backoff_s * 2**(n-1)``
      before re-admission; 0 retries at once.
    * ``spec_accept_floor`` / ``spec_floor_window``: a speculative
      engine whose mean acceptance over the last ``spec_floor_window``
      rounds falls below the floor switches speculation off for good
      (``spec_disabled``); 0 never does.
    * ``admission_pause_frac``: paged cache; while the free-page fraction
      is below it and requests are live, admission pauses. 0 never does.
    """

    deadline_s: Optional[float] = None
    max_retries: int = 2
    retry_backoff_s: float = 0.0
    spec_accept_floor: float = 0.0
    spec_floor_window: int = 16
    admission_pause_frac: float = 0.0


@dataclasses.dataclass
class StepFaults:
    """One step's fired faults (``FaultInjector.plan``)."""

    nan: bool = False
    oom: bool = False
    slow: bool = False
    draft_fail: bool = False


class FaultInjector:
    """Seeded fault schedule and injection counters.

    ``plan(step)`` draws exactly four uniforms a call; the NaN victim is
    drawn from the same stream when the fault is applied
    (``choose_slot``). ``injected`` counts faults applied: a NaN fault with
    no live slot, or an OOM fault on a dense cache, fizzles uncounted."""

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        self.injected: Dict[str, int] = {
            "nan_logits": 0, "page_oom": 0, "slow_step": 0, "draft_fail": 0}

    def plan(self, step: int) -> StepFaults:
        c = self.cfg
        u = self._rng.random(4)
        return StepFaults(
            nan=step in c.nan_at or u[0] < c.nan_rate,
            oom=step in c.oom_at or u[1] < c.oom_rate,
            slow=step in c.slow_at or u[2] < c.slow_rate,
            draft_fail=step in c.draft_fail_at or u[3] < c.draft_fail_rate)

    def choose_slot(self, live_slots: List[int]) -> Optional[int]:
        """Pick (and count) the NaN victim among the live slots, over the
        sorted slots, so the choice does not depend on dict order."""
        if not live_slots:
            return None
        victims = sorted(live_slots)
        slot = victims[int(self._rng.integers(len(victims)))]
        self.injected["nan_logits"] += 1
        return slot

    def count(self, kind: str) -> None:
        self.injected[kind] += 1

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())
