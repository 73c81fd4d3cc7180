"""Fault tolerance of the training loop (``repro.distributed.
fault_tolerance``): checkpoint/restart supervision and a straggler
watchdog.

* ``TrainSupervisor`` wraps the step loop: a checkpoint every
  ``ckpt_every`` steps and at the end; on an exception in a step, a
  restart from the newest intact checkpoint (``latest_step(verify=True)``),
  at most ``max_restarts`` times.
* ``StragglerWatchdog`` flags a step slower than ``factor`` x the step-time
  EWMA — compared with the EWMA *before* the step updates it; the first
  observation seeds it and is never flagged — and keeps the newest
  ``events_cap`` straggler records in a ring.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

from repro_torch import checkpoint as ckpt_lib
from repro_torch.obs import clock as obs_clock
from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["StragglerWatchdog", "TrainSupervisor"]

log = logging.getLogger("repro_torch.ft")


class StragglerWatchdog:
    """EWMA step-time tracker flagging slow steps (> factor x EWMA); its
    EWMA and straggler count live in a ``MetricsRegistry``."""

    def __init__(self, factor: float = 2.0, alpha: float = 0.1,
                 ewma: Optional[float] = None, straggler_steps: int = 0,
                 events: Optional[list] = None, events_cap: int = 256,
                 registry: Optional[MetricsRegistry] = None):
        self.factor = factor
        self.alpha = alpha
        self.registry = registry if registry is not None else MetricsRegistry()
        self._ewma = self.registry.ewma("step_time_s", alpha=alpha)
        self._count = self.registry.counter("straggler_steps")
        if ewma is not None:
            self._ewma.value = float(ewma)
        if straggler_steps:
            self._count.value = int(straggler_steps)
        # a bounded ring of the newest (step, dt, ewma) straggler records;
        # straggler_steps stays exact over every observation
        self.events: list = list(events) if events is not None else []
        self.events_cap = events_cap
        self._ring_i = 0

    @property
    def ewma(self) -> Optional[float]:
        return self._ewma.value

    @ewma.setter
    def ewma(self, v: Optional[float]) -> None:
        self._ewma.value = v

    @property
    def straggler_steps(self) -> int:
        return self._count.value

    @straggler_steps.setter
    def straggler_steps(self, v: int) -> None:
        self._count.value = int(v)

    def observe(self, step: int, dt: float) -> bool:
        ewma = self._ewma.value
        is_straggler = ewma is not None and dt > self.factor * ewma
        if is_straggler:
            self._count.inc()
            if len(self.events) < self.events_cap:
                self.events.append((step, dt, ewma))
            else:
                self.events[self._ring_i] = (step, dt, ewma)
                self._ring_i = (self._ring_i + 1) % self.events_cap
            log.warning("straggler: step %d took %.3fs (ewma %.3fs)",
                        step, dt, ewma)
        self._ewma.update(dt)
        return is_straggler


class TrainSupervisor:
    """Run a step function with checkpoint/restart semantics.

    ``make_state(restore_step_or_None) -> (step, state)`` builds fresh
    state or restores; ``step_fn(step, state) -> (state, metrics)``. An
    exception inside a step rebuilds the state from the newest intact
    checkpoint (the "restart") and resumes there; ``max_restarts`` bounds
    the crash loop. ``to_checkpoint(state)`` gives the tree that is saved
    (default: the state itself), e.g. the state in ``repro``'s layout.
    """

    def __init__(self, ckpt_dir: str, make_state: Callable,
                 step_fn: Callable, ckpt_every: int = 100,
                 max_restarts: int = 3,
                 watchdog: Optional[StragglerWatchdog] = None,
                 to_checkpoint: Optional[Callable] = None):
        self.ckpt_dir = ckpt_dir
        self.make_state = make_state
        self.step_fn = step_fn
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.watchdog = watchdog or StragglerWatchdog()
        self.to_checkpoint = to_checkpoint or (lambda state: state)
        self.restarts = 0

    def run(self, num_steps: int, failure_injector: Optional[Callable] = None):
        """Returns (final_state, history of (step, metrics)).
        ``failure_injector(step)`` may raise (a test hook standing in for a
        node failure)."""
        resume = ckpt_lib.latest_step(self.ckpt_dir)
        step, state = self.make_state(resume)
        history = []
        while step < num_steps:
            try:
                t0 = obs_clock.now()
                if failure_injector is not None:
                    failure_injector(step)
                state, metrics = self.step_fn(step, state)
                self.watchdog.observe(step, obs_clock.now() - t0)
                history.append((step, metrics))
                step += 1
                if step % self.ckpt_every == 0 or step == num_steps:
                    ckpt_lib.save(self.ckpt_dir, step,
                                  self.to_checkpoint(state))
            except Exception as e:  # noqa: BLE001 — any worker failure
                self.restarts += 1
                log.error("step %d failed (%s); restart %d/%d",
                          step, e, self.restarts, self.max_restarts)
                if self.restarts > self.max_restarts:
                    raise
                # resume from the newest checkpoint that passes its
                # checksums: a save torn by this very failure must not
                # seed a crash loop
                resume = ckpt_lib.latest_step(self.ckpt_dir, verify=True)
                step, state = self.make_state(resume)
        return state, history
