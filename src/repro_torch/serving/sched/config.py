"""Scheduling configuration of the port: request SLO classes and the
chunked-prefill token budget (``repro.serving.sched.config``'s
counterpart, field for field).

``SLOClass`` names a request class and its latency objectives. They are
objectives, not guarantees: the scheduler orders admission by (priority,
TTFT deadline), lets deadline-pressed prefills claim more of a step, and
reports per-class violation counts in ``run()``'s metrics.

``SchedConfig`` switches the engine from grouped whole-prompt prefill to
chunked prefill: each step spends at most ``step_token_budget`` tokens of
model forward work; the decode batch is charged first (one token a live
slot) and mid-prefill requests split the rest in chunks of at most
``chunk_tokens``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["SLOClass", "DEFAULT_SLO_CLASSES", "SchedConfig"]


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A request class with latency objectives.

    priority: lower runs first (ties broken by TTFT deadline, then submit
        order). Best-effort requests (``Request.slo is None``) get priority
        0 and no deadline, so a workload without classes is FIFO.
    ttft_target_s: time-to-first-token objective from submit; sets the
        admission deadline (``submit_t + ttft_target_s``) and the
        deadline-pressure rule of ``plan_chunks``.
    tpot_target_s: decode time-per-output-token objective; when the
        engine's recent step time is above the tightest live target, the
        prefill share of a step halves.
    """
    name: str
    ttft_target_s: Optional[float] = None
    tpot_target_s: Optional[float] = None
    priority: int = 0


# an interactive/batch split for the serve CLI and the chip check; real
# deployments define their own
DEFAULT_SLO_CLASSES: Tuple[SLOClass, ...] = (
    SLOClass("interactive", ttft_target_s=0.5, tpot_target_s=0.1,
             priority=0),
    SLOClass("batch", ttft_target_s=10.0, tpot_target_s=None, priority=1),
)


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """Chunked prefill and admission policy.

    chunk_tokens: most prompt tokens a request prefills in one step; 0
        turns chunking off (whole-prompt prefill, SLO-ordered admission).
    step_token_budget: most model-forward tokens a step (decode charged
        first, chunks fill the rest); 0 = ``max_slots + chunk_tokens``, a
        full decode batch plus one chunk.
    admission: "slo" orders the queue by (priority, TTFT deadline, submit
        order); "fifo" keeps FIFO admission (chunking still applies).
    """
    chunk_tokens: int = 64
    step_token_budget: int = 0
    admission: str = "slo"

    def __post_init__(self):
        if self.chunk_tokens < 0:
            raise ValueError(f"chunk_tokens must be >= 0, got "
                             f"{self.chunk_tokens}")
        if self.step_token_budget < 0:
            raise ValueError(f"step_token_budget must be >= 0, got "
                             f"{self.step_token_budget}")
        if self.admission not in ("slo", "fifo"):
            raise ValueError(f"admission must be 'slo' or 'fifo', got "
                             f"{self.admission!r}")

    @property
    def chunked(self) -> bool:
        return self.chunk_tokens > 0

    def budget_for(self, max_slots: int, spec_k: int = 0) -> int:
        """The step's token budget for an engine of ``max_slots`` decode
        slots, each charged ``1 + spec_k`` tokens (speculative decoding's
        verify window; 0 in the port until it is ported)."""
        if self.step_token_budget:
            return self.step_token_budget
        return max_slots * (1 + spec_k) + max(self.chunk_tokens, 1)
