"""Request bookkeeping of the port's continuous-batching engine: one
``Request`` per user call and a FIFO ``RequestQueue`` (the counterparts of
``repro.serving.queue``). Timestamps come from ``repro_torch.obs.clock``,
the clock the SLO queue, the traffic harness and the tracer read too.

Lifecycle: ``queued -> live -> done | failed``. A request re-enters
``queued`` on preemption (paged OOM; ``push_front``, at the head) or on a
quarantine retry (non-finite logits; ``requeue``, at the tail); both
replay it from its prompt. ``failed`` is terminal and carries a reason
code (``serving.faults.FAIL_*``); ``attempts`` counts the quarantines and
``max_retries`` overrides the engine's retry budget.

A request carries its SLO class (``slo``, a ``serving.sched.SLOClass`` or
None for best effort), the queue's enqueue counter (``seq``), the
re-admission gate ``not_before`` (retry backoff) and a deadline
(``deadline_s``): what ``sched.SLOQueue`` orders and expires by. Chunked
prefill advances ``prefill_pos`` and counts ``chunks``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional

import numpy as np

from repro_torch.obs import clock as obs_clock


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (prompt_len,) int32 token ids
    max_new: int                     # generation budget (tokens)
    eos_id: Optional[int] = None     # early-stop token (None: budget only)
    deadline_s: Optional[float] = None   # wall-clock budget from submit
    max_retries: Optional[int] = None    # None: the engine's budget
    attempts: int = 0                    # quarantine replays so far
    not_before: float = 0.0          # re-admission gate (retry backoff)
    state: str = "queued"            # queued | live | done | failed
    fail_reason: Optional[str] = None    # faults.FAIL_* when failed

    # the SLO class (duck-typed: ``priority``, ``ttft_target_s``,
    # ``tpot_target_s``; None = best effort) and the queue's enqueue
    # counter, re-stamped by ``requeue``
    slo: Optional[object] = None
    seq: int = 0

    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    submit_t: float = 0.0
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    # chunked prefill: prompt tokens committed so far, and the chunk
    # windows this request rode in
    prefill_pos: int = 0
    chunks: int = 0
    # speculative decoding: draft tokens proposed and accepted (a replay
    # counts them again from 0)
    spec_proposed: int = 0
    spec_accepted: int = 0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        if len(self.tokens) >= self.max_new:
            return True
        return bool(self.tokens and self.eos_id is not None
                    and self.tokens[-1] == self.eos_id)

    @property
    def terminal(self) -> bool:
        return self.state in ("done", "failed")

    def expired(self, now: float) -> bool:
        return (self.deadline_s is not None
                and now - self.submit_t > self.deadline_s)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_t is None:
            return None
        return self.admit_t - self.submit_t

    @property
    def prefill_s(self) -> Optional[float]:
        if self.first_token_t is None or self.admit_t is None:
            return None
        return self.first_token_t - self.admit_t

    @property
    def tpot_s(self) -> Optional[float]:
        """(done - first token) over the tokens generated after the first."""
        if self.done_t is None or self.first_token_t is None:
            return None
        n = len(self.tokens) - 1
        if n <= 0:
            return None
        return (self.done_t - self.first_token_t) / n

    @property
    def latency_s(self) -> Optional[float]:
        if self.done_t is None:
            return None
        return self.done_t - self.submit_t

    def metrics(self) -> dict:
        return {
            "rid": self.rid,
            "prompt_len": self.prompt_len,
            "gen_len": len(self.tokens),
            "ttft_s": self.ttft_s,
            "queue_wait_s": self.queue_wait_s,
            "prefill_s": self.prefill_s,
            "tpot_s": self.tpot_s,
            "latency_s": self.latency_s,
            "state": self.state,
            "fail_reason": self.fail_reason,
            "attempts": self.attempts,
            "chunks": self.chunks,
            "slo": self.slo.name if self.slo is not None else None,
        }


class RequestQueue:
    """FIFO admission queue; ``submit`` stamps the enqueue time so TTFT
    includes the queue wait. Preemption replays re-enter at the head,
    retries at the tail."""

    def __init__(self):
        self._q: Deque[Request] = collections.deque()
        self._next_rid = 0
        self.submitted = 0

    def submit(self, prompt: np.ndarray, max_new: int,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               max_retries: Optional[int] = None,
               slo: Optional[object] = None,
               submit_t: Optional[float] = None) -> Request:
        """``submit_t`` lets an open-loop harness stamp the arrival it
        intended: a blocking engine step delays this call, and stamping it
        late would hide the queueing delay TTFT measures."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        req = Request(rid=self._next_rid, prompt=prompt, max_new=max_new,
                      eos_id=eos_id, deadline_s=deadline_s,
                      max_retries=max_retries, slo=slo,
                      seq=self.submitted,
                      submit_t=(obs_clock.now() if submit_t is None
                                else submit_t))
        self._next_rid += 1
        self.submitted += 1
        self._q.append(req)
        return req

    def push_front(self, req: Request) -> None:
        """Re-queue a preempted request at the head (it keeps its original
        ``submit_t`` and rid; ``submitted`` is not re-counted)."""
        req.state = "queued"
        self._q.appendleft(req)

    def requeue(self, req: Request) -> None:
        """Re-queue a request at the tail for a retry, behind the work
        already waiting."""
        req.state = "queued"
        self._q.append(req)

    def pop(self) -> Request:
        if not self._q:
            raise IndexError("pop from an empty RequestQueue — admission "
                             "must guard on .empty() before popping")
        return self._q.popleft()

    def peek(self) -> Optional[Request]:
        return self._q[0] if self._q else None

    def empty(self) -> bool:
        return not self._q

    def take_expired(self, now: float) -> List[Request]:
        """Remove and return every queued request past its deadline, in
        rid (submit) order; a replay keeps its rid, so the order holds
        across ``push_front``."""
        dead = {r.rid for r in self._q if r.expired(now)}
        if not dead:
            return []
        expired = sorted((r for r in self._q if r.rid in dead),
                         key=lambda r: r.rid)
        self._q = collections.deque(
            r for r in self._q if r.rid not in dead)
        return expired

    def depth(self) -> int:
        return len(self._q)

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
