"""SLO-aware admission order and the per-step chunk budget of the port
(``repro.serving.sched.slo``'s counterpart, rule for rule).

``SLOQueue`` keeps every contract of the FIFO ``RequestQueue`` the engine
relies on — preempted requests re-enter at the absolute head (they must
win the next admission for the drain to progress), retries re-enter at
the tail, ``not_before`` gates are honoured — but orders ordinary
admission by ``(priority, TTFT deadline, submit order)``. Best-effort
requests get priority 0 and no deadline, so a workload without classes
is FIFO.

``plan_chunks`` is the pure per-step token budgeter: given the
mid-prefill slots, the decode batch's charge and the step budget, it
decides how many prompt tokens each prefill advances this step, and the
window width S (a power of two, so only a few window shapes exist).
"""
from __future__ import annotations

import collections
import math
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import clock as obs_clock
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.sched.config import SchedConfig

__all__ = ["slo_key", "ttft_deadline", "SLOQueue", "plan_chunks"]

_NO_DEADLINE = math.inf


def slo_key(req: Request) -> Tuple[int, float, int]:
    """Admission key: (priority, TTFT deadline, enqueue seq). Priority
    dominates; within a priority the earliest deadline wins; submit order
    breaks ties (``requeue`` re-stamps ``seq``, so a retry goes behind its
    cohort)."""
    slo = req.slo
    pr = getattr(slo, "priority", 0) if slo is not None else 0
    ttft = getattr(slo, "ttft_target_s", None) if slo is not None else None
    dl = req.submit_t + ttft if ttft is not None else _NO_DEADLINE
    return (pr, dl, req.seq)


def ttft_deadline(req: Request) -> float:
    """Absolute TTFT deadline on the monotonic clock; inf without one."""
    return slo_key(req)[1]


class SLOQueue(RequestQueue):
    """Priority + earliest-deadline admission queue: an unordered list
    sorted on demand (an O(n log n) sort per admission is nothing beside a
    model forward), and a deque of replays that always wins ``peek`` and
    ``pop``."""

    def __init__(self):
        super().__init__()
        self._q: List[Request] = []                  # unordered
        self._replays: Deque[Request] = collections.deque()
        self._peeked: Optional[Request] = None

    def _best(self, now: float) -> Optional[Request]:
        if self._replays:
            return self._replays[0]
        if not self._q:
            return None
        order = sorted(self._q, key=slo_key)
        for r in order:
            if r.not_before <= now:
                return r
        # everything waits out its gate: surface the best-ranked request
        # so the engine's not_before check idles, as the FIFO head would
        return order[0]

    def pop(self) -> Request:
        req = self.peek()
        if req is None:
            raise IndexError("pop from an empty SLOQueue — admission must "
                             "guard on .empty() before popping")
        if self._replays and self._replays[0] is req:
            self._replays.popleft()
        else:
            self._q.remove(req)
        self._peeked = None
        return req

    def push_front(self, req: Request) -> None:
        req.state = "queued"
        self._replays.appendleft(req)
        self._peeked = None

    def requeue(self, req: Request) -> None:
        # a retry re-enters behind every waiting request of equal
        # (priority, deadline): a faulty request cannot camp on the head
        req.state = "queued"
        req.seq = self.submitted + len(self._replays) + len(self._q)
        self.submitted = max(self.submitted, req.seq)
        self._q.append(req)
        self._peeked = None

    def submit(self, *args, **kwargs) -> Request:
        self._peeked = None
        return super().submit(*args, **kwargs)

    def peek(self) -> Optional[Request]:
        # memoized: the engine's peek-then-pop sees one choice even as the
        # clock moves between the calls
        if self._peeked is not None and (
                (self._replays and self._replays[0] is self._peeked)
                or self._peeked in self._q):
            return self._peeked
        self._peeked = self._best(obs_clock.now())
        return self._peeked

    def empty(self) -> bool:
        return not (self._q or self._replays)

    def take_expired(self, now: float) -> List[Request]:
        dead = {r.rid for r in self._q if r.expired(now)}
        dead |= {r.rid for r in self._replays if r.expired(now)}
        if not dead:
            return []
        expired = [r for r in self._q if r.rid in dead]
        expired += [r for r in self._replays if r.rid in dead]
        self._q = [r for r in self._q if r.rid not in dead]
        self._replays = collections.deque(
            r for r in self._replays if r.rid not in dead)
        self._peeked = None
        return sorted(expired, key=lambda r: r.rid)

    def depth(self) -> int:
        return len(self._q) + len(self._replays)

    def __len__(self) -> int:
        return self.depth()

    def __bool__(self) -> bool:
        return bool(self._q or self._replays)


def plan_chunks(
    prefills: Sequence[Tuple[int, Request]],
    *,
    cfg: SchedConfig,
    budget: int,
    n_decode_tokens: int,
    max_len: int,
    now: float,
    step_s: float = 0.0,
    tpot_floor: Optional[float] = None,
) -> Tuple[List[Tuple[int, Request, int]], Dict[str, int]]:
    """Split this step's token budget across the mid-prefill requests.

    prefills: (slot, request) pairs mid-prefill. budget: the step's
    forward-token budget (``SchedConfig.budget_for``). n_decode_tokens:
    the decode batch's charge. max_len: the cache's positions a slot,
    which bounds the window so no padded row writes past it. now /
    step_s: the clock and the recent step time, for deadline pressure.
    tpot_floor: the tightest TPOT target among the live decode requests;
    when recent steps exceed it the prefill share halves.

    Returns ``(jobs, meta)``: jobs ``(slot, request, chunk_len)`` with
    ``chunk_len >= 1`` in ``slo_key`` order (the order rows are packed
    into the window), meta the budget split and the window width."""
    residual = budget - n_decode_tokens
    if tpot_floor is not None and step_s > tpot_floor and residual > 1:
        residual //= 2
    if residual <= 0 and prefills:
        # liveness floor: a mid-prefill slot pins cache memory, so it
        # advances one token a step even when decode takes the budget
        residual = 1
    meta = {"budget": budget, "decode_tokens": n_decode_tokens,
            "residual": residual, "assigned": 0, "window": 0}
    if not prefills or residual <= 0:
        return [], meta

    ordered = sorted(prefills, key=lambda sr: slo_key(sr[1]))
    jobs: List[Tuple[int, Request, int]] = []
    left = residual
    for slot, req in ordered:
        if left <= 0:
            break
        remaining = req.prompt_len - req.prefill_pos
        if remaining <= 0:
            raise ValueError(f"request {req.rid} is not mid-prefill "
                             f"(prefill_pos {req.prefill_pos}, prompt "
                             f"{req.prompt_len})")
        cap = cfg.chunk_tokens if cfg.chunk_tokens else remaining
        if ttft_deadline(req) <= now + 2.0 * step_s:
            # deadline-pressed (or past): claim the whole residual
            cap = remaining
        c = min(cap, remaining, left)
        if c <= 0:
            break
        jobs.append((slot, req, c))
        left -= c

    if jobs:
        # every row writes S positions from its prefill_pos: cap S so no
        # row's window crosses max_len, then round it down to a power of
        # two (the window shapes are captured ahead of traffic); the rest
        # lands in the next step's window
        s = max(c for _, _, c in jobs)
        s = min(s, min(max_len - r.prefill_pos for _, r, _ in jobs))
        if s < 1:
            raise ValueError(f"no window fits below max_len {max_len}: "
                             f"{[(r.rid, r.prefill_pos) for _, r, _ in jobs]}")
        s = 1 << (s.bit_length() - 1)
        jobs = [(slot, r, min(c, s)) for slot, r, c in jobs]
        meta["window"] = s
    meta["assigned"] = sum(c for _, _, c in jobs)
    return jobs, meta
