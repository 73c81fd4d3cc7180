"""Data-parallel multi-replica router (the port's copy of
``repro.distributed.router``, its placement policy and fleet metrics).

The tensor-parallel layer (``distributed.tp``) scales one engine *up*;
this scales engines *out*: ``dp`` independent ``ContinuousScheduler``
replicas — each on its own disjoint tp-mesh (a leader and its follower
ranks) or single device, with its own page pool and prefix cache —
behind one placement policy, in one process.

Placement is sticky prefix-cache-aware: a request goes to the replica
whose prefix cache holds the longest leading run of the prompt's pages
(``PrefixCache.probe`` — non-mutating, so probing every replica skews no
per-replica LRU or hit counters), because only *that* replica can turn
the shared prefix into skipped prefill work. Ties — and prompts no
replica has seen — fall back to least load (queued + live requests), so
cold traffic still balances. Stickiness is bounded: when the favored
replica's load exceeds the lightest replica's by more than
``spill_threshold`` requests, the request spills to the lightest one —
a hot prefix must not starve the rest of the fleet while other replicas
idle (the rebuilt prefix pages make the spilled replica a future
affinity target too).

Replicas drain interleaved, one scheduler step each round-robin turn, so
replica 0's long generations never head-of-line block replica 1's admits.
Greedy decoding is deterministic per engine, so routing never changes
tokens — only which cache produces them.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence

import numpy as np

from repro_torch.obs import clock as obs_clock

__all__ = ["Router"]


class Router:
    """Prefix-affinity request router over engine replicas."""

    def __init__(self, engines: Sequence[Any], *, spill_threshold: int = 4):
        if not engines:
            raise ValueError("Router needs at least one engine replica")
        if spill_threshold < 0:
            raise ValueError(
                f"spill_threshold must be >= 0, got {spill_threshold}")
        self.engines = list(engines)
        self.spill_threshold = spill_threshold
        self.routed = 0
        self.affinity_candidates = 0
        self.affinity_hits = 0
        self.spills = 0
        self.placements: List[int] = []

    # ------------------------------------------------------------------
    def _probe(self, engine, prompt: np.ndarray) -> int:
        prefix = getattr(engine.pool, "prefix", None)
        return prefix.probe(prompt) if prefix is not None else 0

    @staticmethod
    def _load(engine) -> int:
        return engine.queue.depth() + len(engine._live)

    def place(self, prompt: np.ndarray) -> int:
        """Replica index for this prompt: longest cached prefix, ties by
        least load, spilled to the least-loaded replica when the favorite
        is ``spill_threshold`` requests deeper than the lightest."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        probes = [self._probe(e, prompt) for e in self.engines]
        loads = [self._load(e) for e in self.engines]
        best_probe = max(probes)
        # least-loaded overall (lowest index breaks exact ties — stable)
        lightest = min(range(len(loads)), key=lambda i: (loads[i], i))
        if best_probe > 0:
            self.affinity_candidates += 1
            favorite = min(
                (i for i in range(len(probes)) if probes[i] == best_probe),
                key=lambda i: (loads[i], i))
            if loads[favorite] - loads[lightest] > self.spill_threshold:
                self.spills += 1
                return lightest
            self.affinity_hits += 1
            return favorite
        return lightest

    def submit(self, prompt: np.ndarray, max_new: int, **kw):
        """Place and enqueue one request; returns the engine's Request."""
        idx = self.place(prompt)
        self.routed += 1
        self.placements.append(idx)
        return self.engines[idx].submit(prompt, max_new, **kw)

    # ------------------------------------------------------------------
    def _pending(self) -> List[Any]:
        return [e for e in self.engines if e.queue or e._live]

    def run(self) -> Dict[str, Any]:
        """Drain every replica, interleaved one step per turn; returns the
        fleet metrics dict (placement counters + per-replica summaries)."""
        for e in self.engines:
            if e.params is None:
                raise RuntimeError("load(params) every replica first")
        t0 = obs_clock.now()
        budget = sum(
            (e.queue.depth() + len(e._live)) * e.max_len * 16 + 1
            for e in self.engines)
        idle = 0
        while True:
            pending = self._pending()
            if not pending:
                break
            before = sum(e.prefill_steps + e.decode_steps
                         + e.total_drained for e in self.engines)
            for e in pending:
                e.step()
            if sum(e.prefill_steps + e.decode_steps + e.total_drained
                   for e in self.engines) == before:
                # every pending replica idled (retry-backoff windows):
                # waiting is free, so it must not eat the progress budget
                idle += 1
                if idle >= 1_000_000:
                    raise RuntimeError("router stuck on idle ticks")
                time.sleep(5e-4)
            else:
                idle = 0
                budget -= len(pending)
                if budget <= 0:
                    raise RuntimeError("router failed to make progress")
        wall = obs_clock.now() - t0
        per_replica = []
        gen = 0
        for e in self.engines:
            done = e._finished
            r_gen = sum(len(r.tokens) for r in done)
            gen += r_gen
            prefix = getattr(e.pool, "prefix", None)
            per_replica.append({
                "drained": e.total_drained,
                "generated_tokens": r_gen,
                "prefill_steps": e.prefill_steps,
                "decode_steps": e.decode_steps,
                "prefix_hit_rate": (prefix.hit_rate
                                    if prefix is not None else None),
                "mesh": (None if e.mesh is None
                         else {"axes": dict(e.mesh.shape)}),
            })
        return {
            "engine": "router",
            "replicas": len(self.engines),
            "routed": self.routed,
            "placements": list(self.placements),
            "affinity": {
                "candidates": self.affinity_candidates,
                "hits": self.affinity_hits,
                "rate": (self.affinity_hits / self.affinity_candidates
                         if self.affinity_candidates else None),
            },
            "spills": self.spills,
            "per_replica": per_replica,
            "generated_tokens": gen,
            "wall_s": round(wall, 4),
            "tok_per_s": round(gen / wall, 2) if wall > 0 else None,
        }
