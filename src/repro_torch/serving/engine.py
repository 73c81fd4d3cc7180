"""Continuous-batching scheduler of the port over the dense slot pool or the
paged KV pool — the counterpart of ``repro.serving.engine.
ContinuousScheduler`` (speculative decoding, chunked prefill, fault
handling and meshes are not ported yet).

Each step: **admit** FIFO runs of equal-length prompts into free slots as
one prefill (the last-position argmax is each request's first token);
**grow** (paged mode) every live row's pages for this step's write,
preempting the youngest request when the pool is dry; **decode** one token
for all ``max_slots`` rows with a per-slot position vector (free slots
decode garbage at a position clamped to ``max_len - 1``, into rows the
next insert overwrites, or into the paged pool's trash page); **evict**
requests at their budget or EOS. Prefill runs under
``ops.serving_phase("prefill")``, decode under ``"decode"``, which picks
the kernels' tile shapes. Positions and tokens stay on the device between
steps; the host reads the (max_slots,) next tokens each step and pushes its
mirrors (and the block table) only after they change.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import LM
from repro_torch.obs import clock as obs_clock
from repro_torch.obs.metrics import RunningStat, percentiles
from repro_torch.paging import PagePool
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.slots import SlotPool


class ContinuousScheduler:
    def __init__(self, cfg: ModelConfig, max_slots: int, max_len: int,
                 eos_id: Optional[int] = None, *, cache: str = "dense",
                 page_size: int = 16, n_pages: int = 0,
                 kv_dtype: Optional[str] = None, prefix_cache: bool = True,
                 device="cuda"):
        if cache not in ("dense", "paged"):
            raise ValueError(f"cache must be 'dense' or 'paged', got "
                             f"{cache!r}")
        self.cfg = cfg
        self.cache_mode = cache
        self.device = resolve_device(device)
        self.model = LM(cfg, self.device)
        self.max_slots = max_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.params = None
        self.queue = RequestQueue()
        if cache == "paged":
            self.pool = PagePool(self.model, max_slots, max_len,
                                 page_size=page_size, n_pages=n_pages,
                                 kv_dtype=kv_dtype,
                                 prefix_cache=prefix_cache)
            self._dev_table = torch.tensor(self.pool.table,
                                           device=self.device)
            self.pool.table_dirty = False
        else:
            self.pool = SlotPool(self.model, max_slots, max_len)
        self._live: Dict[int, Request] = {}          # slot -> request
        self._pos = np.zeros(max_slots, np.int32)    # host mirrors
        self._tok = np.zeros(max_slots, np.int32)
        self._dev_pos = torch.zeros(max_slots, dtype=torch.int32,
                                    device=self.device)
        self._dev_tok = torch.zeros(max_slots, dtype=torch.int32,
                                    device=self.device)
        self._dirty = False
        self._finished: List[Request] = []
        self.total_drained = 0
        self.prefill_steps = 0
        self.decode_steps = 0
        self.preemptions = 0
        self.deferrals = 0
        self._depth_stat = RunningStat("queue_depth")
        self._live_stat = RunningStat("live_slots")

    # ------------------------------------------------------------------
    def load(self, params) -> None:
        """Install params (already on this engine's device)."""
        self.params = params

    @torch.no_grad()
    def _prefill(self, toks: torch.Tensor):
        cache_len = self.max_len
        if self.cache_mode == "paged":
            # page-aligned cache length: the pool writes whole pages
            ps = self.pool.page_size
            cache_len = -(-toks.shape[1] // ps) * ps
        cache, logits = self.model.prefill(self.params, {"tokens": toks},
                                           cache_len)
        return cache["layers"], logits[:, -1].argmax(dim=-1).to(torch.int32)

    @torch.no_grad()
    def _decode(self):
        cache = {"layers": self.pool.layers,
                 "pos": torch.clamp(self._dev_pos, max=self.max_len - 1)}
        if self.cache_mode == "paged":
            # free slots' table rows are all zero: their clamped garbage
            # writes land in the trash page 0
            cache["block_table"] = self._dev_table
        logits, new_cache = self.model.decode_step(self.params, cache,
                                                   self._dev_tok[:, None])
        self.pool.layers = new_cache["layers"]
        self._dev_pos = new_cache["pos"]
        self._dev_tok = logits[:, 0].argmax(dim=-1).to(torch.int32)

    def submit(self, prompt: np.ndarray, max_new: int) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new > self.max_len:
            raise ValueError(f"prompt {prompt.size} + gen {max_new} exceeds "
                             f"max_len {self.max_len}")
        return self.queue.submit(prompt, max_new, eos_id=self.eos_id)

    # ------------------------------------------------------------------
    def _prefill_group(self, group) -> None:
        """Prefill one admitted group ``[(request, slot, Admission|None)]``
        (the admission carries the paged pool's page plan, ``None`` in
        dense mode) and wire up per-request state."""
        t_admit = obs_clock.now()
        for req, _, _ in group:
            req.admit_t = t_admit
        prompts = np.stack([r.prompt for r, _, _ in group])
        with ops.serving_phase("prefill"):
            req_layers, toks_dev = self._prefill(
                torch.as_tensor(prompts, device=self.device))
        self.prefill_steps += 1
        if self.cache_mode == "paged":
            self.pool.insert([a for _, _, a in group], req_layers)
        else:
            self.pool.insert([s for _, s, _ in group], req_layers)
        toks = toks_dev.cpu().numpy()
        now = obs_clock.now()
        for (req, slot, _), tok in zip(group, toks):
            req.slot = slot
            req.state = "live"
            req.tokens.append(int(tok))
            req.first_token_t = now
            self._pos[slot] = req.prompt_len
            self._tok[slot] = tok
            self._live[slot] = req
            self._dirty = True
            if req.done:
                self._evict(slot)

    def _admit_paged(self) -> None:
        """Admit a request only when the page pool covers its whole prompt
        (shared prefix pages, fresh pages, reclaimed cold prefix pages). A
        request the pool cannot place now *defers*: admission stops for
        this step and retries after evictions free pages."""
        while not self.queue.empty() and self.pool.n_free:
            adm = self.pool.admit(self.queue.peek().prompt)
            if adm is None:
                self.deferrals += 1
                return
            group = [(self.queue.pop(), adm.slot, adm)]
            plen = group[0][0].prompt_len
            deferred = False
            while (not self.queue.empty() and self.pool.n_free
                   and self.queue.peek().prompt_len == plen):
                nxt = self.pool.admit(self.queue.peek().prompt)
                if nxt is None:
                    self.deferrals += 1
                    deferred = True
                    break
                group.append((self.queue.pop(), nxt.slot, nxt))
            self._prefill_group(group)
            if deferred:     # already counted: no second attempt this step
                return

    def _admit(self) -> None:
        if self.cache_mode == "paged":
            self._admit_paged()
            return
        while not self.queue.empty() and self.pool.n_free:
            # grouped admission: a FIFO run of equal-length prompts (up to
            # the free-slot count) prefills as one batch
            group = [self.queue.pop()]
            plen = group[0].prompt_len
            while (len(group) < self.pool.n_free and not self.queue.empty()
                   and self.queue.peek().prompt_len == plen):
                group.append(self.queue.pop())
            self._prefill_group(
                [(req, self.pool.alloc(), None) for req in group])

    def _release_slot(self, slot: int) -> Request:
        """Common tail of every live-slot exit: pop the request, return the
        slot's cache (pages or dense row) to its pool, zero the host
        mirrors."""
        req = self._live.pop(slot)
        req.slot = None
        self._pos[slot] = 0
        self._tok[slot] = 0
        self._dirty = True
        if self.cache_mode == "paged":
            self.pool.release(slot)
        else:
            self.pool.free(slot)
        return req

    def _evict(self, slot: int) -> None:
        req = self._release_slot(slot)
        req.state = "done"
        req.done_t = obs_clock.now()
        self._finished.append(req)
        self.total_drained += 1

    def _preempt(self, slot: int) -> None:
        """Paged OOM recovery: release the slot's pages and replay the
        request from its prompt later, re-queued at the head. Greedy decode
        is deterministic, so the replay regenerates the same tokens."""
        req = self._release_slot(slot)
        req.tokens.clear()
        req.first_token_t = None
        req.admit_t = None            # re-stamped at the retry admission
        self.queue.push_front(req)
        self.preemptions += 1

    def _grow_paged(self, horizon: int = 1) -> None:
        """Before each paged decode step, make every live row's next
        ``horizon`` write positions appendable: allocate pages crossed into
        and copy shared pages about to be written. When the pool is dry,
        preempt the *youngest* live request and retry; the oldest is never
        preempted while others live, which guarantees drain progress."""
        for slot in list(self._live):
            if slot not in self._live:       # preempted by an earlier turn
                continue
            p = 0
            while p < horizon:
                if self.pool.ensure_append(slot, int(self._pos[slot]) + p):
                    p += 1
                    continue
                victim = next(reversed(self._live))
                self._preempt(victim)
                if victim == slot:
                    break

    def step(self) -> None:
        """One iteration: admit (+ prefill), grow pages, decode every slot,
        evict."""
        self._depth_stat.push(self.queue.depth())
        self._admit()
        if self.cache_mode == "paged":
            self._grow_paged(1)
        if not self._live:
            return
        self._live_stat.push(len(self._live))
        if self._dirty:
            # copies: on the CPU as_tensor would alias the host mirrors
            self._dev_pos = torch.tensor(self._pos, device=self.device)
            self._dev_tok = torch.tensor(self._tok, device=self.device)
            self._dirty = False
        with ops.serving_phase("decode"):
            if self.cache_mode == "paged" and self.pool.table_dirty:
                self._dev_table = torch.tensor(self.pool.table,
                                               device=self.device)
                self.pool.table_dirty = False
            self._decode()
        self.decode_steps += 1
        toks = self._dev_tok.cpu().numpy()
        for slot in list(self._live):
            req = self._live[slot]
            req.tokens.append(int(toks[slot]))
            self._pos[slot] += 1
            self._tok[slot] = toks[slot]
            if req.done:
                self._evict(slot)

    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self._live)

    def run(self) -> Dict[str, Any]:
        """Drain the queue completely; return the metrics dict."""
        if self.params is None:
            raise RuntimeError("load(params) first")
        t0 = obs_clock.now()
        n0, p0, d0 = self.total_drained, self.prefill_steps, self.decode_steps
        self._depth_stat = RunningStat("queue_depth")
        self._live_stat = RunningStat("live_slots")
        budget = (self.queue.depth() + len(self._live)) * self.max_len + 1
        if self.cache_mode == "paged":
            # preempt-and-replay re-runs requests; each replay costs at most
            # max_len extra steps and the oldest-never-preempted rule bounds
            # the churn, so this is headroom, not an expected count
            budget *= 8
        while self.has_work():
            if budget <= 0:
                raise RuntimeError("scheduler failed to make progress")
            self.step()
            budget -= 1
        if self.total_drained != self.queue.submitted:
            raise RuntimeError(f"drained {self.total_drained} requests but "
                               f"{self.queue.submitted} were submitted")
        wall = obs_clock.now() - t0
        done = self._finished[n0:]
        gen = sum(len(r.tokens) for r in done)
        ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
        cache = {"mode": self.cache_mode, "nbytes": int(self.pool.nbytes)}
        if self.cache_mode == "paged":
            cache.update(self.pool.stats())
            cache["preemptions"] = self.preemptions
            cache["deferrals"] = self.deferrals
        return {
            "engine": "continuous",
            "max_slots": self.max_slots,
            "max_len": self.max_len,
            "cache": cache,
            "concurrency": {"peak": self._live_stat.peak,
                            "mean": round(self._live_stat.mean, 3)},
            "per_request": [r.metrics() for r in done],
            "submitted": len(done),
            "drained": len(done),
            "generated_tokens": gen,
            "wall_s": round(wall, 4),
            "tok_per_s": round(gen / wall, 2) if wall > 0 else None,
            "prefill_steps": self.prefill_steps - p0,
            "decode_steps": self.decode_steps - d0,
            "ttft_s": {"mean": float(np.mean(ttfts)) if ttfts else None,
                       "max": float(np.max(ttfts)) if ttfts else None},
            "latency": {
                "ttft_s": percentiles(r.ttft_s for r in done),
                "queue_wait_s": percentiles(r.queue_wait_s for r in done),
                "prefill_s": percentiles(r.prefill_s for r in done),
                "tpot_s": percentiles(r.tpot_s for r in done),
                "e2e_s": percentiles(r.latency_s for r in done),
            },
            "queue_depth": {"max": self._depth_stat.peak,
                            "mean": self._depth_stat.mean},
        }
