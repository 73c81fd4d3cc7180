"""The port's scheduling policy against ``repro``'s, call for call, without
an engine: ``slo_key`` and ``SLOQueue`` (priority > deadline > submit
order, replays at the absolute head, retries re-stamped to the tail,
``not_before`` gates, ``take_expired``), the ``plan_chunks`` budgeter,
``SchedConfig.budget_for`` and the seeded traffic schedule. Each test of
``repro``'s ``tests/test_sched.py`` runs here on both packages with the
same inputs and must give the same answers; seeded random sequences of
queue operations, chunk plans and schedules add to them.

The port raises ``ValueError`` where ``repro`` asserts on a bad
configuration."""
import time
from types import SimpleNamespace

import numpy as np
import pytest

from repro.obs import clock as rclock
from repro.serving import queue as rqueue
from repro.serving import sched as rsched
from repro.serving import traffic as rtraffic
from repro.serving.sched import slo as rslo
from repro_torch.obs import clock as pclock
from repro_torch.serving import queue as pqueue
from repro_torch.serving import sched as psched
from repro_torch.serving import traffic as ptraffic
from repro_torch.serving.sched import slo as pslo


def _pkg(queue, sched, slo, traffic, clock, config_error):
    ns = SimpleNamespace(
        Request=queue.Request, RequestQueue=queue.RequestQueue,
        SLOQueue=sched.SLOQueue, SLOClass=sched.SLOClass,
        SchedConfig=sched.SchedConfig, plan_chunks=sched.plan_chunks,
        slo_key=slo.slo_key, ttft_deadline=slo.ttft_deadline,
        TrafficConfig=traffic.TrafficConfig,
        make_schedule=traffic.make_schedule, clock=clock,
        config_error=config_error)
    ns.INTERACTIVE = ns.SLOClass("interactive", ttft_target_s=0.5,
                                 tpot_target_s=0.1, priority=0)
    ns.BATCH = ns.SLOClass("batch", ttft_target_s=10.0, priority=1)
    ns.CFG8 = ns.SchedConfig(chunk_tokens=8)
    return ns


PORT = _pkg(pqueue, psched, pslo, ptraffic, pclock, ValueError)
REPRO = _pkg(rqueue, rsched, rslo, rtraffic, rclock, AssertionError)


def both(scenario):
    """Run ``scenario(pkg)`` on the port and on ``repro``; their results
    must be equal. Returns the port's."""
    got, want = scenario(PORT), scenario(REPRO)
    assert got == want
    return got


def _req(P, rid, *, plen=8, slo=None, submit_t=0.0, seq=None,
         prefill_pos=0):
    return P.Request(rid=rid, prompt=np.arange(plen, dtype=np.int32),
                     max_new=4, slo=slo, submit_t=submit_t,
                     seq=rid if seq is None else seq,
                     prefill_pos=prefill_pos)


def _rids(reqs):
    return [r.rid for r in reqs]


P4 = np.arange(4, dtype=np.int32)


# ---------------------------------------------------------------- SLOQueue

def test_slo_key_priority_dominates_deadline():
    def run(P):
        urgent_batch = _req(P, 0, slo=P.BATCH, submit_t=0.0)        # dl 10
        lazy_inter = _req(P, 1, slo=P.INTERACTIVE, submit_t=100.0)  # 100.5
        assert P.slo_key(lazy_inter) < P.slo_key(urgent_batch)
        assert P.ttft_deadline(_req(P, 2)) == float("inf")
        return [P.slo_key(urgent_batch), P.slo_key(lazy_inter)]
    assert both(run) == [(1, 10.0, 0), (0, 100.5, 1)]


def test_sloqueue_orders_by_class_then_deadline():
    def run(P):
        q = P.SLOQueue()
        b = q.submit(P4, 4, slo=P.BATCH)          # first in, low priority
        e1 = q.submit(P4, 4)                      # best effort: no deadline
        i1 = q.submit(P4, 4, slo=P.INTERACTIVE)   # tight deadline, prio 0
        i2 = q.submit(P4, 4, slo=P.INTERACTIVE)   # same class, later
        got = [q.pop() for _ in range(4)]
        assert got == [i1, i2, e1, b]
        return _rids(got)
    both(run)


def test_sloqueue_best_effort_degenerates_to_fifo():
    def run(P):
        q = P.SLOQueue()
        reqs = [q.submit(np.arange(3, dtype=np.int32), 2) for _ in range(5)]
        got = [q.pop() for _ in range(5)]
        assert got == reqs
        return _rids(got)
    both(run)


def test_sloqueue_replays_win_over_tighter_deadlines():
    def run(P):
        q = P.SLOQueue()
        victim = q.submit(P4, 4, slo=P.BATCH)
        q.submit(P4, 4, slo=P.INTERACTIVE)
        first = q.pop()                       # interactive pops first
        q.push_front(victim)                  # preempted: drain progress
        assert q.peek() is victim             # absolute head, despite BATCH
        assert q.pop() is victim
        return [first.rid, victim.rid, q.depth()]
    assert both(run) == [1, 0, 1]


def test_sloqueue_retry_restamps_seq_to_tail():
    def run(P):
        q = P.SLOQueue()
        r0 = q.submit(P4, 4)
        r1 = q.submit(P4, 4)
        assert q.pop() is r0
        q.requeue(r0)                         # retry
        assert r0.seq > r1.seq                # re-stamped behind the waiter
        assert [q.pop(), q.pop()] == [r1, r0]
        return [r0.seq, r1.seq, q.submitted]
    both(run)


def test_sloqueue_backoff_skips_to_eligible():
    def run(P):
        q = P.SLOQueue()
        gated = q.submit(P4, 4, slo=P.INTERACTIVE)
        gated.not_before = time.monotonic() + 60.0   # deep in backoff
        ok = q.submit(P4, 4, slo=P.BATCH)
        assert q.peek() is ok                 # eligible beats better-ranked
        assert q.pop() is ok
        # only the gated request is left: surface it so the engine's
        # not_before check idles
        assert q.peek() is gated
        return [ok.rid, gated.rid]
    both(run)


def test_sloqueue_peek_pop_consistent():
    def run(P):
        q = P.SLOQueue()
        q.submit(P4, 4, slo=P.INTERACTIVE)
        q.submit(P4, 4, slo=P.INTERACTIVE)
        head = q.peek()
        assert q.peek() is head               # memoized
        assert q.pop() is head                # pop honours the peek
        assert len(q) == 1 and bool(q) and q.depth() == 1
        return head.rid
    both(run)


# ---------------------------------------------------------- take_expired

def test_take_expired_rid_order_despite_push_front_interleaving():
    def run(P):
        q = P.RequestQueue()
        reqs = [q.submit(P4, 4, deadline_s=(0.0 if i % 2 else None))
                for i in range(4)]
        r0, r1 = q.pop(), q.pop()
        q.push_front(r0)
        q.push_front(r1)                      # queue now [r1, r0, r2, r3]
        assert q.peek() is r1
        expired = q.take_expired(time.monotonic() + 1.0)
        assert _rids(expired) == [1, 3]       # rid order, not queue order
        assert all(r.expired(time.monotonic() + 1.0) for r in expired)
        assert [q.pop(), q.pop()] == [reqs[0], reqs[2]]  # replay head kept
        return _rids(expired)
    both(run)


def test_sloqueue_take_expired_covers_replays():
    def run(P):
        q = P.SLOQueue()
        r0 = q.submit(P4, 4, deadline_s=0.0)
        r1 = q.submit(P4, 4, deadline_s=0.0, slo=P.INTERACTIVE)
        assert q.pop() is r1
        q.push_front(r1)                      # expired, among the replays
        expired = q.take_expired(time.monotonic() + 1.0)
        assert _rids(expired) == [r0.rid, r1.rid]
        assert q.empty() and not q
        return _rids(expired)
    both(run)


# ----------------------------------------------------------- plan_chunks

def _jobs(jobs):
    return [(s, r.rid, c) for s, r, c in jobs]


def test_plan_chunks_splits_residual_in_slo_order():
    def run(P):
        a = _req(P, 0, plen=20, slo=P.INTERACTIVE, submit_t=0.0)
        b = _req(P, 1, plen=20, slo=P.BATCH, submit_t=0.0)
        jobs, meta = P.plan_chunks([(5, b), (3, a)], cfg=P.CFG8, budget=16,
                                   n_decode_tokens=4, max_len=64, now=0.0)
        # residual 12: interactive first gets its chunk of 8, batch the 4
        # left
        assert _jobs(jobs) == [(3, 0, 8), (5, 1, 4)]
        assert meta["residual"] == 12 and meta["assigned"] == 12
        assert meta["window"] == 8
        return _jobs(jobs), meta
    both(run)


def test_plan_chunks_liveness_floor():
    def run(P):
        a = _req(P, 0, plen=20)
        jobs, meta = P.plan_chunks([(0, a)], cfg=P.CFG8, budget=4,
                                   n_decode_tokens=6, max_len=64, now=0.0)
        assert meta["residual"] == 1
        assert jobs == [(0, a, 1)]
        return _jobs(jobs), meta
    both(run)


def test_plan_chunks_tpot_pressure_halves_residual():
    def run(P):
        a = _req(P, 0, plen=40)
        jobs, meta = P.plan_chunks([(0, a)], cfg=P.CFG8, budget=16,
                                   n_decode_tokens=4, max_len=64, now=0.0,
                                   step_s=0.2, tpot_floor=0.1)
        assert meta["residual"] == 6          # (16 - 4) // 2
        assert jobs == [(0, a, 4)]            # 6 rounded down to a pow2
        _, meta2 = P.plan_chunks([(0, a)], cfg=P.CFG8, budget=16,
                                 n_decode_tokens=4, max_len=64, now=0.0,
                                 step_s=0.05, tpot_floor=0.1)
        assert meta2["residual"] == 12        # no pressure under the floor
        return _jobs(jobs), meta, meta2
    both(run)


def test_plan_chunks_deadline_pressure_claims_residual():
    def run(P):
        late = _req(P, 0, plen=30, slo=P.INTERACTIVE, submit_t=0.0)
        jobs, _ = P.plan_chunks([(0, late)], cfg=P.CFG8, budget=64,
                                n_decode_tokens=0, max_len=64,
                                now=10.0, step_s=0.01)   # deadline past
        # claims the whole remaining 30, pow2-rounded to a 16-wide window
        assert jobs == [(0, late, 16)]
        calm = _req(P, 1, plen=30, slo=P.INTERACTIVE, submit_t=9.9)
        jobs2, _ = P.plan_chunks([(0, calm)], cfg=P.CFG8, budget=64,
                                 n_decode_tokens=0, max_len=64,
                                 now=0.0, step_s=0.01)
        assert jobs2 == [(0, calm, 8)]        # polite chunk, not pressed
        return _jobs(jobs), _jobs(jobs2)
    both(run)


def test_plan_chunks_window_capped_by_cache_bounds():
    def run(P):
        near_end = _req(P, 0, plen=40, prefill_pos=38)   # 2 left at 38
        fresh = _req(P, 1, plen=20)
        jobs, meta = P.plan_chunks([(0, near_end), (1, fresh)], cfg=P.CFG8,
                                   budget=64, n_decode_tokens=0, max_len=40,
                                   now=0.0)
        # rectangular window: S <= min(max_len - prefill_pos) = 2
        assert meta["window"] == 2
        assert all(c <= 2 for _, _, c in jobs)
        return _jobs(jobs), meta
    both(run)


def test_plan_chunks_empty_and_exhausted():
    def run(P):
        assert P.plan_chunks([], cfg=P.CFG8, budget=16, n_decode_tokens=0,
                             max_len=64, now=0.0)[0] == []
        many = [(i, _req(P, i, plen=30)) for i in range(4)]
        jobs, meta = P.plan_chunks(many, cfg=P.CFG8, budget=10,
                                   n_decode_tokens=0, max_len=64, now=0.0)
        assert meta["assigned"] <= 10         # budget respected
        assert len(jobs) == 2                 # 8 + 2, the others starve
        return _jobs(jobs), meta
    both(run)


# ---------------------------------------------------------------- config

def test_sched_config_budget():
    def run(P):
        cfg = P.SchedConfig(chunk_tokens=32)
        assert cfg.chunked
        assert cfg.budget_for(max_slots=4, spec_k=0) == 4 * 1 + 32
        assert cfg.budget_for(max_slots=4, spec_k=3) == 4 * 4 + 32
        assert P.SchedConfig(chunk_tokens=0,
                             step_token_budget=7).budget_for(8, 0) == 7
        assert not P.SchedConfig(chunk_tokens=0).chunked
        for bad in (dict(chunk_tokens=-1), dict(step_token_budget=-1),
                    dict(admission="lifo")):
            with pytest.raises(P.config_error):
                P.SchedConfig(**bad)
        return [P.SchedConfig(chunk_tokens=c, step_token_budget=b)
                .budget_for(s, k) for c in (0, 1, 32) for b in (0, 9)
                for s in (1, 8) for k in (0, 2)]
    both(run)


# --------------------------------------------------------------- traffic

def _schedule_bytes(sched):
    return ([a.t for a in sched], [a.prompt.tobytes() for a in sched],
            [a.prompt.dtype.str for a in sched], [a.max_new for a in sched],
            [a.slo.name if a.slo is not None else None for a in sched])


def test_traffic_schedule_deterministic():
    def run(P):
        tc = P.TrafficConfig(kind="poisson", rate=20.0, n_requests=32,
                             prompt_lens=(8, 24), gen_lens=(4, 12), seed=7)
        a = P.make_schedule(tc, vocab_size=1000)
        b = P.make_schedule(tc, vocab_size=1000)
        assert _schedule_bytes(a) == _schedule_bytes(b)
        c = P.make_schedule(P.TrafficConfig(
            kind="poisson", rate=20.0, n_requests=32, prompt_lens=(8, 24),
            gen_lens=(4, 12), seed=8), 1000)
        assert [x.t for x in a] != [x.t for x in c]
        return _schedule_bytes(a)
    both(run)


def test_traffic_poisson_rate_sanity():
    def run(P):
        tc = P.TrafficConfig(kind="poisson", rate=50.0, n_requests=400,
                             seed=3)
        ts = np.asarray([a.t for a in P.make_schedule(tc, vocab_size=100)])
        assert np.all(np.diff(ts) >= 0)       # sorted arrivals
        mean_gap = float(np.diff(ts).mean())
        assert 0.5 / tc.rate < mean_gap < 2.0 / tc.rate
        return ts.tobytes()
    both(run)


def test_traffic_bursty_shares_instants():
    def run(P):
        tc = P.TrafficConfig(kind="bursty", rate=50.0, n_requests=200,
                             burst_size=8, seed=3)
        ts = [a.t for a in P.make_schedule(tc, vocab_size=100)]
        assert len(set(ts)) < len(ts) / 2     # real bursts
        return ts
    both(run)


def test_traffic_assigns_slo_classes():
    def run(P):
        tc = P.TrafficConfig(rate=10.0, n_requests=50, seed=1)
        sched = P.make_schedule(tc, vocab_size=100,
                                classes=(P.INTERACTIVE, P.BATCH),
                                class_weights=(0.5, 0.5))
        assert {a.slo.name for a in sched} == {"interactive", "batch"}
        with pytest.raises(P.config_error):
            P.TrafficConfig(kind="nope")
        return _schedule_bytes(sched)
    both(run)


@pytest.mark.parametrize("kind", ["poisson", "bursty"])
@pytest.mark.parametrize("seed", [0, 1, 5, 11])
def test_make_schedule_matches_repro_byte_for_byte(kind, seed):
    """The open-loop cells' shape (prompts from a length mix with
    weights, two budgets, the default classes split by weights) over
    several seeds: the same times, prompts, budgets and classes."""
    def run(P):
        tc = P.TrafficConfig(kind=kind, rate=8.0, n_requests=48,
                             prompt_lens=(64, 128, 512),
                             prompt_weights=(0.5, 0.3, 0.2),
                             gen_lens=(32, 64), burst_size=8, seed=seed)
        classes = tuple(P.SLOClass(c.name, c.ttft_target_s, c.tpot_target_s,
                                   c.priority)
                        for c in psched.DEFAULT_SLO_CLASSES)
        return _schedule_bytes(P.make_schedule(tc, 32768, classes=classes,
                                               class_weights=(0.5, 0.5)))
    both(run)


def test_default_slo_classes_match_repro():
    assert [tuple(vars(c).values()) for c in psched.DEFAULT_SLO_CLASSES] \
        == [tuple(vars(c).values()) for c in rsched.DEFAULT_SLO_CLASSES]


# ------------------------------------------ seeded random sequences

class _SharedClock:
    """One fake time source installed in both packages' clocks."""

    def __init__(self):
        self.t = 0.0

    def __enter__(self):
        self._prev = (pclock.set_clock(lambda: self.t),
                      rclock.set_clock(lambda: self.t))
        return self

    def __exit__(self, *exc):
        pclock.set_clock(self._prev[0])
        rclock.set_clock(self._prev[1])


def _queue_script(seed, n_ops=120):
    """A random sequence of queue operations, as plain data."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        op = rng.choice(["submit", "pop", "peek", "push_front", "requeue",
                         "gate", "tick", "expire"],
                        p=[0.3, 0.2, 0.1, 0.08, 0.08, 0.08, 0.1, 0.06])
        ops.append((str(op), int(rng.integers(0, 3)),
                    float(rng.uniform(0.0, 2.0)), int(rng.integers(1, 9))))
    return ops


def _drive_queue(P, fifo, ops, clock):
    """Replay ``ops`` on a fresh queue; returns everything observable."""
    q = P.RequestQueue() if fifo else P.SLOQueue()
    classes = (None, P.INTERACTIVE, P.BATCH)
    out, held = [], []
    for op, k, x, n in ops:
        if op == "submit":
            deadline = x if n % 3 == 0 else None
            r = q.submit(np.arange(n, dtype=np.int32), n, deadline_s=deadline,
                         slo=classes[k])
            out.append(("submit", r.rid, r.seq, r.submit_t))
        elif op in ("pop", "peek") and not q.empty():
            r = q.pop() if op == "pop" else q.peek()
            if op == "pop":
                held.append(r)
            out.append((op, r.rid))
        elif op == "push_front" and held:
            q.push_front(held.pop(k % len(held)))
        elif op == "requeue" and held:
            r = held.pop(k % len(held))
            q.requeue(r)
            out.append(("requeue", r.rid, r.seq))
        elif op == "gate" and not q.empty():
            q.peek().not_before = P.clock.now() + x
        elif op == "tick":
            clock.t += x
        elif op == "expire":
            out.append(("expire", _rids(q.take_expired(P.clock.now()))))
        out.append(("depth", q.depth(), len(q), bool(q), q.empty()))
    while not q.empty():
        out.append(("drain", q.pop().rid))
    return out


@pytest.mark.parametrize("fifo", [False, True], ids=["slo", "fifo"])
@pytest.mark.parametrize("seed", range(6))
def test_queues_match_repro_over_random_sequences(fifo, seed):
    ops = _queue_script(seed)
    results = []
    for P in (PORT, REPRO):
        with _SharedClock() as clock:
            results.append(_drive_queue(P, fifo, ops, clock))
    assert results[0] == results[1]
    assert any(r[0] == "pop" for r in results[0])


def _plan_case(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 7))
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(1, 80))
        reqs.append(dict(rid=rid, plen=plen,
                         prefill_pos=int(rng.integers(0, plen)),
                         cls=int(rng.integers(0, 3)),
                         submit_t=float(rng.uniform(0.0, 5.0)),
                         slot=int(rng.permutation(8)[rid % 8])))
    kw = dict(chunk_tokens=int(rng.choice([0, 1, 5, 8, 32, 64])),
              step_token_budget=int(rng.choice([0, 4, 16, 40, 100])),
              max_slots=int(rng.integers(1, 9)),
              n_decode=int(rng.integers(0, 9)),
              max_len=int(rng.choice([80, 96, 128])),
              now=float(rng.uniform(0.0, 12.0)),
              step_s=float(rng.choice([0.0, 0.01, 0.05, 0.2])),
              tpot_floor=[None, 0.1, 0.02][int(rng.integers(0, 3))])
    return reqs, kw


@pytest.mark.parametrize("seed", range(12))
def test_plan_chunks_matches_repro_on_random_sets(seed):
    reqs, kw = _plan_case(seed)

    def run(P):
        classes = (None, P.INTERACTIVE, P.BATCH)
        pre = [(r["slot"], _req(P, r["rid"], plen=r["plen"],
                                slo=classes[r["cls"]],
                                submit_t=r["submit_t"],
                                prefill_pos=r["prefill_pos"]))
               for r in reqs]
        cfg = P.SchedConfig(chunk_tokens=kw["chunk_tokens"],
                            step_token_budget=kw["step_token_budget"])
        jobs, meta = P.plan_chunks(
            pre, cfg=cfg, budget=cfg.budget_for(kw["max_slots"]),
            n_decode_tokens=kw["n_decode"], max_len=kw["max_len"],
            now=kw["now"], step_s=kw["step_s"], tpot_floor=kw["tpot_floor"])
        if jobs:
            s = meta["window"]
            assert s & (s - 1) == 0 and all(c <= s for _, _, c in jobs)
        return _jobs(jobs), meta
    both(run)
