"""The serving fault model of the port against ``repro``'s, on the CPU.

* ``FaultInjector``'s schedules (``plan`` and ``choose_slot`` draws) are
  byte-equal to ``repro``'s over seeds and rates.
* ``repro``'s ``tests/test_faults.py`` cases run on both packages: the
  guard quarantines exactly the poisoned slot and the retry is
  token-exact, deadlines cancel queued and live requests, an exhausted
  retry budget fails the request, a forced page-OOM storm drains and
  reclaims, an unreachable acceptance floor switches speculation off and
  a failed draft round falls back to plain decode, both token-exact, and
  ``serve --chaos`` runs end to end.
* The port's dense, paged and chunked engines under one seeded chaos
  schedule give ``repro``'s per-request states, fail reasons, attempts,
  tokens and ``faults`` block on the same converted weights (float32, as
  ``tests/test_torch_chunked.py`` holds the streams), and a deadline run
  under both packages' fake clocks, advanced in lockstep, gives equal
  results.
* A real non-finite row (NaN written into one slot's cache) quarantines
  that slot only, in a decode step and in a chunk window, and the guard
  leaves a fault-free step's logits bitwise unchanged. NaN left in a
  released dense slot's V meets the next request in that slot as it does
  in ``repro`` (ROADMAP C9).

All comparisons are exact: greedy streams and counts, no tolerance.
"""
import functools
import json
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.launch import serve as rserve
from repro.models import LM as RLM
from repro.obs import clock as rclock
from repro.serving import ContinuousScheduler as RScheduler
from repro.serving import FaultConfig as RFaultConfig
from repro.serving import FaultInjector as RFaultInjector
from repro.serving import RequestQueue as RRequestQueue
from repro.serving import ResilienceConfig as RResilienceConfig
from repro.serving import SchedConfig as RSchedConfig
from repro.spec import SpecConfig as RSpecConfig
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.obs import clock
from repro_torch.paging import PagePool
from repro_torch.serving import (ContinuousScheduler, FaultConfig,
                                 FaultInjector, RequestQueue,
                                 ResilienceConfig, SchedConfig)
from repro_torch.serving.faults import FAIL_DEADLINE, FAIL_NUMERIC
from repro_torch.spec import SpecConfig

from test_torch_model import _packed_pair
from torch_cpu_threads import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# The injector's schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rates,pins", [
    (0, dict(), dict()),
    (3, dict(nan_rate=0.3, oom_rate=0.3), dict(nan_at=(5,))),
    (7, dict(nan_rate=0.05, oom_rate=0.05, slow_rate=0.02,
             draft_fail_rate=0.05), dict()),
    (11, dict(nan_rate=0.9, oom_rate=0.5, slow_rate=0.5,
              draft_fail_rate=0.5), dict(oom_at=(1, 2), slow_at=(3,)))])
def test_injector_schedule_byte_equal_to_repro(seed, rates, pins):
    """60 steps of plan() with a choose_slot() draw after every NaN step
    (over unsorted live sets): the same faults, victims and counters, and
    the generators' states byte-equal at the end."""
    port = FaultInjector(FaultConfig(seed=seed, **rates, **pins))
    ref = RFaultInjector(RFaultConfig(seed=seed, **rates, **pins))
    live_sets = ([], [2, 0], [5, 1, 3], [4])
    for step in range(1, 61):
        p, r = port.plan(step), ref.plan(step)
        assert (p.nan, p.oom, p.slow, p.draft_fail) == \
            (r.nan, r.oom, r.slow, r.draft_fail), step
        if p.nan:
            live = live_sets[step % len(live_sets)]
            assert port.choose_slot(live) == ref.choose_slot(live)
    assert port.injected == ref.injected
    assert port._rng.bit_generator.state == ref._rng.bit_generator.state


@pytest.mark.parametrize("pkg", ["repro", "port"])
def test_injector_schedule_deterministic(pkg):
    """Same seed, same schedule; *_at steps fire exactly."""
    fc, fi = ((RFaultConfig, RFaultInjector) if pkg == "repro"
              else (FaultConfig, FaultInjector))
    cfg = fc(seed=3, nan_rate=0.3, oom_rate=0.3, nan_at=(5,))
    a = [fi(cfg).plan(s) for s in range(1, 20)]
    b = [fi(cfg).plan(s) for s in range(1, 20)]
    assert a == b
    assert a[4].nan
    assert any(f.oom for f in a)


# ---------------------------------------------------------------------------
# repro's test_faults.py cases on both packages
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _package(name):
    """The reduced 2-layer config, its random weights and the engine's
    classes and keywords of one package (its own init; the cases compare
    each package with itself)."""
    if name == "repro":
        cfg = rget_config("ternary-paper", reduced=True, num_layers=2)
        return types.SimpleNamespace(
            cfg=cfg, params=RLM(cfg).init(jax.random.PRNGKey(0)),
            engine=RScheduler, faults=RFaultConfig,
            resilience=RResilienceConfig, sched=RSchedConfig,
            spec=RSpecConfig, kw={}, paged={"paged_attn": "jax"},
            clock=rclock, serve=rserve, serve_args=[])
    cfg = get_config("ternary-paper", reduced=True, num_layers=2)
    cfg, params = serve.build_params(cfg, 0, "cpu", packed=False)
    return types.SimpleNamespace(
        cfg=cfg, params=params, engine=ContinuousScheduler,
        faults=FaultConfig, resilience=ResilienceConfig, sched=SchedConfig,
        spec=SpecConfig, kw={"device": "cpu"}, paged={}, clock=clock,
        serve=serve, serve_args=["--device", "cpu"])


def _engine(pk, slots=3, max_len=32, **kw):
    eng = pk.engine(pk.cfg, max_slots=slots, max_len=max_len, **pk.kw, **kw)
    eng.load(pk.params)
    return eng


def _workload(cfg, lens=(4, 4, 6, 5), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def _reference(pk, prompts, gen=8, **kw):
    eng = _engine(pk, **kw)
    reqs = [eng.submit(p, gen) for p in prompts]
    eng.run()
    return [list(r.tokens) for r in reqs]


@functools.lru_cache(maxsize=None)
def _fault_free(name):
    """One package's fault-free streams of the default workload, run once
    and shared by the cases that compare with them."""
    pk = _package(name)
    return _reference(pk, _workload(pk.cfg))


PKGS = pytest.mark.parametrize("pkg", ["repro", "port"])


@PKGS
def test_nan_quarantine_isolates_slot_and_retry_is_token_exact(pkg):
    pk = _package(pkg)
    prompts = _workload(pk.cfg)
    ref = _fault_free(pkg)
    eng = _engine(pk, faults=pk.faults(nan_at=(3, 5)),
                  resilience=pk.resilience(max_retries=2))
    reqs = [eng.submit(p, 8) for p in prompts]
    m = eng.run()
    assert m["faults"]["injected"]["nan_logits"] == 2
    assert m["faults"]["quarantines"] == 2
    assert m["faults"]["retries"] == 2
    assert m["faults"]["failed_requests"] == 0
    assert any(r.attempts > 0 for r in reqs)
    for r, want in zip(reqs, ref):
        assert r.state == "done" and list(r.tokens) == want, r.rid
        assert r.terminal
    assert eng.pool.n_free == eng.max_slots


@PKGS
def test_guard_disabled_outputs_unchanged(pkg):
    pk = _package(pkg)
    prompts = _workload(pk.cfg)
    a = _fault_free(pkg)
    eng = _engine(pk, resilience=pk.resilience())
    reqs = [eng.submit(p, 8) for p in prompts]
    m = eng.run()
    assert [list(r.tokens) for r in reqs] == a
    assert m["faults"]["quarantines"] == 0
    assert m["faults"]["injected"] == {}


@PKGS
def test_retries_exhausted_terminates_failed(pkg):
    pk = _package(pkg)
    prompts = _workload(pk.cfg)
    eng = _engine(pk, faults=pk.faults(nan_at=tuple(range(2, 30))),
                  resilience=pk.resilience(max_retries=0))
    req = eng.submit(prompts[0], 4)
    m = eng.run()
    assert req.state == "failed" and req.fail_reason == FAIL_NUMERIC
    assert req.slot is None and eng.pool.n_free == eng.max_slots
    assert m["faults"]["failed_requests"] == 1
    assert eng.total_drained == eng.queue.submitted
    assert req.metrics()["fail_reason"] == FAIL_NUMERIC


@PKGS
def test_deadline_cancels_queued_and_mid_decode(pkg):
    """deadline_s 0 cancels while queued; 50 ms slow steps against a 600
    ms deadline cancel a live request mid-decode (it needs >= 30 steps)."""
    pk = _package(pkg)
    prompts = _workload(pk.cfg)
    eng = _engine(pk)
    doomed = eng.submit(prompts[0], 8, deadline_s=0.0)
    ok = eng.submit(prompts[1], 4)
    m = eng.run()
    assert doomed.state == "failed" and doomed.fail_reason == FAIL_DEADLINE
    assert doomed.tokens == [] and doomed.slot is None
    assert ok.state == "done" and len(ok.tokens) == 4
    assert m["faults"]["degradations"]["deadline_cancellations"] == 1

    slow = _engine(pk, max_len=40,
                   faults=pk.faults(slow_at=tuple(range(1, 200)),
                                    slow_s=0.05))
    req = slow.submit(prompts[0], 30, deadline_s=0.6)
    slow.run()
    assert req.state == "failed" and req.fail_reason == FAIL_DEADLINE
    assert req.first_token_t is not None
    assert req.slot is None and slow.pool.n_free == slow.max_slots


@PKGS
def test_paged_chaos_drains_token_exact_and_reclaims(pkg):
    pk = _package(pkg)
    prompts = _workload(pk.cfg)
    kw = dict(cache="paged", page_size=4, n_pages=40, **pk.paged)
    ref = _reference(pk, prompts, **kw)
    eng = _engine(pk, faults=pk.faults(nan_at=(3,), oom_at=(4, 6),
                                       oom_burst=2), **kw)
    reqs = [eng.submit(p, 8) for p in prompts]
    m = eng.run()
    assert m["faults"]["injected"]["page_oom"] == 2
    for r, want in zip(reqs, ref):
        assert r.state == "done" and list(r.tokens) == want, r.rid
    assert eng.pool.all_reclaimed
    assert eng.total_drained == eng.queue.submitted


@PKGS
def test_spec_auto_disable_degradation(pkg):
    """Ladder rung 1: with an unreachable acceptance floor the engine
    switches speculation off once the rolling window fills, finishes on
    plain decode, and stays token-exact."""
    pk = _package(pkg)
    prompts = _workload(pk.cfg)
    spec = pk.spec(k=2)
    ref = _reference(pk, prompts, spec=spec)
    eng = _engine(pk, spec=spec,
                  resilience=pk.resilience(spec_accept_floor=1.1,
                                           spec_floor_window=2))
    reqs = [eng.submit(p, 8) for p in prompts]
    m = eng.run()
    deg = m["faults"]["degradations"]
    assert deg["spec_disabled"] and deg["spec_disables"] == 1
    assert m["spec"]["disabled"]
    assert [list(r.tokens) for r in reqs] == ref


@PKGS
def test_spec_draft_fault_falls_back_token_exact(pkg):
    """A draft fault turns that round into plain decode; the stream (and
    the draft's re-sync bookkeeping) stays token-exact."""
    pk = _package(pkg)
    prompts = _workload(pk.cfg)
    spec = pk.spec(k=2)
    ref = _reference(pk, prompts, spec=spec, slots=2)
    eng = _engine(pk, slots=2, spec=spec,
                  faults=pk.faults(draft_fail_at=(2, 4), nan_at=(3,)))
    reqs = [eng.submit(p, 8) for p in prompts]
    m = eng.run()
    assert m["spec"]["draft_fallbacks"] == 2
    assert m["faults"]["injected"]["draft_fail"] == 2
    assert [list(r.tokens) for r in reqs] == ref


@pytest.mark.parametrize("queue", [RRequestQueue, RequestQueue])
def test_queue_pop_empty_raises_descriptive(queue):
    q = queue()
    with pytest.raises(IndexError, match="empty RequestQueue"):
        q.pop()
    assert q.empty() and q.depth() == 0


@PKGS
def test_serve_cli_chaos_smoke(pkg, capsys):
    pk = _package(pkg)
    metrics = pk.serve.main(["--arch", "ternary-paper", "--reduced",
                             "--requests", "6", "--slots", "2",
                             "--prompt-len", "8", "--gen-lens", "2,6",
                             "--chaos", "--max-retries", "2",
                             *pk.serve_args])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["submitted"] == out["drained"] == 6
    assert "faults" in out and "injected" in out["faults"]
    done = sum(r["state"] == "done" for r in out["per_request"])
    failed = sum(r["state"] == "failed" for r in out["per_request"])
    assert done + failed == 6
    assert metrics["faults"]["failed_requests"] == failed


def test_serve_cli_chaos_deadline_retries_on_cpu(capsys):
    """The port's CLI with all three flags, packed and over the paged
    cache: every request terminal, the faults block beside the per-request
    reasons."""
    metrics = serve.main(["--device", "cpu", "--reduced", "--packed",
                          "--ternary-min-dim", "64", "--requests", "6",
                          "--slots", "2", "--prompt-len", "8",
                          "--gen-lens", "2,6", "--cache", "paged",
                          "--page-size", "4", "--chaos", "--seed", "1",
                          "--deadline-s", "30", "--max-retries", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == json.loads(json.dumps(metrics))
    assert out["drained"] == 6
    states = {r["state"] for r in out["per_request"]}
    assert states <= {"done", "failed"}
    assert all((r["fail_reason"] is None) == (r["state"] == "done")
               for r in out["per_request"])
    assert out["faults"]["failed_requests"] == sum(
        r["state"] == "failed" for r in out["per_request"])
    assert all(r["attempts"] <= 2 for r in out["per_request"])


# ---------------------------------------------------------------------------
# The port's engine against repro's under one chaos schedule
# ---------------------------------------------------------------------------

MODES = {
    "dense": ({}, {}),
    "paged": (dict(cache="paged", page_size=4, n_pages=24),
              dict(paged_attn="jax")),
    "chunked": ({}, {}),
}


@pytest.fixture(scope="module")
def pair():
    return _packed_pair("float32", num_layers=2)


def _lockstep(engines, prompts, gens, clocks=None, **submit_kw):
    """Submit the workload to each engine and step them together until
    both drain (advancing ``clocks`` by 0.1 s before every step); returns
    each engine's requests and metrics."""
    reqs = [[e.submit(p, g, **submit_kw) for p, g in zip(prompts, gens)]
            for e in engines]
    snaps = [e.begin_metrics() for e in engines]
    while any(e.has_work() for e in engines):
        for c in clocks or ():
            c.advance(0.1)
        for e in engines:
            e.step()
    return reqs, [e.collect_metrics(s) for e, s in zip(engines, snaps)]


def _outcome(reqs):
    return [(r.state, r.fail_reason, r.attempts, list(r.tokens))
            for r in reqs]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_engines_match_repro(pair, mode, seed):
    """Both engines under FaultConfig(seed, nan 0.2, oom 0.2), one retry:
    the same outcomes request by request and the same faults block (and
    cache metrics, paged)."""
    rcfg, rparams, pcfg, pparams = pair
    pkw, rkw = MODES[mode]
    prompts, gens, _ = serve.build_workload(pcfg, 8, 8, (3, 9), seed=5)
    chunked = mode == "chunked"
    rfaults = RFaultConfig(seed=seed, nan_rate=0.2, oom_rate=0.2)
    reng = RScheduler(rcfg, max_slots=3, max_len=20, faults=rfaults,
                      resilience=RResilienceConfig(max_retries=1),
                      sched=(RSchedConfig(chunk_tokens=3, admission="fifo")
                             if chunked else None), **pkw, **rkw)
    reng.load(rparams)
    peng = ContinuousScheduler(
        pcfg, max_slots=3, max_len=20, device="cpu",
        faults=FaultConfig(seed=seed, nan_rate=0.2, oom_rate=0.2),
        resilience=ResilienceConfig(max_retries=1),
        sched=(SchedConfig(chunk_tokens=3, admission="fifo")
               if chunked else None), **pkw)
    peng.load(pparams)
    (rreqs, preqs), (rm, pm) = _lockstep([reng, peng], prompts, gens)
    assert _outcome(preqs) == _outcome(rreqs)
    assert pm["faults"] == rm["faults"]
    assert pm["faults"]["injected"]["nan_logits"] > 0
    assert pm["faults"]["quarantines"] > 0
    assert [r["attempts"] for r in pm["per_request"]] == \
        [r["attempts"] for r in rm["per_request"]]
    assert pm["cache"] == rm["cache"] or mode != "paged"
    assert peng._step_no == reng._step_no
    if mode == "paged":
        assert pm["faults"]["injected"]["page_oom"] > 0
        assert peng.pool.all_reclaimed and reng.pool.all_reclaimed
    else:
        assert peng.pool.all_free
    if chunked:
        assert pm["sched"]["chunk_steps"] == rm["sched"]["chunk_steps"]


def test_deadlines_match_repro_under_fake_clocks(pair):
    """Both engines under their own fake clocks, advanced 0.1 s a step in
    lockstep: deadlines of 0.45 s (and 0.25 s, queued behind full slots)
    cancel the same requests at the same steps."""
    rcfg, rparams, pcfg, pparams = pair
    prompts, gens, _ = serve.build_workload(pcfg, 6, 6, (4, 9), seed=2)
    with rclock.fake_clock() as rc, clock.fake_clock() as pc:
        reng = RScheduler(rcfg, max_slots=2, max_len=16,
                          resilience=RResilienceConfig(deadline_s=0.45))
        reng.load(rparams)
        peng = ContinuousScheduler(
            pcfg, max_slots=2, max_len=16, device="cpu",
            resilience=ResilienceConfig(deadline_s=0.45))
        peng.load(pparams)
        (rreqs, preqs), (rm, pm) = _lockstep([reng, peng], prompts, gens,
                                             clocks=(rc, pc))
    assert _outcome(preqs) == _outcome(rreqs)
    assert pm["faults"] == rm["faults"]
    cancels = pm["faults"]["degradations"]["deadline_cancellations"]
    assert cancels == sum(r.fail_reason == FAIL_DEADLINE for r in preqs)
    assert 0 < cancels < len(prompts)
    assert any(r.first_token_t is not None for r in preqs
               if r.fail_reason == FAIL_DEADLINE)      # cancelled live
    assert peng.pool.all_free


def test_admission_pause_matches_repro(pair):
    """admission_pause_frac on a small page pool: the same pauses and
    outcomes as repro's."""
    rcfg, rparams, pcfg, pparams = pair
    prompts, gens, _ = serve.build_workload(pcfg, 6, 8, (4, 8), seed=4)
    res = dict(admission_pause_frac=0.5)
    reng = RScheduler(rcfg, max_slots=3, max_len=16, cache="paged",
                      page_size=4, n_pages=13, paged_attn="jax",
                      resilience=RResilienceConfig(**res))
    reng.load(rparams)
    peng = ContinuousScheduler(pcfg, max_slots=3, max_len=16, device="cpu",
                               cache="paged", page_size=4, n_pages=13,
                               resilience=ResilienceConfig(**res))
    peng.load(pparams)
    (rreqs, preqs), (rm, pm) = _lockstep([reng, peng], prompts, gens)
    assert _outcome(preqs) == _outcome(rreqs)
    assert pm["faults"] == rm["faults"]
    assert pm["faults"]["degradations"]["admission_pauses"] > 0
    assert pm["cache"] == rm["cache"]


def test_page_pool_injected_failures_are_used_one_per_call(pair):
    """Armed failures fail admit and ensure_append calls that need pages,
    one each; a call needing none uses none."""
    _, _, pcfg, _ = pair
    pool = PagePool(LM(pcfg, "cpu"), 2, 16, page_size=4)
    prompt = np.arange(1, 7, dtype=np.int32)
    pool.inject_alloc_failures(2)
    assert pool.admit(prompt) is None and pool.fault_alloc_failures == 1
    adm = pool.admit(prompt[:4], use_prefix=False)
    assert adm is None and pool.fault_alloc_failures == 0
    adm = pool.admit(prompt)
    assert adm is not None
    pool.inject_alloc_failures(1)
    assert pool.ensure_append(adm.slot, 6)      # inside its second page
    assert pool.fault_alloc_failures == 1
    assert not pool.ensure_append(adm.slot, 8)  # needs a third
    assert pool.fault_alloc_failures == 0
    assert pool.ensure_append(adm.slot, 8)
    with pytest.raises(ValueError):
        pool.inject_alloc_failures(-1)


# ---------------------------------------------------------------------------
# Real non-finite rows, and the guard's neutrality
# ---------------------------------------------------------------------------

def _poison(eng, slot):
    """NaN into the last layer's K at the slot's position 0 (dense row, or
    its first page): every query of the slot attends it, and the replay
    rewrites it before reading it. (In an earlier layer the NaN would reach
    the later layers' V at the slot's other positions, which a masked
    attention still multiplies by 0.)"""
    layer = eng.pool.layers[-1]
    if eng.cache_mode == "paged":
        layer["k_pages"][eng.pool.slot_pages[slot][0], 0] = float("nan")
    else:
        layer["k"][slot, 0] = float("nan")


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_nan_in_one_slots_cache_quarantines_that_slot(pair, mode):
    """After every slot is decoding, NaN lands in one slot's cache: the
    next decode step quarantines that slot alone, the others commit their
    tokens, and the replay (whose prefill rewrites position 0) gives the
    fault-free stream."""
    _, _, pcfg, pparams = pair
    kw = (dict(cache="paged", page_size=4, prefix_cache=False)
          if mode == "paged" else {})
    prompts, gens, _ = serve.build_workload(pcfg, 3, 6, (8,), seed=7)
    ref = ContinuousScheduler(pcfg, max_slots=3, max_len=16, device="cpu",
                              **kw)
    ref.load(pparams)
    want, _ = serve.run_continuous(ref, prompts, gens)

    eng = ContinuousScheduler(pcfg, max_slots=3, max_len=16, device="cpu",
                              **kw)
    eng.load(pparams)
    reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    eng.step()                                  # admit all, one decode
    assert len(eng._live) == 3
    victim = 1
    before = {s: len(r.tokens) for s, r in eng._live.items()}
    _poison(eng, victim)
    eng.step()
    assert eng.quarantines == 1 and victim not in eng._live
    assert reqs[victim].attempts == 1 and reqs[victim].state == "queued"
    assert all(len(eng._live[s].tokens) == before[s] + 1
               for s in eng._live)
    assert not bool(torch.isfinite(eng.last_logits[victim]).all())
    assert bool(torch.isfinite(eng.last_logits[[0, 2]]).all())
    eng.run()
    for r, w in zip(reqs, want):
        assert r.state == "done" and r.tokens == list(w)
    assert eng.quarantines == 1 and eng.failed_requests == 0


def test_nan_in_a_chunk_window_quarantines_that_row(pair):
    """Two prompts mid-prefill (chunks of 4): NaN in one's cache makes its
    next window row non-finite; it alone is quarantined and replayed, and
    both streams equal the fault-free chunked run's."""
    _, _, pcfg, pparams = pair
    prompts, gens, _ = serve.build_workload(pcfg, 2, 12, (5,), seed=8)
    sched = SchedConfig(chunk_tokens=4, admission="fifo")
    ref = ContinuousScheduler(pcfg, max_slots=2, max_len=20, device="cpu",
                              sched=sched)
    ref.load(pparams)
    want, _ = serve.run_continuous(ref, prompts, gens)

    eng = ContinuousScheduler(pcfg, max_slots=2, max_len=20, device="cpu",
                              sched=sched)
    eng.load(pparams)
    reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    eng.step()                                  # admit both, first window
    assert sorted(eng._prefills) == [0, 1] and eng.chunk_steps == 1
    done = reqs[1].prefill_pos
    _poison(eng, 0)
    eng.step()
    assert eng.quarantines == 1 and reqs[0].attempts == 1
    assert 0 not in eng._prefills and reqs[1].prefill_pos > done
    eng.run()
    for r, w in zip(reqs, want):
        assert r.state == "done" and r.tokens == list(w)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_guard_leaves_a_clean_steps_logits_bitwise(pair, mode):
    """One engine step with an all-false mask against the model's own
    decode step on a copy of the same cache: equal logits bit for bit,
    and every row flagged finite."""
    _, _, pcfg, pparams = pair
    kw = dict(cache="paged", page_size=4) if mode == "paged" else {}
    prompts, gens, _ = serve.build_workload(pcfg, 3, 6, (8,), seed=9)
    eng = ContinuousScheduler(pcfg, max_slots=3, max_len=16, device="cpu",
                              faults=FaultConfig(seed=0), **kw)
    eng.load(pparams)
    for p, g in zip(prompts, gens):
        eng.submit(p, g)
    eng.step()
    eng._push_host_state()
    layers = [{k: v.clone() for k, v in layer.items()}
              for layer in eng.pool.layers]
    cache = {"layers": layers,
             "pos": torch.clamp(eng._dev_pos.clone(), max=15)}
    if mode == "paged":
        cache["block_table"] = eng._dev_table.clone()
    with torch.no_grad():
        logits, _ = eng.model.decode_step(pparams, cache,
                                          eng._dev_tok.clone()[:, None])
    eng.step()
    assert torch.equal(eng.last_logits, logits[:, 0])
    assert bool(eng._dev_ok.all()) and not bool(eng._dev_nan.any())
    assert eng.quarantines == 0


def test_slo_admission_retry_drains(pair):
    """A quarantine retry under SLO admission while requests wait:
    SLOQueue.requeue raises queue.submitted to keep its seq stamps fresh
    (in both packages), so repro's run() fails its drained == submitted
    check; the port's engine counts its own submissions and drains, its
    outcomes equal to the same schedule under FIFO admission."""
    rcfg, rparams, pcfg, pparams = pair
    prompts, gens, _ = serve.build_workload(pcfg, 8, 8, (3, 9), seed=5)
    reng = RScheduler(rcfg, max_slots=3, max_len=20,
                      sched=RSchedConfig(chunk_tokens=3),
                      faults=RFaultConfig(nan_at=(3, 5, 7)),
                      resilience=RResilienceConfig(max_retries=1))
    reng.load(rparams)
    for p, g in zip(prompts, gens):
        reng.submit(p, g)
    with pytest.raises(AssertionError, match="drained-request count"):
        reng.run()
    outcomes = {}
    for admission in ("slo", "fifo"):
        eng = ContinuousScheduler(
            pcfg, max_slots=3, max_len=20, device="cpu",
            sched=SchedConfig(chunk_tokens=3, admission=admission),
            faults=FaultConfig(nan_at=(3, 5, 7)),
            resilience=ResilienceConfig(max_retries=1))
        eng.load(pparams)
        reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
        m = eng.run()
        assert m["drained"] == eng.submitted == len(prompts)
        assert m["faults"]["quarantines"] == \
            m["faults"]["injected"]["nan_logits"] > 0
        outcomes[admission] = _outcome(reqs)
    assert eng.queue.submitted == len(prompts)      # FIFO: no restamps
    assert outcomes["slo"] == outcomes["fifo"]


@pytest.mark.parametrize("chunk", [0, 3], ids=["whole_prompt", "chunked"])
def test_nan_in_a_released_slots_v_meets_the_next_request_as_in_repro(
        pair, chunk):
    """ROADMAP C9, settled as repro's behaviour: NaN written into a
    released dense slot's V (layer 0, position 14, past anything the next
    request writes), then a request served into that slot. Whole-prompt
    admission rewrites the row whole, so the request is clean; a chunked
    one writes only its own positions, and attention multiplies the
    masked NaN by a probability of 0, so every attempt is quarantined
    until the request fails. Both packages give the same outcome."""
    rcfg, rparams, pcfg, pparams = pair
    prompts, _, _ = serve.build_workload(pcfg, 2, 6, (5,), seed=7)
    outcomes = []
    for pkg in ("repro", "port"):
        if pkg == "repro":
            eng = RScheduler(rcfg, max_slots=1, max_len=16, sched=(
                RSchedConfig(chunk_tokens=chunk, admission="fifo")
                if chunk else None))
            eng.load(rparams)
        else:
            eng = ContinuousScheduler(
                pcfg, max_slots=1, max_len=16, device="cpu",
                sched=(SchedConfig(chunk_tokens=chunk, admission="fifo")
                       if chunk else None))
            eng.load(pparams)
        eng.submit(prompts[0], 5)
        eng.run()
        if pkg == "repro":
            cache = eng.pool.layers["cache0"]
            cache["v"] = cache["v"].at[0, 0, 14].set(float("nan"))
        else:
            eng.pool.layers[0]["v"][0, 14] = float("nan")
        req = eng.submit(prompts[1], 5)
        m = eng.run()
        outcomes.append((req.state, req.fail_reason, req.attempts,
                         list(req.tokens), m["faults"]["quarantines"]))
    assert outcomes[1] == outcomes[0]
    if chunk:
        assert outcomes[0][:3] == ("failed", FAIL_NUMERIC, 3)
    else:
        assert outcomes[0][0] == "done" and outcomes[0][4] == 0
