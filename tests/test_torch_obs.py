"""The port's observability layer held against ``repro``'s: the fakeable
clock, the ring-buffer ``Tracer`` (the same scripted calls under the same
fake clock give equal ``to_dict()``), ``Histogram`` and ``percentiles`` on
the same numpy draws, the registry, ``kernel_probe``, and a traced serving
run of a reduced ``ternary-paper`` on both engines with the same weights:
the port's export passes ``repro``'s ``validate_events`` and
``scripts/trace_report.py``, each request's track holds ``repro``'s
sequence of event names, the metrics JSON has ``repro``'s keys, and TTFT
and TPOT rebuilt from the trace match ``Request.metrics()`` to the
microsecond (each stamp is rounded to an integer microsecond once).
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import clock as rclock
from repro.obs import metrics as rmetrics
from repro.obs import trace as rtrace
from repro.serving import ContinuousScheduler as RScheduler
from repro_torch.core import weights
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.obs import (MetricsRegistry, Tracer, load_trace,
                             percentiles, validate_events)
from repro_torch.obs import clock as obs_clock
from repro_torch.obs.clock import FakeClock, fake_clock
from repro_torch.obs.metrics import Histogram, RunningStat
from repro_torch.serving import ContinuousScheduler, RequestQueue

from test_torch_model import _packed_pair
from test_torch_paging import SCENARIOS

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# clock
# ---------------------------------------------------------------------------

def test_fake_clock_ticks_advances_and_restores():
    real = obs_clock.now()
    with fake_clock(FakeClock(t0=100.0, tick=0.5)) as fc:
        assert obs_clock.now() == 100.5
        assert obs_clock.now() == 101.0
        fc.advance(2.0)
        assert obs_clock.now() == 103.5
        with pytest.raises(ValueError):
            fc.advance(-1.0)
    assert obs_clock.now() >= real
    prev = obs_clock.set_clock(lambda: 7.0)
    assert obs_clock.now() == 7.0
    obs_clock.reset_clock()
    assert obs_clock.now() >= real
    obs_clock.set_clock(prev)


def test_queue_and_engine_stamp_the_obs_clock():
    with fake_clock(FakeClock(t0=500.0)):
        req = RequestQueue().submit(np.ones(4, np.int32), 2)
    assert req.submit_t == 500.0


# ---------------------------------------------------------------------------
# tracer: the same scripted calls on both packages
# ---------------------------------------------------------------------------

def _script(tracer, clock):
    """Tracks, every event kind, retrospective spans out of order, and
    enough events to overflow a small ring."""
    pid = tracer.new_pid("engine")
    tracer.thread_name(pid, 0, "scheduler")
    t_submit = clock()
    for rid in range(3):
        tracer.thread_name(pid, rid + 1, f"req {rid}")
        tracer.instant("submit", t=t_submit, cat="request", pid=pid,
                       tid=rid + 1, args={"rid": rid, "prompt_len": 8})
    for step in range(6):
        with tracer.span("decode_step", cat="kernel", pid=pid,
                         args={"live": step}):
            clock.advance(0.001 * (step + 1))
        tracer.counter("sched", {"queue_depth": 3 - step // 2,
                                 "live_slots": step}, pid=pid)
    tracer.complete("queue_wait", t_submit, clock(), cat="request", pid=pid,
                    tid=1, args={"rid": 0})
    tracer.instant("straggler_step", pid=pid, args={"dt_s": 0.5})
    tracer.complete("prefill", clock(), t_submit, pid=pid)   # clamps to 0


@pytest.mark.parametrize("capacity", [4, 13, 1 << 10])
@pytest.mark.parametrize("tick", [0.0, 1e-4, 0.0123457])
def test_tracer_to_dict_equals_repros(capacity, tick):
    got = Tracer(capacity, clock=FakeClock(t0=3.0, tick=tick))
    ref = rtrace.Tracer(capacity, clock=rclock.FakeClock(t0=3.0, tick=tick))
    _script(got, got._clock)
    _script(ref, ref._clock)
    assert got.to_dict() == ref.to_dict()
    assert got.dropped == ref.dropped and len(got) == len(ref)
    if capacity == 4:
        # the ring dropped most events but every track keeps its name
        assert got.dropped > 0
        names = [e for e in got.to_dict()["traceEvents"] if e["ph"] == "M"]
        assert len(names) == 5


def test_tracer_under_the_global_fake_clock_equals_repros(tmp_path):
    with fake_clock(tick=0.002) as fc, rclock.fake_clock(tick=0.002) as rfc:
        got, ref = Tracer(16), rtrace.Tracer(16)
        _script(got, fc)
        _script(ref, rfc)
    path = tmp_path / "t.json"
    assert got.export(str(path)) == len(ref.to_dict()["traceEvents"])
    assert load_trace(str(path)) == json.loads(json.dumps(ref.to_dict()))
    assert bool(got) and bool(Tracer())


def test_validate_events_rejects_what_repro_rejects(tmp_path):
    good = {"ph": "i", "name": "x", "pid": 0, "tid": 3, "ts": 0,
            "args": {"rid": 2}}
    validate_events([good])
    rtrace.validate_events([good])
    for bad in ({**good, "tid": 1}, {**good, "ts": 0.5},
                {"ph": "X", "name": "s", "pid": 0, "tid": 0, "ts": 0,
                 "dur": -1}, {"name": "no ph", "pid": 0, "tid": 0}):
        with pytest.raises(ValueError):
            validate_events([bad])
        with pytest.raises(AssertionError):
            rtrace.validate_events([bad])
    path = tmp_path / "not_a_trace.json"
    path.write_text("{}")
    with pytest.raises(ValueError):
        load_trace(str(path))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,cap", [(0, 8), (5, 8), (100, 8), (3000, 4096),
                                   (5000, 4096)])
def test_histogram_and_percentiles_equal_repros(n, cap):
    draws = np.random.default_rng(n).lognormal(size=n)
    got, ref = Histogram("h", cap=cap), rmetrics.Histogram("h", cap=cap)
    for v in draws:
        got.observe(v)
        ref.observe(v)
    assert got.percentiles() == ref.percentiles()
    assert got.n == ref.n == n
    vals = list(draws) + [None]
    assert percentiles(vals) == rmetrics.percentiles(vals)


def test_running_stat_ring_equals_repros():
    got, ref = RunningStat("s", cap=5), rmetrics.RunningStat("s", cap=5)
    for v in np.random.default_rng(1).integers(0, 50, size=23):
        got.push(v)
        ref.push(v)
    assert (got.n, got.total, got.peak, got.ring, got.mean) == \
        (ref.n, ref.total, ref.peak, ref.ring, ref.mean)


def test_registry_snapshot_equals_repros():
    regs = (MetricsRegistry(), rmetrics.MetricsRegistry())
    for reg in regs:
        reg.counter("drained").inc(3)
        reg.gauge("depth").set(2)
        reg.ewma("step_time_s", alpha=0.3).update(0.5)
        reg.ewma("step_time_s", alpha=0.3).update(1.5)
        h = reg.histogram("lat", cap=4)
        for v in range(9):
            h.observe(v / 10)
        reg.stat("live", cap=2).push(4)
        reg.counter("gone").inc()
        reg.reset("gone")
    got, ref = regs
    assert got.snapshot() == ref.snapshot()
    assert "lat" in got and "gone" not in got and len(got) == len(ref) == 5
    with pytest.raises(TypeError):
        got.gauge("drained")


# ---------------------------------------------------------------------------
# kernel probe
# ---------------------------------------------------------------------------

def _probe_operands():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    mats = [torch.from_numpy(rng.integers(-1, 2, size=s).astype(np.int8))
            for s in ((64, 32), (64, 32), (32, 64))]
    return x, mats


def test_kernel_probe_times_each_eager_dispatch():
    x, (w, wg, wo) = _probe_operands()
    pw = weights.pack(w)
    seen = []
    with ops.kernel_probe(lambda plan, dt: seen.append((plan, dt))):
        y1 = ops.ternary_gemm(x, pw)
        ops.fused_mlp(x, pw, weights.pack(wo), weights.pack(wg))
    assert [type(p).__name__ for p, _ in seen] == ["GemmPlan",
                                                   "FusedMlpPlan"]
    assert all(dt > 0 for _, dt in seen)
    assert (seen[0][0].m, seen[0][0].impl) == (4, "dense")
    assert (seen[1][0].impl, seen[1][0].ff, seen[1][0].gated) == \
        ("pallas", 32, True)
    # outside the scope: no callback, the same result
    assert torch.equal(ops.ternary_gemm(x, pw), y1)
    assert len(seen) == 2


def test_kernel_probe_counts_the_chains_gemms():
    """A bitplane MLP runs the chain: the block and its three GEMMs are
    each a dispatch, as in repro."""
    x, (w, wg, wo) = _probe_operands()
    seen = []
    with ops.kernel_probe(lambda plan, dt: seen.append(plan)):
        ops.fused_mlp(x, weights.pack(w, "bitplane"),
                      weights.pack(wo, "bitplane"),
                      weights.pack(wg, "bitplane"))
    assert [getattr(p, "format", p.impl) for p in seen] == [
        "bitplane", "bitplane", "bitplane", "chain"]


def test_kernel_probe_skips_dispatch_under_capture(monkeypatch):
    x, (w, _, _) = _probe_operands()
    seen = []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with ops.kernel_probe(lambda plan, dt: seen.append(dt)):
        ops.ternary_gemm(x, weights.pack(w))
    assert seen == []


# ---------------------------------------------------------------------------
# a traced serving run on both engines
# ---------------------------------------------------------------------------

def _traced_runs(mode, tmp_path):
    """The same workload and weights through repro's and the port's engine,
    each with a tracer; returns (requests, metrics, trace file) for
    both."""
    rcfg, rparams, pcfg, pparams = _packed_pair("float32", num_layers=2)
    if mode == "dense":
        prompts, gens, _ = serve.build_workload(pcfg, 7, 8, (2, 9), seed=5)
        kw, pkw = dict(max_slots=3, max_len=18), {}
    else:
        make, kw, paged_kw = SCENARIOS[mode]
        prompts, gens = make()
        pkw = dict(cache="paged", **paged_kw)
    out = {}
    for name, cls, params, extra in (
            ("repro", RScheduler, rparams,
             dict(pkw, paged_attn="jax") if pkw else {}),
            ("port", ContinuousScheduler, pparams, dict(pkw, device="cpu"))):
        tracer = (rtrace.Tracer if name == "repro" else Tracer)()
        eng = cls(rcfg if name == "repro" else pcfg, tracer=tracer, **kw,
                  **extra)
        eng.load(params)
        reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
        metrics = eng.run()
        path = tmp_path / f"{name}.json"
        tracer.export(str(path))
        out[name] = (reqs, metrics, path)
    return out


def _tracks(events):
    tracks = {}
    for e in events:
        rid = (e.get("args") or {}).get("rid")
        if rid is not None:
            tracks.setdefault(rid, []).append(e["name"])
    return tracks


@pytest.mark.parametrize("mode", ["dense", "oom", "prefix_cow"])
def test_engine_trace_matches_repro(mode, tmp_path):
    runs = _traced_runs(mode, tmp_path)
    rreqs, rm, rpath = runs["repro"]
    preqs, pm, ppath = runs["port"]
    pevents = load_trace(str(ppath))["traceEvents"]
    revents = rtrace.load_trace(str(rpath))["traceEvents"]
    rtrace.validate_events(pevents)
    validate_events(pevents)
    assert _tracks(pevents) == _tracks(revents)
    if mode == "oom":
        names = {n for t in _tracks(pevents).values() for n in t}
        assert {"defer", "preempt"} <= names

    # the metrics JSON: repro's keys without the unported planner's count
    assert set(pm) == set(rm) - {"planned_gemms"}
    assert pm["faults"] == rm["faults"]
    assert pm["mesh"] is rm["mesh"] is None
    assert pm["spec"] is rm["spec"] is None
    assert pm["sched"] is rm["sched"] is None
    assert set(pm["latency"]) == set(rm["latency"])
    assert set(pm["cache"]) == set(rm["cache"])
    assert [len(r.tokens) for r in preqs] == [len(r.tokens) for r in rreqs]

    # engine spans: one decode_step per decode step, counters every step
    eng_spans = [e for e in pevents if e["ph"] == "X" and e["tid"] == 0]
    steps = [e for e in eng_spans if e["name"] == "decode_step"]
    assert len(steps) == pm["decode_steps"]
    assert len([e for e in eng_spans if e["name"] == "prefill"]) == \
        pm["prefill_steps"]
    sched = [e for e in pevents if e["ph"] == "C" and e["name"] == "sched"]
    assert len(sched) == pm["decode_steps"]
    assert all({"queue_depth", "live_slots", "prefilling"} <= set(e["args"])
               for e in sched)

    # TTFT and TPOT from the trace: each stamp rounded to a microsecond once
    spans = {}
    for e in pevents:
        rid = (e.get("args") or {}).get("rid")
        if rid is not None and e["ph"] == "X":
            spans.setdefault(rid, {})[e["name"]] = e    # the last attempt's
    for r in preqs:
        mm = r.metrics()
        s = spans[r.rid]
        ttft = (s["queue_wait"]["dur"] + s["prefill"]["dur"]) / 1e6
        assert ttft == pytest.approx(mm["ttft_s"], abs=1.001e-6)
        if mm["tpot_s"] is not None:
            tpot = s["decode"]["dur"] / 1e6 / (len(r.tokens) - 1)
            assert tpot == pytest.approx(mm["tpot_s"],
                                         abs=1.001e-6 / (len(r.tokens) - 1))

    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import trace_report
    finally:
        sys.path.pop(0)
    rep = trace_report.report(str(ppath))
    assert rep["step_breakdown"]["decode_step"]["n"] == pm["decode_steps"]
    assert len(rep["ttft_waterfall"]) == pm["drained"]
    assert rep["ttft_waterfall"][0]["ttft_s"] == pytest.approx(
        pm["latency"]["ttft_s"]["max"], abs=2e-6)
    assert 0.0 < rep["interleave"]["busy_frac"] <= 1.0
    # the kernel-phase spans carry the warmed plans' modelled roofline, as
    # repro's do: the same rows, one per span
    rrep = trace_report.report(str(rpath))
    mvm = rep["measured_vs_modeled"]
    assert set(mvm) == set(rrep["measured_vs_modeled"]) == {"decode_step",
                                                            "prefill"}
    assert mvm["decode_step"]["n"] == pm["decode_steps"]
    assert mvm["prefill"]["n"] == pm["prefill_steps"]
    assert all(row["modeled_s"] > 0 for row in mvm.values())
    json.dumps(rep)


def test_engine_counters_are_registry_backed():
    _, _, pcfg, pparams = _packed_pair("float32", num_layers=2)
    eng = ContinuousScheduler(pcfg, max_slots=2, max_len=16, device="cpu")
    eng.load(pparams)
    prompts, gens, _ = serve.build_workload(pcfg, 3, 6, (2, 4), seed=1)
    snap = eng.begin_metrics()
    for p, g in zip(prompts, gens):
        eng.submit(p, g)
    while eng.has_work():
        eng.step()
    m = eng.collect_metrics(snap)
    assert m["drained"] == eng.total_drained == 3
    for name in ("total_drained", "prefill_steps", "decode_steps",
                 "preemptions", "deferrals"):
        assert eng.metrics.counter(name).value == getattr(eng, name)
    got = eng.metrics.snapshot()
    assert got["decode_steps"] == m["decode_steps"] > 0
    assert got["step_time_s"] == eng.metrics.ewma("step_time_s",
                                                  alpha=0.3).value > 0
    eng.deferrals = 7
    assert eng.metrics.counter("deferrals").value == 7


def test_straggler_steps_are_counted_and_traced():
    _, _, pcfg, pparams = _packed_pair("float32", num_layers=2)
    tracer = Tracer()
    eng = ContinuousScheduler(pcfg, max_slots=2, max_len=16, device="cpu",
                              tracer=tracer)
    with fake_clock(FakeClock(t0=10.0)) as fc:
        for dt in (0.01, 0.01, 0.5, 0.01):
            t0 = obs_clock.now()
            fc.advance(dt)
            eng._note_step_time(t0)
    assert eng.metrics.counter("straggler_steps").value == 1
    ev = [e for e in tracer.events() if e["name"] == "straggler_step"]
    assert len(ev) == 1 and ev[0]["args"]["dt_s"] == 0.5
    assert len([e for e in tracer.events() if e["name"] == "util"]) == 4


def test_serve_cli_trace_on_cpu(tmp_path, capsys):
    path = tmp_path / "run.json"
    m = serve.main(["--device", "cpu", "--reduced", "--packed",
                    "--ternary-min-dim", "64", "--requests", "5",
                    "--slots", "2", "--prompt-len", "8", "--gen-lens", "2,5",
                    "--trace", str(path), "--trace-buffer", "4096"])
    captured = capsys.readouterr()
    assert json.loads(captured.out.strip().splitlines()[-1])["drained"] == 5
    assert f"# trace: {path}" in captured.err
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import trace_report
    finally:
        sys.path.pop(0)
    rep = trace_report.report(str(path))
    assert rep["dropped"] == 0
    assert rep["step_breakdown"]["decode_step"]["n"] == m["decode_steps"]
    assert trace_report.main([str(path)]) == 0
