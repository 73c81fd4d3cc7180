"""Chunked prefill on the CPU: the port's (B, S) decode windows against
``repro``'s ``decode_step`` on the same weights and against S one-token
steps, the chunked engine against whole-prompt admission and against
``repro``'s chunked engine, the window's pad rows, the static buffers the
captured windows read, and the serve CLI's chunked and open-loop modes.

Tolerances: windows against ``repro`` in float32 at ``TOL`` of
``tests/test_torch_model.py`` (1e-4 of max|logit|: the same sums in
another order through the layers), bf16 at its 3e-2. A window against S
one-token steps, and chunked admission against whole-prompt admission
(bf16 config, as ``repro``'s ``tests/test_chunked_prefill.py`` holds
them), are exact: the GEMMs' rows do not depend on M at these shapes (M >=
2), and a window stores each token's K/V before it attends, as the
one-token steps and the prefill do. The card's GEMM tiles differ between
phases, so there chunked and whole-prompt agree under ``chip_smoke.py``'s
near-tie rule instead. ``repro``'s mid-prefill injected-OOM test has no
counterpart: the port's page pool has no fault injection yet."""
import dataclasses
import functools
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LM as RLM
from repro.obs import trace as rtrace
from repro.serving import ContinuousScheduler as RScheduler
from repro.serving import SchedConfig as RSchedConfig
from repro.serving import run_open_loop as r_run_open_loop
from repro_torch.configs import get_config
from repro_torch.kernels import autotune, ops
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.obs import Tracer, load_trace, validate_events
from repro_torch.paging import Int8Pages
from repro_torch.serving import (ContinuousScheduler, SchedConfig,
                                 TrafficConfig, make_schedule,
                                 run_open_loop)
from repro_torch.serving.sched import DEFAULT_SLO_CLASSES

from test_torch_decode_graph import _buffers
from test_torch_model import TDT, TOL, _close, _packed_pair
from test_torch_obs import ROOT, _tracks
from test_torch_paging import SCENARIOS
from torch_cpu_threads import one_torch_thread  # noqa: F401

# repro's tests/test_chunked_prefill.py workload: several lengths no chunk
# size divides, one shorter than every chunk size, one over 3 chunks
PLENS = (16, 23, 7, 16, 31, 5)
GENS = (6, 3, 8, 2, 5, 7)




@functools.lru_cache(maxsize=None)
def _pair(dtype):
    """Both packages' reduced 2-layer model on the same weights, built once
    a dtype for the file."""
    return _packed_pair(dtype, num_layers=2)


# ---------------------------------------------------------------------------
# (B, S) windows
# ---------------------------------------------------------------------------

B, PAGE, T = 3, 4, 6           # rows, page size, pages a row


def _port_cache(plm, mode, dtype, max_len):
    if mode == "dense":
        return plm.init_cache(B, max_len, TDT[dtype])
    kv = "int8" if mode == "paged-int8" else None
    cache = plm.init_paged_cache(1 + B * T, PAGE, B, TDT[dtype], kv)
    cache["block_table"] = torch.arange(1, 1 + B * T,
                                        dtype=torch.int32).reshape(B, T)
    return cache


def _repro_cache(rlm, mode, dtype, max_len):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    if mode == "dense":
        return rlm.init_cache(B, max_len, jdt)
    kv = "int8" if mode == "paged-int8" else None
    cache = rlm.init_paged_cache(1 + B * T, PAGE, B, jdt, kv)
    cache["block_table"] = jnp.arange(1, 1 + B * T,
                                      dtype=jnp.int32).reshape(B, T)
    return cache


@pytest.mark.parametrize("mode,dtype", [
    ("dense", "float32"), ("dense", "bfloat16"), ("paged", "float32"),
    ("paged", "bfloat16"), ("paged-int8", "float32")])
def test_windows_match_repro(mode, dtype):
    """Two windows per row from per-row offsets (0, 2, 4): S 5, then S 4
    from where each row stopped; the logits of every window position and
    the positions each row reached, against repro's decode_step."""
    rcfg, rparams, pcfg, pparams = _pair(dtype)
    rcfg = dataclasses.replace(rcfg, paged_attn_impl="jax")
    rlm, plm = RLM(rcfg), LM(pcfg, "cpu")
    max_len = B * T * PAGE // B
    rc, pc = (_repro_cache(rlm, mode, dtype, max_len),
              _port_cache(plm, mode, dtype, max_len))
    pos = np.array([0, 2, 4], np.int32)
    rc["pos"], pc["pos"] = jnp.asarray(pos), torch.from_numpy(pos)
    rng = np.random.default_rng(11)
    for s in (5, 4):
        tok = rng.integers(0, rcfg.vocab_size, size=(B, s)).astype(np.int32)
        rlog, rc = rlm.decode_step(rparams, rc, jnp.asarray(tok))
        with torch.no_grad():
            plog, pc = plm.decode_step(pparams, pc, torch.from_numpy(tok))
        assert tuple(plog.shape) == rlog.shape == (B, s, rcfg.vocab_size)
        _close(plog, rlog, TOL[dtype])
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(rc["pos"]))
    if mode == "dense":
        _close(pc["layers"][1]["k"], rc["layers"]["cache0"]["k"][1],
               TOL[dtype])


def _clone_cache(cache):
    def c(t):
        if isinstance(t, Int8Pages):
            return Int8Pages(t.codes.clone(), t.scales.clone())
        return t.clone()
    return dict(cache, layers=[{k: c(v) for k, v in layer.items()}
                               for layer in cache["layers"]])


def _cache_tensors(cache):
    for layer in cache["layers"]:
        for t in layer.values():
            if isinstance(t, Int8Pages):
                yield t.codes
                yield t.scales
            else:
                yield t


@pytest.mark.parametrize("mode", ["dense", "paged", "paged-int8"])
def test_window_equals_one_token_steps_bitwise(mode):
    """A window of S tokens from per-row positions gives the logits and
    writes the cache bytes of S one-token steps, bit for bit."""
    cfg = get_config("ternary-paper", reduced=True, num_layers=2,
                     ternary_min_dim=64)
    cfg, params = serve.build_params(cfg, 0, "cpu", packed=True)
    model = LM(cfg, "cpu")
    base = _port_cache(model, mode, "bfloat16", T * PAGE)
    base["pos"] = torch.tensor([0, 3, 9], dtype=torch.int32)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(B, 8)).astype(np.int32))
    with torch.no_grad():
        # earlier content, then the window and the steps from there
        _, base = model.decode_step(params, base, toks[:, :3])
        win_cache = _clone_cache(base)
        win, win_cache = model.decode_step(params, win_cache, toks[:, 3:])
        steps, step_cache = [], _clone_cache(base)
        for j in range(3, 8):
            lg, step_cache = model.decode_step(params, step_cache,
                                               toks[:, j:j + 1])
            steps.append(lg)
    assert torch.equal(win, torch.cat(steps, dim=1))
    assert torch.equal(win_cache["pos"], step_cache["pos"])
    for a, b in zip(_cache_tensors(win_cache), _cache_tensors(step_cache)):
        assert torch.equal(a, b)


def test_window_runs_under_the_chunk_phase():
    """Every GEMM of a chunk window is planned under the "chunk" phase,
    whose tile is the block-shape tuner's under the chunk key."""
    cfg = get_config("ternary-paper", reduced=True, num_layers=2,
                     ternary_min_dim=64)
    cfg, params = serve.build_params(cfg, 0, "cpu", packed=True)
    eng = ContinuousScheduler(cfg, max_slots=3, max_len=48, device="cpu",
                              sched=SchedConfig(chunk_tokens=8))
    eng.load(params)
    eng.submit(np.arange(20, dtype=np.int32), 3)
    plans = []
    with ops.kernel_probe(lambda plan, dt: plans.append(plan)):
        eng.step()                        # admit + first window
    assert eng.chunk_steps == 1 and plans
    assert {p.phase for p in plans} == {"chunk"}
    tuner = autotune.get_tuner()
    for p in plans:
        want = tuner.lookup(p.m, p.k, p.n, impl="dense", phase="chunk")
        assert (p.block_m, p.block_n) == (want.block_m, want.block_n)


# ---------------------------------------------------------------------------
# Chunked against whole-prompt admission (repro's test_chunked_prefill.py)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _small():
    cfg = get_config("ternary-paper", reduced=True, num_layers=2,
                     ternary_min_dim=64)
    return serve.build_params(cfg, 0, "cpu", packed=True)


def _workload(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in PLENS]


def _run(cfg, params, *, slots=3, max_len=48, on_step=None, **kw):
    eng = ContinuousScheduler(cfg, max_slots=slots, max_len=max_len,
                              device="cpu", **kw)
    eng.load(params)
    reqs = [eng.submit(p, g) for p, g in zip(_workload(cfg), GENS)]
    if on_step is None:
        metrics = eng.run()
    else:
        snap = eng.begin_metrics()
        while eng.has_work():
            eng.step()
            on_step(eng)
        metrics = eng.collect_metrics(snap)
    return [list(r.tokens) for r in reqs], metrics, eng


@pytest.fixture(scope="module")
def small():
    cfg, params = _small()
    ref, _, _ = _run(cfg, params)
    return cfg, params, ref


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_chunked_dense_token_exact(small, chunk):
    """Chunk sizes from one token a step through non-dividing (5) to one
    exceeding every prompt (64)."""
    cfg, params, ref = small
    got, m, eng = _run(cfg, params, sched=SchedConfig(chunk_tokens=chunk))
    assert got == ref
    assert m["sched"]["chunked_prefill"]
    assert m["sched"]["prefill_completions"] == len(PLENS)
    assert m["sched"]["chunk_tokens_committed"] == sum(PLENS)
    assert m["prefill_steps"] == 0 and eng.pool.all_free
    if chunk == 64:
        # windows round down to powers of two: an L-token prompt completes
        # in at most bit_length(L) windows, a power-of-two one in one
        assert all(r["chunks"] <= int(r["prompt_len"]).bit_length()
                   for r in m["per_request"])
        assert all(r["chunks"] == 1 for r in m["per_request"]
                   if r["prompt_len"] == 16)


def test_chunked_paged_token_exact(small):
    cfg, params, ref = small
    paged, _, _ = _run(cfg, params, cache="paged", page_size=4)
    got, m, eng = _run(cfg, params, cache="paged", page_size=4,
                       sched=SchedConfig(chunk_tokens=8))
    assert paged == ref and got == ref
    assert m["sched"]["prefill_completions"] == len(PLENS)
    assert m["cache"]["prefix"]["hits"] == 0     # private pages only
    assert eng.pool.all_reclaimed


def test_chunked_paged_int8_chunk_size_invariant(small):
    """int8 pages: whole-prompt prefill attends bf16 in-flight K/V while
    windows attend the quantized pages, so chunked against whole-prompt is
    not exact; every chunk size stores and attends the same bytes, so the
    stream does not depend on it."""
    cfg, params, _ = small
    kw = dict(cache="paged", page_size=4, kv_dtype="int8")
    ref, _, _ = _run(cfg, params, sched=SchedConfig(chunk_tokens=8), **kw)
    for chunk in (4, 64):
        got, m, _ = _run(cfg, params, sched=SchedConfig(chunk_tokens=chunk),
                         **kw)
        assert got == ref, chunk
        assert m["sched"]["prefill_completions"] == len(PLENS)


def test_tiny_pool_preemption_token_exact(small):
    """A page pool below the working set: chunked admission defers and
    preempts (mid-prefill slots first) and still drains exactly."""
    cfg, params, _ = small
    ref, _, _ = _run(cfg, params, max_len=40)
    got, m, eng = _run(cfg, params, max_len=40, cache="paged", page_size=4,
                       n_pages=14, sched=SchedConfig(chunk_tokens=8))
    assert got == ref
    assert m["cache"]["preemptions"] + m["cache"]["deferrals"] >= 1
    assert eng.pool.all_reclaimed


def test_slo_admission_whole_prompt_exact(small):
    """chunk_tokens=0: SLO-ordered admission with whole-prompt prefill; a
    workload without classes is FIFO, so the streams are the baseline's."""
    cfg, params, ref = small
    got, m, _ = _run(cfg, params, sched=SchedConfig(chunk_tokens=0))
    assert got == ref
    assert not m["sched"]["chunked_prefill"]
    assert m["sched"]["chunk_steps"] == 0 and m["prefill_steps"] > 0


def test_step_token_budget_trickle_still_drains(small):
    """A budget the decode batch alone fills: the liveness floor advances
    each prefill a token a step and everything drains exactly."""
    cfg, params, ref = small
    got, m, _ = _run(cfg, params,
                     sched=SchedConfig(chunk_tokens=8, step_token_budget=4))
    assert got == ref
    assert m["sched"]["chunk_steps"] >= -(-sum(PLENS) // 4)


def test_metrics_split_and_percentiles(small):
    """TTFT = queue wait + prefill, TPOT present, p50 <= p90 <= p99."""
    cfg, params, _ = small
    _, m, _ = _run(cfg, params, sched=SchedConfig(chunk_tokens=8))
    for r in m["per_request"]:
        assert r["queue_wait_s"] is not None and r["prefill_s"] is not None
        assert r["ttft_s"] == pytest.approx(
            r["queue_wait_s"] + r["prefill_s"], abs=1e-6)
        if r["gen_len"] > 1:
            assert r["tpot_s"] is not None
        assert r["chunks"] >= 1
    for key in ("ttft_s", "queue_wait_s", "prefill_s", "tpot_s", "e2e_s"):
        block = m["latency"][key]
        assert block["p50"] <= block["p90"] <= block["p99"] <= block["max"]
    assert m["latency"]["ttft_s"]["n"] == len(PLENS)


def test_slo_report_counts_violations(small):
    """The default classes with an unreachable TTFT target on one and an
    unmissable one on the other: the per-class scoreboard counts each
    request once, every request of the first as a violation and none of
    the second."""
    cfg, params, _ = small
    strict = dataclasses.replace(DEFAULT_SLO_CLASSES[0], ttft_target_s=0.0)
    lax = dataclasses.replace(DEFAULT_SLO_CLASSES[1], ttft_target_s=1e9)
    eng = ContinuousScheduler(cfg, max_slots=3, max_len=48, device="cpu",
                              sched=SchedConfig(chunk_tokens=8))
    eng.load(params)
    classes = (strict, lax)
    for i, (p, g) in enumerate(zip(_workload(cfg), GENS)):
        eng.submit(p, g, slo=classes[i % 2])
    slo = eng.run()["sched"]["slo"]
    assert slo["interactive"]["n"] == 3 == slo["batch"]["n"]
    assert slo["interactive"]["ttft_violations"] == 3
    assert slo["batch"]["ttft_violations"] == 0


# ---------------------------------------------------------------------------
# The port's chunked engine against repro's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_chunked_engines_give_equal_streams_in_float32(mode, tmp_path):
    """Both chunked engines on the same prompts and weights: equal greedy
    streams, the same sched metrics (keys and counts), the same request
    tracks in their traces."""
    rcfg, rparams, pcfg, pparams = _pair("float32")
    prompts = _workload(pcfg)
    kw = dict(max_slots=3, max_len=48)
    pkw = dict(cache="paged", page_size=4) if mode == "paged" else {}
    runs = {}
    for name, cls, cfg, params, extra, sched in (
            ("repro", RScheduler, rcfg, rparams,
             dict(pkw, paged_attn="jax") if pkw else {},
             RSchedConfig(chunk_tokens=5)),
            ("port", ContinuousScheduler, pcfg, pparams,
             dict(pkw, device="cpu"), SchedConfig(chunk_tokens=5))):
        tracer = (rtrace.Tracer if name == "repro" else Tracer)()
        eng = cls(cfg, sched=sched, tracer=tracer, **kw, **extra)
        eng.load(params)
        reqs = [eng.submit(p, g) for p, g in zip(prompts, GENS)]
        metrics = eng.run()
        path = tmp_path / f"{name}.json"
        tracer.export(str(path))
        runs[name] = ([list(r.tokens) for r in reqs], metrics, path)
    (rtoks, rm, rpath), (ptoks, pm, ppath) = runs["repro"], runs["port"]
    assert ptoks == rtoks
    assert set(pm["sched"]) == set(rm["sched"])
    for key in ("chunked_prefill", "chunk_tokens", "step_token_budget",
                "admission", "chunk_steps", "chunk_tokens_committed",
                "prefill_completions", "slo"):
        assert pm["sched"][key] == rm["sched"][key], key
    for key in ("decode_steps", "prefill_steps", "generated_tokens"):
        assert pm[key] == rm[key], key
    assert [r["chunks"] for r in pm["per_request"]] == \
        [r["chunks"] for r in rm["per_request"]]

    pevents = load_trace(str(ppath))["traceEvents"]
    validate_events(pevents)
    rtrace.validate_events(pevents)
    assert _tracks(pevents) == _tracks(
        rtrace.load_trace(str(rpath))["traceEvents"])
    windows = [e for e in pevents if e["ph"] == "X"
               and e["name"] == "chunk_window"]
    assert len(windows) == pm["sched"]["chunk_steps"]
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import trace_report
    finally:
        sys.path.pop(0)
    rep = trace_report.report(str(ppath))
    assert rep["step_breakdown"]["chunk_window"]["n"] == \
        pm["sched"]["chunk_steps"]
    assert len(rep["ttft_waterfall"]) == pm["drained"]
    json.dumps(rep)


@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_open_loop_compressed_matches_repro(kind):
    """``run_open_loop`` at time_scale 0 (every arrival at t = 0) on both
    packages' chunked engines, one schedule: equal streams and the traffic
    block's counts."""
    rcfg, rparams, pcfg, pparams = _pair("float32")
    tc = TrafficConfig(kind=kind, rate=8.0, n_requests=6,
                       prompt_lens=(6, 12, 20), gen_lens=(3, 5), seed=0)
    sched = make_schedule(tc, pcfg.vocab_size, classes=DEFAULT_SLO_CLASSES,
                          class_weights=(0.5, 0.5))
    peng = ContinuousScheduler(pcfg, max_slots=3, max_len=32, device="cpu",
                               sched=SchedConfig(chunk_tokens=8))
    peng.load(pparams)
    preqs, pm = run_open_loop(peng, sched, time_scale=0.0)
    reng = RScheduler(rcfg, max_slots=3, max_len=32,
                      sched=RSchedConfig(chunk_tokens=8))
    reng.load(rparams)
    rreqs, rm = r_run_open_loop(reng, sched, time_scale=0.0)
    assert [r.tokens for r in preqs] == [r.tokens for r in rreqs]
    assert pm["traffic"]["n"] == rm["traffic"]["n"] == 6
    assert pm["traffic"]["degenerate_schedule"]
    assert set(pm["traffic"]) == set(rm["traffic"])
    assert pm["sched"]["slo"].keys() == rm["sched"]["slo"].keys()


# ---------------------------------------------------------------------------
# Pad rows and static buffers
# ---------------------------------------------------------------------------

def _snapshot(tensors):
    return [t.clone() for t in tensors]


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_pad_rows_leave_other_slots_unchanged(small, mode):
    """One window over two of three slots while the third decodes: the
    third slot rides the window as a garbage row, which keeps every byte
    below its write frontier (dense) or of its pages (paged), and writes
    only at and past its frontier (dense) or into the trash page
    (paged)."""
    cfg, params, _ = small
    kw = dict(cache="paged", page_size=4) if mode == "paged" else {}
    eng = ContinuousScheduler(cfg, max_slots=3, max_len=48, device="cpu",
                              sched=SchedConfig(chunk_tokens=4), **kw)
    eng.load(params)
    prompts = _workload(cfg)
    eng.submit(prompts[2], 8)           # 7 tokens: decoding after 2 steps
    while not eng._live:
        eng.step()
    live = next(iter(eng._live))
    front = int(eng._pos[live])
    for p in (prompts[0], prompts[1]):
        eng.submit(p, 4)
    eng._admit()
    jobs = [(s, r, 4) for s, r in eng._prefills.items()]
    assert len(jobs) == 2 and eng.chunker.rows == 3
    if mode == "dense":
        tensors = [t for layer in eng.pool.layers for t in layer.values()]
        before = _snapshot(t[live, :front] for t in tensors)
        tail = _snapshot(t[live, front:] for t in tensors)
    else:
        pages = list(eng.pool.slot_pages[live])
        before = _snapshot(t[pages] for layer in eng.pool.layers
                           for t in layer.values())
    eng.chunker.advance(eng.params, eng.pool, jobs, eng._pos)
    if mode == "dense":
        after = [t[live, :front] for t in tensors]
        written = [not torch.equal(a, t[live, front:])
                   for a, t in zip(tail, tensors)]
    else:
        after = [t[pages] for layer in eng.pool.layers
                 for t in layer.values()]
        written = [bool(t[0].any()) for layer in eng.pool.layers
                   for t in layer.values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert any(written)                    # the garbage row's writes


def test_window_rows_past_the_cache_end_clamp(small):
    """A dense window row whose positions run past ``max_len`` (a garbage
    row near the end of its slot) stores its overflow at the last position
    and leaves the positions below its start and the other rows as they
    were."""
    cfg, params, _ = small
    model = LM(cfg, "cpu")
    cache = model.init_cache(2, 16)
    gen = torch.Generator().manual_seed(0)
    for layer in cache["layers"]:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    before = _snapshot(t for layer in cache["layers"] for t in layer.values())
    toks = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    pos = torch.tensor([0, 14], dtype=torch.int32)
    logits, _ = model.decode_step(params, dict(cache, pos=pos), toks)
    assert bool(torch.isfinite(logits).all())
    after = [t for layer in cache["layers"] for t in layer.values()]
    for b, a in zip(before, after):
        assert torch.equal(b[1, :14], a[1, :14])
        assert torch.equal(b[0, 4:], a[0, 4:])
        assert not torch.equal(b[1, 14:], a[1, 14:])


def _chunk_buffers(eng):
    ch = eng.chunker
    out = {"chunk.pos": ch._pos.data_ptr()}
    out.update({f"chunk.toks{s}": t.data_ptr() for s, t in ch._toks.items()})
    if eng.cache_mode == "paged":
        out["chunk.table"] = ch._table.data_ptr()
    return out | _buffers(eng)


@pytest.mark.parametrize("scenario,kv_dtype", [
    ("dense", None), ("churn", None), ("oom", None), ("oom", "int8")])
def test_static_buffers_keep_their_storage(scenario, kv_dtype):
    """Every buffer a captured window or the captured decode step reads
    keeps its address through admit, chunk windows, evict and preempt."""
    cfg, params = _small()
    make, kw, paged_kw = SCENARIOS["churn" if scenario == "dense"
                                   else scenario]
    prompts, gens = make()
    if scenario != "dense":
        kw = dict(kw, cache="paged", kv_dtype=kv_dtype, **paged_kw)
    eng = ContinuousScheduler(cfg, device="cpu",
                              sched=SchedConfig(chunk_tokens=4), **kw)
    eng.load(params)
    start = _chunk_buffers(eng)
    # widths: the powers of two up to min(slots + 4, max_len)
    top = min(kw["max_slots"] + 4, kw["max_len"])
    assert sorted(eng.chunker._toks) == [1 << i for i in
                                          range(top.bit_length())]
    for p, g in zip(prompts, gens):
        eng.submit(p, g)
    seen = []
    snap = eng.begin_metrics()
    while eng.has_work():
        eng.step()
        seen.append(_chunk_buffers(eng))
    m = eng.collect_metrics(snap)
    assert m["sched"]["chunk_steps"] > 0 and m["decode_steps"] > 0
    assert all(ptrs == start for ptrs in seen)
    if scenario == "oom":
        assert m["cache"]["preemptions"] > 0


def test_load_refuses_mid_prefill_requests(small):
    cfg, params, _ = small
    eng = ContinuousScheduler(cfg, max_slots=2, max_len=32, device="cpu",
                              sched=SchedConfig(chunk_tokens=2))
    eng.load(params)
    eng.submit(np.arange(12, dtype=np.int32), 3)
    eng.step()
    assert eng._prefills and not eng._live
    with pytest.raises(RuntimeError):
        eng.load(params)


# ---------------------------------------------------------------------------
# The serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--chunked-prefill", "--chunk-tokens", "4"],
    ["--chunked-prefill", "--traffic", "poisson", "--arrival-rate", "200"],
    ["--traffic", "bursty", "--arrival-rate", "200", "--cache", "paged",
     "--page-size", "8"],
    ["--chunked-prefill", "--slo-ttft-ms", "50", "--slo-tpot-ms", "5",
     "--step-token-budget", "6", "--cache", "paged", "--page-size", "8"]])
def test_serve_cli_chunked_and_open_loop_on_cpu(capsys, extra):
    m = serve.main(["--device", "cpu", "--reduced", "--packed",
                    "--ternary-min-dim", "64", "--requests", "6",
                    "--slots", "3", "--prompt-len", "12",
                    "--gen-lens", "2,5"] + extra)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["drained"] == m["drained"] == 6
    sched = out["sched"]
    assert sched["chunked_prefill"] == ("--chunked-prefill" in extra)
    if "--chunked-prefill" in extra:
        assert sched["chunk_tokens_committed"] == 6 * 12
    if "--traffic" in extra:
        assert out["traffic"]["n"] == 6
        assert set(sched["slo"]) <= {"interactive", "batch"}
    if "--step-token-budget" in extra:
        assert sched["step_token_budget"] == 6


def test_prefill_logits_from_gives_every_later_position(small):
    """``prefill(logits_from=k)``: the logits of positions k.. of one
    forward, each within the model tests' tolerance of a prefill of that
    prefix alone, and its last row the default's."""
    cfg, params, _ = small
    model = LM(cfg, "cpu")
    toks = torch.as_tensor(_workload(cfg)[0][None])
    s = toks.shape[1]
    _, last = model.prefill(params, {"tokens": toks}, s)
    _, rows = model.prefill(params, {"tokens": toks}, s, logits_from=s - 4)
    assert rows.shape == (1, 4, cfg.vocab_size)
    tol = TOL[cfg.dtype]
    _close(rows[:, -1:], last.float().numpy(), tol)
    for t in range(s - 4, s):
        _, ref = model.prefill(params, {"tokens": toks[:, :t + 1]}, t + 1)
        _close(rows[:, t - (s - 4)], ref[:, 0].float().numpy(), tol)
