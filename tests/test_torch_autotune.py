"""The port's block-shape tuner (``repro_torch.kernels.autotune``) held
against ``repro``'s: keys, bucketing, the cache file both ways, and, with
the port's constants and grids patched to ``repro``'s, the same candidates,
model scores (float equality), model-mode winners and fused compositions;
``GemmPlan.roofline()`` / ``FusedMlpPlan.roofline()`` with ``repro``'s keys
and, with equal blocks and patched constants, its values within 1e-12.
Then the port's own: every candidate is a tile its kernel instantiates
(the tables equal the ``.cu`` sources'), explicit and cached tiles that
name none raise, ``save()`` from several processes at once, ``ternary_gemm``'s
plan memo, and a served reduced ``ternary-paper`` engine that tunes at
``load()`` only and whose kernel-phase spans carry the modelled roofline
(``scripts/trace_report.py`` run as a child process has rows for them).
Every tuner here writes an explicit ``tmp_path`` cache.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import formats as rformats
from repro.core import weights as rweights
from repro.kernels import autotune as rautotune
from repro.kernels import ops as rops
from repro_torch.core import formats, weights
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import fused_mlp as fused_lib
from repro_torch.kernels import ternary_gemm as gemm_lib
from repro_torch.kernels import ternary_gemm_bitplane as bitplane_lib
from repro_torch.launch import serve
from repro_torch.obs import Tracer
from repro_torch.serving import ContinuousScheduler, SchedConfig

from test_torch_model import _packed_pair

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
PHASES = (None,) + ops.SERVING_PHASES
IMPLS = ("dense", "skip", "skip_db", "bitplane", "bitplane_factorized")


def _sweep(seed=0, n=300):
    """Seeded (m, k, n, sparsity, impl, fixed_n, fixed_k, phase) problems,
    every phase and impl included."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        impl = IMPLS[i % len(IMPLS)]
        skip = impl.startswith("skip")
        out.append((int(rng.integers(1, 9000)),
                    int(rng.choice([64, 256, 1000, 1024, 4096])),
                    int(rng.choice([96, 512, 1024, 4096, 16544])),
                    float(rng.choice([1.0, 0.7, 0.5, 0.3, 0.125, 0.04,
                                      0.001])),
                    impl,
                    int(rng.choice([16, 64, 128])) if skip else None,
                    int(rng.choice([32, 64, 256])) if skip else None,
                    PHASES[i % len(PHASES)]))
    return out


def test_cache_keys_match_repro():
    for m, k, n, s, impl, fn, fk, phase in _sweep():
        assert autotune.cache_key(m, k, n, s, impl, fixed_n=fn, fixed_k=fk,
                                  phase=phase) == \
            rautotune.cache_key(m, k, n, s, impl, fixed_n=fn, fixed_k=fk,
                                phase=phase)
        assert autotune.fused_cache_key(m, k, n, fn or 1024, s, 1.0 - s / 2,
                                        phase=phase) == \
            rautotune.fused_cache_key(m, k, n, fn or 1024, s, 1.0 - s / 2,
                                      phase=phase)


def test_buckets_match_repro():
    for v in list(range(1, 2100)) + [4095, 4096, 4097, 65536, 10 ** 6]:
        assert autotune._pow2_bucket(v) == rautotune._pow2_bucket(v)
    for s in np.linspace(-0.5, 1.5, 401):
        assert autotune._sparsity_bucket(float(s)) == \
            rautotune._sparsity_bucket(float(s))
    assert autotune.SPARSITY_GRID == rautotune.SPARSITY_GRID


def _entries(tuner):
    return {k: v.as_list() for k, v in tuner.entries().items()}


def test_cache_files_load_both_ways(tmp_path):
    """A file repro's tuner saves loads in the port to the same entries,
    and the reverse; a malformed entry drops alone."""
    rpath, ppath = tmp_path / "repro.json", tmp_path / "port.json"
    rt = rautotune.Autotuner(path=str(rpath), mode="model")
    pt = autotune.Autotuner(path=str(ppath), mode="model")
    for m, k, n, s, impl, fn, fk, phase in _sweep(1, 40):
        impl = "dense" if impl.startswith("bitplane") else impl
        rt.lookup(m, k, n, s, impl, fixed_n=fn, fixed_k=fk, phase=phase)
        pt.lookup(m, k, n, s, impl, fixed_n=fn, fixed_k=fk, phase=phase)
    rt.lookup_fused(8, 1024, 4096, 1024, phase="decode")
    pt.lookup_fused(8, 1024, 4096, 1024, phase="decode")
    loaded = autotune.Autotuner(path=str(rpath))
    assert _entries(loaded) == _entries(rt)
    assert isinstance(loaded.entries()[autotune.fused_cache_key(
        8, 1024, 4096, 1024, phase="decode")], autotune.FusedBlockConfig)
    back = rautotune.Autotuner(path=str(ppath))
    assert _entries(back) == _entries(pt)
    assert json.loads(ppath.read_text())["version"] == 1

    data = json.loads(rpath.read_text())
    good = dict(data["entries"])
    data["entries"].update({"bad:text": ["a", 1, 2], "bad:arity": [1, 2],
                            "bad:type": 7})
    rpath.write_text(json.dumps(data))
    for lib in (autotune, rautotune):
        got = lib.Autotuner(path=str(rpath)).entries()
        assert {k: v.as_list() for k, v in got.items()} == good
    rpath.write_text("{not json")
    assert autotune.Autotuner(path=str(rpath)).entries() == {}


@pytest.fixture
def repro_constants(monkeypatch):
    _patch_repro_constants(monkeypatch)


def _patch_repro_constants(monkeypatch):
    """The port's tuner with repro's v5e constants and grids (the wave term
    off), so its score and picks must be repro's."""
    for name in ("HBM_BW", "PEAK_FLOPS"):
        monkeypatch.setattr(autotune, name, getattr(rautotune, name))
    monkeypatch.setattr(autotune, "SMEM_BYTES", rautotune.VMEM_BYTES)
    monkeypatch.setattr(autotune, "STEP_OVERHEAD_S", 1e-6)
    monkeypatch.setattr(autotune, "PRESSURE", 0.25)
    monkeypatch.setattr(autotune, "REREAD", 1.0)
    for name in ("PIPE_STEPS", "STEP_LAT_S", "STEP_LAT_FRAG_S", "STEP_THR_S",
                 "STEP_THR_FRAG_S"):
        monkeypatch.setattr(autotune, name, 0.0)
    monkeypatch.setattr(autotune, "MIN_BLOCK_M", 8)
    monkeypatch.setattr(autotune, "FALLBACK_BLOCK_N", 128)
    monkeypatch.setattr(autotune, "FALLBACK_BLOCK_K", 256)
    monkeypatch.setattr(autotune, "CANDIDATE_BLOCKS", {
        impl: rautotune.CANDIDATE_BLOCKS for impl in IMPLS})
    monkeypatch.setattr(autotune, "DECODE_CANDIDATE_BLOCKS", {
        impl: rautotune.DECODE_CANDIDATE_BLOCKS for impl in IMPLS})


def test_model_mode_equals_repro_under_its_constants(repro_constants,
                                                     tmp_path):
    pt = autotune.Autotuner(path=str(tmp_path / "p.json"), mode="model")
    rt = rautotune.Autotuner(path=str(tmp_path / "r.json"), mode="model")
    for m, k, n, s, impl, fn, fk, phase in _sweep(2):
        got = pt.candidates(m, k, n, fixed_n=fn, fixed_k=fk, phase=phase,
                            impl=impl)
        want = rt.candidates(m, k, n, fixed_n=fn, fixed_k=fk, phase=phase)
        assert [c.as_list() for c in got] == [c.as_list() for c in want]
        for c in want:
            pc = autotune.BlockConfig(*c.as_list())
            assert pt._model_score(pc, m, k, n, s) == \
                rt._model_score(c, m, k, n, s)
        assert pt.lookup(m, k, n, s, impl, fixed_n=fn, fixed_k=fk,
                         phase=phase).as_list() == \
            rt.lookup(m, k, n, s, impl, fixed_n=fn, fixed_k=fk,
                      phase=phase).as_list()
    # a tile that fits no grid entry: both fall back alike
    assert pt.candidates(8, 64, 64, fixed_n=64, fixed_k=2 ** 22)[0].as_list() \
        == rt.candidates(8, 64, 64, fixed_n=64, fixed_k=2 ** 22)[0].as_list()
    for m, phase in ((8, "decode"), (40, "verify"), (256, "chunk"),
                     (1024, "prefill"), (300, None)):
        for pins in ({}, dict(fixed_n1=128, fixed_k1=256, fixed_n2=64,
                              fixed_k2=512)):
            assert pt.lookup_fused(m, 1024, 4096, 1024, 0.6, 0.3,
                                   phase=phase, **pins).as_list() == \
                rt.lookup_fused(m, 1024, 4096, 1024, 0.6, 0.3, phase=phase,
                                **pins).as_list()
    assert _entries(pt) == _entries(rt)


def _rt(rng, k, n):
    return rformats.random_ternary(rng, k, n, 0.5)


def test_rooflines_have_repros_keys_and_values(fresh_tuner, monkeypatch):
    """repro's tests/test_fused_mlp.py shapes: a 256 x 128 dense2bit GEMM
    at M 32, a gated 512 -> 2048 -> 512 block at M 256; the port plans its
    blocks, then both rooflines are taken under repro's constants."""
    rng = np.random.default_rng(20)
    t = _rt(rng, 256, 128)
    pw = weights.pack(torch.from_numpy(t), "dense2bit")
    rw = rweights.pack(t, "dense2bit")
    plan = ops.ternary_gemm_plan(pw, 32)
    ts = [_rt(rng, a, b) for a, b in ((512, 2048), (512, 2048), (2048, 512))]
    pi, pg, po = (weights.pack(torch.from_numpy(x), "dense2bit") for x in ts)
    ri, rg, ro = (rweights.pack(x, "dense2bit") for x in ts)
    got_plan = ops.fused_mlp_plan(pi, po, pg, m=256, impl="pallas")
    _patch_repro_constants(monkeypatch)

    got = plan.roofline()
    want_plan = rops.ternary_gemm_plan(rw, 32)
    assert set(got) == set(want_plan.roofline())
    want = dataclasses.replace(want_plan, block_m=plan.block_m,
                               block_n=plan.block_n,
                               block_k=plan.block_k).roofline()
    _close_dict(got, want)

    want_plan = rops.fused_mlp_plan(ri, ro, rg, m=256, impl="pallas")
    got = got_plan.roofline()
    assert set(got) == set(want_plan.roofline())
    want = dataclasses.replace(
        want_plan, **{f: getattr(got_plan, f) for f in (
            "block_m", "block_n1", "block_k1", "block_n2", "block_k2")}
    ).roofline()
    _close_dict(got, want)
    assert got["bytes"] < got["unfused_bytes"] and got["fused_speedup"] > 1
    up, down = got_plan.sub_plans()
    assert (up.n, down.k, up.block_n, down.block_n) == (
        2048, 2048, got_plan.block_n1, got_plan.block_n2)


def _close_dict(got, want):
    for key, w in want.items():
        g = got[key]
        if isinstance(w, float) and w != 0:
            assert abs(g - w) <= 1e-12 * abs(w), key
        else:
            assert g == w, key


def test_rooflines_use_the_h100s_constants():
    rng = np.random.default_rng(3)
    w = weights.pack(torch.from_numpy(_rt(rng, 1024, 1024)), "dense2bit")
    rl = ops.ternary_gemm_plan(w, 8, phase="decode").roofline()
    assert rl["peak_flops"] == autotune.PEAK_FLOPS == 989e12
    assert rl["ceiling_flops"] == min(
        989e12, rl["arithmetic_intensity"] * 3.35e12)
    assert rl["bound"] == "memory" and rl["model_time_s"] > 0
    assert (rl["collective"], rl["collective_bytes"], rl["tp"]) == \
        (None, 0.0, 1)
    assert 0 < rl["achieved_flops"] <= rl["ceiling_flops"]


def _macro_rows(src, name, arity):
    body = re.search(rf"#define {name}\(X\)(.*?)\n\n", src, re.S).group(1)
    return [tuple(int(v) for v in row.split(","))
            for row in re.findall(r"X\(([\d,\s]+)\)", body)
            if len(row.split(",")) == arity]


def test_tile_tables_equal_the_cuda_sources():
    b1 = _macro_rows((CSRC / "ternary_gemm.cu").read_text(), "B1_TILES", 5)
    assert {(bm, bn): (wm, wn, st) for bm, bn, wm, wn, st in b1} == \
        gemm_lib.TILES
    b7 = _macro_rows((CSRC / "ternary_gemm_bitplane.cu").read_text(),
                     "B7_TILES", 6)
    assert tuple((bm, bn) for bm, bn, *_ in b7) == bitplane_lib.TILES
    skip = (CSRC / "ternary_gemm_skip.cu").read_text()
    assert tuple(int(v) for v in re.findall(r"if \(bm == (\d+)\)", skip)) \
        == gemm_lib.SKIP_BLOCK_M
    b4 = (CSRC / "fused_mlp.cu").read_text()
    assert tuple((int(a), int(b)) for a, b in re.findall(
        r"if \(bm == (\d+) && strip == (\d+)\)", b4)) == fused_lib.TILES


@pytest.mark.parametrize("impl", IMPLS)
def test_every_candidate_is_an_instantiated_tile(impl):
    tuner = autotune.Autotuner(path="unused.json", mode="model")
    skip = impl.startswith("skip")
    tiles = (bitplane_lib.TILES if impl.startswith("bitplane")
             else gemm_lib.TILES)
    for m in list(range(1, 70)) + [127, 128, 129, 256, 1024, 8192]:
        for phase in PHASES:
            pins = dict(fixed_n=128, fixed_k=256) if skip else {}
            for c in tuner.candidates(m, 1024, 4096, phase=phase, impl=impl,
                                      **pins):
                if skip:
                    assert c.block_m in gemm_lib.SKIP_BLOCK_M
                    assert (c.block_n, c.block_k) == (128, 256)
                else:
                    assert (c.block_m, c.block_n) in tiles, (m, phase, c)
                    assert c.block_k == gemm_lib.BLOCK_K
    with pytest.raises(ValueError, match="no candidate tiles"):
        tuner.candidates(8, 64, 64, impl="nope")


def test_fused_entries_name_b4_tiles():
    assert [fused_lib.tile_for(bm) for bm in (1, 16, 17, 32, 64, 128)] == [
        (16, 64), (16, 64), (64, 128), (64, 128), (64, 128), (64, 128)]


@pytest.fixture
def fresh_tuner(tmp_path, monkeypatch):
    tuner = autotune.Autotuner(path=str(tmp_path / "tune.json"),
                               mode="model")
    monkeypatch.setattr(autotune, "_GLOBAL", tuner)
    return tuner


def test_explicit_and_cached_tiles_must_be_instantiated(fresh_tuner):
    rng = np.random.default_rng(4)
    w = weights.pack(torch.from_numpy(_rt(rng, 256, 192)), "dense2bit")
    assert ops.ternary_gemm_plan(w, 8, block_m=32, block_n=128).block_m == 32
    assert ops.ternary_gemm_plan(w, 8, block_m=64).block_n == 64
    with pytest.raises(ValueError, match="not one of B1's tiles"):
        ops.ternary_gemm_plan(w, 8, block_m=8, block_n=128)
    bp = weights.pack(torch.from_numpy(_rt(rng, 256, 192)), "bitplane")
    with pytest.raises(ValueError, match="not one of B7's tiles"):
        ops.ternary_gemm_plan(bp, 8, block_m=64, block_n=64)
    # a cache entry (a hand-edited file) that names no tile raises too
    fresh_tuner._cache[autotune.cache_key(8, 256, 192, phase="decode")] = \
        autotune.BlockConfig(8, 128, 512)
    with pytest.raises(ValueError, match="tuner's tile"):
        ops.ternary_gemm_plan(w, 8, phase="decode")


_SAVER = """
import sys
from repro_torch.kernels import autotune
tuner = autotune.Autotuner(path=sys.argv[1], mode="model")
for m in range(1, 40):
    tuner.lookup(m + 100 * int(sys.argv[2]), 1024, 1024, phase="decode")
"""


def test_save_is_safe_when_processes_write_at_once(tmp_path):
    """Four processes tune into one file at once: each save writes its own
    temporary file and renames it, so the file is always whole."""
    path = str(tmp_path / "shared.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _SAVER, path, str(i)],
                              env=env) for i in range(4)]
    assert [p.wait(120) for p in procs] == [0] * 4
    data = json.loads(Path(path).read_text())
    assert data["version"] == 1 and data["entries"]
    assert not list(tmp_path.glob("*.tmp"))
    assert autotune.Autotuner(path=path).entries()


def test_auto_mode_measures_only_with_a_card(fresh_tuner, tmp_path):
    """``run`` is called only with a card present; here the model
    decides, as a model-mode tuner does."""
    calls = []
    cfg = fresh_tuner.lookup(8, 1024, 1024, phase="decode", run=calls.append)
    if not torch.cuda.is_available():
        assert calls == []
        assert cfg == autotune.Autotuner(
            path=str(tmp_path / "model.json"), mode="model").lookup(
                8, 1024, 1024, phase="decode")


def test_ternary_gemm_memoizes_its_plan(fresh_tuner, monkeypatch):
    """A repeated dispatch takes the plan from the weight's memo: no
    planning, no tuner lookup; another tuner plans afresh."""
    rng = np.random.default_rng(5)
    w = weights.pack(torch.from_numpy(_rt(rng, 128, 96)), "dense2bit")
    x = torch.randn(8, 128)
    ops.ternary_gemm(x, w)
    planned = []
    real = ops.ternary_gemm_plan
    monkeypatch.setattr(ops, "ternary_gemm_plan",
                        lambda *a, **k: planned.append(1) or real(*a, **k))
    y = ops.ternary_gemm(x, w)
    with ops.serving_phase("decode"):
        ops.ternary_gemm(x, w)
        ops.ternary_gemm(x, w)
    assert len(planned) == 1
    monkeypatch.setattr(autotune, "_GLOBAL", autotune.Autotuner(
        path=str(Path(fresh_tuner.path).with_name("other.json"))))
    assert torch.equal(ops.ternary_gemm(x, w), y)
    assert len(planned) == 2


# ---------------------------------------------------------------------------
# the engine: tuning at load(), modelled spans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A reduced ternary-paper (2 layers) served whole-prompt and chunked,
    traced, with every tuner lookup after load() counted."""
    d = tmp_path_factory.mktemp("autotune_engine")
    mp = pytest.MonkeyPatch()
    mp.setattr(autotune, "_GLOBAL", autotune.Autotuner(
        path=str(d / "tune.json"), mode="model"))
    lookups = []
    for name in ("lookup", "lookup_fused"):
        real = getattr(autotune.Autotuner, name)
        mp.setattr(autotune.Autotuner, name,
                   lambda self, *a, _real=real, **k:
                   lookups.append(a) or _real(self, *a, **k))
    _, _, pcfg, pparams = _packed_pair("bfloat16", num_layers=2)
    prompts, gens, _ = serve.build_workload(pcfg, 5, 8, (2, 5), seed=7)
    out = {}
    try:
        for name, kw in (("whole", {}),
                         ("chunked", dict(sched=SchedConfig(
                             chunk_tokens=4)))):
            tracer = Tracer()
            eng = ContinuousScheduler(pcfg, max_slots=2, max_len=16,
                                      device="cpu", tracer=tracer, **kw)
            eng.load(pparams)
            at_load = len(lookups)
            for p, g in zip(prompts, gens):
                eng.submit(p, g)
            metrics = eng.run()
            path = d / f"{name}.json"
            tracer.export(str(path))
            out[name] = dict(at_load=at_load, after=len(lookups) - at_load,
                             metrics=metrics, path=path, engine=eng)
    finally:
        mp.undo()
    return out


def test_engine_tunes_at_load_only(served):
    for run in served.values():
        assert run["at_load"] > 0
        assert run["after"] == 0
        assert run["metrics"]["drained"] == 5


def test_kernel_phase_spans_carry_the_modelled_roofline(served):
    keys = {"gemms", "modeled_flops", "modeled_bytes", "model_time_s",
            "m_bucket"}
    names = set()
    for run in served.values():
        events = json.loads(Path(run["path"]).read_text())["traceEvents"]
        for e in events:
            if e.get("ph") == "X" and e["name"] in (
                    "decode_step", "prefill", "chunk_window") \
                    and e.get("tid") == 0:
                assert keys <= set(e["args"]), e
                assert e["args"]["model_time_s"] > 0
                assert e["args"]["m_bucket"] >= 1
                names.add(e["name"])
    assert names == {"decode_step", "prefill", "chunk_window"}
    eng = served["whole"]["engine"]
    agg = eng._modeled("decode", 2)
    plans = [p for (_, m, ph), p in eng.gemm_plans.items()
             if (m, ph) == (2, "decode")]
    assert agg["gemms"] == len(plans)
    assert agg["model_time_s"] == pytest.approx(
        sum(p.roofline()["model_time_s"] for p in plans))


def test_trace_report_rows_for_a_port_trace(served):
    """scripts/trace_report.py (``repro``'s reader) as a child process on
    the port's traces."""
    for name, spans in (("whole", {"decode_step", "prefill"}),
                        ("chunked", {"decode_step", "chunk_window"})):
        run = served[name]
        rep = json.loads(subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "trace_report.py"),
             str(run["path"]), "--json"], check=True, capture_output=True,
            text=True, timeout=120).stdout)
        mvm = rep["measured_vs_modeled"]
        assert spans <= set(mvm)
        assert mvm["decode_step"]["n"] == run["metrics"]["decode_steps"]
        assert all(mvm[s]["modeled_s"] > 0 for s in spans)
