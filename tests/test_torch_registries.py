"""The port's fused-MLP and paged-attention registries, and the plans an
engine warms at load, held against ``repro``'s: the same rows and
priorities, the same ``(format_up, format_down, impl)`` for every pack
format, gated or not, in every phase, the same plan keys and ``(format,
impl)`` from ``precompute_plans`` / ``precompute_fused_plans`` on a
reduced packed ``ternary-paper`` tree, ``repro``'s errors for an unknown
row, and an engine that honours ``paged_attn=`` and
``cfg.paged_attn_impl`` as ``repro``'s does.

Blocks are not compared: both packages take them from their block-shape
tuner under the same fused key (``autotune.fused_cache_key``), whose
grids differ by design (the port's fused entry names one of B4's tiles,
``fused_mlp.TILES``); the keys are compared. On the CPU
every row runs a plain version, so the paged rows are held bitwise to
``paged_decode_attention_ref`` (which ``tests/test_torch_paging.py``
holds against ``repro``'s lowerings) and the engines' streams bitwise to
each other.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rformats
from repro.core import weights as rweights
from repro.kernels import autotune as rautotune
from repro.kernels import ops as rops
from repro.serving import ContinuousScheduler as RScheduler
from repro.serving import SchedConfig as RSchedConfig
from repro_torch.core import weights
from repro_torch.kernels import autotune
from repro_torch.kernels import fused_mlp as fused_lib
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.paging import kernels as paged_lib
from repro_torch.serving import ContinuousScheduler, SchedConfig

from test_torch_model import _packed_pair

PHASES = (None, "prefill", "decode", "verify", "chunk")
K, FF, N = 64, 96, 32
TILE = dict(tile_k=32, tile_n=16)


def _pack_pair(t, fmt, opts):
    return (rweights.pack(t, fmt, **opts),
            weights.pack(torch.from_numpy(t), fmt, **opts))


def _tile_matrix(seed, k, n, s):
    rng = np.random.default_rng(seed)
    kp, npad = -(-k // TILE["tile_k"]) * TILE["tile_k"], \
        -(-n // TILE["tile_n"]) * TILE["tile_n"]
    return rformats.random_tile_ternary(rng, kp, npad, TILE["tile_k"],
                                        TILE["tile_n"], s)[:k, :n]


def _blocks():
    """name -> ({in, gate, out} repro containers, the port's)."""
    rng = np.random.default_rng(0)
    dense = {"in": rformats.random_ternary(rng, K, FF, 0.5),
             "gate": rformats.random_ternary(rng, K, FF, 0.5),
             "out": rformats.random_ternary(rng, FF, N, 0.5)}
    sparse = {"in": _tile_matrix(1, K, FF, 0.25),
              "gate": _tile_matrix(2, K, FF, 0.25),
              "out": _tile_matrix(3, FF, N, 0.25)}
    cases = {"dense2bit": (dense, "dense2bit", {}),
             "tiled_sparse": (sparse, "tiled", TILE),
             "tiled_full": (dense, "tiled", TILE),
             "bitplane": (dense, "bitplane", {}),
             "base3": (dense, "base3", {})}
    out = {}
    for name, (mats, fmt, opts) in cases.items():
        pairs = {k: _pack_pair(t, fmt, opts) for k, t in mats.items()}
        out[name] = ({k: p[0] for k, p in pairs.items()},
                     {k: p[1] for k, p in pairs.items()})
    return out


BLOCKS = _blocks()


def test_registries_have_repros_rows_and_priorities():
    def table(reg):
        return {name: row.priority for name, row in reg.items()}

    assert table(ops.fused_registry()) == table(rops.fused_registry())
    assert table(ops.paged_attention_registry()) == \
        table(rops.paged_attention_registry())
    assert sorted(ops.fused_registry()) == ["chain", "pallas"]
    assert sorted(ops.paged_attention_registry()) == ["jax", "pallas"]


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_fused_mlp_plan_matches_repro(name, gated):
    rw, pw = BLOCKS[name]
    rg, pg = (rw["gate"], pw["gate"]) if gated else (None, None)
    for phase in PHASES:
        for m in (1, 8, 40, 256):
            for impl in ("auto", "pallas", "chain"):
                want = rops.fused_mlp_plan(rw["in"], rw["out"], rg, m=m,
                                           impl=impl, phase=phase)
                got = ops.fused_mlp_plan(pw["in"], pw["out"], pg, m=m,
                                         impl=impl, phase=phase)
                for field in ("impl", "format_up", "format_down", "m", "k",
                              "ff", "n", "gated", "activation", "phase",
                              "occupancy_up", "occupancy_down"):
                    assert getattr(got, field) == getattr(want, field), \
                        (field, phase, m, impl)
                assert (got.block_m is None) == (got.impl == "chain")
    # under an ambient scope the plan takes the scope's phase, as repro's
    with ops.serving_phase("verify"):
        got = ops.fused_mlp_plan(pw["in"], pw["out"], pg, m=8)
    assert got.phase == "verify"


def test_fused_plan_blocks_are_b4s_tiles():
    """The fused row's blocks are the B4 tile the tuner's fused entry (under
    repro's key, composed from the chain plans' pinned sub-keys) names;
    the entry is in the tuner's cache under that key after planning."""
    rw, pw = BLOCKS["dense2bit"]
    tuner = autotune.get_tuner()
    for phase in ops.SERVING_PHASES:
        plan = ops.fused_mlp_plan(pw["in"], pw["out"], pw["gate"], m=8,
                                  phase=phase)
        assert plan.impl == "pallas"
        key = autotune.fused_cache_key(
            8, pw["in"].k, pw["in"].n, pw["out"].n, pw["in"].occupancy(),
            pw["out"].occupancy(), phase=phase)
        assert key == rautotune.fused_cache_key(
            8, rw["in"].k, rw["in"].n, rw["out"].n, rw["in"].occupancy(),
            rw["out"].occupancy(), phase=phase)
        entry = tuner.entries()[key]
        tile = fused_lib.tile_for(entry.block_m)
        assert (plan.block_m, plan.block_n1, plan.block_n2) == (
            tile[0], tile[1], tile[1])
        assert tile in fused_lib.TILES
    plan = ops.fused_mlp_plan(pw["in"], pw["out"], pw["gate"], m=8,
                              impl="chain")
    assert (plan.block_m, plan.block_n1, plan.block_k2) == (None,) * 3


def test_fused_rows_run_the_same_block_on_the_cpu():
    """Each name reaches its row (the plain versions here). In float32
    the two are the same plain GEMMs chained, so they agree within 1e-5."""
    _, pw = BLOCKS["dense2bit"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (5, K)).astype(np.float32))
    seen = []
    with ops.kernel_probe(lambda plan, dt: seen.append(plan.impl)):
        auto = ops.fused_mlp(x, pw["in"], pw["out"], pw["gate"])
        chain = ops.fused_mlp(x, pw["in"], pw["out"], pw["gate"],
                              impl="chain")
    assert seen[0] == "pallas" and seen[-1] == "chain"
    torch.testing.assert_close(auto, chain, rtol=1e-5, atol=1e-5)


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_unknown_rows_raise_repros_errors():
    rw, pw = BLOCKS["dense2bit"]
    assert _error(lambda: ops.fused_mlp_plan(
        pw["in"], pw["out"], m=4, impl="nope")) == _error(
        lambda: rops.fused_mlp_plan(rw["in"], rw["out"], m=4, impl="nope"))
    q = np.zeros((1, 2, 8), np.float32)
    pages = np.zeros((2, 4, 1, 8), np.float32)
    table = np.zeros((1, 1), np.int32)
    lens = np.ones(1, np.int32)
    assert _error(lambda: ops.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, pages, pages, table, lens)),
        impl="nope")) == _error(lambda: rops.paged_decode_attention(
            *(jnp.asarray(a) for a in (q, pages, pages, table, lens)),
            impl="nope"))
    # the tensor-parallel branches plan since the serving half of A12
    got = ops.fused_mlp_plan(pw["in"], pw["out"], m=4, tp=2)
    want = rops.fused_mlp_plan(rw["in"], rw["out"], m=4, tp=2)
    assert (got.ff, got.collective, got.tp) == \
        (want.ff, want.collective, want.tp)
    assert ops.precompute_plans({}, shard=lambda path, w: ("k", 2)) == {}


def test_paged_rows_on_cpu_tensors_run_the_plain_version():
    rng = np.random.default_rng(2)
    b, h, kv, hd, ps, t = 3, 4, 2, 8, 4, 3
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (8, ps, kv, hd)).astype(np.float32)) for _ in range(2))
    table = torch.from_numpy(rng.integers(1, 8, (b, t)).astype(np.int32))
    lens = torch.tensor([1, 7, 12], dtype=torch.int32)
    for window in (0, 5):
        want = paged_lib.paged_decode_attention_ref(q, kp, vp, table, lens,
                                                    window=window)
        for impl in ("auto", "jax", "pallas"):
            got = ops.paged_decode_attention(q, kp, vp, table, lens,
                                             window=window, impl=impl)
            assert torch.equal(got, want), (impl, window)


# --- the plans an engine warms ------------------------------------------------

@pytest.fixture(scope="module")
def one_layer():
    return _packed_pair("float32", num_layers=1)


@pytest.fixture(scope="module")
def two_layers():
    return _packed_pair("float32", num_layers=2)


MS = dict(prefill_ms=(1, 2, 4, 8, 16, 32, 64), decode_ms=(4,),
          verify_ms=(12,), chunk_ms=(4, 8, 16))


def _is_packed(path, w):
    return path[-1] == "w_packed"


def _r_is_packed(path, w):
    return getattr(path[-1], "key", None) == "w_packed"


def test_precompute_plans_match_repro(one_layer, two_layers):
    """One layer: the port's per-layer tree flattens to repro's stacked
    one leaf for leaf, so the keys are equal. Two layers: the port has a
    leaf per layer, each planning as repro's stacked leaf (7 a block)."""
    rcfg, rparams, pcfg, pparams = one_layer
    for impl in ("auto", "ref"):
        want = rops.precompute_plans(rparams, select=_r_is_packed,
                                     impl=impl, **MS)
        got = ops.precompute_plans(pparams, select=_is_packed, impl=impl,
                                   **MS)
        assert list(got) == list(want)
        for key, plan in got.items():
            ref = want[key]
            assert (plan.format, plan.impl, plan.m, plan.k, plan.n,
                    plan.phase) == (ref.format, ref.impl, ref.m, ref.k,
                                    ref.n, ref.phase), key
    _, rparams2, _, pparams2 = two_layers
    want = rops.precompute_plans(rparams2, select=_r_is_packed, **MS)
    got = ops.precompute_plans(pparams2, select=_is_packed, **MS)
    n_leaves = 1 + max(i for i, _, _ in got)
    assert n_leaves == 2 * 7 + 1
    for (i, m, phase), plan in got.items():
        ref = want[(min(i % 7 if i < 14 else 7, 7), m, phase)]
        assert (plan.format, plan.impl, plan.k, plan.n) == (
            ref.format, ref.impl, ref.k, ref.n)


def test_precompute_fused_plans_match_repro(one_layer, two_layers):
    _, rparams, _, pparams = one_layer
    want = rops.precompute_fused_plans(rparams, **MS)
    got = ops.precompute_fused_plans(pparams, **MS)
    assert list(got) == list(want)
    for key, plan in got.items():
        ref = want[key]
        assert (plan.format_up, plan.format_down, plan.impl, plan.m,
                plan.ff, plan.phase) == (ref.format_up, ref.format_down,
                                         ref.impl, ref.m, ref.ff,
                                         ref.phase), key
    _, rparams2, _, pparams2 = two_layers
    want = rops.precompute_fused_plans(rparams2, **MS)
    got = ops.precompute_fused_plans(pparams2, **MS)
    assert {i for i, _, _ in got} == {0, 1}
    for (i, m, phase), plan in got.items():
        assert plan.impl == want[(0, m, phase)].impl


def test_engine_plans_at_load_as_repro(one_layer):
    """The dense engine's plan keys equal repro's engine's (prefill Ms up
    to slots * max_len, the decode M, the chunk Ms); its plans take the
    "auto" rows the port dispatches, repro's its CPU "ref" rows; neither
    warms fused plans on the CPU."""
    rcfg, rparams, pcfg, pparams = one_layer
    for sched in (None, 4):
        reng = RScheduler(rcfg, max_slots=3, max_len=20, sched=None
                          if sched is None else RSchedConfig(
                              chunk_tokens=sched))
        reng.load(rparams)
        peng = ContinuousScheduler(pcfg, max_slots=3, max_len=20,
                                   device="cpu", sched=None
                                   if sched is None else SchedConfig(
                                       chunk_tokens=sched))
        peng.load(pparams)
        assert list(peng.gemm_plans) == list(reng.gemm_plans)
        assert peng.fused_plans == reng.fused_plans == {}
        for key, plan in peng.gemm_plans.items():
            assert plan.impl == "dense" and plan.format == "dense2bit"
            assert (plan.m, plan.phase) == (reng.gemm_plans[key].m,
                                            reng.gemm_plans[key].phase)


def _recording_rows(monkeypatch):
    calls = []
    for name, row in ops.paged_attention_registry().items():
        def fn(*a, _fn=row.fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setitem(ops._PAGED_ATTN, name,
                            dataclasses.replace(row, fn=fn))
    return calls


@pytest.mark.parametrize("cfg_impl,arg,want", [
    ("auto", None, "auto"), ("jax", None, "jax"), ("auto", "jax", "jax"),
    ("jax", "pallas", "pallas"), ("pallas", "auto", "auto")])
def test_engine_honours_paged_attn(one_layer, monkeypatch, cfg_impl, arg,
                                   want):
    """paged_attn=None inherits cfg.paged_attn_impl, a value overrides it
    for that engine (repro's rule, held on repro's own engine too); the
    decode steps dispatch that row ("auto" takes "jax" on the CPU), and
    every row serves the dense engine's streams."""
    rcfg, rparams, pcfg, pparams = one_layer
    rcfg = dataclasses.replace(rcfg, paged_attn_impl=cfg_impl)
    pcfg = dataclasses.replace(pcfg, paged_attn_impl=cfg_impl)
    reng = RScheduler(rcfg, max_slots=2, max_len=24, cache="paged",
                      page_size=4, paged_attn=arg)
    peng = ContinuousScheduler(pcfg, max_slots=2, max_len=24, device="cpu",
                               cache="paged", page_size=4, paged_attn=arg)
    assert peng.cfg.paged_attn_impl == reng.cfg.paged_attn_impl == want
    dense = ContinuousScheduler(pcfg, max_slots=2, max_len=24, device="cpu",
                                paged_attn=arg)
    assert dense.cfg.paged_attn_impl == cfg_impl
    prompts, gens, _ = serve.build_workload(pcfg, 3, 8, (3, 5), seed=2)
    calls = _recording_rows(monkeypatch)
    peng.load(pparams)
    pouts, _ = serve.run_continuous(peng, prompts, gens)
    assert set(calls) == {"jax" if want == "auto" else want}
    dense.load(pparams)
    douts, _ = serve.run_continuous(dense, prompts, gens)
    for p, d in zip(pouts, douts):
        np.testing.assert_array_equal(p, d)
