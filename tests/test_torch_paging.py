"""The port's paged KV cache held against ``repro``'s on the CPU: int8 page
quantization, prefix keys and the page pool's host bookkeeping bit for
bit; the plain paged decode attention against ``repro``'s ``_jax`` and
``_ref`` lowerings (never ``paged_decode_attention_pallas``, whose
interpret mode does not trace under the installed jax); whole paged serving
runs against the port's dense runs and ``repro``'s paged runs.

Tolerances, each with its reason:
* f32 attention: 2e-5, the bound ``repro`` states between its own ``_jax``
  and ``_ref`` lowerings (the same sums in another order);
* bf16 attention: equal to ``_jax``, which rounds p to bf16 before the PV
  product as the dense decode and the port do; within one bf16 ulp of the
  largest output against ``_ref``, which keeps p in f32. Rounding p moves
  every term of the PV sum by up to 2^-9 of itself, so the difference
  scales with the terms, not with an output that cancels;
* token streams: exact. Paged and dense decode run the same
  ``naive_attention`` lines; masked view positions add exact zeros.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.launch import serve as rserve
from repro.models import LM as RLM
from repro.paging import Int8Pages as RInt8Pages
from repro.paging import PagePool as RPagePool
from repro.paging import PrefixCache as RPrefixCache
from repro.paging import page_keys as rpage_keys
from repro.paging import quant as rquant
from repro.paging.kernels import paged_decode_attention_jax
from repro.paging.kernels import paged_decode_attention_ref as rpaged_ref
from repro.serving import ContinuousScheduler as RScheduler
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.models.attention import naive_attention
from repro_torch.paging import (Int8Pages, PagePool, PrefixCache, page_keys,
                                tree_nbytes)
from repro_torch.paging import quant
from repro_torch.paging import kernels as paged_lib
from repro_torch.paging.kernels import (gather_pages,
                                        paged_decode_attention_ref)
from repro_torch.serving import ContinuousScheduler
from test_torch_model import _packed_pair

F32_TOL = 2e-5
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


# ---------------------------------------------------------------------------
# int8 pages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_rows_bitwise_equal_to_repro(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 8, 2, 32)) * 3).astype(np.float32)
    x[0, 0, 1] = 0.0                        # an all-zero row: scale 1.0
    # scale 127/127 = 1 exactly, so these rows sit on exact halves
    x[1, 0, 0] = 0.0
    x[1, 0, 0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    codes, scales = quant.quantize_rows(torch.from_numpy(x).to(TDT[dtype]))
    rcodes, rscales = rquant.quantize_rows(jnp.asarray(x, JDT[dtype]))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rcodes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(rscales))
    assert scales[0, 0, 1] == 1.0 and not codes[0, 0, 1].any()
    # half to even, as jnp.round
    assert codes[1, 0, 0, :6].tolist() == [127, 0, 2, 2, 0, -2]
    for out in (torch.float32, torch.bfloat16):
        back = quant.dequantize_rows(codes, scales, out)
        rback = rquant.dequantize_rows(rcodes, rscales, jnp.dtype(
            str(out).split(".")[1]))
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(rback, np.float32))


def test_int8_pages_container_matches_repro():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 2, 16)).astype(np.float32)
    pages = Int8Pages.quantize(torch.from_numpy(x))
    rpages = RInt8Pages.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(pages.codes.numpy(),
                                  np.asarray(rpages.codes))
    np.testing.assert_array_equal(pages.dequantize().numpy(),
                                  np.asarray(rpages.dequantize()))
    assert pages.shape == tuple(rpages.shape) and pages.nbytes == rpages.nbytes
    zeros, rzeros = Int8Pages.zeros((3, 4, 2, 16)), RInt8Pages.zeros(
        (3, 4, 2, 16))
    np.testing.assert_array_equal(zeros.scales.numpy(),
                                  np.asarray(rzeros.scales))
    assert tree_nbytes({"k": [pages], "v": torch.zeros(4)}) == \
        pages.nbytes + 16


# ---------------------------------------------------------------------------
# Prefix keys and the prefix registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page_size", [1, 4, 8])
def test_page_keys_are_repros_bytes(page_size):
    rng = np.random.default_rng(page_size)
    for n in (1, 7, 8, 9, 20):
        prompt = rng.integers(0, 1000, size=n).astype(np.int32)
        assert page_keys(prompt, page_size) == rpage_keys(prompt, page_size)


def test_prefix_cache_matches_repro_call_for_call():
    rng = np.random.default_rng(2)
    head = rng.integers(0, 50, size=16).astype(np.int32)
    prompts = [np.concatenate([head[:n], rng.integers(0, 50, size=m)])
               .astype(np.int32) for n, m in ((16, 4), (8, 4), (16, 0),
                                               (12, 9), (0, 11))]
    ours, ref = PrefixCache(4), RPrefixCache(4)
    pid = 1
    for step in range(3):
        for p in prompts:
            got, want = ours.lookup(p), ref.lookup(p)
            assert got == want
            assert ours.probe(p) == ref.probe(p)
            keys, matched = got
            for key in keys[len(matched):]:
                ours.register(key, pid)
                ref.register(key, pid)
                pid += 1
        for victim in (3 * step + 2, 3 * step + 5):
            ours.unregister_page(victim)
            ref.unregister_page(victim)
        assert (ours.lookups, ours.hits, ours.hit_rate, len(ours)) == \
            (ref.lookups, ref.hits, ref.hit_rate, len(ref))
        assert [ours.holds(i) for i in range(pid)] == \
            [ref.holds(i) for i in range(pid)]


# ---------------------------------------------------------------------------
# PagePool: the host ownership model, call for call
# ---------------------------------------------------------------------------

def _pool_state(pool) -> dict:
    return {"table": np.asarray(pool.table).tolist(),
            "refcount": np.asarray(pool._refcount).tolist(),
            "free_pages": [int(p) for p in pool._free_pages],
            "free_slots": list(pool._free_slots),
            "reclaimable": list(pool._reclaimable),
            "slot_pages": {s: [int(p) for p in ps]
                           for s, ps in pool.slot_pages.items()},
            "cow_count": pool.cow_count,
            "pages_used_peak": pool.pages_used_peak,
            "stats": pool.stats()}


class _Lockstep:
    """The port's PagePool and repro's, driven by the same calls; the
    results and the whole host state are compared after every call."""

    def __init__(self, **kw):
        cfg = get_config("ternary-paper", reduced=True, num_layers=1)
        rcfg = rget_config("ternary-paper", reduced=True, num_layers=1)
        self.ours = PagePool(LM(cfg, "cpu"), **kw)
        self.ref = RPagePool(RLM(rcfg), **kw)
        self.check()

    def check(self):
        assert _pool_state(self.ours) == _pool_state(self.ref)

    def __call__(self, name, *args):
        got = getattr(self.ours, name)(*args)
        want = getattr(self.ref, name)(*args)
        if name == "admit":
            got = got and (got.slot, got.page_ids, got.n_shared)
            want = want and (want.slot, want.page_ids, want.n_shared)
        assert got == want, (name, args, got, want)
        self.check()
        return got


def test_page_pool_scripted_trajectory_matches_repro():
    """The cases of repro's own PagePool tests: sharing, growth,
    copy-on-write, rollback on OOM and reclamation of cold prefix pages."""
    run = _Lockstep(max_slots=3, max_len=32, page_size=8, n_pages=6)
    prompt = np.arange(12, dtype=np.int32)          # 1 full + 1 partial page
    a = run("admit", prompt)[0]
    assert run("ensure_append", a, 12)              # sole owner: in place
    b = run("admit", prompt)[0]                     # shares both pages
    assert run("ensure_append", b, 12)              # shared tail: COW
    assert run.ours.cow_count == 1
    assert run("ensure_append", a, 16)              # crosses into a new page
    # 3 pages needed, 1 free: all-or-nothing failure, rolled back
    assert run("admit", np.arange(100, 124, dtype=np.int32)) is None
    run("release", a)
    run("release", b)
    # pinned-but-cold prefix pages are reclaimed under pressure
    free_before = run.ours.n_free_pages
    c = run("admit", np.arange(200, 232, dtype=np.int32))[0]
    assert free_before < 4 == len(run.ours.slot_pages[c])
    assert run.ours.n_free_pages == 0
    run("release", c)
    assert run.ours.all_reclaimed


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_random_trajectory_matches_repro(seed, prefix_cache):
    """A seeded stream of admit / ensure_append / release over a small
    pool (prompts drawn from one shared head, identical pairs among them):
    every return value and the whole host state stay equal."""
    rng = np.random.default_rng(seed)
    max_len = 32
    run = _Lockstep(max_slots=3, max_len=max_len, page_size=4, n_pages=10,
                    prefix_cache=prefix_cache)
    head = rng.integers(0, 30, size=16)
    prompts = [np.concatenate([head[:int(rng.integers(0, 17))],
                               rng.integers(0, 30, size=int(rng.integers(
                                   1, 8)))]).astype(np.int32)
               for _ in range(5)]
    prompts += prompts[:2]                          # identical pairs
    next_pos = {}                                   # live slot -> position
    dry = refused = 0
    for _ in range(120):
        op = rng.choice(["admit", "append", "append", "append", "release"])
        live = sorted(next_pos)
        if op == "admit" or not live:
            prompt = prompts[int(rng.integers(len(prompts)))]
            adm = run("admit", prompt)
            if adm is None:
                refused += 1
            else:
                next_pos[adm[0]] = prompt.size
            continue
        slot = live[int(rng.integers(len(live)))]
        if op == "append" and next_pos[slot] < max_len:
            if run("ensure_append", slot, next_pos[slot]):
                next_pos[slot] += 1
            else:
                dry += 1
        elif op == "release":
            run("release", slot)
            del next_pos[slot]
    assert run.ours.pages_used_peak == run.ours.usable_pages
    assert dry + refused + run.ours.cow_count > 0


def test_page_pool_rejects_what_repro_rejects():
    cfg = get_config("ternary-paper", reduced=True, num_layers=1)
    with pytest.raises(ValueError, match="bshd"):
        PagePool(LM(dataclasses.replace(cfg, cache_layout="opt"), "cpu"), 2,
                 16)
    with pytest.raises(ValueError, match="sliding-window"):
        PagePool(LM(dataclasses.replace(cfg, sliding_window=8), "cpu"), 2, 16)
    with pytest.raises(ValueError, match="cannot hold"):
        PagePool(LM(cfg, "cpu"), 2, 32, page_size=8, n_pages=4)


# ---------------------------------------------------------------------------
# Paged decode attention: the plain version against repro's lowerings
# ---------------------------------------------------------------------------

def _attention_inputs(seed, heads, kv_heads, page_size, kv_dtype):
    """Inputs for both packages: random pages, a table whose entries past
    each row's length are garbage page ids, ragged lengths."""
    rng = np.random.default_rng(seed)
    b, p, t, hd = 3, 10, 4, 16
    q = rng.standard_normal((b, heads, hd)).astype(np.float32)
    kp = rng.standard_normal((p, page_size, kv_heads, hd)).astype(np.float32)
    vp = rng.standard_normal((p, page_size, kv_heads, hd)).astype(np.float32)
    table = rng.integers(0, p, size=(b, t)).astype(np.int32)
    # one token, a ragged length past a page boundary, the full width
    lengths = np.array([1, int(rng.integers(page_size, t * page_size)),
                        t * page_size], np.int32)
    dt = "bf16" if kv_dtype == "bf16" else "f32"
    ours = [torch.from_numpy(q).to(TDT[dt])]
    ref = [jnp.asarray(q, JDT[dt])]
    for pages in (kp, vp):
        if kv_dtype == "int8":
            ours.append(Int8Pages.quantize(torch.from_numpy(pages)))
            ref.append(RInt8Pages.quantize(jnp.asarray(pages)))
        else:
            ours.append(torch.from_numpy(pages).to(TDT[dt]))
            ref.append(jnp.asarray(pages, JDT[dt]))
    ours += [torch.from_numpy(table), torch.from_numpy(lengths)]
    ref += [jnp.asarray(table), jnp.asarray(lengths)]
    return ours, ref


@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (4, 4)])
@pytest.mark.parametrize("page_size", [4, 8])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_paged_attention_plain_matches_repro(heads, kv_heads, page_size,
                                             window, kv_dtype):
    ours, ref = _attention_inputs(7 * page_size + window, heads, kv_heads,
                                  page_size, kv_dtype)
    got = paged_decode_attention_ref(*ours, window=window).float().numpy()
    via_ops = ops.paged_decode_attention(*ours, window=window)
    np.testing.assert_array_equal(via_ops.float().numpy(), got)
    want_jax = np.asarray(paged_decode_attention_jax(*ref, window=window),
                          np.float32)
    want_ref = np.asarray(rpaged_ref(*ref, window=window), np.float32)
    assert got.shape == want_jax.shape
    if kv_dtype == "bf16":
        np.testing.assert_array_equal(got, want_jax)
        assert (np.abs(got - want_ref)
                <= _bf16_ulp(np.abs(want_ref).max())).all()
    else:
        np.testing.assert_allclose(got, want_jax, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(got, want_ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_plain_is_naive_attention_on_the_gathered_view(kv_dtype):
    """The paged plain version is the dense decode's math over the gathered
    view, bit for bit: what makes paged serving equal dense serving."""
    (q, kp, vp, table, lengths), _ = _attention_inputs(
        3, 4, 2, 8, kv_dtype)
    q = q.to(torch.bfloat16)
    out = paged_decode_attention_ref(q, kp, vp, table, lengths)
    ks = gather_pages(kp, table, q.dtype)
    vs = gather_pages(vp, table, q.dtype)
    ref = naive_attention(q[:, None], ks, vs, causal=False,
                          q_offset=lengths - 1, kv_valid_len=lengths)[:, 0]
    assert torch.equal(out, ref)


# (table width, page size, window) -> (splits, tokens, chunk, buffers): the
# serving shape (13 pages of 16), the long rows (64 pages), a window, one
# page, a table past the cluster size
@pytest.mark.parametrize("geom,plan", [
    ((13, 16, 0), (4, 52, 52, 2)), ((64, 16, 0), (4, 256, 64, 4)),
    ((64, 16, 300), (4, 76, 64, 4)), ((1, 4, 0), (1, 4, 4, 2)),
    ((13, 16, 5), (1, 8, 8, 2)), ((512, 16, 0), (4, 2048, 64, 4))])
def test_split_plan_comes_from_table_page_and_window(geom, plan):
    """B5's split of every row: from the most tokens a row can attend
    alone, so it cannot change with the batch or the lengths (the
    wrapper's launch takes nothing else), and it covers that span."""
    got = paged_lib.split_plan(*geom)
    assert (got.splits, got.tokens, got.chunk, got.buffers) == plan
    t, ps, window = geom
    span = min(t * ps, window) if window else t * ps
    assert got.splits * got.tokens >= span
    assert got.tokens % 4 == 0 and got.chunk % 4 == 0
    assert paged_lib.launch_plan(16, 16, 64, t, ps, window=window) == got
    assert paged_lib.launch_plan(16, 4, 64, t, ps, window=window,
                                 quant=True) == got


@pytest.mark.parametrize("bad,match", [
    (dict(heads=6, kv_heads=4), "kv heads"),
    (dict(head_dim=40, quant=True), "multiple of 16 with int8"),
    (dict(head_dim=8, quant=True), "multiple of 16 with int8"),
    (dict(head_dim=12), "multiple of 8 with bf16"),
    (dict(head_dim=0), "multiple of 8 with bf16"),
    (dict(window=-1), "window")])
def test_launch_plan_refuses_what_the_kernel_does_not_take(bad, match):
    args = {**dict(heads=16, kv_heads=16, head_dim=64, table_width=13,
                   page_size=16, window=0, quant=False), **bad}
    with pytest.raises(ValueError, match=match):
        paged_lib.launch_plan(**args)


@pytest.mark.parametrize("head_dim,quant", [(8, False), (40, False),
                                            (16, True), (48, True)])
def test_launch_plan_takes_rows_of_whole_16_byte_pieces(head_dim, quant):
    """A row of hd bf16 values or hd int8 codes that splits into 16-byte
    copies is taken, with the same split as any other head width."""
    assert (paged_lib.launch_plan(4, 2, head_dim, 13, 16, quant=quant)
            == paged_lib.split_plan(13, 16))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cpu_tensors_take_the_plain_version(kv_dtype):
    """The kernel's wrapper refuses CPU tensors; the registry gives them
    the plain version, bit for bit."""
    ours, _ = _attention_inputs(5, 4, 2, 8, kv_dtype)
    with pytest.raises(ValueError, match="CUDA"):
        paged_lib.paged_decode_attention_cuda(*ours)
    assert torch.equal(ops.paged_decode_attention(*ours, window=3),
                       paged_decode_attention_ref(*ours, window=3))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_plain_rows_do_not_depend_on_the_batch(kv_dtype):
    """The plain version, which the kernel is held against, gives a row
    the same bits alone or in a batch, as the kernel must."""
    (q, kp, vp, table, lengths), _ = _attention_inputs(9, 4, 2, 8, kv_dtype)
    q = q.to(torch.bfloat16)
    full = paged_decode_attention_ref(q, kp, vp, table, lengths)
    for rows in ([1], [2, 0]):
        idx = torch.tensor(rows)
        part = paged_decode_attention_ref(q[idx], kp, vp, table[idx],
                                          lengths[idx])
        assert torch.equal(part, full[idx])


# ---------------------------------------------------------------------------
# Engine scenarios (repro's tests/test_paging.py), on the port
# ---------------------------------------------------------------------------

def _workload(n, prompt_len, seed, lens):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, 512, size=(n, prompt_len)).astype(np.int32)
    gens = [int(g) for g in rng.integers(lens[0], lens[1], size=n)]
    return prompts, gens


def _shared_prefix_workload():
    """20-token prompts on 8-token pages: 2 full pages shared by everyone
    plus a partial tail page shared within each identical pair, so the
    first decode append into a shared tail copies on write."""
    rng = np.random.default_rng(5)
    common = rng.integers(0, 512, size=16).astype(np.int32)
    tails = [rng.integers(0, 512, size=4).astype(np.int32) for _ in range(2)]
    prompts = np.stack([np.concatenate([common, tails[i // 2]])
                        for i in range(4)])
    return prompts, [6, 4, 5, 3]


SCENARIOS = {
    # more requests than slots and a pool near the working set: pages are
    # evicted and reused across requests
    "churn": (lambda: _workload(8, 12, 3, (2, 12)),
              dict(max_slots=3, max_len=32), dict(page_size=8, n_pages=13)),
    "prefix_cow": (_shared_prefix_workload,
                   dict(max_slots=2, max_len=40), dict(page_size=8)),
    # a pool far below the working set: admissions defer, decode preempts
    "oom": (lambda: _workload(8, 12, 2, (6, 21)),
            dict(max_slots=4, max_len=36), dict(page_size=8, n_pages=9)),
}
CACHE_KEYS = ("pages_used_peak", "cow_copies", "deferrals", "preemptions")


def _run(cls, cfg, params, prompts, gens, **kw):
    eng = cls(cfg, **kw)
    eng.load(params)
    reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    metrics = eng.run()
    return [list(r.tokens) for r in reqs], metrics, eng


def _cache_numbers(metrics):
    c = metrics["cache"]
    return {k: c[k] for k in CACHE_KEYS} | {"hits": c["prefix"]["hits"]}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("mode", ["float32", "float32-int8", "bfloat16",
                                  "bfloat16-int8"])
def test_paged_engine_scenarios(scenario, mode):
    """float32: port paged == port dense == repro paged (``paged_attn=
    "jax"``, same weights) and the cache metrics equal repro's. int8 pages
    change the attended values, so their streams are held against repro's
    int8 run (float32) rather than the dense run. bf16 pages: port paged ==
    port dense (bf16 rounds at other places in the two frameworks, so no
    stream comparison with repro there)."""
    make, kw, paged_kw = SCENARIOS[scenario]
    prompts, gens = make()
    dtype, _, kv = mode.partition("-")
    kv = kv or None
    rcfg, rparams, pcfg, pparams = _packed_pair(dtype, num_layers=2)
    paged, mp, eng = _run(ContinuousScheduler, pcfg, pparams, prompts, gens,
                          device="cpu", cache="paged", kv_dtype=kv, **kw,
                          **paged_kw)
    assert mp["drained"] == len(gens)
    assert [len(t) for t in paged] == gens
    assert eng.pool.all_reclaimed
    if kv is None:
        dense, md, _ = _run(ContinuousScheduler, pcfg, pparams, prompts, gens,
                            device="cpu", **kw)
        for i, (a, b) in enumerate(zip(dense, paged)):
            assert a == b, f"request {i} diverged under paging"
        assert md["cache"]["mode"] == "dense"
    if dtype == "float32":
        rpaged, rm, _ = _run(RScheduler, rcfg, rparams, prompts, gens,
                             cache="paged", paged_attn="jax", kv_dtype=kv,
                             **kw, **paged_kw)
        assert paged == rpaged
        assert _cache_numbers(mp) == _cache_numbers(rm)
        assert set(mp["cache"]) == set(rm["cache"])
    if scenario == "churn":
        needed = sum(-(-(p.size + g) // 8) for p, g in zip(prompts, gens))
        assert needed > mp["cache"]["pages_total"]
    elif scenario == "prefix_cow":
        assert mp["cache"]["prefix"]["hits"] > 0
        assert mp["cache"]["cow_copies"] > 0
    else:
        assert mp["cache"]["deferrals"] > 0 and mp["cache"]["preemptions"] > 0


INT8_STEP_TOL = 2e-2


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_one_decode_step_paged_vs_dense(kv_dtype):
    """Prefill the same prompts into the dense cache and into a paged
    pool, then one decode step in each (the check chip_smoke.py runs on the
    card): bf16 pages give the dense logits bit for bit; int8 pages stay
    within INT8_STEP_TOL of max|logit| (1.2-1.5% measured here and at full
    width), the CPU share of chip_smoke.py's int8 bound."""
    cfg = get_config("ternary-paper", reduced=True, num_layers=4,
                     ternary_min_dim=64)
    cfg, params = serve.build_params(cfg, 0, "cpu", packed=True)
    prompts, _, _ = serve.build_workload(cfg, 8, 30, (4,), seed=0)
    model, ps, max_len = LM(cfg, "cpu"), 8, 64
    b, s = prompts.shape
    toks = torch.from_numpy(prompts)
    pos = torch.full((b,), s, dtype=torch.int32)
    with torch.no_grad():
        cache, logits = model.prefill(params, {"tokens": toks}, max_len)
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        dense, _ = model.decode_step(
            params, {"layers": cache["layers"], "pos": pos}, nxt)
        pool = PagePool(model, b, max_len, page_size=ps, kv_dtype=kv_dtype)
        adms = [pool.admit(p) for p in prompts]
        pcache, _ = model.prefill(params, {"tokens": toks},
                                  -(-s // ps) * ps)
        pool.insert(adms, pcache["layers"])
        assert all(pool.ensure_append(a.slot, s) for a in adms)
        paged, _ = model.decode_step(
            params, {"layers": pool.layers, "pos": pos,
                     "block_table": torch.tensor(pool.table)}, nxt)
    if kv_dtype is None:
        assert torch.equal(paged, dense)
    else:
        rel = float((paged - dense).abs().max() / dense.abs().max())
        assert 0 < rel <= INT8_STEP_TOL


def test_int8_pages_shrink_the_cache():
    _, _, pcfg, pparams = _packed_pair("bfloat16", num_layers=2)
    prompts, gens = _workload(5, 16, 1, (2, 6))
    kw = dict(device="cpu", cache="paged", max_slots=2, max_len=24,
              page_size=8)
    _, m16, _ = _run(ContinuousScheduler, pcfg, pparams, prompts, gens, **kw)
    _, m8, _ = _run(ContinuousScheduler, pcfg, pparams, prompts, gens,
                    kv_dtype="int8", **kw)
    assert m8["cache"]["kv_dtype"] == "int8"
    assert m8["cache"]["nbytes"] < m16["cache"]["nbytes"]


# ---------------------------------------------------------------------------
# The serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_paged_int8(capsys):
    common = ["--reduced", "--requests", "6", "--slots", "2",
              "--prompt-len", "8", "--gen-lens", "2,9", "--cache", "paged",
              "--page-size", "8", "--kv-dtype", "int8", "--pages", "4"]
    m = serve.main(["--device", "cpu", "--packed", "--ternary-min-dim", "64",
                    *common])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["drained"] == m["drained"] == 6
    rm = rserve.main(["--arch", "ternary-paper", *common])
    cache, rcache = m["cache"], rm["cache"]
    assert set(cache) == set(rcache)
    assert set(cache["prefix"]) == set(rcache["prefix"])
    assert cache["mode"] == "paged" and cache["kv_dtype"] == "int8"
    assert cache["pages_total"] == 3 and cache["page_size"] == 8
