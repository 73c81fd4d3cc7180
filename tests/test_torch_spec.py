"""Speculative decoding on the CPU: the port's ``repro_torch.spec`` and the
engine's spec round against ``repro``'s, on reduced configs.

* ``longest_prefix_match`` equals ``repro``'s on seeded windows;
  ``resparsify`` packs and scales are bitwise ``repro``'s; the draft
  builders behave as ``repro``'s ``test_draft_builders`` pins.
* A verify window equals k+1 one-token steps bit for bit (logits and
  cache bytes), dense and paged with bf16 and int8 pages, as ``repro``'s
  ``tests/test_spec.py`` holds its own; the NaN mask touches only its
  rows.
* ``PagePool.truncate`` under prefix sharing and copy on write leaves the
  table, refcounts and free list of ``repro``'s pool, call for call.
* The spec engine's streams equal the non-spec engine's, for k 1, 2 and
  4, dense, paged bf16 and int8, chunked and under preemption; and equal
  ``repro``'s spec engine's on the same converted weights (float32), with
  the same rounds, proposals, acceptances, emitted tokens and page
  reclaims.
* Unsupported configs are refused as ``repro`` refuses them; ``serve
  --spec layer_skip --device cpu`` gives ``repro``'s metrics keys.

All comparisons are exact: tokens, counts and bits, no tolerance.
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
from repro.serving import ContinuousScheduler as RScheduler
from repro.serving import SchedConfig as RSchedConfig
from repro.spec import SpecConfig as RSpecConfig
from repro.spec import longest_prefix_match as r_lpm
from repro.spec import resparsify as r_resparsify
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import weights
from repro_torch.kernels import graphs
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.paging import Int8Pages, PagePool
from repro_torch.serving import ContinuousScheduler, SchedConfig
from repro_torch.spec import (SpecConfig, build_draft, external, layer_skip,
                              longest_prefix_match, make_verify_step,
                              resparsify)

from test_torch_decode_graph import _buffers
from test_torch_model import _packed_pair, repro_tree_to_numpy
from test_torch_paging import _Lockstep
from torch_cpu_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    """repro's packed 2-layer float32 model and the port's copy of it."""
    return _packed_pair("float32", num_layers=2)


@pytest.fixture(scope="module")
def bf16_model():
    """The port's packed 4-layer bf16 model (its own init)."""
    cfg = get_config("ternary-paper", reduced=True, num_layers=4,
                     ternary_min_dim=64)
    return serve.build_params(cfg, 0, "cpu", packed=True)


# ---------------------------------------------------------------------------
# Acceptance and drafts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_longest_prefix_match_equals_repro(seed):
    """Windows whose drafts match the greedy tokens with probability 3/4
    at every position (so every accepted count occurs), and repro's
    hand-written case."""
    rng = np.random.default_rng(seed)
    b, k = 16, 4
    greedy = rng.integers(0, 5, size=(b, k + 1)).astype(np.int32)
    window = np.where(rng.random((b, k + 1)) < 0.75,
                      np.roll(greedy, 1, axis=1),
                      rng.integers(0, 5, size=(b, k + 1))).astype(np.int32)
    cases = [(window, greedy),
             (np.array([[5, 1, 2, 3], [5, 1, 9, 3], [5, 9, 9, 9],
                        [5, 1, 2, 3]], np.int32),
              np.array([[1, 2, 3, 4], [1, 7, 8, 9], [7, 8, 9, 1],
                        [1, 2, 9, 6]], np.int32))]
    counts = []
    for w, g in cases:
        n_acc, bonus = longest_prefix_match(torch.from_numpy(w),
                                            torch.from_numpy(g))
        rn, rb = r_lpm(jnp.asarray(w), jnp.asarray(g))
        assert n_acc.dtype == bonus.dtype == torch.int32
        np.testing.assert_array_equal(n_acc.numpy(), np.asarray(rn))
        np.testing.assert_array_equal(bonus.numpy(), np.asarray(rb))
        counts.append(set(n_acc.tolist()))
    assert len(counts[0]) >= 3 and counts[1] == {0, 1, 2, 3}


@pytest.mark.parametrize("sparsity", [0.125, 0.5])
def test_resparsify_packs_bitwise_equal_to_repro(pair, sparsity):
    """Every re-packed container of the port's draft holds repro's words,
    scales and bias bit for bit; every other leaf is the target's own."""
    rcfg, rparams, pcfg, pparams = pair
    rdraft = r_resparsify(RLM(rcfg), rparams, sparsity)
    ours = resparsify(LM(pcfg, "cpu"), pparams, sparsity)
    theirs = params_from_numpy(repro_tree_to_numpy(rdraft.params), pcfg,
                               "cpu")
    assert ours.name == rdraft.name
    n = 0

    def walk(a, b, t):
        nonlocal n
        if isinstance(a, weights.TernaryWeight):
            n += 1
            assert a.shape == b.shape and a.format_name == b.format_name
            for f in ("packed", "scale", "bias"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None)
                if x is not None:
                    assert torch.equal(x, y), f
            assert a.bias is t.bias
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for key in a:
                walk(a[key], b[key], t[key])
        elif isinstance(a, list):
            for x, y, z in zip(a, b, t):
                walk(x, y, z)
        else:
            assert a is t                 # shared, not copied
    walk(ours.params, theirs, pparams)
    assert n == 4 * 2 + 3 * 2 + 1          # q/k/v/o, the MLP, the lm head
    for layer in ours.params["layers"]:
        w = layer["mixer"]["q"]["w_packed"]
        assert w.occupancy() <= sparsity + 0.02, w.occupancy()


def test_draft_builders(bf16_model):
    """repro's test_draft_builders on the port, and an external draft."""
    cfg, params = bf16_model
    model = LM(cfg, "cpu")
    d = layer_skip(model, params, 2)
    assert d.model.cfg.num_layers == 2 and d.name == "layer_skip(2/4)"
    # the draft's layers are the target's tensors, not copies
    assert d.params["layers"][1] is params["layers"][1]
    assert len(d.params["layers"]) == 2
    assert d.params["embed"]["table"] is params["embed"]["table"]
    with pytest.raises(ValueError):
        layer_skip(model, params, 4)         # must be a strict prefix
    unpacked = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="TernaryWeight"):
        resparsify(model, unpacked, 0.25)
    with pytest.raises(ValueError, match="not in"):
        resparsify(model, params, 0.0)
    d2 = build_draft(SpecConfig(draft="layer_skip", k=2), model, params)
    assert d2.model.cfg.num_layers == 2      # default: half the stack
    with pytest.raises(ValueError, match="draft_cfg"):
        build_draft(SpecConfig(draft="external", k=2), model, params)
    with pytest.raises(ValueError, match="unknown draft"):
        build_draft(SpecConfig(draft="nope", k=2), model, params)
    small = dataclasses.replace(cfg, num_layers=1, name="small")
    d3 = build_draft(SpecConfig(draft="external", draft_cfg=small, k=2),
                     model, params)
    assert d3.name == "external(small)" and len(d3.params["layers"]) == 1
    assert build_draft(SpecConfig(draft=d, k=2), model, params) is d
    assert external(small, device="cpu").model.device.type == "cpu"


def test_external_draft_engine_token_exact(bf16_model):
    """A spec engine whose draft is an independent 1-layer model (its own
    random weights): its tokens are the non-spec engine's."""
    cfg, params = bf16_model
    small = dataclasses.replace(cfg, num_layers=1, name="small")
    prompts, gens = _workload(cfg, 4)
    base, _, _ = _run(cfg, params, prompts, gens, 40)
    outs, m, _ = _run(cfg, params, prompts, gens, 40,
                      spec=SpecConfig(draft="external", draft_cfg=small,
                                      k=2))
    assert [list(a) for a in outs] == [list(b) for b in base]
    assert m["spec"]["draft"] == "external(small)"


# ---------------------------------------------------------------------------
# The verify window against one-token steps
# ---------------------------------------------------------------------------

def _clone_layers(layers):
    def c(t):
        if isinstance(t, Int8Pages):
            return Int8Pages(t.codes.clone(), t.scales.clone())
        return t.clone()
    return [{k: c(v) for k, v in layer.items()} for layer in layers]


def _layer_tensors(layers):
    for layer in layers:
        for t in layer.values():
            if isinstance(t, Int8Pages):
                yield t.codes
                yield t.scales
            else:
                yield t


@pytest.mark.parametrize("mode", ["dense", "paged", "paged-int8"])
def test_verify_window_bitwise_equal_to_one_token_steps(bf16_model, mode):
    """Two slots at positions 12 and 9, a k 3 window: the verify step's
    logits and cache bytes are those of 4 one-token steps bit for bit,
    its packed output holds their argmax, the accepted counts and an
    all-true guard; a NaN mask on slot 1 leaves slot 0 bitwise alone and
    fails slot 1's guard alone."""
    cfg, params = bf16_model
    model = LM(cfg, "cpu")
    k, max_len, ps = 3, 24, 4
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    pos = torch.tensor([12, 9], dtype=torch.int32)
    table = None
    with torch.no_grad():
        if mode == "dense":
            cache, logits = model.prefill(
                params, {"tokens": torch.from_numpy(prompts)}, max_len)
            layers = cache["layers"]
        else:
            pool = PagePool(model, 2, max_len, page_size=ps,
                            kv_dtype="int8" if mode == "paged-int8" else None)
            adms = [pool.admit(p) for p in prompts]
            cache, logits = model.prefill(
                params, {"tokens": torch.from_numpy(prompts)}, 12)
            pool.insert(adms, cache["layers"])
            for a, p0 in zip(adms, pos.tolist()):
                for j in range(k + 1):
                    assert pool.ensure_append(a.slot, p0 + j)
            layers, table = pool.layers, torch.from_numpy(pool.table)
    first = logits[:, -1].argmax(-1).to(torch.int32)
    window = torch.cat([first[:, None], torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(2, k)).astype(np.int32))], dim=1)
    window[0, 1] = 7                       # some drafts the greedy may hit

    verify = make_verify_step(model, max_len, k)
    win_layers = _clone_layers(layers)
    out, win_logits = verify(params, win_layers, pos, window, table)
    seq_layers = _clone_layers(layers)
    seq = []
    with torch.no_grad():
        for j in range(k + 1):
            c = {"layers": seq_layers, "pos": pos + j}
            if table is not None:
                c["block_table"] = table
            lg, _ = model.decode_step(params, c, window[:, j:j + 1])
            seq.append(lg)
    assert torch.equal(win_logits, torch.cat(seq, dim=1))
    for a, b in zip(_layer_tensors(win_layers), _layer_tensors(seq_layers)):
        assert torch.equal(a, b)
    greedy = win_logits.argmax(-1).to(torch.int32)
    n_acc, _ = longest_prefix_match(window, greedy)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, k + 3)
    assert torch.equal(out[:, :k + 1], greedy)
    assert torch.equal(out[:, k + 1], n_acc)
    assert out[:, k + 2].tolist() == [1, 1]

    mask = torch.tensor([False, True])
    out2, lg2 = verify(params, _clone_layers(layers), pos, window, table,
                       mask)
    assert torch.equal(lg2[0], win_logits[0]) and out2[:, k + 2].tolist() \
        == [1, 0]
    assert not bool(torch.isfinite(lg2[1]).any())


# ---------------------------------------------------------------------------
# Paged rollback
# ---------------------------------------------------------------------------

def test_truncate_matches_repro_under_sharing():
    """repro's test_paged_rollback_leak_free_under_sharing, driven through
    both pools in lockstep (the whole host state compared after every
    call): a slot grows through a copy on write and fresh pages, truncates
    back, and the pools release to the same state."""
    run = _Lockstep(max_slots=3, max_len=32, page_size=4, n_pages=24)
    prefix = np.random.default_rng(0).integers(0, 512, size=10).astype(
        np.int32)
    a = run("admit", prefix)[0]
    b = run("admit", prefix)[0]
    assert run.ours.slot_pages[b] == run.ours.slot_pages[a]
    free0 = run.ours.n_free_pages
    for p in range(6):
        assert run("ensure_append", b, 10 + p)
    assert run.ours.cow_count == 1
    grown = len(run.ours.slot_pages[b])
    consumed = free0 - run.ours.n_free_pages
    assert consumed == 1 + (grown - 3)
    assert run("truncate", b, 12) == grown - 3
    assert len(run.ours.slot_pages[b]) == 3
    assert (run.ours.table[b, 3:] == 0).all()
    assert run("truncate", b, 12) == 0
    assert run("truncate", b, 1) == 2      # down to one page
    for pid in run.ours.slot_pages[a]:
        assert run.ours._refcount[pid] >= 1
    run("release", a)
    run("release", b)
    c = run("admit", prefix)[0]
    run("release", c)
    assert run.ours.all_reclaimed
    with pytest.raises(ValueError):
        run.ours.truncate(c, 4)              # not live


# ---------------------------------------------------------------------------
# The spec engine
# ---------------------------------------------------------------------------

def _workload(cfg, n, prompt_len=12, seed=0, lens=(1, 10)):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(n, prompt_len)).astype(np.int32)
    gens = [int(g) for g in rng.integers(lens[0], lens[1], size=n)]
    return prompts, gens


def _run(cfg, params, prompts, gens, max_len, slots=2, **kw):
    eng = ContinuousScheduler(cfg, max_slots=slots, max_len=max_len,
                              device="cpu", **kw)
    eng.load(params)
    outs, metrics = serve.run_continuous(eng, prompts, gens)
    return outs, metrics, eng


MODES = {"dense": {}, "paged": dict(cache="paged", page_size=4),
         "paged-int8": dict(cache="paged", page_size=4, kv_dtype="int8"),
         "chunked": dict(sched=SchedConfig(chunk_tokens=4,
                                           admission="fifo"))}


@pytest.fixture(scope="module")
def non_spec_streams(bf16_model):
    """The non-spec engine's streams of the 6-request workload per mode,
    run once and shared by every k."""
    cfg, params = bf16_model
    prompts, gens = _workload(cfg, 6)
    done = {}

    def streams(mode):
        if mode not in done:
            done[mode] = _run(cfg, params, prompts, gens, 40,
                              **MODES[mode])[0]
        return done[mode]
    return streams


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_engine_token_exact(bf16_model, non_spec_streams, mode, k):
    """6 mixed-budget requests through 2 slots: the spec engine's streams
    are the non-spec engine's; the spec block's counts are consistent
    and the pools drain clean."""
    cfg, params = bf16_model
    prompts, gens = _workload(cfg, 6)
    kw = MODES[mode]
    base = non_spec_streams(mode)
    outs, m, eng = _run(cfg, params, prompts, gens, 40,
                        spec=SpecConfig(draft="layer_skip", k=k,
                                        draft_layers=2), **kw)
    for i, (a, b) in enumerate(zip(base, outs)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}, k={k}")
    s = m["spec"]
    assert s["rounds"] == m["decode_steps"] > 0
    assert s["draft_tokens_proposed"] % k == 0
    assert s["draft_tokens_accepted"] <= s["draft_tokens_proposed"]
    assert 1.0 <= s["mean_accepted_len"] <= k + 1
    assert sum(r["proposed"] for r in s["per_request"]) == \
        s["draft_tokens_proposed"]
    json.dumps(m)
    if mode.startswith("paged"):
        assert eng.pool.all_reclaimed
        assert s["rollback_page_reclaims"] > 0 or k == 1
    else:
        assert eng.pool.all_free
    if mode == "chunked":
        assert m["sched"]["step_token_budget"] == 2 * (1 + k) + 4
        assert m["sched"]["chunk_tokens_committed"] == prompts.size


def test_spec_engine_token_exact_under_preemption(bf16_model):
    """A page pool too small for both live requests: preempt-and-replay
    mid-decode (and rollback beside it) keeps the streams exact."""
    cfg, params = bf16_model
    prompts, gens = _workload(cfg, 4, prompt_len=8, lens=(8, 14))
    kw = dict(cache="paged", page_size=4, n_pages=9, prefix_cache=False)
    base, _, _ = _run(cfg, params, prompts, gens, 28, **kw)
    outs, m, eng = _run(cfg, params, prompts, gens, 28,
                        spec=SpecConfig(draft="layer_skip", k=2,
                                        draft_layers=1), **kw)
    assert m["cache"]["preemptions"] + m["cache"]["deferrals"] > 0
    for i, (a, b) in enumerate(zip(base, outs)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    assert eng.pool.all_reclaimed


SPEC_KEYS = ("rounds", "draft_tokens_proposed", "draft_tokens_accepted",
             "acceptance_rate", "mean_accepted_len",
             "rollback_page_reclaims", "per_request", "draft", "k",
             "disabled", "draft_fallbacks")


@pytest.mark.parametrize("mode,draft", [("dense", "layer_skip"),
                                        ("dense", "resparsify"),
                                        ("paged", "layer_skip"),
                                        ("chunked", "layer_skip")])
def test_spec_engine_matches_repro(pair, mode, draft):
    """The port's spec engine and repro's on the same float32 weights: the
    same streams, spec block (rounds, proposals, acceptances, emitted per
    slot-round, page reclaims, per request) and cache metrics. The paged
    pool is small enough to preempt."""
    rcfg, rparams, pcfg, pparams = pair
    prompts, gens, _ = serve.build_workload(pcfg, 6, 8, (3, 9), seed=5)
    spec = dict(draft=draft, k=2, draft_layers=1, draft_sparsity=0.5)
    kw = {"paged": dict(cache="paged", page_size=4, n_pages=14)}.get(
        mode, {})
    rkw = dict(paged_attn="jax") if mode == "paged" else {}
    reng = RScheduler(rcfg, max_slots=3, max_len=24,
                      spec=RSpecConfig(**spec),
                      sched=(RSchedConfig(chunk_tokens=3, admission="fifo")
                             if mode == "chunked" else None), **kw, **rkw)
    reng.load(rparams)
    rreqs = [reng.submit(p, g) for p, g in zip(prompts, gens)]
    rm = reng.run()
    peng = ContinuousScheduler(
        pcfg, max_slots=3, max_len=24, device="cpu",
        spec=SpecConfig(**spec),
        sched=(SchedConfig(chunk_tokens=3, admission="fifo")
               if mode == "chunked" else None), **kw)
    peng.load(pparams)
    preqs = [peng.submit(p, g) for p, g in zip(prompts, gens)]
    pm = peng.run()
    assert [list(r.tokens) for r in preqs] == [list(r.tokens) for r in rreqs]
    assert {k: pm["spec"][k] for k in SPEC_KEYS} == \
        {k: rm["spec"][k] for k in SPEC_KEYS}
    assert peng.spec_emitted == reng.spec_emitted
    assert pm["spec"]["draft_tokens_accepted"] > 0
    assert pm["cache"] == rm["cache"]
    assert pm["decode_steps"] == rm["decode_steps"]
    if mode == "paged":
        assert pm["spec"]["rollback_page_reclaims"] > 0
        assert pm["cache"]["preemptions"] > 0
        assert peng.pool.all_reclaimed and reng.pool.all_reclaimed
    if mode == "chunked":
        assert pm["sched"]["chunk_steps"] == rm["sched"]["chunk_steps"]


@pytest.mark.parametrize("pkg", ["repro", "port"])
def test_spec_engine_rejects_unsupported(pkg):
    """repro's test_spec_engine_rejects_unsupported on both packages (the
    port has no SSM config: a ternary-paper copy of family "ssm" stands
    in for mamba2-130m)."""
    if pkg == "repro":
        engine, spec_cls, gc, kw = RScheduler, RSpecConfig, rget_config, {}
        ssm = rget_config("mamba2-130m", reduced=True)
        headroom_error = AssertionError
    else:
        engine, spec_cls, gc = ContinuousScheduler, SpecConfig, get_config
        kw = {"device": "cpu"}
        ssm = dataclasses.replace(get_config("ternary-paper", reduced=True),
                                  family="ssm")
        headroom_error = ValueError

    def cfg(**o):
        return gc("ternary-paper", reduced=True, num_layers=2, **o)

    with pytest.raises(ValueError, match="attention-only"):
        engine(ssm, max_slots=1, max_len=16, spec=spec_cls(k=2), **kw)
    with pytest.raises(ValueError, match="sliding-window"):
        engine(cfg(sliding_window=8), max_slots=1, max_len=16,
               spec=spec_cls(k=2), **kw)
    with pytest.raises(ValueError, match="bshd"):
        engine(cfg(cache_layout="opt"), max_slots=1, max_len=16,
               spec=spec_cls(k=2), **kw)
    with pytest.raises(ValueError, match="spec.k"):
        engine(cfg(), max_slots=1, max_len=16, spec=spec_cls(k=0), **kw)
    with pytest.raises(ValueError, match="no room"):
        engine(cfg(), max_slots=1, max_len=5, spec=spec_cls(k=4), **kw)
    eng = engine(cfg(), max_slots=1, max_len=16, spec=spec_cls(k=4), **kw)
    with pytest.raises(headroom_error):      # k positions of headroom
        eng.submit(np.zeros(8, np.int32), 8)
    eng.submit(np.zeros(8, np.int32), 4)


def _keys(tree, prefix=""):
    """The key paths of a metrics dict (lists: their first element's)."""
    out = set()
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.add(prefix + k)
            out |= _keys(v, prefix + k + ".")
    elif isinstance(tree, list) and tree:
        out |= _keys(tree[0], prefix + "[].")
    return out


def test_serve_cli_spec_on_cpu_matches_repros_keys(capsys):
    """``serve --spec layer_skip --device cpu`` drains with a spec block,
    and its metrics have repro's key paths, but for the ones the port does
    not have (``planned_gemms``)."""
    argv = ["--arch", "ternary-paper", "--reduced", "--requests", "4",
            "--slots", "2", "--prompt-len", "8", "--gen-lens", "2,5",
            "--spec", "layer_skip", "--spec-k", "2"]
    ours = serve.main(argv + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == json.loads(json.dumps(ours))
    theirs = rserve.main(argv)
    assert out["submitted"] == out["drained"] == 4
    assert out["spec"]["k"] == 2 and out["max_len"] == theirs["max_len"]
    assert out["spec"]["draft"] == theirs["spec"]["draft"] == \
        "layer_skip(2/4)"
    assert out["spec"]["draft_tokens_proposed"] > 0
    assert _keys(ours) == _keys(theirs) - {"planned_gemms"}


# ---------------------------------------------------------------------------
# The captured round's plumbing
# ---------------------------------------------------------------------------

def test_engine_replays_captured_draft_and_verify(bf16_model):
    """Stand-in graphs whose replays run the captured steps eagerly: the
    streams of the eager engine, one draft and one verify replay a round,
    and every static buffer (pos, tokens, the second-newest tokens, the
    window, the caches, the draft's cache) keeps its storage."""
    cfg, params = bf16_model
    prompts, gens = _workload(cfg, 5, lens=(3, 10))
    spec = SpecConfig(draft="layer_skip", k=2, draft_layers=2)
    kw = dict(cache="paged", page_size=4)
    ref, rm, _ = _run(cfg, params, prompts, gens, 40, spec=spec, **kw)

    eng = ContinuousScheduler(cfg, max_slots=2, max_len=40, device="cpu",
                              spec=spec, **kw)
    eng.load(params)
    replays = {"draft": 0, "verify": 0}

    def capture(name, step):
        step()

        def replay():
            replays[name] += 1
            step()
        return replay

    eng._draft_graph = graphs.CapturedStep(
        eng._draft_step, capture=lambda s: capture("draft", s))
    eng._verify_graph = graphs.CapturedStep(
        eng._verify_step, capture=lambda s: capture("verify", s))
    assert set(eng.spec_graphs) == {"draft", "verify"}
    eng._dirty = True

    def buffers():
        out = _buffers(eng)
        out.update(prev=eng._dev_prev.data_ptr(),
                   win=eng._dev_win.data_ptr())
        for i, layer in enumerate(eng._draft_layers):
            out.update({f"draft.{i}.{n}": t.data_ptr()
                        for n, t in layer.items()})
        return out

    seen = [buffers()]
    reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    while eng.has_work():
        eng.step()
        seen.append(buffers())
    assert [list(r.tokens) for r in reqs] == [list(t) for t in ref]
    assert replays["draft"] == replays["verify"] == rm["spec"]["rounds"]
    assert all(b == seen[0] for b in seen)
