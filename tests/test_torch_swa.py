"""Rolling sliding-window caches and the ``opt`` / ``flat`` cache layouts,
held against ``repro`` on a reduced packed ``ternary-paper`` (2 layers,
``sliding_window=8``), in ``bshd``, ``opt`` and ``flat``: prefill below and
above the window, then decode past the wrap, per-slot positions, windows
unrolled into one-token steps, the dense engine and the static server, and
``repro``'s refusals of speculative decoding, chunked prefill and paged
caches.

Tolerances: float32 throughout (``dtype`` and ``cache_dtype``), so logits
agree within 1e-4 of max|logit| (the same sums in another order through 2
layers) and greedy streams are equal. An unrolled window runs the very
one-token steps it replaces, so it is held bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as rserve
from repro.models import LM as RLM
from repro.models import attention as rattention
from repro.serving import ContinuousScheduler as RScheduler
from repro.serving import SchedConfig as RSchedConfig
from repro.spec import SpecConfig as RSpecConfig
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.models import attention
from repro_torch.serving import ContinuousScheduler, SchedConfig
from repro_torch.spec import SpecConfig

from test_torch_model import _packed_pair

WINDOW = 8
TOL = 1e-4
LAYOUTS = {"bshd": {}, "opt": {"cache_layout": "opt"},
           "flat": {"decode_cache_shard": "flat"}}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def pair(request):
    return (request.param,) + _packed_pair(
        "float32", num_layers=2, sliding_window=WINDOW,
        **LAYOUTS[request.param])


def _close(got: torch.Tensor, ref) -> None:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=TOL,
                               atol=TOL * scale)


def test_cache_shapes_match_repro(pair):
    layout, rcfg, _, pcfg, _ = pair
    for max_len in (5, 24):
        want = rattention.init_kv_cache(rcfg, 3, max_len)
        got = attention.init_kv_cache(pcfg, 3, max_len)
        for name in ("k", "v"):
            assert tuple(got[name].shape) == want[name].shape, \
                (layout, max_len)


@pytest.mark.parametrize("prompt_len", [5, 13])
def test_prefill_then_decode_match_repro(pair, prompt_len):
    """Prefill below (5) and above (13, rolled) the 8-position cache,
    then 10 greedy decode steps, past the wrap."""
    layout, rcfg, rparams, pcfg, pparams = pair
    toks = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, size=(2, prompt_len)).astype(np.int32)
    rlm, plm = RLM(rcfg), LM(pcfg, "cpu")
    rdecode = jax.jit(rlm.decode_step)
    rc, rl = jax.jit(lambda p, t: rlm.prefill(
        p, {"tokens": t}, 24, cache_dtype=jnp.float32))(
        rparams, jnp.asarray(toks))
    pc, pl = plm.prefill(pparams, {"tokens": torch.from_numpy(toks)}, 24,
                         cache_dtype=torch.float32)
    _close(pl, rl)
    _close(pc["layers"][1]["k"], rc["layers"]["cache0"]["k"][1])
    for _ in range(10):
        want = np.asarray(jnp.argmax(rl[:, -1], axis=-1)).astype(np.int32)
        got = pl[:, -1].argmax(dim=-1).numpy().astype(np.int32)
        np.testing.assert_array_equal(got, want)
        rl, rc = rdecode(rparams, rc, jnp.asarray(want[:, None]))
        pl, pc = plm.decode_step(pparams, pc, torch.from_numpy(got[:, None]))
        _close(pl, rl)
    _close(pc["layers"][0]["v"], rc["layers"]["cache0"]["v"][0])


def test_per_slot_decode_matches_repro(pair):
    """A (B,) position vector, rows before, at and past the wrap: each row
    writes its own slot (``pos % 8``), committed after the stack in
    ``opt``."""
    layout, rcfg, rparams, pcfg, pparams = pair
    rng = np.random.default_rng(4)
    rlm, plm = RLM(rcfg), LM(pcfg, "cpu")
    rdecode = jax.jit(rlm.decode_step)
    pos = np.array([0, 6, 11], np.int32)
    rc = dict(rlm.init_cache(3, 24, jnp.float32), pos=jnp.asarray(pos))
    pc = dict(plm.init_cache(3, 24, torch.float32), pos=torch.from_numpy(pos))
    for _ in range(4):
        tok = rng.integers(0, rcfg.vocab_size, size=(3, 1)).astype(np.int32)
        rl, rc = rdecode(rparams, rc, jnp.asarray(tok))
        pl, pc = plm.decode_step(pparams, pc, torch.from_numpy(tok))
        _close(pl, rl)
    _close(pc["layers"][1]["k"], rc["layers"]["cache0"]["k"][1])
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(rc["pos"]))


def test_window_unrolls_into_one_token_steps_bitwise(pair):
    """decode_step over S = 3 tokens on a rolling or opt cache is the
    three one-token steps: logits and caches bitwise."""
    layout, rcfg, rparams, pcfg, pparams = pair
    plm = LM(pcfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, pcfg.vocab_size, size=(2, 10)).astype(np.int32))
    win = torch.from_numpy(np.random.default_rng(6).integers(
        0, pcfg.vocab_size, size=(2, 3)).astype(np.int32))
    a, _ = plm.prefill(pparams, {"tokens": toks}, 24,
                       cache_dtype=torch.float32)
    b, _ = plm.prefill(pparams, {"tokens": toks}, 24,
                       cache_dtype=torch.float32)
    a["pos"] = b["pos"] = torch.tensor([10, 10], dtype=torch.int32)
    assert plm._decode_window_unrolled(a)
    got, a = plm.decode_step(pparams, a, win)
    steps = []
    for j in range(3):
        lg, b = plm.decode_step(pparams, b, win[:, j:j + 1])
        steps.append(lg)
    assert torch.equal(got, torch.cat(steps, dim=1))
    for la, lb in zip(a["layers"], b["layers"]):
        assert torch.equal(la["k"], lb["k"]) and torch.equal(la["v"],
                                                             lb["v"])
    assert torch.equal(a["pos"], b["pos"])


def test_engine_and_static_serve_repros_streams(pair):
    """The dense engine over rolling (and opt / flat) caches, 12-token
    prompts (the prefill rolls) and budgets past the wrap: streams equal
    repro's engine's and the port's static server's."""
    layout, rcfg, rparams, pcfg, pparams = pair
    prompts, gens, _ = serve.build_workload(pcfg, 5, 12, (3, 9), seed=3)
    max_len = 12 + 9 + 1
    reng = RScheduler(rcfg, max_slots=2, max_len=max_len)
    reng.load(rparams)
    routs, _ = rserve.run_continuous(reng, prompts, gens)
    peng = ContinuousScheduler(pcfg, max_slots=2, max_len=max_len,
                               device="cpu")
    peng.load(pparams)
    pouts, _ = serve.run_continuous(peng, prompts, gens)
    server = serve.BatchedServer(pcfg, max_len, "cpu")
    server.load(pparams)
    souts, _ = serve.run_static(server, prompts, gens, batch=2)
    for r, p, s in zip(routs, pouts, souts):
        np.testing.assert_array_equal(p, r)
        np.testing.assert_array_equal(s, r)
    shapes = {tuple(t.shape) for lay in peng.pool.layers for t in lay.values()}
    want = {tuple(np.asarray(t).shape[1:]) for t in
            jax.tree_util.tree_leaves(reng.pool.layers)}
    assert shapes == want


def _error(make):
    with pytest.raises(ValueError) as info:
        make()
    return str(info.value)


@pytest.mark.parametrize("what", ["spec", "chunked", "paged"])
def test_engine_refuses_as_repro(pair, what):
    layout, rcfg, _, pcfg, _ = pair
    kw = dict(max_slots=2, max_len=24)
    rkw, pkw = dict(kw), dict(kw, device="cpu")
    if what == "spec":
        rkw["spec"] = RSpecConfig(draft="layer_skip", k=2, draft_layers=1)
        pkw["spec"] = SpecConfig(draft="layer_skip", k=2, draft_layers=1)
    elif what == "chunked":
        rkw["sched"] = RSchedConfig(chunk_tokens=4)
        pkw["sched"] = SchedConfig(chunk_tokens=4)
    else:
        rkw["cache"] = pkw["cache"] = "paged"
    assert _error(lambda: ContinuousScheduler(pcfg, **pkw)) == \
        _error(lambda: RScheduler(rcfg, **rkw))


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_window_matches_repro(causal):
    """The no-cache blockwise attention with a window (the prefill of a
    prompt longer than its rolling cache): 80 tokens, blocks of 16 and
    32, window 24, so whole KV blocks fall out of the walk."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 80, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 80, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 80, 2, 16)).astype(np.float32)
    want = rattention.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=24, block_q=16, block_kv=32)
    got = attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=24, block_q=16, block_kv=32)
    _close(got, want)
    naive = attention.naive_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=24)
    torch.testing.assert_close(got, naive, rtol=1e-5, atol=1e-5)


def test_opt_decode_attention_matches_repro():
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 2, 16, 12)).astype(np.float32)
    for valid, window, q_off in ((12, 0, 0), (9, 4, 8)):
        want = rattention.opt_decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            kv_valid_len=valid, window=window, q_offset=q_off)
        got = attention.opt_decode_attention(
            torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            kv_valid_len=valid, window=window, q_offset=q_off)
        _close(got, want)
