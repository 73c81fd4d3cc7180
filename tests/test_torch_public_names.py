"""The last of ``repro``'s public names the port lacked, each against
``repro``'s on the same inputs: ``kernels.ops.pack_weights`` and
``pack_weights_tiled`` (the same words, tile metadata, scale and bias),
``run_open_loop(deadline_s=)`` (every arrival's budget: the same
outcomes) and ``n_live`` of the slot and page pools (the same counts as
the engines admit and drain)."""
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.serving import ContinuousScheduler as RScheduler
from repro.serving import TrafficConfig as RTrafficConfig
from repro.serving import make_schedule as r_make_schedule
from repro.serving import run_open_loop as r_run_open_loop

from repro_torch.kernels import ops
from repro_torch.serving import (ContinuousScheduler, TrafficConfig,
                                 make_schedule, run_open_loop)
from repro_torch.serving.faults import FAIL_DEADLINE

from test_torch_model import _packed_pair
from torch_cpu_threads import one_torch_thread  # noqa: F401

ENGINE = dict(max_slots=3, max_len=24)
POOLS = {"dense": {}, "paged": dict(cache="paged", page_size=4)}


def _ternary(k, n, seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    t[:, : n // 4] *= (rng.random((k, n // 4)) < 0.1)   # sparse columns
    scale = rng.random(n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return t, scale, bias


def _words(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("k,n", [(64, 32), (100, 70), (300, 260)])
def test_pack_weights_match_repros(k, n):
    t, scale, bias = _ternary(k, n, k + n)
    got = ops.pack_weights(t, scale=scale, bias=bias)
    want = rops.pack_weights(t, scale=scale, bias=bias)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(_words(got.packed.numpy()),
                                  _words(want.packed))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.bias.numpy(), np.asarray(want.bias))
    assert torch.equal(got.materialize(torch.float32),
                       torch.as_tensor(t, dtype=torch.float32))
    # a tensor in gives the same container as the array
    again = ops.pack_weights(torch.as_tensor(t))
    assert torch.equal(again.packed, got.packed) and again.scale is None


@pytest.mark.parametrize("tiles", [(256, 128), (64, 32)])
def test_pack_weights_tiled_match_repros(tiles):
    t, scale, _ = _ternary(300, 260, 7)
    tk, tn = tiles
    got = ops.pack_weights_tiled(t, tile_k=tk, tile_n=tn, scale=scale)
    want = rops.pack_weights_tiled(t, tile_k=tk, tile_n=tn, scale=scale)
    for name in ("packed", "kt_indices", "kt_counts"):
        np.testing.assert_array_equal(
            _words(getattr(got, name).numpy()),
            _words(getattr(want, name)), err_msg=name)
    assert (got.tile_k, got.tile_n, got.nnz) == (want.tile_k, want.tile_n,
                                                 want.nnz)
    assert got.bias is None and want.bias is None


@pytest.fixture(scope="module")
def pair():
    return _packed_pair("float32", num_layers=1)


def _outcomes(reqs):
    return [(r.state, r.fail_reason, list(r.tokens)) for r in reqs]


@pytest.mark.parametrize("deadline", [0.0, None])
def test_open_loop_deadline_matches_repros(pair, deadline):
    """Every arrival of a compressed schedule with a budget of 0 s is
    cancelled while queued, on both packages' engines; without one, all
    finish with the same tokens."""
    rcfg, rparams, pcfg, pparams = pair
    kw = dict(kind="poisson", rate=8.0, n_requests=5, prompt_lens=(6, 10),
              gen_lens=(3, 4), seed=1)
    sched = make_schedule(TrafficConfig(**kw), pcfg.vocab_size)
    rsched = r_make_schedule(RTrafficConfig(**kw), rcfg.vocab_size)
    peng = ContinuousScheduler(pcfg, device="cpu", **ENGINE)
    peng.load(pparams)
    preqs, pm = run_open_loop(peng, sched, time_scale=0.0,
                              deadline_s=deadline)
    reng = RScheduler(rcfg, **ENGINE)
    reng.load(rparams)
    rreqs, rm = r_run_open_loop(reng, rsched, time_scale=0.0,
                                deadline_s=deadline)
    assert _outcomes(preqs) == _outcomes(rreqs)
    cancelled = sum(r.fail_reason == FAIL_DEADLINE for r in preqs)
    assert cancelled == (len(sched) if deadline == 0.0 else 0)
    assert pm["faults"]["degradations"]["deadline_cancellations"] == \
        rm["faults"]["degradations"]["deadline_cancellations"] == cancelled


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_n_live_matches_repros(pair, pool):
    """The pools' live slots step by step as five requests pass through
    three slots and drain, on both packages' engines."""
    rcfg, rparams, pcfg, pparams = pair
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, pcfg.vocab_size, size=(5, 6)).astype(np.int32)
    peng = ContinuousScheduler(pcfg, device="cpu", **ENGINE, **POOLS[pool])
    peng.load(pparams)
    reng = RScheduler(rcfg, **ENGINE, **POOLS[pool])
    reng.load(rparams)
    seen = []
    for eng in (peng, reng):
        for i, p in enumerate(prompts):
            eng.submit(p, 2 + i % 3)
        live = [eng.pool.n_live]
        while eng.has_work():
            eng.step()
            live.append(eng.pool.n_live)
            assert eng.pool.n_live + eng.pool.n_free == eng.max_slots
        seen.append(live)
    assert seen[0] == seen[1]
    assert max(seen[0]) >= 2 and seen[0][-1] == 0
