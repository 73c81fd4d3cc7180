"""The prefix-affinity router on the CPU against ``repro``'s: placements and
counters bit for bit on stub engines (seeded probe / load states, spills,
ties), the fleet metrics of a drained run over stub engines, and dp 2 over
two real CPU engines of each package on the same weights (a two-wave
shared-prefix workload over paged pools, so the second wave meets the
first one's prefixes): equal placements and affinity counters, streams
equal to each other and to one engine's."""
import types

import numpy as np
import pytest

from repro.distributed.router import Router as RRouter
from repro.serving import ContinuousScheduler as RScheduler

from repro_torch.distributed.router import Router
from repro_torch.serving import ContinuousScheduler

from test_torch_model import _packed_pair
from torch_cpu_threads import one_torch_thread  # noqa: F401


class _Queue:
    """The stub's queue: its depth (a base load plus what was submitted)
    and its truth (anything submitted left)."""

    def __init__(self, eng):
        self.eng = eng

    def depth(self):
        return self.eng.depth + len(self.eng.queue_items)

    def __bool__(self):
        return bool(self.eng.queue_items)


class _Stub:
    """An engine as the router sees it: a prefix probe, a queue depth, live
    slots; ``step`` drains one queued request."""

    def __init__(self, probe=0, depth=0, live=0, with_prefix=True):
        self.probe_len, self.depth, self.live = probe, depth, live
        prefix = (types.SimpleNamespace(probe=lambda p: self.probe_len,
                                        hit_rate=0.25)
                  if with_prefix else None)
        self.pool = types.SimpleNamespace(prefix=prefix)
        self.queue_items = []
        self.queue = _Queue(self)
        self.params, self.mesh, self.max_len = object(), None, 8
        self.prefill_steps = self.decode_steps = self.total_drained = 0
        self._finished = []

    @property
    def _live(self):
        return {i: None for i in range(self.live)}

    def submit(self, prompt, max_new, **kw):
        req = types.SimpleNamespace(tokens=list(range(max_new)))
        self.queue_items.append(req)
        return req

    def step(self):
        if self.queue_items:
            self._finished.append(self.queue_items.pop(0))
            self.prefill_steps += 1
            self.decode_steps += 2
            self.total_drained += 1


def _pair(states, **kw):
    return (Router([_Stub(*s) for s in states], **kw),
            RRouter([_Stub(*s) for s in states], **kw))


def _counters(r):
    return (r.routed, r.affinity_candidates, r.affinity_hits, r.spills,
            list(r.placements))


def test_router_validates_args_as_repro():
    for make in (lambda R: R([]), lambda R: R([_Stub()], spill_threshold=-1)):
        with pytest.raises(ValueError) as a:
            make(Router)
        with pytest.raises(ValueError) as b:
            make(RRouter)
        assert str(a.value) == str(b.value)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("threshold", [0, 2, 4])
def test_router_placements_and_counters_equal_repros(seed, threshold):
    """Seeded engine states (probes, queue depths, live counts, a replica
    without a prefix cache) before every placement: both routers place
    each prompt alike and count alike."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 5))
    states = [(0, 0, 0, bool(i or seed % 2)) for i in range(n)]
    port, ref = _pair(states, spill_threshold=threshold)
    for _ in range(40):
        probes = rng.integers(0, 4, size=n) * rng.integers(0, 2)
        depths = rng.integers(0, 8, size=n)
        lives = rng.integers(0, 3, size=n)
        for router in (port, ref):
            for e, p, d, lv in zip(router.engines, probes, depths, lives):
                e.probe_len, e.depth, e.live = int(p), int(d), int(lv)
        prompt = rng.integers(0, 100, size=8)
        assert port.place(prompt) == ref.place(prompt)
        port.submit(prompt, 2)
        ref.submit(prompt, 2)
        assert _counters(port) == _counters(ref)


def test_router_policy_cases_as_repros():
    cases = [([(0, 3), (0, 0, 1), (0,)], {}),          # cold: least load
             ([(0,), (3, 2), (1,)], {}),               # deepest prefix wins
             ([(2, 2), (2,)], {}),                     # tie -> least load
             ([(4, 6, 1), (0,)], dict(spill_threshold=4)),   # spill
             ([(4, 4), (0,)], dict(spill_threshold=4))]      # sticky at it
    for states, kw in cases:
        port, ref = _pair(states, **kw)
        assert port.place(np.arange(8)) == ref.place(np.arange(8))
        assert _counters(port) == _counters(ref)


def test_router_run_metrics_equal_repros():
    """A drained run over stub engines: the fleet metrics' keys and every
    value but the wall-clock ones."""
    port, ref = _pair([(0,), (2,), (0, 2)], spill_threshold=1)
    rng = np.random.default_rng(7)
    for _ in range(9):
        prompt = rng.integers(0, 50, size=6)
        port.submit(prompt, int(prompt[0] % 4) + 1)
        ref.submit(prompt, int(prompt[0] % 4) + 1)
    got, want = port.run(), ref.run()
    assert set(got) == set(want)
    for key in ("wall_s", "tok_per_s"):
        got.pop(key), want.pop(key)
    assert got == want
    with pytest.raises(RuntimeError):
        bare = _Stub()
        bare.params = None
        Router([bare]).run()


@pytest.fixture(scope="module")
def engines_pair():
    rcfg, rparams, pcfg, pparams = _packed_pair("bfloat16", num_layers=2)
    return rcfg, rparams, pcfg, pparams


def _workload(vocab, n=8, plen=16, prefix=8, seed=5):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, vocab, size=(n, plen)).astype(np.int32)
    prompts[::2, :prefix] = rng.integers(0, vocab, size=prefix)
    gens = [int(g) for g in rng.integers(2, 6, size=n)]
    return prompts, gens


def _drive(front, prompts, gens, waves=2):
    per = len(prompts) // waves
    reqs = []
    for w in range(waves):
        reqs += [front.submit(p, g) for p, g in
                 zip(prompts[w * per:(w + 1) * per],
                     gens[w * per:(w + 1) * per])]
        front.run()
    return [np.asarray(r.tokens, np.int32) for r in reqs]


def test_dp2_router_over_cpu_engines_equals_repros(engines_pair):
    rcfg, rparams, pcfg, pparams = engines_pair
    prompts, gens = _workload(pcfg.vocab_size)
    kw = dict(max_slots=2, max_len=24, cache="paged", page_size=4)
    reng = [RScheduler(rcfg, **kw) for _ in range(2)]
    peng = [ContinuousScheduler(pcfg, device="cpu", **kw) for _ in range(2)]
    for e in reng:
        e.load(rparams)
    for e in peng:
        e.load(pparams)
    rfront, pfront = RRouter(reng), Router(peng)
    routs = _drive(rfront, prompts, gens)
    pouts = _drive(pfront, prompts, gens)
    assert _counters(pfront) == _counters(rfront)
    assert pfront.affinity_hits > 0
    one = ContinuousScheduler(pcfg, device="cpu", **kw)
    one.load(pparams)
    single = _drive(one, prompts, gens)
    for r, p, s in zip(routs, pouts, single):
        np.testing.assert_array_equal(p, r)
        np.testing.assert_array_equal(p, s)
