"""The device-resident decode step on the CPU: the static buffers (positions,
tokens, the block table, the caches) keep their storage through admit,
evict, preempt and block-table pushes, and the step gives the token
streams of the rebinding step it replaced; the launch counters count a
captured step once per replay and leave the warm-up and the capture out.
A CUDA graph needs a card (``tests/test_torch_cuda.py`` holds graph against
eager there); here a stand-in capture calls the step and replays it
eagerly."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_mlp as fused_lib
from repro_torch.kernels import graphs
from repro_torch.kernels import ternary_gemm as gemm_lib
from repro_torch.launch import serve
from repro_torch.paging import Int8Pages
from repro_torch.paging import kernels as paged_lib
from repro_torch.serving import ContinuousScheduler

from test_torch_model import _packed_pair
from test_torch_paging import SCENARIOS


class RebindingScheduler(ContinuousScheduler):
    """The decode step before this change: new position and token tensors
    every step (the layout a captured graph cannot follow)."""

    @torch.no_grad()
    def _decode_step(self):
        cache = {"layers": self.pool.layers,
                 "pos": torch.clamp(self._dev_pos, max=self.max_len - 1)}
        if self.cache_mode == "paged":
            cache["block_table"] = self._dev_table
        logits, new_cache = self.model.decode_step(self.params, cache,
                                                   self._dev_tok[:, None])
        self.pool.layers = new_cache["layers"]
        self._dev_pos = new_cache["pos"]
        self._dev_tok = logits[:, 0].argmax(dim=-1).to(torch.int32)

    def _read_step(self):
        toks = self._dev_tok.numpy()
        return toks, np.ones(toks.shape, bool)

    def _push_host_state(self):
        if self._dirty:
            self._dev_pos = torch.tensor(self._pos)
            self._dev_tok = torch.tensor(self._tok)
            self._dirty = False
        if self.cache_mode == "paged" and self.pool.table_dirty:
            self._dev_table = torch.tensor(self.pool.table)
            self.pool.table_dirty = False


def _buffers(engine):
    """Name -> data_ptr of every tensor the decode step reads or writes in
    place."""
    out = {"pos": engine._dev_pos.data_ptr(),
           "tok": engine._dev_tok.data_ptr()}
    if engine.cache_mode == "paged":
        out["block_table"] = engine._dev_table.data_ptr()
    for i, layer in enumerate(engine.pool.layers):
        for name, t in layer.items():
            if isinstance(t, Int8Pages):
                out[f"{i}.{name}.codes"] = t.codes.data_ptr()
                out[f"{i}.{name}.scales"] = t.scales.data_ptr()
            else:
                out[f"{i}.{name}"] = t.data_ptr()
    return out


def _drive(cls, scenario, pcfg, pparams, on_step=None, **extra):
    """Drain a paging scenario's workload (``"dense"``: churn's workload
    over the dense cache), calling ``on_step(engine)`` after each step."""
    make, kw, paged_kw = SCENARIOS["churn" if scenario == "dense"
                                   else scenario]
    prompts, gens = make()
    if scenario != "dense":
        kw = dict(kw, cache="paged", **paged_kw)
    eng = cls(pcfg, device="cpu", **kw, **extra)
    eng.load(pparams)
    reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    snap = eng.begin_metrics()
    while eng.has_work():
        eng.step()
        if on_step is not None:
            on_step(eng)
    return [list(r.tokens) for r in reqs], eng.collect_metrics(snap), eng


class CountedScheduler(ContinuousScheduler):
    """Counts the block-table pushes."""

    table_pushes = 0

    def _push_host_state(self):
        if self.cache_mode == "paged" and self.pool.table_dirty:
            self.table_pushes += 1
        super()._push_host_state()


@pytest.mark.parametrize("scenario,kv_dtype", [
    ("dense", None), ("churn", None), ("churn", "int8"), ("oom", None),
    ("oom", "int8"), ("prefix_cow", None), ("prefix_cow", "int8")])
def test_static_buffers_keep_their_storage(scenario, kv_dtype):
    _, _, pcfg, pparams = _packed_pair("float32", num_layers=2)
    kw = {} if scenario == "dense" else dict(kv_dtype=kv_dtype)
    seen = []

    def check(eng):
        seen.append(_buffers(eng))

    toks, m, eng = _drive(CountedScheduler, scenario, pcfg, pparams, check,
                          **kw)
    assert len(seen) >= m["decode_steps"] > 0
    assert all(ptrs == seen[0] for ptrs in seen)
    if scenario == "dense":
        assert eng.pool.all_free
    else:
        assert eng.pool.all_reclaimed and eng.table_pushes > 1
    if scenario == "oom":
        assert m["cache"]["preemptions"] > 0 and m["cache"]["deferrals"] > 0

    moved = []
    ref, rm, _ = _drive(RebindingScheduler, scenario, pcfg, pparams,
                        lambda e: moved.append(_buffers(e)), **kw)
    assert toks == ref
    assert m["cache"] == rm["cache"]
    # the check above sees a step that rebinds its buffers
    assert any(ptrs != moved[0] for ptrs in moved)


def _fake_kernel_step(calls):
    """A stand-in decode step whose 'kernels' count as the wrappers do."""
    def step():
        calls.append(1)
        gemm_lib.ternary_gemm_cuda.launches += 49
        fused_lib.fused_mlp_cuda.launches += 12
        paged_lib.paged_decode_attention_cuda.launches += 12
    return step


def _stand_in_capture(step):
    """What ``cuda_graph_capture`` does to ``step`` (two warm-up calls,
    then the captured one), with a replay that launches nothing."""
    for _ in range(3):
        step()
    return lambda: None


def test_captured_step_counts_replays_not_warmup_or_capture():
    before = graphs.read_launches()
    calls = []
    cap = graphs.CapturedStep(_fake_kernel_step(calls),
                              capture=_stand_in_capture)
    assert len(calls) == 3
    assert graphs.read_launches() == before
    want = {k: 0 for k in before} | {"ternary_gemm": 49, "fused_mlp": 12,
                                     "paged_decode_attention": 12}
    assert cap.launches_per_replay == want
    for _ in range(5):
        cap.replay()
    after = graphs.read_launches()
    assert {k: after[k] - before[k] for k in after} == {
        k: 5 * v for k, v in want.items()}
    assert len(calls) == 3                  # replays ran no Python step


def test_engine_replays_a_captured_step():
    """The engine with a stand-in graph whose replay runs the captured
    step eagerly: the same streams as the eager step, one replay a
    decode step."""
    _, _, pcfg, pparams = _packed_pair("float32", num_layers=2)
    prompts, gens, _ = serve.build_workload(pcfg, 5, 8, (2, 7), seed=3)
    eager = ContinuousScheduler(pcfg, max_slots=2, max_len=16, device="cpu")
    eager.load(pparams)
    ref, rm = serve.run_continuous(eager, prompts, gens)

    eng = ContinuousScheduler(pcfg, max_slots=2, max_len=16, device="cpu")
    eng.load(pparams)
    replays = []

    def capture(step):
        step()
        return lambda: (replays.append(1), step())

    eng._graph = graphs.CapturedStep(eng._decode_step, capture=capture)
    eng._dirty = True
    outs, m = serve.run_continuous(eng, prompts, gens)
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, b)
    assert len(replays) == m["decode_steps"] == rm["decode_steps"]


def test_load_refuses_live_requests():
    _, _, pcfg, pparams = _packed_pair("float32", num_layers=2)
    eng = ContinuousScheduler(pcfg, max_slots=2, max_len=16, device="cpu")
    eng.load(pparams)
    eng.submit(np.arange(4, dtype=np.int32), 5)
    eng.step()
    with pytest.raises(RuntimeError):
        eng.load(pparams)
