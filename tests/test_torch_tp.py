"""Tensor-parallel serving on the CPU: tp 2 as two processes over gloo (the
engine spawns its follower rank; the group meets through a ``FileStore``
in a fresh temporary directory, so parallel test workers never share a
port), on a reduced packed ``ternary-paper`` (2 layers, bf16) drawn by
``repro`` and converted. Dense, paged bf16 and int8, chunked prefill
(4-token chunks) and speculative decoding (``layer_skip``, k 2), each
against the port at tp 1 and against ``repro``'s single-device engine on
the same weights; one GQA case whose single K/V head does not split (the
head rule gives each rank half the query heads and that head).

The rule for streams: equal, or parting at a near tie of the reference
(``_near_tie``: teacher-forced, both tokens at the split and every later
token of the tp-2 stream within ``TIE_TOL`` of max|logit| below the top
logit). tp 2 sums the row-split projections' f32 partials before the
bias and the cast, where one device accumulates them in one f32 sum, so
bf16 outputs can round one ulp apart. The first decode step's (or verify
window's) logits lie within ``LOGIT_TOL`` of max|logit| of tp 1's.

Every engine's group times out after ``TIMEOUT_S`` (a hung collective
raises on the leader) and ``close()`` stops the follower, killing it
when it does not stop."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serving import ContinuousScheduler as RScheduler
from repro.serving import SchedConfig as RSchedConfig
from repro.spec import SpecConfig as RSpecConfig

from repro_torch.distributed import tp as tp_lib
from repro_torch.models import LM
from repro_torch.serving import ContinuousScheduler, SchedConfig
from repro_torch.spec import SpecConfig

from test_torch_model import _packed_pair
from torch_cpu_threads import one_torch_thread  # noqa: F401

TIMEOUT_S = 120.0
LOGIT_TOL = 3e-2
TIE_TOL = 3e-2
ENGINE = dict(max_slots=3, max_len=24)
MODES = {
    "dense": ({}, {}),
    "paged_bf16": (dict(cache="paged", page_size=4),
                   dict(cache="paged", page_size=4)),
    "paged_int8": (dict(cache="paged", page_size=4, kv_dtype="int8"),
                   dict(cache="paged", page_size=4, kv_dtype="int8")),
    "chunked": (dict(sched=SchedConfig(chunk_tokens=4)),
                dict(sched=RSchedConfig(chunk_tokens=4))),
    "spec": (dict(spec=SpecConfig(draft="layer_skip", k=2, draft_layers=1)),
             dict(spec=RSpecConfig(draft="layer_skip", k=2,
                                   draft_layers=1))),
}


def _mesh():
    return tp_lib.replica_meshes(1, 2, ["cpu", "cpu"],
                                 timeout_s=TIMEOUT_S)[0]


def _workload(vocab, seed=11):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, vocab, size=(5, 10)).astype(np.int32)
    gens = [int(g) for g in rng.integers(3, 9, size=5)]
    return prompts, gens


def _drive(eng, prompts, gens):
    """Submit, step to the first decode step (or verify window) and take
    its logits, drain; the streams, the logits and the metrics."""
    reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    for _ in range(ENGINE["max_len"]):
        eng.step()
        if eng.last_logits is not None:
            break
    first = eng.last_logits.float().clone()
    metrics = eng.run()
    return [np.asarray(r.tokens, np.int32) for r in reqs], first, metrics


def _serve_port(cfg, params, prompts, gens, mesh=None, **kw):
    eng = ContinuousScheduler(cfg, device="cpu", mesh=mesh, **ENGINE, **kw)
    try:
        eng.load(params)
        return _drive(eng, prompts, gens)
    finally:
        eng.close()


def _near_tie(cfg, params, prompt, ref, got):
    """Where ``got`` parts from ``ref``: teacher-forced on ``got``, both
    tokens at the split and every later token of ``got`` lie within
    TIE_TOL * max|logit| below the top logit."""
    j = int(np.nonzero(ref != got)[0][0])
    seq = np.concatenate([prompt, got[:-1]]).astype(np.int32)
    with torch.no_grad():
        _, logits = LM(cfg, "cpu").prefill(
            params, {"tokens": torch.as_tensor(seq[None])}, len(seq),
            logits_from=len(prompt) - 1 - len(seq))
    rows = logits[0].float()
    top = rows.max(dim=-1).values
    lag = top - rows.gather(1, torch.as_tensor(got, dtype=torch.long)[:, None]
                            )[:, 0]
    bound = TIE_TOL * float(rows.abs().max())
    ref_lag = float(top[j] - rows[j, int(ref[j])])
    assert max(ref_lag, float(lag[j:].max())) <= bound, (j, ref_lag,
                                                         lag[j:], bound)


def _streams(cfg, params, prompts, want, got):
    for p, a, b in zip(prompts, want, got):
        assert len(a) == len(b)
        if not np.array_equal(a, b):
            _near_tie(cfg, params, p, a, b)


@pytest.fixture(scope="module")
def pair():
    return _packed_pair("bfloat16", num_layers=2)


@pytest.fixture(scope="module")
def workload(pair):
    return _workload(pair[2].vocab_size)


@pytest.mark.parametrize("mode", list(MODES))
def test_tp2_serves_as_tp1_and_repro(pair, workload, mode):
    rcfg, rparams, pcfg, pparams = pair
    prompts, gens = workload
    pkw, rkw = MODES[mode]
    one, first1, _ = _serve_port(pcfg, pparams, prompts, gens, **pkw)
    two, first2, metrics = _serve_port(pcfg, pparams, prompts, gens,
                                       mesh=_mesh(), **pkw)
    assert metrics["mesh"]["tp"] == 2 and metrics["mesh"]["axes"] == {
        "model": 2}
    assert metrics["mesh"]["collective_plans"] > 0
    assert [len(t) for t in two] == gens
    scale = float(first1.abs().max())
    assert float((first2 - first1).abs().max()) <= LOGIT_TOL * scale
    _streams(pcfg, pparams, prompts, one, two)
    reng = RScheduler(rcfg, **ENGINE, **rkw)
    reng.load(rparams)
    rreqs = [reng.submit(p, g) for p, g in zip(prompts, gens)]
    reng.run()
    _streams(pcfg, pparams, prompts,
             [np.asarray(r.tokens, np.int32) for r in rreqs], two)
    if mode == "spec":
        assert metrics["spec"]["rounds"] > 0
    if mode == "chunked":
        assert metrics["sched"]["chunk_steps"] > 0


def test_tp2_gqa_head_rule_replicates_attention(pair):
    """One K/V head: each rank keeps half the query heads and the one
    K/V head they read (replicated on both ranks), o row split, the MLP,
    the lm head and the embedding table split."""
    _, _, pcfg, pparams = _packed_pair("bfloat16", num_layers=2,
                                       num_kv_heads=1)
    prompts, gens = _workload(pcfg.vocab_size, seed=12)
    one, first1, _ = _serve_port(pcfg, pparams, prompts, gens)
    two, first2, metrics = _serve_port(pcfg, pparams, prompts, gens,
                                       mesh=_mesh(), cache="paged",
                                       page_size=4)
    scale = float(first1.abs().max())
    assert float((first2 - first1).abs().max()) <= LOGIT_TOL * scale
    _streams(pcfg, pparams, prompts, one, two)
    local = tp_lib.local_config(pcfg, 2)
    assert (local.num_heads, local.num_kv_heads, local.head_pad) == (
        pcfg.num_heads // 2, 1, 0)
    assert tp_lib.attention_split(pcfg, 2) == "replicate"


def test_tp_refusals():
    """repro's refusals stay: encoder-decoder and VLM configs belong to
    the static server, mesh or not (every decoder family takes a mesh:
    ``test_torch_tp_families``), and graph capture over gloo on a card
    raises."""
    _, _, pcfg, _ = _packed_pair("bfloat16", num_layers=1)
    for family, extra in (("encdec", dict(enc_layers=1)), ("vlm", {})):
        fam = dataclasses.replace(pcfg, family=family, **extra)
        with pytest.raises(ValueError, match="static BatchedServer"):
            ContinuousScheduler(fam, device="cpu", mesh=_mesh(), **ENGINE)
    moe = ContinuousScheduler(dataclasses.replace(pcfg, family="moe"),
                              device="cpu", mesh=_mesh(), **ENGINE)
    assert moe.tp == 2
    moe.close()
    shared = tp_lib.Mesh(("model",), (2,), ("cuda:0", "cuda:0"))
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="NCCL"):
            ContinuousScheduler(pcfg, mesh=shared, **ENGINE)
    else:
        # the card's check comes first on a machine without one
        with pytest.raises(RuntimeError, match="cuda"):
            ContinuousScheduler(pcfg, mesh=shared, cuda_graph=False,
                                **ENGINE)


def test_serve_mesh_cli(capsys):
    """``serve --mesh dp,tp``: tp 2 over two CPU ranks behind the router
    (repro's fleet metrics; dp 2 is the router tests'); fewer devices than
    dp * tp, --static and --traffic raise, as repro's do."""
    from repro_torch.launch import serve
    base = ["--device", "cpu", "--reduced", "--packed", "--ternary-min-dim",
            "64", "--requests", "6", "--slots", "2", "--prompt-len", "8",
            "--gen-lens", "2,4"]
    m = serve.main(base + ["--cache", "paged", "--page-size", "4",
                           "--mesh", "1,2", "--mesh-devices", "cpu,cpu"])
    assert m["engine"] == "router" and m["replicas"] == 1
    assert m["routed"] == 6 and m["placements"] == [0] * 6
    assert [r["mesh"] for r in m["per_replica"]] == [{"axes": {"model": 2}}]
    assert m["generated_tokens"] == sum(r["generated_tokens"]
                                        for r in m["per_replica"])
    with pytest.raises(ValueError, match="needs 4 devices"):
        serve.main(base + ["--mesh", "2,2"])
    for extra in (["--static"], ["--traffic", "poisson"]):
        with pytest.raises(SystemExit, match="mesh"):
            serve.main(base + ["--mesh", "1,2", "--mesh-devices", "cpu,cpu"]
                       + extra)
