"""Tensor-parallel serving of the MoE, SSM and hybrid families on the CPU,
at tp 2 (two gloo processes: the engine spawns its follower rank), held
against the port at tp 1 and ``repro``'s single-device engine on the same
packed weights (``test_torch_families``' reduced widths, 2 layers, float32):

* mixtral with 4 experts (expert parallelism: two whole experts a rank)
  and with 3 (the expert d_ff split: w_in and w_gate by columns, w_out by
  rows); mamba2 split by SSM heads, dense and paged, and with one head of
  256 (the head count does not divide: the mixer stays whole); jamba
  (SSM heads, attention heads, the MLP and expert parallelism), dense,
  paged bf16 and paged int8;
* streams equal, or split at a logged near tie (``test_torch_tp``'s
  rule: both tokens within ``TIE_TOL`` of max|logit|), and the first
  decode step's logits within ``LOGIT_TOL`` of max|logit| of tp 1's;
* every rank routes alike: each MoE layer's capacity pick (``tok_sel``)
  of a prefill is equal on both ranks and to one process's;
* ``serve --mesh 1,2`` on a reduced MoE, SSM and hybrid model."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import LM as RLM
from repro.models import layers as rlayers
from repro.serving import ContinuousScheduler as RScheduler

from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.distributed import tp as tp_lib
from repro_torch.models import LM, moe

from test_torch_families import _kw
from test_torch_gloo_ranks import run_ranks
from test_torch_model import repro_tree_to_numpy
from test_torch_tp import ENGINE, LOGIT_TOL, _mesh, _serve_port, _streams, \
    _workload
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_family_ranks import routes_rank

# case -> (arch, config overrides, engine options)
CASES = {
    "mixtral_expert_parallel": ("mixtral-8x22b", {}, {}),
    "mixtral_ff_split": ("mixtral-8x22b", dict(num_experts=3), {}),
    "mamba2_dense": ("mamba2-130m", {}, {}),
    "mamba2_paged": ("mamba2-130m", {}, dict(cache="paged", page_size=4)),
    "mamba2_whole": ("mamba2-130m", dict(ssm_head_dim=256), {}),
    "jamba_dense": ("jamba-v0.1-52b", {}, {}),
    "jamba_paged_bf16": ("jamba-v0.1-52b", {},
                         dict(cache="paged", page_size=4)),
    "jamba_paged_int8": ("jamba-v0.1-52b", {},
                         dict(cache="paged", page_size=4, kv_dtype="int8")),
}


def _pair(arch, **over):
    """(repro cfg, repro params, port cfg, port params): the same packed
    weights (``test_torch_families._pair`` with config overrides)."""
    kw = dict(_kw(arch, True), **over)
    rcfg = rget_config(arch, reduced=True, **kw)
    pcfg = get_config(arch, reduced=True, **kw)
    rparams = rlayers.pack_params(RLM(rcfg).init(jax.random.PRNGKey(0)),
                                  rcfg)
    rcfg = dataclasses.replace(rcfg, quantization="ternary_packed")
    pcfg = dataclasses.replace(pcfg, quantization="ternary_packed")
    return rcfg, rparams, pcfg, params_from_numpy(
        repro_tree_to_numpy(rparams), pcfg, "cpu")


def _placement(cfg, tp):
    return (tp_lib.moe_split(cfg, tp), tp_lib.ssm_split(cfg, tp),
            tp_lib.attention_split(cfg, tp))


def test_cases_cover_every_placement():
    """The cases reach expert parallelism, the d_ff split, the SSM head
    split and its whole-mixer fallback; attention splits by heads in
    every case with attention (two K/V heads over two ranks)."""
    seen = {name: _placement(get_config(arch, reduced=True, **dict(
        _kw(arch, True), **over)), 2) for name, (arch, over, _) in
        CASES.items()}
    assert seen["mixtral_expert_parallel"][0] == "e"
    assert seen["mixtral_ff_split"][0] == "ff"
    assert seen["mamba2_dense"][1] and not seen["mamba2_whole"][1]
    assert seen["jamba_dense"] == ("e", True, "heads")
    assert {p[2] for name, p in seen.items()
            if not name.startswith("mamba2")} == {"heads"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp2_streams_equal_tp1_and_repros(case):
    arch, over, kw = CASES[case]
    rcfg, rparams, pcfg, pparams = _pair(arch, **over)
    prompts, gens = _workload(pcfg.vocab_size, seed=13)
    one, first1, _ = _serve_port(pcfg, pparams, prompts, gens, **kw)
    two, first2, metrics = _serve_port(pcfg, pparams, prompts, gens,
                                       mesh=_mesh(), **kw)
    scale = float(first1.abs().max())
    assert float((first2 - first1).abs().max()) <= LOGIT_TOL * scale
    _streams(pcfg, pparams, prompts, one, two)
    assert [len(t) for t in two] == gens         # every budget met
    assert metrics["decode_steps"] > 0
    reng = RScheduler(rcfg, **ENGINE, **kw)
    reng.load(rparams)
    rreqs = [reng.submit(p, g) for p, g in zip(prompts, gens)]
    reng.run()
    _streams(pcfg, pparams, prompts,
             [np.asarray(r.tokens, np.int32) for r in rreqs], two)


@pytest.mark.parametrize("over", [{}, dict(num_experts=3)],
                         ids=["expert_parallel", "ff_split"])
def test_every_rank_routes_alike(over):
    """Routing runs on the replicated activations, so every rank picks
    the same tokens for each expert (a split pick would drop other tokens
    on each rank, C11) and one process picks them too."""
    _, _, pcfg, pparams = _pair("mixtral-8x22b", **over)
    tokens = np.random.default_rng(3).integers(
        0, pcfg.vocab_size, size=(3, 12)).astype(np.int64)
    ranks = run_ranks(2, routes_rank, pcfg, pparams, tokens)
    with torch.no_grad(), moe.recorded_routes() as log:
        _, want = LM(pcfg, "cpu").prefill(
            pparams, {"tokens": torch.as_tensor(tokens)}, 13)
    assert len(log) == len(ranks[0][0]) == 2
    for got, _ in ranks:
        for a, b in zip(got, log):
            np.testing.assert_array_equal(a, b.numpy())
    want = want.float().numpy()
    for _, logits in ranks:
        assert np.abs(logits - want).max() <= LOGIT_TOL * np.abs(want).max()


def test_engine_rank_routes_agree():
    """``ContinuousScheduler.rank_routes``: the leader and its follower
    rank pick the same tokens for every expert of jamba's MoE layer, as
    one device does."""
    from repro_torch.serving import ContinuousScheduler
    _, _, pcfg, pparams = _pair("jamba-v0.1-52b")
    tokens, _ = _workload(pcfg.vocab_size, seed=14)
    one = ContinuousScheduler(pcfg, device="cpu", **ENGINE)
    one.load(pparams)
    (want,) = one.rank_routes(tokens)
    eng = ContinuousScheduler(pcfg, device="cpu", mesh=_mesh(), **ENGINE)
    try:
        eng.load(pparams)
        ranks = eng.rank_routes(tokens)
    finally:
        eng.close()
    assert len(ranks) == 2 and len(want) == 1
    for got in ranks:
        assert len(got) == 1 and np.array_equal(got[0], want[0])


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "mamba2-130m",
                                  "jamba-v0.1-52b"])
def test_serve_mesh_cli_serves_families(arch):
    """The reduced family configs (latent weights: their quantization is
    "none"), over the paged cache where the model has no sliding
    window."""
    from repro_torch.launch import serve
    cache = [] if get_config(arch).sliding_window else [
        "--cache", "paged", "--page-size", "4"]
    m = serve.main(["--device", "cpu", "--arch", arch, "--reduced",
                    "--requests", "4", "--slots", "2", "--prompt-len", "8",
                    "--gen-lens", "2,4", "--mesh", "1,2", "--mesh-devices",
                    "cpu,cpu"] + cache)
    assert m["engine"] == "router" and m["routed"] == 4
    assert [r["mesh"] for r in m["per_replica"]] == [{"axes": {"model": 2}}]
    assert m["generated_tokens"] == sum(r["generated_tokens"]
                                        for r in m["per_replica"]) > 0


def test_ssm_cache_rows_follow_the_head_split():
    """``cache_sharding`` / ``device_put_cache`` of an SSM stack at tp 2:
    a state row splits by heads, a conv row keeps the rank's x channels
    and all of B and C (``ssm_columns``), each the shape of the local
    model's own rows; with one head of 256 they stay whole."""
    for over, split in (({}, True), (dict(ssm_head_dim=256), False)):
        cfg = get_config("mamba2-130m", reduced=True, **over)
        whole = LM(cfg, "cpu").init_cache(3, 8, torch.float32)["layers"][0]
        for t in whole.values():
            t.normal_()
        spec = tp_lib.cache_sharding(whole, cfg, {"model": 2})
        assert spec == ({"state": (None, "model"), "conv": (None, None,
                                                           "model")}
                        if split else {"state": (), "conv": ()})
        for rank in (0, 1):
            got = tp_lib.device_put_cache(whole, cfg, {"model": 2},
                                          rank=rank)
            local = LM(tp_lib.local_config(cfg, 2), "cpu").init_cache(
                3, 8, torch.float32)["layers"][0]
            assert {k: v.shape for k, v in got.items()} == {
                k: v.shape for k, v in local.items()}
            if split:
                h = cfg.ssm_heads // 2
                cols = tp_lib.ssm_columns(cfg, rank, 2)[1]
                assert torch.equal(got["state"], whole["state"][
                    :, rank * h:(rank + 1) * h])
                assert torch.equal(got["conv"], whole["conv"][..., cols])


def test_engine_keeps_repros_refusals():
    """encoder-decoder and VLM configs stay the static server's, mesh or
    not, with a message that names no ROADMAP item."""
    for arch in ("seamless-m4t-large-v2", "internvl2-76b"):
        with pytest.raises(ValueError, match="static BatchedServer") as e:
            from repro_torch.serving import ContinuousScheduler
            ContinuousScheduler(get_config(arch, reduced=True), device="cpu",
                                mesh=_mesh(), **ENGINE)
        assert "A12" not in str(e.value)
