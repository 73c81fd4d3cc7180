"""Tensor-parallel training of the MoE, SSM, hybrid, encoder-decoder and
VLM families on the CPU (``launch.train.DistTrainer``: ranks are gloo
processes), held against ``repro`` at reduced widths, 2 layers, QAT in
float32 (``test_torch_family_train``'s weights: ``repro``'s init with the
weights at a threshold tie moved off it):

* the first step at tp 2 and at dp 2 x tp 2 from the same step-0
  checkpoint against ``repro``'s unsharded ``make_train_step`` on the
  global batch (metrics, parameters and AdamW moments under
  ``test_torch_family_train``'s rule: 1e-5 of each leaf's largest, except
  where the RMS gradient lies within 100 eps of 0). A MoE layer's capacity
  and aux loss are per data-parallel rank (ROADMAP C17), so mixtral and
  jamba at dp 2 x tp 2 are held to the port's one-process data-parallel
  step instead (each half batch's gradients averaged in f32);
* data-parallel ranks hold the same bits, and tensor-parallel ranks the
  same gradients for every replicated leaf;
* the SSM gated norm's all-reduce and the expert bank's row-split STE on
  two ranks against the whole computation;
* a tp 2 family mesh's checkpoint restores in one process bitwise, and
  back into the mesh bitwise;
* each family's ``param_specs`` resolved on a ``{"data": 2, "model": 2}``
  and a 16 x 16 mesh equals ``repro``'s resolution of its own specs leaf
  by leaf, except the SSM in_proj, whose placement is the port's per-head
  column set where ``repro``'s GSPMD splits the concatenation
  contiguously (ROADMAP C18);
* ``train --model-parallel 2`` on every family."""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.data import SyntheticLM as RSyntheticLM
from repro.distributed import sharding as rsharding
from repro.launch import steps as rsteps
from repro.models import LM as RLM
from repro.optim import warmup_cosine as rwarmup

from repro_torch import checkpoint as ckpt_lib
from repro_torch.checkpoint.convert import (opt_state_to_numpy,
                                            params_to_numpy)
from repro_torch.configs import get_config
from repro_torch.core import quantize
from repro_torch.data import SyntheticLM
from repro_torch.distributed import tp as tp_lib
from repro_torch.launch import steps, train
from repro_torch.models import LM, ssm
from repro_torch.optim import adamw, clip_by_global_norm, warmup_cosine
from repro_torch.optim.optimizers import tree_map

from test_torch_family_train import STEP_TOL, _kw, _repro
from test_torch_gloo_ranks import run_ranks
from test_torch_train import _close, _close_trees, _eps_dominated, _np
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_family_ranks import family_rank_checks

TIMEOUT_S = 120.0
LR, TOTAL, BATCH, SEQ = 1e-2, 10, 4, 32
ARCHS = ["mixtral-8x22b", "mamba2-130m", "jamba-v0.1-52b",
         "seamless-m4t-large-v2", "internvl2-76b"]
MOE = ("mixtral-8x22b", "jamba-v0.1-52b")
MESHES = [(1, 2), (2, 2)]


def _mesh_id(m):
    return f"dp{m[0]}_tp{m[1]}"


def _cfg(arch):
    return get_config(arch, reduced=True, **_kw(arch, 1))


def _port_params(arch):
    from repro_torch.checkpoint.convert import params_from_numpy
    return params_from_numpy(_np(_repro(arch)[0]), _cfg(arch), "cpu")


def _state(params, opt, met, cfg):
    return {"params": params_to_numpy(params, cfg),
            "m": opt_state_to_numpy(opt, cfg)["m"],
            "v": opt_state_to_numpy(opt, cfg)["v"],
            "met": {k: float(v) for k, v in met.items()}}


@functools.lru_cache(maxsize=None)
def _repro_step(arch):
    """repro's unsharded first step on the global batch of step 0."""
    rcfg = rget_config(arch, reduced=True, **_kw(arch, 1))
    rparams = _repro(arch)[0]
    rstep, ropt_init = rsteps.make_train_step(RLM(rcfg), rcfg,
                                              rwarmup(LR, 2, TOTAL))
    batch = RSyntheticLM(rcfg, BATCH, SEQ).global_batch(0)
    params, opt, met = jax.jit(rstep)(rparams, ropt_init(rparams), {
        k: jnp.asarray(v) for k, v in batch.items()})
    return {"params": _np(params), "m": _np(opt["m"]), "v": _np(opt["v"]),
            "met": {k: float(v) for k, v in met.items()}}


def _port_dp_step(arch):
    """The port's one-process data-parallel first step (C17): each half
    of the global batch's gradients, their f32 mean, the clip and AdamW."""
    cfg, params = _cfg(arch), _port_params(arch)
    model = LM(cfg, "cpu")
    batch = SyntheticLM(cfg, BATCH, SEQ).sharded_batch(0)
    halves = [steps._value_and_grad(model, params, {
        k: v[r * 2:(r + 1) * 2] for k, v in batch.items()})
        for r in range(2)]
    grads = tree_map(lambda a, b: ((a.float() + b.float()) / 2).to(a.dtype),
                     halves[0][1], halves[1][1])
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    lr = warmup_cosine(LR, 2, TOTAL)(torch.ones((), dtype=torch.int32))
    opt_init, opt_update = adamw()
    params, opt = opt_update(grads, opt_init(params), params, lr)
    loss = (halves[0][0]["loss"] + halves[1][0]["loss"]) / 2
    return _state(params, opt, {"loss": loss, "grad_norm": gnorm, "lr": lr},
                  cfg)


@pytest.fixture(scope="module")
def step0(tmp_path_factory):
    """Every family's step-0 checkpoint of the shared weights."""
    out = {}
    for arch in ARCHS:
        cfg, params = _cfg(arch), _port_params(arch)
        d = str(tmp_path_factory.mktemp(arch))
        ckpt_lib.save(d, 0, {"params": params_to_numpy(params, cfg),
                             "opt": opt_state_to_numpy(adamw()[0](params),
                                                       cfg)})
        out[arch] = d
    return out


@pytest.fixture(scope="module")
def mesh_runs(step0, tmp_path_factory):
    """Each mesh started once and rebuilt for every family: the first
    step's metrics, the gathered state and the ranks' reports; at tp 2
    (under full remat) also the state saved, restored into the mesh and
    gathered again."""
    out = {}
    for dp, tp in MESHES:
        tr = train.DistTrainer(_cfg(ARCHS[0]), data_parallel=dp,
                               model_parallel=tp, batch=BATCH, seq=SEQ,
                               lr=LR, total_steps=TOTAL, device="cpu",
                               timeout_s=TIMEOUT_S)
        try:
            for arch in ARCHS:
                # tp 2 under full remat: the backward recomputes each block
                # (the encoder's too) with its collectives, in the group
                cfg = _cfg(arch) if dp > 1 else dataclasses.replace(
                    _cfg(arch), remat="full")
                tr.build(cfg, batch=BATCH, seq=SEQ, lr=LR, total_steps=TOTAL)
                assert tr.restore(step0[arch], 0) == 0
                run = {"met": tr.step(0), "state": tr.checkpoint_tree(),
                       "report": tr.report(grads_step=1)}
                if dp == 1:
                    d = str(tmp_path_factory.mktemp(f"{arch}_tp2"))
                    ckpt_lib.save(d, 1, run["state"])
                    assert tr.restore(d, 1) == 1
                    run["ckpt"], run["again"] = d, tr.checkpoint_tree()
                out[arch, (dp, tp)] = run
        finally:
            tr.close()
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_matches_repros_unsharded_step(mesh_runs, arch, mesh):
    run = mesh_runs[arch, mesh]
    ref = _port_dp_step(arch) if mesh[0] > 1 and arch in MOE \
        else _repro_step(arch)
    for key in ("loss", "grad_norm", "lr"):
        _close(torch.tensor(run["met"][key]), ref["met"][key], STEP_TOL)
    state = run["state"]
    assert int(state["opt"]["step"]) == 1
    loose = jax.tree.map(np.logical_or, _eps_dominated(ref["v"], 1),
                         _eps_dominated(_np(state["opt"]["v"]), 1))
    _close_trees(state["params"], ref["params"], STEP_TOL, loose,
                 1.1 * ref["met"]["lr"])
    _close_trees(state["opt"]["m"], ref["m"], STEP_TOL, loose, 0.1 * 2e-6)
    _close_trees(state["opt"]["v"], ref["v"], STEP_TOL, loose, 0.05 * 1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_data_parallel_ranks_hold_the_same_bits(mesh_runs, arch):
    rep = mesh_runs[arch, (2, 2)]["report"]
    counts = train.check_replicas(rep)
    assert counts["leaves_compared"] == 2 * len(rep[0]["params"]) * 3


@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_leaves_get_equal_grads(mesh_runs, arch):
    """Norms and a MoE router are whole on every rank of a replica and
    get equal gradients; the split leaves' differ (an SSM in_proj counts
    as split: its z, x and dt columns are; the embedding table, split by
    vocabulary rows, is the first leaf)."""
    for mesh in MESHES:
        rep = mesh_runs[arch, mesh]["report"]
        counts = train.check_replicas(rep)
        n_rep = sum(not s for s in rep[0]["split"])
        assert n_rep >= 3 and rep[0]["split"][0]   # 2 layers' norms, final
        assert counts["replicated_grads_compared"] == mesh[0] * n_rep
        split = [i for i, s in enumerate(rep[0]["split"]) if s]
        assert split and all(rep[0]["grads"][i] != rep[1]["grads"][i]
                             for i in split)


@pytest.fixture(scope="module")
def rank_checks():
    rng = np.random.default_rng(5)
    y, z, g_out = (rng.standard_normal((3, 5, 64)).astype(np.float32)
                   for _ in range(3))
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    w_bank = rng.standard_normal((3, 64, 24)).astype(np.float32)
    g_bank = rng.standard_normal((3, 64, 24)).astype(np.float32)
    args = (y, z, scale, g_out, w_bank, g_bank)
    return args, run_ranks(2, family_rank_checks, *args)


def test_gated_norm_all_reduce_matches_the_whole(rank_checks):
    (y, z, scale, g_out, *_), got = rank_checks
    ys, zs, ss = (torch.from_numpy(a).requires_grad_()
                  for a in (y, z, scale))
    out = ssm._gated_norm(ys, zs, ss, 1e-5)
    gy, gz, gs = torch.autograd.grad(out, [ys, zs, ss],
                                     torch.from_numpy(g_out))
    for key, want in (("norm", out), ("gy", gy), ("gz", gz)):
        _close(np.concatenate([r[key] for r in got], axis=-1),
               want.detach(), 1e-5)
    _close(np.concatenate([r["gscale"] for r in got]), gs, 1e-5)


def test_bank_row_split_ste_matches_the_whole_bank(rank_checks):
    """Each expert's columns ternarize over all of its rows: the row
    shards' statistics summed over the group give the whole bank's codes,
    scales and pass-through gradient."""
    (*_, w_bank, g_bank), got = rank_checks
    wt = torch.from_numpy(w_bank).requires_grad_()
    y = quantize.ste_ternarize(wt, 0.7)
    (gw,) = torch.autograd.grad(y, [wt], torch.from_numpy(g_bank))
    ys = np.concatenate([r["ste_y"] for r in got], axis=-2)
    gws = np.concatenate([r["ste_g"] for r in got], axis=-2)
    np.testing.assert_array_equal(np.sign(ys), np.sign(y.detach().numpy()))
    np.testing.assert_allclose(ys, y.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(gws, gw.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_mesh_checkpoint_restores_bitwise(mesh_runs, arch):
    """The tp 2 mesh's checkpoint read in one process is the gathered
    state bit for bit, and restored into the mesh (its shards cut again)
    it gathers to the same bits."""
    run = mesh_runs[arch, (1, 2)]
    step, flat = ckpt_lib.restore(run["ckpt"])
    assert step == 1
    one = ckpt_lib.unflatten(flat)
    for got in (one, run["again"]):
        a = jax.tree_util.tree_leaves(got)
        b = jax.tree_util.tree_leaves(run["state"])
        assert len(a) == len(b)
        assert all(np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(a, b))
    # and the one process's model evaluates it
    params = train.params_from_numpy(one["params"], _cfg(arch), "cpu")
    with torch.no_grad():
        loss, _ = LM(_cfg(arch), "cpu").loss(
            params, SyntheticLM(_cfg(arch), BATCH, SEQ).sharded_batch(2))
    assert np.isfinite(float(loss))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    return {path: tree}


@pytest.mark.parametrize("sizes", [dict(data=2, model=2),
                                   dict(data=16, model=16)],
                         ids=["2x2", "16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_resolve_as_repros(arch, sizes):
    cfg = _cfg(arch)
    rcfg = rget_config(arch, reduced=True, **_kw(arch, 1))
    rlm = RLM(rcfg)
    rshapes, rspecs = rlm.init_with_specs_abstract()
    stub = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
    shapes, got = steps.model_shardings(LM(cfg, "cpu"), cfg, sizes)
    got, shapes = _flat(got), _flat(shapes)

    def want(path):
        """repro's resolution of the leaf at the port's ``path``."""
        if path[0] in ("layers", "enc_layers"):
            block = (f"block{path[1] % rlm.period}" if path[0] == "layers"
                     else "enc_block")
            node, snode = rspecs[block], rshapes[block]
            for k in path[2:]:
                node, snode = node[k], snode[k]
            res = tuple(rsharding.resolve_spec(node, snode.shape, stub,
                                               cfg.fsdp))
            return res[1:]                       # the stacked layer axis
        node, snode = rspecs, rshapes
        for k in path:
            node, snode = node[k], snode[k]
        return tuple(rsharding.resolve_spec(node, snode.shape, stub,
                                            cfg.fsdp))

    c18 = 0
    for path, spec in got.items():
        if spec is None:
            continue
        if "in_proj" in path:
            # C18: the logical spec resolves alike, the placement does not
            assert spec == want(path), path
            if tp_lib.ssm_split(cfg, sizes["model"]) and path[-1] == "w":
                cols = tp_lib.ssm_columns(cfg, 0, sizes["model"])[0]
                n = shapes[path].shape[-1]
                assert not torch.equal(
                    cols, torch.arange(n // sizes["model"]))
                c18 += 1
            continue
        assert spec == want(path), (path, spec, want(path))
    if tp_lib.ssm_split(cfg, sizes["model"]):
        assert c18 == sum(k == "ssm" for k, _ in LM(cfg, "cpu").kinds)


def test_family_mesh_init_gathers_one_process_draw():
    """``DistTrainer.init`` on a MoE model's tp 2 mesh: every rank draws
    the whole model from the seed and keeps its shards (whole experts a
    rank), and the gathered state is the one process's draw bitwise."""
    cfg = dataclasses.replace(_cfg("mixtral-8x22b"), num_layers=1)
    want = LM(cfg, "cpu").init(torch.Generator().manual_seed(3))
    tr = train.DistTrainer(cfg, data_parallel=1, model_parallel=2,
                           batch=BATCH, seq=SEQ, lr=LR, total_steps=TOTAL,
                           device="cpu", timeout_s=TIMEOUT_S)
    try:
        tr.init(3)
        bank = tr.me.params["layers"][0]["ffn"]["w_in"]
        got = tr.state(params_only=True)["params"]
    finally:
        tr.close()
    assert bank.shape[0] == cfg.num_experts // 2
    a, b = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_families_tensor_parallel(arch, tmp_path):
    out = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--model-parallel", "2", "--steps", "2", "--batch",
                      "2", "--seq", "16", "--set", "grad_accum=1",
                      "--log-every", "1", "--ckpt-dir", str(tmp_path)])
    assert out["steps"] == 2 and np.isfinite(out["last_loss"])
    assert ckpt_lib.latest_step(str(tmp_path)) == 2
