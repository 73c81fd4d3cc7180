"""Sharded training state (``cfg.fsdp``) in the port against ``repro``:
each rank's slice of every leaf has the shape of ``repro``'s
``NamedSharding`` shard on (2, 1), (4, 1) and (2, 2) meshes for every
registered architecture (reduced, ``fsdp=True``; at tp 2 the differences
are the ones ROADMAP C15 and C18 name); and the distributed trainer on
gloo CPU ranks (``launch.train.DistTrainer``) on reduced ternary-paper
with ``fsdp=True`` at dp 2, dp 2 with ``grad_accum`` 2 and dp 2 x tp 2
(under full remat): the first step's gradients, the data group's mean
before the clip, gathered, bitwise equal to the whole-state mesh's
(within f32 rounding under accumulation, whose reduce-scatter of each
microbatch sums in another order); steps 1 and 3 within
``tests/test_torch_dist_train.py``'s rule of ``repro``'s unsharded step
(GSPMD's semantics); ``state_bytes`` exactly the rank's slices' bytes
and the dry run's for the same cell; the collectives the step runs;
checkpoints both ways between the mesh and one process; the compressed
trainer keeping whole state as ``repro``'s does."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config as rget_config
from repro.data import SyntheticLM as RSyntheticLM
from repro.distributed import sharding as rsharding
from repro.launch import steps as rsteps
from repro.models import LM as RLM
from repro.optim import warmup_cosine as rwarmup

from repro_torch import checkpoint as ckpt_lib
from repro_torch.checkpoint.convert import (opt_state_to_numpy,
                                            params_to_numpy)
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticLM
from repro_torch.distributed import fsdp
from repro_torch.distributed import tp as tp_lib
from repro_torch.launch import dryrun, steps, train
from repro_torch.models import LM
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import tree_leaves, tree_map

from test_torch_dist_train import (ARGS, BATCH, EVAL_STEP, LR, SEED, SEQ,
                                   TOTAL, _check_state, _trainer)
from test_torch_gloo_ranks import run_ranks
from test_torch_train import KW, _close, _eps_dominated, _np, _pair
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_family_ranks import fsdp_grads_rank

SHAPE_MESHES = [(2, 1), (4, 1), (2, 2)]
# (label, mesh, config overrides): the sharded runs and their whole-state
# twins; dp 2 x tp 2 runs under full remat (the backward gathers again)
RUNS = {"dp2": ((2, 1), {}), "dp2_accum2": ((2, 1), {"grad_accum": 2}),
        "dp2_tp2": ((2, 2), {"remat": "full"})}


# ---------------------------------------------------------------------------
# placement against repro's shards
# ---------------------------------------------------------------------------

def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, path + (k,)).items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, path + (i,)).items()}
    return {path: tree}


@functools.lru_cache(maxsize=None)
def _repro_abstract(arch):
    rlm = RLM(rget_config(arch, reduced=True, fsdp=True))
    shapes, specs = rlm.init_with_specs_abstract()
    return rlm.period, shapes, specs


def _repro_shard_shape(arch, path, amesh):
    """``repro``'s shard shape of the leaf at the port's ``path`` (its
    stacked layer axis dropped)."""
    period, shapes, specs = _repro_abstract(arch)
    stacked = path[0] in ("layers", "enc_layers")
    if stacked:
        node, snode = (specs, shapes)
        block = (f"block{path[1] % period}" if path[0] == "layers"
                 else "enc_block")
        node, snode = node[block], snode[block]
        rest = path[2:]
    else:
        node, snode, rest = specs, shapes, path
    for k in rest:
        node, snode = node[k], snode[k]
    spec = rsharding.resolve_spec(node, snode.shape, amesh, True)
    shape = NamedSharding(amesh, spec).shard_shape(snode.shape)
    return tuple(shape[1:] if stacked else shape)


def _c15_c18(cfg, tp, path):
    """Whether ROADMAP C15 or C18 names a difference at ``path``:
    attention whole where the head rule keeps it so, a K/V head's columns
    whole where it replicates them, q's and o's whole heads where tp does
    not divide the query heads, an SSM mixer's columns placed by
    heads, its conv channels and per-head vectors with them (or the whole
    mixer where its heads do not split)."""
    if tp == 1:
        return False
    for node in ("mixer", "cross"):
        if node in path:
            leaf = path[path.index(node) + 1]
            if leaf in ("q", "k", "v", "o"):
                place = tp_lib.attention_split(cfg, tp)
                uneven = (cfg.num_heads + cfg.head_pad) % tp != 0
                return place is None or (place == "replicate"
                                         and (leaf in ("k", "v") or uneven))
            return True                             # an SSM mixer's leaf
    return False


@pytest.mark.parametrize("sizes", SHAPE_MESHES,
                         ids=lambda s: f"dp{s[0]}_tp{s[1]}")
@pytest.mark.parametrize("arch", list_archs())
def test_shard_shapes_equal_repros(arch, sizes):
    """Every rank's slice of every leaf (model axis first, then the data
    axes) has the shape of ``repro``'s shard of it under
    ``resolve_spec`` with ``fsdp=True``; at tp 2 only C15's and C18's
    leaves differ."""
    dp, tp = sizes
    cfg = get_config(arch, reduced=True, fsdp=True)
    mesh = tp_lib.Mesh(("data", "model"), sizes, ("meta",) * (dp * tp))
    amesh = AbstractMesh(sizes, ("data", "model"))
    model = LM(cfg, "cpu")
    shapes, _ = steps.model_shardings(model, cfg, mesh)
    specs = model.param_specs()
    marks = fsdp.data_marks(shapes, specs, mesh, True)
    named = split = 0
    for m in range(tp):
        tp_shards, _ = tp_lib.strip_marks(tp_lib.shard_params(
            shapes, specs, mesh, rank=m, cfg=cfg, latent=True))
        for d in range(dp):
            got = _flat(fsdp.shard_data(tp_shards, marks, d, dp))
            for path, t in got.items():
                want = _repro_shard_shape(arch, path, amesh)
                if tuple(t.shape) != want:
                    assert _c15_c18(cfg, tp, path), (path, t.shape, want)
                    named += 1
    for path, mark in _flat(marks).items():
        split += mark is not None
    assert split > 0
    if tp == 1:
        assert named == 0


# ---------------------------------------------------------------------------
# the trainer on gloo ranks
# ---------------------------------------------------------------------------

def _reference(ckpt_dir, **over):
    """repro's unsharded steps 1 and 3 from ``_pair``'s weights (with
    ``over``), as ``test_torch_dist_train``'s reference fixture; the
    step-0 checkpoint written once."""
    rcfg, rparams, pcfg, pparams = _pair(SEED, **over)
    if ckpt_dir is not None:
        ckpt_lib.save(ckpt_dir, 0, {
            "params": params_to_numpy(pparams, pcfg),
            "opt": opt_state_to_numpy(adamw()[0](pparams), pcfg)})
    rstep, ropt_init = rsteps.make_train_step(RLM(rcfg), rcfg,
                                              rwarmup(LR, 2, TOTAL))
    rstep = jax.jit(rstep)
    ropt = ropt_init(rparams)
    data = RSyntheticLM(rcfg, BATCH, SEQ)
    out, lr_sum, loose = {}, 0.0, None
    for i in range(3):
        rparams, ropt, rmet = rstep(rparams, ropt, {
            k: jnp.asarray(v) for k, v in data.global_batch(i).items()})
        lr_sum += float(rmet["lr"])
        now = _eps_dominated(_np(ropt["v"]), i + 1)
        loose = now if loose is None else jax.tree.map(np.logical_or,
                                                       loose, now)
        if i in (0, 2):
            out[i + 1] = {"params": _np(rparams), "m": _np(ropt["m"]),
                          "v": _np(ropt["v"]), "loose": loose,
                          "lr_sum": lr_sum,
                          "met": {k: float(v) for k, v in rmet.items()}}
    return out


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    ckpt0 = str(tmp_path_factory.mktemp("step0"))
    return ckpt0, {1: _reference(ckpt0), 2: _reference(None, grad_accum=2)}


def _cfg(fsdp_on, **over):
    return get_config("ternary-paper", reduced=True, **KW, fsdp=fsdp_on,
                      **over)


def _run(tr, cfg, ckpt0, steps_to_take=3, compress=False):
    """Rebuild ``tr`` for ``cfg``, restore step 0, report the first
    step's gradients; then ``steps_to_take`` steps with the gathered
    state after steps 1 and 3."""
    tr.build(cfg, batch=BATCH, seq=SEQ, lr=LR, total_steps=TOTAL,
             compress=compress)
    assert tr.restore(ckpt0, 0) == 0
    out = {"restored": tr.checkpoint_tree(),
           "report0": tr.report(grads_step=0)}
    if steps_to_take:
        out["eval0"] = tr.eval_loss(EVAL_STEP)
        out.update(met=[tr.step(0)], comm=tr.last_comm)
        out["state1"] = tr.checkpoint_tree()
        for i in range(1, steps_to_take):
            out["met"].append(tr.step(i))
        out["state3"] = tr.checkpoint_tree()
        out["report3"] = tr.report()
    return out


@pytest.fixture(scope="module")
def dp2(refs):
    """The dp 2 ranks, kept for the module (the checkpoint test restores
    into them)."""
    tr = _trainer(_cfg(True), 2, 1)
    yield tr
    tr.close()


@pytest.fixture(scope="module")
def runs(refs, dp2):
    """Each label's sharded run and its whole-state twin's first-step
    report; the compressed trainer on the fsdp config."""
    ckpt0, _ = refs
    out = {}
    for label, (mesh, over) in RUNS.items():
        tr = dp2 if mesh == (2, 1) else _trainer(_cfg(True, **over), *mesh)
        try:
            out[label, "whole"] = _run(tr, _cfg(False, **over), ckpt0, 0)
            out[label, "fsdp"] = _run(tr, _cfg(True, **over), ckpt0)
        finally:
            if tr is not dp2:
                tr.close()
    out["compress"] = _run(dp2, _cfg(True), ckpt0, 0, compress=True)
    return out


@pytest.mark.parametrize("label", ["dp2", "dp2_tp2"])
def test_first_step_grads_equal_the_whole_state_meshs(runs, label):
    """The first step's gradients, reduce-scattered into the slices and
    gathered, are the whole-state mesh's f32 all-reduce mean bit for bit
    (two ranks: one sum of two); the ranks' own gradients too."""
    whole, sharded = runs[label, "whole"], runs[label, "fsdp"]
    for w, s in zip(whole["report0"], sharded["report0"]):
        assert s["sharded"] and not w["sharded"]
        assert s["grads_synced"] == w["grads_synced"]
    a = jax.tree.leaves(sharded["restored"])
    b = jax.tree.leaves(whole["restored"])
    assert len(a) == len(b)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def mean_grads():
    """Two gloo ranks' whole-state and sharded mean gradients at
    ``grad_accum`` 1 and 2 (``fsdp_grads_rank``), one spawn for both."""
    _, _, _, params = _pair(SEED)
    cfgs = [_cfg(True, grad_accum=a) for a in (1, 2)]
    batch = {k: v.numpy() for k, v in
             SyntheticLM(cfgs[0], BATCH, SEQ).sharded_batch(0).items()}
    got = run_ranks(2, fsdp_grads_rank, cfgs, params, batch)
    return {a: [rank[i] for rank in got] for i, a in enumerate((1, 2))}


@pytest.mark.parametrize("accum", [1, 2])
def test_gathered_mean_gradient_against_the_whole_states(mean_grads, accum):
    """Two gloo ranks, the data group's mean gradient before the clip:
    at ``grad_accum`` 1 the slices' reduce-scatter gathered equals the
    whole state's all-reduce bit for bit; at 2 each microbatch's gradient
    is reduce-scattered (f32), so the mean sums in another order than the
    all-reduce of the accumulated gradient: within 1e-6 of each leaf's
    magnitude, and both ranks hold the same bits."""
    got = mean_grads[accum]
    for whole, sharded in got:
        a, b = jax.tree.leaves(whole), jax.tree.leaves(sharded)
        assert len(a) == len(b)
        if accum == 1:
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            for x, y in zip(a, b):
                _close(y, x, 1e-6)
    for x, y in zip(jax.tree.leaves(got[0][1]), jax.tree.leaves(got[1][1])):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("steps_taken,tol", [(1, 1e-5), (3, 1e-4)])
@pytest.mark.parametrize("label", list(RUNS))
def test_fsdp_mesh_matches_repros_unsharded_step(runs, refs, label,
                                                 steps_taken, tol):
    """``test_torch_dist_train``'s rule: loss, grad norm, lr, every
    parameter and AdamW moment after 1 and 3 steps against ``repro``'s
    unsharded step (``grad_accum`` 2 against ``repro``'s at 2)."""
    accum = RUNS[label][1].get("grad_accum", 1)
    ref = refs[1][accum][steps_taken]
    run = runs[label, "fsdp"]
    met = run["met"][steps_taken - 1]
    for key in ("loss", "grad_norm", "lr"):
        _close(torch.tensor(met[key]), ref["met"][key], tol)
    state = run[f"state{steps_taken}"]
    assert int(state["opt"]["step"]) == steps_taken
    _check_state(state, ref, tol)


def _expected_state_bytes(cfg, dp, tp, d, m):
    """The bytes of rank (d, m)'s params, m and v, from the whole tree
    cut by hand: the tensor-parallel slices, then each data mark's block."""
    _, _, _, whole = _pair(SEED)
    mesh = tp_lib.Mesh(("data", "model"), (dp, tp), ("cpu",) * (dp * tp))
    specs = LM(cfg, "cpu").param_specs()
    marks = fsdp.data_marks(whole, specs, mesh, True)
    tp_marks = {}
    if tp > 1:
        _, tp_marks = tp_lib.strip_marks(tp_lib.shard_params(
            whole, specs, mesh, rank=m, cfg=cfg, latent=True))
    mine = tp_lib.shard_tree(whole, tp_marks, m, tp)
    total = 0
    for t, mark in zip(tree_leaves(mine), tree_leaves(
            tree_map(lambda _, k: k, mine, marks))):
        n = t.numel() // (dp if mark is not None else 1)
        total += 3 * n * 4                       # f32 params, m and v
    return total


@pytest.mark.parametrize("label", list(RUNS))
def test_state_bytes_are_the_ranks_slices_and_the_dry_runs(runs, label):
    """Each rank's ``state_bytes`` is its slices' bytes exactly, about
    1/dp of the whole-state twin's, and equals the dry run's
    ``state_size_in_bytes`` for rank 0 of the same cell."""
    (dp, tp), over = RUNS[label]
    cfg = _cfg(True, **over)
    whole = runs[label, "whole"]["report0"]
    reports = runs[label, "fsdp"]["report0"]
    for rep, w in zip(reports, whole):
        assert rep["state_bytes"] == _expected_state_bytes(
            cfg, dp, tp, rep["d"], rep["m"])
        assert w["state_bytes"] / dp <= rep["state_bytes"] \
            < 0.51 * w["state_bytes"]
    step, args, _ = dryrun.rank_step(
        cfg, ShapeConfig("train", SEQ, BATCH, "train"),
        dryrun.parse_mesh(f"{dp}x{tp}"))
    assert fsdp.state_bytes(args[0], args[1]) == reports[0]["state_bytes"]


@pytest.mark.parametrize("label", list(RUNS))
def test_replicas_compare_the_gathered_state(runs, label):
    """``check_replicas`` holds the data ranks' state gathered over the
    data group equal (the norms whole on every rank, the slices put
    together alike) after 3 steps; every rank at step 3."""
    (dp, tp), _ = RUNS[label]
    rep = runs[label, "fsdp"]["report3"]
    counts = train.check_replicas(rep)
    assert counts["leaves_compared"] == (dp - 1) * tp * len(
        rep[0]["params"]) * 3
    assert [r["step"] for r in rep] == [3] * (dp * tp)
    assert all(r["sharded"] for r in rep)


def test_held_out_loss_of_the_slices_is_one_process_loss(runs):
    """The mesh's loss on a held-out batch (its slices gathered at use,
    no gradient) equals one process's on the whole weights."""
    _, _, pcfg, pparams = _pair(SEED)
    batch = SyntheticLM(pcfg, BATCH, SEQ).sharded_batch(EVAL_STEP)
    with torch.no_grad():
        want = float(LM(pcfg, "cpu").loss(pparams, batch)[0])
    for label in RUNS:
        got = runs[label, "fsdp"]["eval0"]
        assert abs(got - want) <= 1e-5 * abs(want), label


def test_the_step_gathers_and_reduce_scatters_each_slice(runs):
    """dp 2, no remat: each sharded leaf is all-gathered once and its
    gradient reduce-scattered once; the whole leaves' gradients go in one
    f32 all-reduce, then the norm's one and the loss's one. Under full
    remat (dp 2 x tp 2) each block's slices are gathered again in the
    backward."""
    _, _, _, whole = _pair(SEED)
    cfg = _cfg(True)
    mesh = {"data": 2, "model": 1}
    marks = fsdp.data_marks(whole, LM(cfg, "cpu").param_specs(), mesh, True)
    n = sum(m is not None for m in tree_leaves(marks))
    per_block = sum(m is not None for m in tree_leaves(marks["layers"]))
    assert runs["dp2", "fsdp"]["comm"]["data"]["calls"] == 2 * n + 3
    assert runs["dp2_tp2", "fsdp"]["comm"]["data"]["calls"] \
        == 2 * n + 3 + per_block
    whole_calls = runs["dp2", "whole"]["report0"]
    assert whole_calls[0]["sharded"] is False


def test_compressed_trainer_keeps_whole_state(runs):
    """``--compress-grads`` on an fsdp config: every rank holds the whole
    params and moments (``repro``'s shard_map trainer replicates them)."""
    comp = runs["compress"]["report0"]
    whole = runs["dp2", "whole"]["report0"]
    for c, w in zip(comp, whole):
        assert not c["sharded"]
        assert c["state_bytes"] == w["state_bytes"]
        assert c["params"] == w["params"]
    assert "grads_synced" not in comp[0]


def test_one_process_ignores_fsdp():
    """One process (``--data-parallel 1``) holds whole state whatever
    ``cfg.fsdp`` says: a step with fsdp set gives the same bits."""
    out = {}
    for flag in (False, True):
        model, data, step, init = train.build(_cfg(flag), BATCH, SEQ, LR,
                                              TOTAL, "cpu")
        state = init(SEED)
        params, _, met = step(state["params"], state["opt"],
                              data.sharded_batch(0))
        out[flag] = (params_to_numpy(params, _cfg(flag)), met)
    a, b = (jax.tree.leaves(out[f][0]) for f in (False, True))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert float(out[False][1]["loss"]) == float(out[True][1]["loss"])


def test_checkpoints_cross_between_an_fsdp_mesh_and_one_process(
        dp2, refs, tmp_path):
    """The restored step-0 checkpoint gathers back bit for bit; the fsdp
    mesh's step-2 checkpoint (under the supervisor) resumes in one
    process to step 3, and the mesh restores that bit for bit and trains
    on from it."""
    d = str(tmp_path)
    sup, _, _ = train.make_dist_supervisor(
        _cfg(True), data_parallel=2, model_parallel=1, batch=4, seq=32,
        lr=3e-3, steps=2, ckpt_dir=d, ckpt_every=2, device="cpu",
        trainer=dp2)
    dp2.build(_cfg(True), batch=4, seq=32, lr=3e-3, total_steps=2,
              compress=False)
    _, history = sup.run(2)
    assert [s for s, _ in history] == [0, 1]
    assert ckpt_lib.latest_step(d) == 2
    second = train.main(ARGS + ["--set", "fsdp=true", "--ckpt-dir", d,
                                "--steps", "3", "--ckpt-every", "3"])
    assert second["steps"] == 1
    dp2.build(_cfg(True), batch=4, seq=32, lr=3e-3, total_steps=3,
              compress=False)
    assert dp2.restore(d, 3) == 3
    saved = ckpt_lib.restore(d, 3)[1]
    ckpt_lib.save(str(tmp_path / "again"), 3, dp2.checkpoint_tree())
    again = ckpt_lib.restore(str(tmp_path / "again"), 3)[1]
    assert set(saved) == set(again)
    for k in saved:
        assert torch.equal(saved[k], again[k]), k
    assert np.isfinite(dp2.step(3)["loss"])
    assert all(r["sharded"] for r in dp2.report())
    ckpt0, _ = refs
    dp2.build(_cfg(True), batch=BATCH, seq=SEQ, lr=LR, total_steps=TOTAL)
    assert dp2.restore(ckpt0, 0) == 0
    restored = dp2.checkpoint_tree()
    flat0 = ckpt_lib.restore(ckpt0, 0)[1]
    ckpt_lib.save(str(tmp_path / "zero"), 0, restored)
    for k, v in ckpt_lib.restore(str(tmp_path / "zero"), 0)[1].items():
        assert torch.equal(v, flat0[k]), k


def test_data_marks_follow_the_resolved_specs():
    """A leaf is marked where ``resolve_spec`` puts the data axes on one
    of its dimensions: q's rows, o's columns, the table's d_model, none
    with fsdp off or on a mesh whose data axes do not divide."""
    cfg = _cfg(True)
    model = LM(cfg, "cpu")
    shapes, _ = steps.model_shardings(model, cfg, {"data": 2, "model": 1})
    specs = model.param_specs()
    marks = fsdp.data_marks(shapes, specs, {"data": 2, "model": 1}, True)
    layer = marks["layers"][0]
    assert layer["mixer"]["q"]["w"] == 0 and layer["mixer"]["o"]["w"] == 1
    assert marks["embed"]["table"] == 1 and layer["norm1"]["scale"] is None
    off = fsdp.data_marks(shapes, specs, {"data": 2, "model": 1}, False)
    assert all(m is None for m in tree_leaves(off))
    odd = fsdp.data_marks(shapes, specs, {"data": 3, "model": 1}, True)
    assert all(m is None for m in tree_leaves(odd))
    pods = fsdp.data_marks(shapes, specs, types.SimpleNamespace(
        axis_names=("pod", "data", "model"),
        shape={"pod": 2, "data": 2, "model": 1}), True)
    assert pods["layers"][0]["mixer"]["q"]["w"] == 0
