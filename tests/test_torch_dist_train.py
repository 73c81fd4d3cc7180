"""The distributed trainer on the CPU against ``repro``: ranks are processes
over gloo (``launch.train.DistTrainer`` spawns its followers; each group
meets through a ``FileStore`` in a fresh temporary directory and times
out after ``TIMEOUT_S``), on a reduced ``ternary-paper`` (2 layers, d
128, 4 heads of 32, ff 256, vocab 512, ternary_min_dim 64) in float32.

* dp 2, tp 2 (under full remat) and dp 2 x tp 2 against ``repro``'s
  unsharded ``make_train_step`` on the global batch (GSPMD's semantics
  are the unsharded math), after 1 and 3 steps, from the same weights (a step-0
  checkpoint every rank restores): loss, grad norm, lr, every parameter
  and AdamW moment with ``tests/test_torch_train.py``'s rule — 1e-5
  relative after one step, 1e-4 after three, except elements whose RMS
  gradient lies within 100 eps of 0 (held to the summed lr);
* the compressed step against ``repro``'s ``make_compressed_dp_step`` in
  one child process with two forced host devices, as
  ``tests/test_compressed_trainer.py`` runs it: metrics within 1e-4, the
  state within 1e-4 of each leaf's magnitude except elements whose codes
  can flip at a threshold tie (counted: under 1 in 10^4 of the state);
* the autograd collectives, the row-split STE and the tensor-parallel
  clip norm on two ranks against the whole computation (1e-5);
* data-parallel ranks hold the same bits after every step, and the
  tensor-parallel ranks get the same gradients for every replicated leaf
  (the norms; the table is split by vocabulary rows): 64-bit checksums of
  each leaf;
* checkpoints cross between a dp 2 x tp 2 mesh and one process both
  ways, and a restart brings every rank back to the same step;
* every family the one-process trainer trains runs plain and compressed
  data parallelism, and with its state split over the data group
  (``fsdp=True``); the MoE layer's capacity and aux loss are per rank
  (ROADMAP C17);
* the placement helpers (``sharded_batch``, ``batch_sharding``,
  ``replicated``, ``opt_state_shardings``, ``input_specs``,
  ``model_shardings``) against ``repro``'s, and the CLI's refusals."""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as rget_config
from repro.configs.base import SHAPES as RSHAPES
from repro.data import SyntheticLM as RSyntheticLM
from repro.distributed import sharding as rsharding
from repro.launch import steps as rsteps
from repro.models import LM as RLM
from repro.optim import warmup_cosine as rwarmup

from repro_torch import checkpoint as ckpt_lib
from repro_torch.checkpoint.convert import (opt_state_to_numpy,
                                            params_to_numpy)
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import quantize
from repro_torch.data import SyntheticLM
from repro_torch.distributed import sharding
from repro_torch.distributed import tp as tp_lib
from repro_torch.launch import steps, train
from repro_torch.models import LM
from repro_torch.optim import adamw, global_norm
from repro_torch.optim.optimizers import tree_leaves

from test_torch_train import KW, _close, _close_trees, _eps_dominated, _np, \
    _pair
from torch_cpu_threads import one_torch_thread  # noqa: F401
from test_torch_gloo_ranks import run_ranks, tp_rank_checks

TIMEOUT_S = 120.0
LR, TOTAL, BATCH, SEQ, SEED = 1e-2, 10, 4, 32, 5
MESHES = [(2, 1), (1, 2), (2, 2)]
MAX_FLIP_SHARE = 1e-4
EVAL_STEP = 10_000


def _mesh_id(m):
    return f"dp{m[0]}_tp{m[1]}"


def _trainer(cfg, dp, tp, **kw):
    return train.DistTrainer(cfg, data_parallel=dp, model_parallel=tp,
                             batch=BATCH, seq=SEQ, lr=LR, total_steps=TOTAL,
                             device="cpu", timeout_s=TIMEOUT_S, **kw)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """repro's unsharded steps 1 and 3 from _pair's weights, and a step-0
    checkpoint of the same weights (the port's layout = repro's)."""
    rcfg, rparams, pcfg, pparams = _pair(SEED)
    d = str(tmp_path_factory.mktemp("step0"))
    ckpt_lib.save(d, 0, {"params": params_to_numpy(pparams, pcfg),
                         "opt": opt_state_to_numpy(adamw()[0](pparams),
                                                   pcfg)})
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
    return pcfg, d, out


def _run_mesh(cfg, ckpt0, dp, tp, compress=False):
    """Restore step 0 on every rank, three steps; the gathered state, the
    metrics and the ranks' reports after steps 1 and 3."""
    tr = _trainer(cfg, dp, tp, compress=compress)
    try:
        assert tr.restore(ckpt0, 0) == 0
        out = {"eval0": tr.eval_loss(EVAL_STEP)}
        out.update(met=[tr.step(0)], comm=[tr.last_comm])
        out["state1"] = tr.checkpoint_tree()
        out["report1"] = tr.report(grads_step=1)
        for i in (1, 2):
            out["met"].append(tr.step(i))
        out["state3"] = tr.checkpoint_tree()
        out["report3"] = tr.report()
        return out
    finally:
        tr.close()


@pytest.fixture(scope="module")
def mesh_runs(reference):
    """Every mesh's run, each mesh started once; tp 2 with full remat (the
    backward recomputes each block, its collectives included)."""
    cfg, ckpt0, _ = reference
    return {m: _run_mesh(dataclasses.replace(cfg, remat="full") if m == (
        1, 2) else cfg, ckpt0, *m) for m in MESHES}


@pytest.fixture(params=MESHES, ids=_mesh_id)
def mesh_run(request, mesh_runs):
    return request.param, mesh_runs[request.param]


def _check_state(got, ref, tol):
    _close_trees(got["params"], ref["params"], tol, ref["loose"],
                 1.1 * ref["lr_sum"])
    _close_trees(got["opt"]["m"], ref["m"], tol)
    _close_trees(got["opt"]["v"], ref["v"], tol)


@pytest.mark.parametrize("steps_taken,tol", [(1, 1e-5), (3, 1e-4)])
def test_mesh_matches_repros_unsharded_step(mesh_run, reference,
                                            steps_taken, tol):
    (dp, tp), run = mesh_run
    ref = reference[2][steps_taken]
    met = run["met"][steps_taken - 1]
    for key in ("loss", "grad_norm", "lr"):
        _close(torch.tensor(met[key]), ref["met"][key], tol)
    state = run[f"state{steps_taken}"]
    assert int(state["opt"]["step"]) == steps_taken
    _check_state(state, ref, tol)


def test_held_out_loss_is_one_process_loss(mesh_run, reference):
    """``DistTrainer.eval_loss`` (no gradient, no update; the data
    group's mean) of the restored weights equals one process's loss on
    the global batch of that step within 1e-5."""
    (dp, tp), run = mesh_run
    _, _, pcfg, pparams = _pair(SEED)
    batch = SyntheticLM(pcfg, BATCH, SEQ).sharded_batch(EVAL_STEP)
    with torch.no_grad():
        want = float(LM(pcfg, "cpu").loss(pparams, batch)[0])
    assert abs(run["eval0"] - want) <= 1e-5 * abs(want)


def test_data_parallel_ranks_hold_the_same_bits(mesh_run):
    (dp, tp), run = mesh_run
    for rep in (run["report1"], run["report3"]):
        counts = train.check_replicas(rep)
        assert counts["leaves_compared"] == (dp - 1) * tp * len(
            rep[0]["params"]) * 3
    assert [r["step"] for r in run["report3"]] == [3] * (dp * tp)


@pytest.mark.parametrize("mesh_run", [(1, 2), (2, 2)], indirect=True,
                         ids=_mesh_id)
def test_replicated_leaves_get_equal_grads(mesh_run):
    """The norms (and the row splits' whole biases) are replicated
    leaves; their gradients are equal on every tensor-parallel rank of a
    replica, and the split leaves' differ (the embedding table, split by
    vocabulary rows, is the first leaf)."""
    (dp, tp), run = mesh_run
    rep = run["report1"]
    counts = train.check_replicas(rep)
    n_rep = sum(not s for s in rep[0]["split"])
    assert n_rep >= 2 * 2 + 1          # 2 norms a layer, final norm
    assert rep[0]["split"][0]          # the table
    assert counts["replicated_grads_compared"] == dp * (tp - 1) * n_rep
    split = [i for i, s in enumerate(rep[0]["split"]) if s]
    assert all(rep[0]["grads"][i] != rep[1]["grads"][i] for i in split)


def test_data_group_syncs_in_f32_and_tp_collectives_are_counted(mesh_run):
    (dp, tp), run = mesh_run
    comm = run["comm"][0]
    if dp > 1:
        n = sum(a.size for a in jax.tree.leaves(run["state1"]["params"]))
        # one f32 all-reduce of every gradient (a rank's slices), one loss
        per_rank = comm["data"]["bytes"] - 4
        assert per_rank * tp >= 4 * n and comm["data"]["calls"] == 2
    if tp > 1:
        # per layer: o and down, each two STE statistics and one partial
        # sum forward, q/k/v and gate/up regions' input grads backward;
        # the logits' gather and its input's grad; the clip norm; the
        # split table's lookup sum. Under full remat (tp 2) the backward
        # recomputes each block up to its last saved tensor: all but the
        # down projection's sum
        recompute = 2 * (3 + 2) if dp == 1 else 0
        assert comm["model"]["calls"] == 2 * (3 + 3) + recompute \
            + 2 * 2 + 2 + 1 + 1


# ---------------------------------------------------------------------------
# the compressed step against repro's, in a child with two host devices
# ---------------------------------------------------------------------------

CHILD = r"""
import os, sys, json, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.data import SyntheticLM
from repro.distributed import compression
from repro.launch.train import make_compressed_dp_step
from repro.launch.mesh import make_local_mesh
from repro.models import LM
from repro.optim import warmup_cosine
out_path, kw, seed, lr, total, batch, seq = sys.argv[1:8]
cfg = get_config("ternary-paper", reduced=True, **json.loads(kw))
model = LM(cfg)
params = model.init(jax.random.PRNGKey(int(seed)))
mesh = make_local_mesh(2, 1)
step, opt_init = make_compressed_dp_step(
    model, cfg, mesh, warmup_cosine(float(lr), 2, int(total)))
opt, err = opt_init(params), compression.init_error_state(params)
data = SyntheticLM(cfg, int(batch), int(seq))
jstep = jax.jit(step)
out = {}
np_tree = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
for i in range(3):
    b = {k: jnp.asarray(v) for k, v in data.global_batch(i).items()}
    params, opt, err, met = jstep(params, opt, err, b)
    if i in (0, 2):
        out[i + 1] = {"params": np_tree(params), "m": np_tree(opt["m"]),
                      "v": np_tree(opt["v"]), "err": np_tree(err),
                      "met": {k: float(v) for k, v in met.items()}}
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def compressed_pair(reference, tmp_path_factory):
    cfg, ckpt0, _ = reference
    path = str(tmp_path_factory.mktemp("compressed") / "ref.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    env.pop("XLA_FLAGS", None)
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, path, json.dumps(KW), str(SEED),
         str(LR), str(TOTAL), str(BATCH), str(SEQ)], env=env,
        stderr=subprocess.PIPE, text=True)
    try:
        got = _run_mesh(cfg, ckpt0, 2, 1, compress=True)
    finally:
        _, err = child.communicate(timeout=600)
    assert child.returncode == 0, err[-3000:]
    with open(path, "rb") as f:
        ref = pickle.load(f)
    return got, ref


def _close_counting(got, ref, tol):
    """Leafwise within tol of each leaf's magnitude; the elements off it
    are returned (counted), each within 1.0 of the leaf's magnitude."""
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    off = total = 0
    for path, leaf in flat_g:
        leaf, want = np.asarray(leaf, np.float32), flat_r[path]
        scale = max(float(np.abs(want).max()), 1e-12)
        bad = np.abs(leaf - want) > tol * scale + tol * np.abs(want)
        assert np.all(np.abs(leaf - want) <= scale)
        off += int(bad.sum())
        total += want.size
    return off, total


@pytest.mark.parametrize("steps_taken", [1, 3])
def test_compressed_step_matches_repros(compressed_pair, steps_taken):
    got, ref = compressed_pair
    ref = ref[steps_taken]
    met = got["met"][steps_taken - 1]
    assert set(met) == set(ref["met"])
    for key in ("loss", "grad_norm", "lr"):
        _close(torch.tensor(met[key]), ref["met"][key], 1e-4)
    state = got[f"state{steps_taken}"]
    off = total = 0
    for mine, theirs in ((state["params"], ref["params"]),
                         (state["opt"]["m"], ref["m"]),
                         (state["opt"]["v"], ref["v"]),
                         (state["err"], ref["err"])):
        o, t = _close_counting(mine, theirs, 1e-4)
        off, total = off + o, total + t
    assert off <= MAX_FLIP_SHARE * total, (off, total)
    counts = train.check_replicas(got[f"report{steps_taken}"])
    assert counts["leaves_compared"] > 0


@pytest.mark.parametrize("mesh_run", [(2, 1)], indirect=True, ids=_mesh_id)
def test_compressed_step_sends_half_the_bytes(compressed_pair, mesh_run):
    got, _ = compressed_pair
    _, run = mesh_run
    codes = got["comm"][0]["data"]["bytes"]
    plain = run["comm"][0]["data"]["bytes"]
    # bf16 codes + f32 scales + the loss, against f32 gradients + the loss
    assert codes < 0.51 * plain and got["comm"][0]["data"]["calls"] == 3


# ---------------------------------------------------------------------------
# the collectives, the row-split STE and the norm on two ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp_checks():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    w_rows = rng.standard_normal((16, 12)).astype(np.float32)
    w_cols = rng.standard_normal((16, 10)).astype(np.float32)
    w = rng.standard_normal((64, 24)).astype(np.float32)
    g = rng.standard_normal((64, 24)).astype(np.float32)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((4, 8), (6,), (3, 10))]
    split = [True, False, True]
    got = run_ranks(2, tp_rank_checks, x, w_rows, w_cols, w, g, leaves,
                    split)
    return (x, w_rows, w_cols, w, g, leaves, split), got


def test_autograd_collectives_match_the_whole(tp_checks):
    """f (identity forward, all-reduced input grad), g (all-reduce
    forward, identity backward) and the gather (its rank's columns of the
    grad) give the whole computation's values and gradients; without a
    gradient the reduce gives the same bits."""
    (x, w_rows, w_cols, *_), got = tp_checks
    xt = torch.from_numpy(x).requires_grad_()
    wr = torch.from_numpy(w_rows).requires_grad_()
    wc = torch.from_numpy(w_cols).requires_grad_()
    cols = xt @ wc
    rows = xt @ wr
    ((cols * cols).sum() + rows.sin().sum()).backward()
    for rank, out in enumerate(got):
        _close(out["cols"], cols.detach(), 1e-5)
        _close(out["rows"], rows.detach(), 1e-5)
        assert np.array_equal(out["rows_nograd"], out["rows"])
        _close(out["gx"], xt.grad, 1e-5)
        _close(out["gwr"], wr.grad[rank * 8:(rank + 1) * 8], 1e-5)
        _close(out["gwc"], wc.grad[:, rank * 5:(rank + 1) * 5], 1e-5)
    assert np.array_equal(got[0]["gx"], got[1]["gx"])


def test_row_split_ste_matches_the_whole_matrix(tp_checks):
    (_, _, _, w, g, *_), got = tp_checks
    wt = torch.from_numpy(w).requires_grad_()
    y = quantize.ste_ternarize(wt, 0.7)
    (gw,) = torch.autograd.grad(y, [wt], torch.from_numpy(g))
    ys = np.concatenate([out["ste_y"] for out in got])
    gws = np.concatenate([out["ste_g"] for out in got])
    np.testing.assert_array_equal(np.sign(ys), np.sign(y.detach().numpy()))
    np.testing.assert_allclose(ys, y.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(gws, gw.numpy(), rtol=1e-6, atol=1e-6)


def test_tensor_parallel_norm_counts_replicated_leaves_once(tp_checks):
    (*_, leaves, split), got = tp_checks
    want = float(global_norm([torch.from_numpy(a) for a in leaves]))
    for out in got:
        assert abs(out["norm"] - want) <= 1e-6 * want
    assert got[0]["norm"] == got[1]["norm"]


# ---------------------------------------------------------------------------
# checkpoints across meshes, restart, the CLI
# ---------------------------------------------------------------------------

ARGS = ["--reduced", "--set", "ternary_min_dim=64", "--set",
        "dtype=float32", "--set", "num_layers=2", "--batch", "4", "--seq",
        "32", "--lr", "3e-3", "--log-every", "100", "--device", "cpu"]
MESH_ARGS = ["--data-parallel", "2", "--model-parallel", "2"]


def test_checkpoints_cross_between_a_mesh_and_one_process(tmp_path):
    """dp 2 x tp 2 writes step 2; one process resumes it to 4; a dp 2 x tp
    2 trainer restores step 4 bit for bit, then runs to 6 under the
    supervisor with one injected failure at step 5: it restarts from the
    step-4 checkpoint and every rank ends at step 6 with equal replicas."""
    d = str(tmp_path)
    first = train.main(ARGS + MESH_ARGS + ["--ckpt-dir", d, "--steps", "2",
                                           "--ckpt-every", "2"])
    assert first["steps"] == 2 and np.isfinite(first["last_loss"])
    second = train.main(ARGS + ["--ckpt-dir", d, "--steps", "4",
                                "--ckpt-every", "2"])
    assert second["steps"] == 2
    cfg = get_config("ternary-paper", reduced=True, **KW)
    sup, _, tr = train.make_dist_supervisor(
        cfg, data_parallel=2, model_parallel=2, batch=4, seq=32, lr=3e-3,
        steps=6, ckpt_dir=d, ckpt_every=2, device="cpu",
        timeout_s=TIMEOUT_S)
    try:
        assert tr.restore(d, 4) == 4
        saved = ckpt_lib.restore(d, 4)[1]
        mine = ckpt_lib.save(str(tmp_path / "again"), 4,
                             tr.checkpoint_tree())
        again = ckpt_lib.restore(str(tmp_path / "again"), 4)[1]
        assert set(saved) == set(again)
        for k in saved:
            assert torch.equal(saved[k], again[k]), k
        del mine
        failed = []

        def injector(step):
            if step == 5 and not failed:
                failed.append(step)
                raise RuntimeError("injected failure")

        _, history = sup.run(6, failure_injector=injector)
        # the failure at 5 rolls every rank back to the step-4 checkpoint
        assert sup.restarts == 1 and [s for s, _ in history] == [4, 4, 5]
        counts = train.check_replicas(tr.report())
        assert counts["leaves_compared"] > 0
    finally:
        tr.close()
    assert ckpt_lib.latest_step(d) == 6


def test_train_cli_refuses_what_repro_refuses(tmp_path):
    base = ARGS + ["--ckpt-dir", str(tmp_path), "--steps", "1"]
    for extra in (["--compress-grads"],
                  ["--compress-grads", "--data-parallel", "2",
                   "--model-parallel", "2"],
                  ["--compress-grads", "--model-parallel", "2"]):
        with pytest.raises(SystemExit, match="pure data-parallel"):
            train.main(base + extra)
    # every family takes a model-parallel mesh, as repro's trainer does
    out = train.main(["--arch", "mamba2-130m", "--reduced", "--device",
                      "cpu", "--model-parallel", "2", "--steps", "1",
                      "--batch", "2", "--seq", "16", "--ckpt-dir",
                      str(tmp_path / "mamba2")])
    assert out["steps"] == 1 and np.isfinite(out["last_loss"])
    mixtral = get_config("mixtral-8x22b", reduced=True)
    _, resolved = steps.model_shardings(LM(mixtral, "cpu"), mixtral,
                                        {"model": 2})
    assert resolved["layers"][0]["ffn"]["w_in"] == ("model",)
    assert resolved["layers"][0]["ffn"]["router"] == ()


# ---------------------------------------------------------------------------
# every family under plain and compressed data parallelism; C17
# ---------------------------------------------------------------------------

FAMILIES = ["mixtral-8x22b", "mamba2-130m", "jamba-v0.1-52b",
            "seamless-m4t-large-v2", "internvl2-76b"]


def _family_cfg(arch, fsdp=False):
    return get_config(arch, reduced=True, num_layers=2, dtype="float32",
                      grad_accum=1, fsdp=fsdp)


@pytest.fixture(scope="module")
def families():
    """One dp 2 mesh rebuilt for each family, plain, compressed, then
    with its state split over the data group: the first step's metrics
    and the ranks' reports."""
    out = {}
    tr = _trainer(_family_cfg(FAMILIES[0]), 2, 1)
    try:
        for arch in FAMILIES:
            for compress in (False, True, "fsdp"):
                tr.build(_family_cfg(arch, fsdp=compress == "fsdp"),
                         batch=BATCH, seq=SEQ, lr=LR, total_steps=TOTAL,
                         compress=compress is True)
                tr.init(0)
                out[arch, compress] = (tr.step(0), tr.report())
    finally:
        tr.close()
    return out


def _losses(arch):
    """One process's loss on the global batch and the mean of its losses
    on each rank's rows, from the trainer's seed-0 weights."""
    cfg = _family_cfg(arch)
    model = LM(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = SyntheticLM(cfg, BATCH, SEQ).sharded_batch(0)
    with torch.no_grad():
        whole = float(model.loss(params, batch)[0])
        halves = [float(model.loss(params, {
            k: v[r * 2:(r + 1) * 2] for k, v in batch.items()})[0])
            for r in range(2)]
    return whole, sum(halves) / 2


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("compress", [False, True, "fsdp"],
                         ids=["f32", "codes", "fsdp"])
def test_every_family_trains_data_parallel(families, arch, compress):
    met, reports = families[arch, compress]
    whole, per_rank = _losses(arch)
    assert all(np.isfinite(v) for v in met.values())
    # the group's mean of each rank's loss on its rows
    assert abs(met["loss"] - per_rank) <= 1e-5 * abs(per_rank)
    train.check_replicas(reports)
    if get_config(arch).num_experts == 0:
        assert abs(met["loss"] - whole) <= 1e-5 * abs(whole)
    # fsdp: each rank holds its slices, a little over half the state
    plain = families[arch, False][1][0]["state_bytes"]
    assert all(r["sharded"] == (compress == "fsdp") for r in reports)
    if compress == "fsdp":
        assert all(plain / 2 <= r["state_bytes"] < 0.6 * plain
                   for r in reports)
    else:
        assert all(r["state_bytes"] == plain for r in reports)


def test_c17_moe_capacity_and_aux_are_per_rank(families):
    """A MoE layer's per-step capacity and aux loss are computed over the
    rank's rows (GSPMD: over the global batch): the mesh's loss is the
    mean of one process's losses on each rank's rows, not its loss on the
    global batch."""
    met, _ = families["mixtral-8x22b", False]
    whole, per_rank = _losses("mixtral-8x22b")
    assert abs(met["loss"] - per_rank) <= 1e-5 * abs(per_rank)
    assert abs(met["loss"] - whole) > 1e-4 * abs(whole)


# ---------------------------------------------------------------------------
# placements against repro
# ---------------------------------------------------------------------------

def _stub_mesh(**sizes):
    return types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))


def _norm_spec(spec):
    """A PartitionSpec in the port's form: a one-name tuple as the name,
    trailing Nones dropped."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in tuple(spec)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("sizes", [dict(data=2, model=2), dict(data=4),
                                   dict(pod=2, data=2, model=2),
                                   dict(data=3, model=1)],
                         ids=lambda s: "x".join(f"{k}{v}"
                                                for k, v in s.items()))
def test_batch_and_opt_state_shardings_equal_repros(sizes, monkeypatch):
    monkeypatch.setattr(rsharding, "NamedSharding", lambda mesh, spec: spec)
    mesh = _stub_mesh(**sizes)
    cfg = get_config("internvl2-76b", reduced=True)
    batch = SyntheticLM(cfg, 4, 32).global_batch(0)
    ref = rsharding.batch_sharding(batch, mesh)
    got = sharding.batch_sharding(batch, mesh)
    assert {k: _norm_spec(v) for k, v in ref.items()} == got
    assert sharding.replicated(batch, mesh) == {k: () for k in batch}
    params = {"a": np.zeros((4, 6)), "b": [np.zeros(3), np.zeros(())]}
    pspecs = {"a": ("data", "model"), "b": [("model",), ()]}
    opt = {"m": params, "v": params, "step": np.zeros((), np.int32)}
    ref = rsharding.opt_state_shardings(
        {"a": P("data", "model"), "b": [P("model"), P()]}, opt, mesh)
    got = sharding.opt_state_shardings(pspecs, opt, mesh)
    assert got["step"] == () and _norm_spec(ref["step"]) == ()
    for key in ("m", "v"):
        assert got[key]["a"] == _norm_spec(ref[key]["a"])
        assert [tuple(s) for s in got[key]["b"]] == [
            _norm_spec(s) for s in ref[key]["b"]]


@pytest.mark.parametrize("sizes", [(2, 2), (2, 1), (4, 1), (1, 2)])
def test_sharded_batch_gives_each_rank_its_rows(sizes):
    cfg = get_config("seamless-m4t-large-v2", reduced=True)
    dp, tp = sizes
    mesh = tp_lib.Mesh(("data", "model"), sizes, ("cpu",) * (dp * tp))
    whole = RSyntheticLM(rget_config("seamless-m4t-large-v2", reduced=True),
                         4, 32).global_batch(3)
    mine = SyntheticLM(cfg, 4, 32)
    for k, v in mine.global_batch(3).items():
        assert np.array_equal(v, whole[k]) and v.dtype == whole[k].dtype
    for r in range(dp * tp):
        got = mine.sharded_batch(3, mesh, rank=r)
        d = r // tp
        for k, v in got.items():
            rows = 4 // dp
            assert np.array_equal(v.numpy(), whole[k][d * rows:(d + 1)
                                                      * rows])
    odd = SyntheticLM(cfg, 3, 32)
    got = odd.sharded_batch(1, mesh, rank=dp * tp - 1)
    for k, v in odd.global_batch(1).items():
        assert np.array_equal(got[k].numpy(), v) or dp == 1


@pytest.mark.parametrize("arch", ["ternary-paper", "mixtral-8x22b",
                                  "seamless-m4t-large-v2", "internvl2-76b",
                                  "mamba2-130m"])
def test_input_specs_equal_repros(arch):
    for name, shape in SHAPES.items():
        ref = rsteps.input_specs(rget_config(arch), RSHAPES[name])
        got = steps.input_specs(get_config(arch), shape)
        assert set(got) == set(ref)
        for k, (shp, dtype) in got.items():
            assert shp == ref[k].shape
            assert str(dtype).split(".")[-1] == str(ref[k].dtype)


def test_model_shardings_allocate_nothing_and_resolve_the_specs():
    cfg = get_config("ternary-paper", reduced=True, num_layers=2)
    model = LM(cfg, "cpu")
    shapes, specs = steps.model_shardings(model, cfg, {"data": 2,
                                                       "model": 2})
    whole = model.init(torch.Generator().manual_seed(0))
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    assert [(t.shape, t.dtype) for t in tree_leaves(shapes)] == [
        (t.shape, t.dtype) for t in tree_leaves(whole)]
    assert specs == sharding.resolve_specs(model.param_specs(), whole,
                                           {"data": 2, "model": 2}, False)
    rcfg = rget_config("ternary-paper", reduced=True, num_layers=2)
    r_shapes, _ = RLM(rcfg).init_with_specs_abstract()
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(r_shapes)) \
        == sum(t.numel() for t in tree_leaves(shapes))
