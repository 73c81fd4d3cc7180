"""K/V heads held by several ranks under the head rule, on the CPU:

* reduced ternary-paper with one K/V head at tp 2 (each rank 2 query
  heads and the one K/V head): the first f32 train step against one
  process's and ``repro``'s from the same weights
  (``test_torch_dist_train``'s rule, 1e-5), the K/V head's gradients
  summed over both ranks and equal on them;
* reduced ternary-paper (4 query heads, 2 K/V heads) at tp 4 over four
  gloo ranks, where each rank holds one query head and the K/V head
  ``rank // 2`` — head 0 on ranks 0 and 1, head 1 on ranks 2 and 3, the
  placement GQA-8 has at tp 16 with two heads in place of eight: streams,
  dense and paged bf16, against tp 1 and ``repro``'s engine (equal, or
  parting at a near tie: ``test_torch_tp``'s rule), the first decode
  step's logits within ``LOGIT_TOL`` of max|logit| of tp 1's; the first
  f32 train step against one process's and ``repro``'s; the state
  gathered after the restore bit for bit the checkpoint's, each K/V head
  taken once from its ranks (``tp.gather_tree``); each head's k and v
  gradients, summed over its two ranks alone, equal on them
  (``check_replicas``: 2 layers x 2 leaves x 2 second ranks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as RSyntheticLM
from repro.launch import steps as rsteps
from repro.models import LM as RLM
from repro.optim import warmup_cosine as rwarmup
from repro.serving import ContinuousScheduler as RScheduler

from repro_torch import checkpoint as ckpt_lib
from repro_torch.checkpoint.convert import (opt_state_to_numpy,
                                            params_to_numpy)
from repro_torch.data import SyntheticLM
from repro_torch.distributed import tp as tp_lib
from repro_torch.launch import steps, train
from repro_torch.models import LM
from repro_torch.optim import adamw, warmup_cosine

from test_torch_dist_train import (BATCH, LR, SEED, SEQ, TOTAL, _check_state,
                                   _trainer)
from test_torch_model import _packed_pair
from test_torch_tp import (ENGINE, LOGIT_TOL, MODES, _serve_port, _streams,
                           _workload)
from test_torch_train import _close, _eps_dominated, _np, _pair
from torch_cpu_threads import one_torch_thread  # noqa: F401

TP = 4


# ---------------------------------------------------------------------------
# the first train step from the same weights
# ---------------------------------------------------------------------------

def first_step_refs(ckpt_dir, **over):
    """From ``_pair``'s weights (``repro``'s init carried over; reduced
    ternary-paper in f32, with ``over``): a step-0 checkpoint written to
    ``ckpt_dir``, then the port's first one-process step and ``repro``'s
    first step from them, each {"params", "m", "v", "loose", "lr_sum",
    "met"} in ``repro``'s layout. Returns (port config, one process's,
    ``repro``'s, the step-0 params in that layout)."""
    rcfg, rparams, pcfg, pparams = _pair(SEED, **over)
    ckpt_lib.save(ckpt_dir, 0, {
        "params": params_to_numpy(pparams, pcfg),
        "opt": opt_state_to_numpy(adamw()[0](pparams), pcfg)})
    step, opt_init = steps.make_train_step(LM(pcfg, "cpu"), pcfg,
                                           warmup_cosine(LR, 2, TOTAL))
    params, opt, met = step(pparams, opt_init(pparams),
                            SyntheticLM(pcfg, BATCH, SEQ).sharded_batch(0))
    rstep, ropt_init = rsteps.make_train_step(RLM(rcfg), rcfg,
                                              rwarmup(LR, 2, TOTAL))
    rp, ropt, rmet = jax.jit(rstep)(rparams, ropt_init(rparams), {
        k: jnp.asarray(v) for k, v in
        RSyntheticLM(rcfg, BATCH, SEQ).global_batch(0).items()})
    out = []
    for ps, m, v, mt in ((params_to_numpy(params, pcfg),
                          params_to_numpy(opt["m"], pcfg),
                          params_to_numpy(opt["v"], pcfg), met),
                         (_np(rp), _np(ropt["m"]), _np(ropt["v"]), rmet)):
        out.append({"params": ps, "m": m, "v": v,
                    "loose": _eps_dominated(v, 1), "lr_sum": float(mt["lr"]),
                    "met": {k: float(mt[k])
                            for k in ("loss", "grad_norm", "lr")}})
    return pcfg, out[0], out[1], params_to_numpy(pparams, pcfg)


def check_first_step(met, state, refs):
    """A mesh's first step against each reference of ``refs`` by
    ``test_torch_dist_train``'s rule (1e-5 relative)."""
    for ref in refs:
        for key in ("loss", "grad_norm", "lr"):
            _close(torch.tensor(met[key]), ref["met"][key], 1e-5)
        _check_state(state, ref, 1e-5)


@pytest.fixture(scope="module")
def one_head_step(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("one_head_step0"))
    return (d,) + first_step_refs(d, num_kv_heads=1)


def test_one_kv_head_tp2_first_train_step(one_head_step):
    """The first f32 step at tp 2 against one process's and ``repro``'s
    from the same weights (``test_torch_dist_train``'s rule, 1e-5), then
    the ranks' gradients of the shared K/V head's columns equal (summed
    over both ranks)."""
    ckpt0, pcfg, one, rep, _ = one_head_step
    tr = _trainer(pcfg, 1, 2)
    try:
        assert tr.restore(ckpt0, 0) == 0
        met = tr.step(0)
        state = tr.checkpoint_tree()
        reports = tr.report(grads_step=1)
    finally:
        tr.close()
    check_first_step(met, state, (one, rep))
    counts = train.check_replicas(reports)
    # k and v of each of the 2 layers, one K/V head on both ranks
    assert counts["head_grads_compared"] == 2 * 2
    assert sum(h is not None for h in reports[0]["heads"]) == 2 * 2


# ---------------------------------------------------------------------------
# two K/V heads at tp 4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kv2_pair():
    return _packed_pair("bfloat16", num_layers=2)


@pytest.mark.parametrize("mode", ["dense", "paged_bf16"])
def test_kv2_tp4_streams(kv2_pair, mode):
    rcfg, rparams, pcfg, pparams = kv2_pair
    assert (pcfg.num_heads, pcfg.num_kv_heads) == (4, 2)
    assert tp_lib.attention_split(pcfg, TP) == "replicate"
    local = tp_lib.local_config(pcfg, TP)
    assert (local.num_heads, local.num_kv_heads) == (1, 1)
    prompts, gens = _workload(pcfg.vocab_size, seed=23)
    pkw, rkw = MODES[mode]
    one, first1, _ = _serve_port(pcfg, pparams, prompts, gens, **pkw)
    four, first4, metrics = _serve_port(
        pcfg, pparams, prompts, gens, mesh=tp_lib.replica_meshes(
            1, TP, ["cpu"] * TP, timeout_s=120.0)[0], **pkw)
    assert metrics["mesh"]["tp"] == TP
    scale = float(first1.abs().max())
    assert float((first4 - first1).abs().max()) <= LOGIT_TOL * scale
    _streams(pcfg, pparams, prompts, one, four)
    reng = RScheduler(rcfg, **ENGINE, **rkw)
    reng.load(rparams)
    rreqs = [reng.submit(p, g) for p, g in zip(prompts, gens)]
    reng.run()
    _streams(pcfg, pparams, prompts,
             [np.asarray(r.tokens, np.int32) for r in rreqs], four)


@pytest.fixture(scope="module")
def kv2_step(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("kv2_step0"))
    return (d,) + first_step_refs(d)


def test_kv2_tp4_first_train_step(kv2_step):
    ckpt0, pcfg, one, rep, start = kv2_step
    tr = _trainer(pcfg, 1, TP)
    try:
        assert tr.restore(ckpt0, 0) == 0
        whole = tr.checkpoint_tree()["params"]
        met = tr.step(0)
        state = tr.checkpoint_tree()
        reports = tr.report(grads_step=1)
    finally:
        tr.close()
    got, want = dict(_leaves(whole)), dict(_leaves(start))
    assert got.keys() == want.keys()
    # k and v, each stacked over the 2 layers (repro's layout), 2 heads wide
    kv = [path for path in got if path[-2] in ("k", "v")]
    assert [got[path].shape for path in kv] == [(2, 128, 2 * 32)] * 2
    for path, leaf in want.items():
        assert np.array_equal(got[path], leaf), path
    check_first_step(met, state, (one, rep))
    counts = train.check_replicas(reports)
    # k and v of each of the 2 layers; each of the 2 K/V heads on 2 ranks
    assert counts["head_grads_compared"] == 2 * 2 * 2
    for r, rep_r in enumerate(reports):
        held = [h for h in rep_r["heads"] if h is not None]
        assert held == [r // 2] * (2 * 2)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, np.asarray(tree)
