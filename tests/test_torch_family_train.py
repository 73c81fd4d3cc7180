"""Training the non-dense families in the port, held against ``repro``'s
``make_train_step`` on the same weights and batches: jamba (one attention
and one SSM layer, an MLP and a MoE FFN), mixtral (MoE, sliding window),
mamba2 (SSM), seamless (encoder-decoder) and internvl2 (VLM), reduced
widths, 2 layers, QAT (``quantization="ternary"``, so the straight-through
ternarization runs on every projection and on the stacked expert banks,
reduced over axis -2), float32, ``grad_accum`` 1 and 2:

* the gradient of the loss (the MoE aux term included) for every leaf;
* one train step's metrics (loss, ce, aux, grad norm, lr), updated
  parameters and AdamW moments.

The latent weights are ``repro``'s init, except that a weight within
1e-6 (relative) of its column's ternarization threshold (0.7 mean|w|, a
sum the two packages take in another order) is moved 1e-5 off it, the
same in both packages: at the seed, one of mixtral's expert weights lies
3e-9 from its threshold, below float32's resolution, and takes the other
code in each package.

Tolerances (``tests/test_torch_train.py``'s): 1e-5 of each leaf's
largest magnitude for the step, except where the RMS gradient lies
within 100 eps of 0 in either package (``_eps_dominated``: parameters
held to the lr, moments to what such a gradient gives them); gradients within 1e-4 of
each leaf's largest (the same sums in another order through the STE's
masks, the routing and the scans), or of 1e-3 of the model's largest
gradient where the leaf's is smaller: seamless's cross-attention key bias
has gradient 0 (the softmax does not see a constant added to every score
of a row) and reads rounding noise, ~3e-9 of the largest.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as rget_config
from repro.data import SyntheticLM as RSyntheticLM
from repro.launch import steps as rsteps
from repro.models import LM as RLM
from repro.optim import warmup_cosine as rwarmup
from repro_torch.checkpoint.convert import (opt_state_to_numpy,
                                            params_from_numpy,
                                            params_to_numpy)
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch import steps
from repro_torch.models import LM
from repro_torch.optim import warmup_cosine

from test_torch_train import _close, _close_trees, _eps_dominated, _np
from torch_cpu_threads import one_torch_thread  # noqa: F401

GRAD_TOL = 1e-4
STEP_TOL = 1e-5
ARCHS = ["jamba-v0.1-52b", "mixtral-8x22b", "mamba2-130m",
         "seamless-m4t-large-v2", "internvl2-76b"]


def _kw(arch, grad_accum):
    layers = (dict(num_layers=2, attn_period=2, attn_offset=1)
              if arch.startswith("jamba") else dict(num_layers=2))
    return dict(dtype="float32", quantization="ternary", ternary_min_dim=64,
                grad_accum=grad_accum, **layers)


def _off_threshold(path, w, cfg):
    """A latent weight that the STE ternarizes, each element within 1e-6
    (relative) of its column's threshold moved 1e-5 off it, on its side."""
    if "embed" in jax.tree_util.keystr(path) or w.ndim < 2 \
            or min(w.shape[-2:]) < cfg.ternary_min_dim:
        return w
    a = np.abs(np.asarray(w, np.float64))
    thr = cfg.ternary_threshold * a.mean(axis=-2, keepdims=True)
    rel = (a - thr) / thr
    near = np.abs(rel) < 1e-6
    if not near.any():
        return w
    moved = np.sign(w) * thr * (1 + np.where(rel >= 0, 1e-5, -1e-5))
    return jnp.asarray(np.where(near, moved, w), w.dtype)


@functools.lru_cache(maxsize=None)
def _repro(arch):
    """repro's params (float32 latent, ``_off_threshold``) and its jitted
    loss gradient."""
    rcfg = rget_config(arch, reduced=True, **_kw(arch, 1))
    model = RLM(rcfg)
    grad = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))
    params = jax.tree_util.tree_map_with_path(
        lambda path, w: _off_threshold(path, w, rcfg),
        model.init(jax.random.PRNGKey(0)))
    return params, grad


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_repro(arch):
    rparams, rgrad = _repro(arch)
    pcfg = get_config(arch, reduced=True, **_kw(arch, 1))
    if arch.startswith(("jamba", "mixtral")):
        assert any(f == "moe" for _, f in LM(pcfg, "cpu").kinds)
    pparams = params_from_numpy(_np(rparams), pcfg, "cpu")
    arrs = SyntheticLM(pcfg, 4, 32).global_batch(0)
    want = _np(rgrad(rparams, {k: jnp.asarray(v) for k, v in arrs.items()}))
    metrics, grads = steps._value_and_grad(
        LM(pcfg, "cpu"), pparams,
        SyntheticLM(pcfg, 4, 32).sharded_batch(0))
    if pcfg.num_experts:
        assert float(metrics["aux"]) > 0
    got = params_to_numpy(grads, pcfg)
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    ref = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat) == len(ref)
    nonzero = 0
    largest = max(float(np.abs(g).max()) for g in ref.values())
    for path, leaf in flat:
        leaf = np.asarray(leaf, np.float32)
        nonzero += bool(np.abs(ref[path]).max() > 0)
        scale = max(float(np.abs(ref[path]).max()), 1e-3 * largest)
        np.testing.assert_allclose(leaf, ref[path], rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale,
                                   err_msg=jax.tree_util.keystr(path))
    assert nonzero > len(flat) // 2


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_repro(arch, grad_accum):
    kw = _kw(arch, grad_accum)
    rcfg = rget_config(arch, reduced=True, **kw)
    pcfg = get_config(arch, reduced=True, **kw)
    rparams = _repro(arch)[0]
    pparams = params_from_numpy(_np(rparams), pcfg, "cpu")
    rstep, ropt_init = rsteps.make_train_step(RLM(rcfg), rcfg,
                                              rwarmup(1e-2, 2, 10))
    pstep, popt_init = steps.make_train_step(LM(pcfg, "cpu"), pcfg,
                                             warmup_cosine(1e-2, 2, 10))
    ropt, popt = ropt_init(rparams), popt_init(pparams)
    batch = RSyntheticLM(rcfg, 4, 32).global_batch(1)
    rparams, ropt, rmet = jax.jit(rstep)(rparams, ropt, {
        k: jnp.asarray(v) for k, v in batch.items()})
    pparams, popt, pmet = pstep(pparams, popt,
                                SyntheticLM(pcfg, 4, 32).sharded_batch(1))
    assert set(pmet) == set(rmet)
    for key in rmet:
        _close(pmet[key], rmet[key], STEP_TOL)
    rv = _np(ropt["v"])
    pstate = opt_state_to_numpy(popt, pcfg)
    # eps-dominated on either side: a gradient of rounding noise may be an
    # exact 0 in one package only
    loose = jax.tree.map(np.logical_or, _eps_dominated(rv, 1),
                         _eps_dominated(_np(pstate["v"]), 1))
    _close_trees(params_to_numpy(pparams, pcfg), _np(rparams), STEP_TOL,
                 loose, 1.1 * float(rmet["lr"]))
    # |g| < 1e-6 where loose: AdamW's first moments (1 - b1) g, (1 - b2) g^2
    _close_trees(pstate["m"], _np(ropt["m"]), STEP_TOL, loose, 0.1 * 2e-6)
    _close_trees(pstate["v"], rv, STEP_TOL, loose, 0.05 * 1e-12)
    assert int(pstate["step"]) == int(ropt["step"]) == 1
