"""The port's training path held against ``repro`` on the same weights and
batches: the straight-through ternarization, the full-sequence forward
and loss under each attention implementation, AdamW, SGD with momentum,
clipping and the schedule, the prefill and decode step builders, the train
step (with and without gradient accumulation and remat), and the training
CLI's checkpoint/restart.

Everything runs in float32 on a reduced ``ternary-paper`` (2 layers, d 128,
4 heads of 32, ff 256, vocab 512, ternary_min_dim 64). Tolerances: the STE
forward's ternary codes are bitwise equal and its values within 1e-6
relative (each column's scale is a mean that XLA and torch sum in
different orders), its gradient within 1e-6; losses and hidden states
within 1e-4 of their magnitude (the same sums in another order through 2
layers); one train step's loss, grad norm, parameters and AdamW moments
within 1e-5 relative, three steps' within 1e-4 (rounding differences grow
through the updates), except parameters whose RMS gradient is within 100
eps of 0, where AdamW's division amplifies rounding (``_eps_dominated``:
fewer than 1 in 100, held to the summed learning rate); optimizer and
schedule math within 1e-6; the step builders' logits within 1e-3 (their
caches are bf16 in both packages).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as rckpt
from repro.configs import get_config as rget_config
from repro.core import quantize as rquantize
from repro.data import SyntheticLM as RSyntheticLM
from repro.launch import steps as rsteps
from repro.launch import train as rtrain
from repro.models import LM as RLM
from repro.models import layers as rlayers
from repro.optim import adamw as radamw
from repro.optim import clip_by_global_norm as rclip
from repro.optim import sgd_momentum as rsgd
from repro.optim import warmup_cosine as rwarmup
from repro_torch.checkpoint.convert import (opt_state_to_numpy,
                                            params_from_numpy,
                                            params_to_numpy)
from repro_torch.configs import get_config
from repro_torch.core import quantize
from repro_torch.data import SyntheticLM
from repro_torch.launch import steps, train
from repro_torch.models import LM
from repro_torch.models import layers
from repro_torch.optim import (adamw, clip_by_global_norm, sgd_momentum,
                               warmup_cosine)

KW = dict(ternary_min_dim=64, dtype="float32", num_layers=2)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if np.issubdtype(np.asarray(a).dtype, np.floating)
                        else np.asarray(a), tree)


def _pair(seed=0, **over):
    rcfg = rget_config("ternary-paper", reduced=True, **KW, **over)
    pcfg = get_config("ternary-paper", reduced=True, **KW, **over)
    rparams = RLM(rcfg).init(jax.random.PRNGKey(seed))
    pparams = params_from_numpy(_np(rparams), pcfg, "cpu")
    return rcfg, rparams, pcfg, pparams


def _close(got, ref, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


def _close_trees(got, ref, tol, loose=None, loose_bound=0.0):
    """Leafwise ``_close``; where the ``loose`` tree of masks is True the
    element is held to |got - ref| <= ``loose_bound`` instead."""
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_l = dict(jax.tree_util.tree_flatten_with_path(loose)[0]) \
        if loose is not None else {}
    assert len(flat_g) == len(flat_r)
    for path, leaf in flat_g:
        leaf, want = np.asarray(leaf, np.float32), flat_r[path]
        mask = flat_l.get(path, np.zeros(want.shape, bool))
        assert np.all(np.abs(leaf - want)[mask] <= loose_bound)
        _close(np.where(mask, want, leaf), want, tol)


def _eps_dominated(v, step, b2=0.95, floor=1e-6):
    """Elements whose RMS gradient sqrt(v_hat) lies within 100 eps of 0
    but is not 0 (an exact zero moves both packages alike).
    AdamW divides by sqrt(v_hat) + eps there, so a 1e-5 relative change of
    a gradient that small (the sums' rounding) moves the update by a large
    fraction of lr; such elements are held to the largest move the updates
    can make (the summed lr, plus the decay's share) instead."""
    return jax.tree.map(
        lambda a: (a > 0) & (np.sqrt(a / (1 - b2 ** step)) < floor), v)


# ---------------------------------------------------------------------------
# straight-through ternarization (the repaired QAT gradient)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16), (64, 48), (7, 130)])
@pytest.mark.parametrize("threshold", [0.7, 0.5])
def test_ste_ternarize_matches_repro(shape, threshold):
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    ref_y, vjp = jax.vjp(lambda a: rquantize.ste_ternarize(a, threshold),
                         jnp.asarray(w))
    (ref_g,) = vjp(jnp.asarray(g))
    wt = torch.from_numpy(w).requires_grad_()
    y = quantize.ste_ternarize(wt, threshold)
    (got_g,) = torch.autograd.grad(y, [wt], torch.from_numpy(g))
    # the codes agree bitwise; alpha is a per-column mean that XLA and
    # torch sum in different orders, one f32 ulp apart at most
    y = y.detach().numpy()
    np.testing.assert_array_equal(np.sign(y), np.sign(np.asarray(ref_y)))
    np.testing.assert_allclose(y, np.asarray(ref_y), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), rtol=1e-6,
                               atol=1e-6)
    assert quantize.effective_weight(wt, "none") is wt


def test_qat_linear_weight_gradient_matches_repro():
    """A 16 x 16 ternary linear, x of 4 rows, loss sum(x @ W_eff): the
    latent weight's gradient is repro's straight-through one (masked to
    |w| <= 2 mean|w| per column), not the scale's gradient alone."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 16)).astype(np.float32)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    rcfg = rget_config("ternary-paper", reduced=True, ternary_min_dim=16,
                       dtype="float32")
    pcfg = get_config("ternary-paper", reduced=True, ternary_min_dim=16,
                      dtype="float32")
    ref = jax.grad(lambda a: jnp.sum(rlayers.linear_apply(
        {"w": a}, jnp.asarray(x), rcfg)))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    (got,) = torch.autograd.grad(
        layers.linear_apply({"w": wt}, torch.from_numpy(x), pcfg).sum(), [wt])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# full-sequence forward and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["naive", "flash", "pallas"])
def test_forward_and_loss_match_repro(attn_impl):
    rcfg, rparams, pcfg, pparams = _pair(1, attn_impl=attn_impl)
    data = RSyntheticLM(rcfg, 2, 40)
    batch = data.global_batch(0)
    rh, rn, _ = RLM(rcfg).forward(rparams, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    rloss, rmet = RLM(rcfg).loss(rparams, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    model = LM(pcfg, "cpu")
    pbatch = SyntheticLM(pcfg, 2, 40).sharded_batch(0)
    with torch.no_grad():
        ph, pn, aux = model.forward(pparams, pbatch)
        ploss, pmet = model.loss(pparams, pbatch)
    assert pn == rn == 0 and float(aux) == 0.0
    _close(ph, rh, 1e-4)
    _close(ploss, rloss, 1e-4)
    assert set(pmet) == set(rmet) == {"loss", "ce", "aux"}
    _close(pmet["ce"], rmet["ce"], 1e-4)


def test_chunked_logits_give_the_same_loss():
    _, _, pcfg, pparams = _pair(2)
    batch = SyntheticLM(pcfg, 2, 32).sharded_batch(0)
    with torch.no_grad():
        whole, _ = LM(pcfg, "cpu").loss(pparams, batch)
        chunked, _ = LM(dataclasses.replace(pcfg, logits_chunk=8),
                        "cpu").loss(pparams, batch)
    _close(chunked, whole.numpy(), 1e-6)


# ---------------------------------------------------------------------------
# optimizer, clipping, schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_repro_over_steps(state_dtype):
    rng = np.random.default_rng(3)
    p = {"a": rng.standard_normal((5, 3)).astype(np.float32),
         "b": [rng.standard_normal(7).astype(np.float32)]}
    rinit, rupd = radamw(state_dtype=state_dtype)
    pinit, pupd = adamw(state_dtype=state_dtype)
    rp, pp = jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p)
    rs, ps = rinit(rp), pinit(pp)
    for i in range(4):
        g = {"a": rng.standard_normal((5, 3)).astype(np.float32),
             "b": [rng.standard_normal(7).astype(np.float32)]}
        lr = 1e-2 * (i + 1)
        rp, rs = rupd(jax.tree.map(jnp.asarray, g), rs, rp, lr)
        pp, ps = pupd(jax.tree.map(torch.from_numpy, g), ps, pp, lr)
    assert int(ps["step"]) == int(rs["step"]) == 4
    assert ps["m"]["a"].dtype == getattr(torch, state_dtype)
    for got, ref in ((pp, rp), (ps["m"], rs["m"]), (ps["v"], rs["v"])):
        _close(got["a"], jnp.asarray(ref["a"], jnp.float32), 1e-6)
        _close(got["b"][0], jnp.asarray(ref["b"][0], jnp.float32), 1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_repro(max_norm):
    rng = np.random.default_rng(4)
    g = {"a": rng.standard_normal((6, 2)).astype(np.float32),
         "b": rng.standard_normal(9).astype(np.float32)}
    rg, rn = rclip(jax.tree.map(jnp.asarray, g), max_norm)
    pg, pn = clip_by_global_norm(jax.tree.map(torch.from_numpy, g), max_norm)
    _close(pn, rn, 1e-6)
    for k in g:
        _close(pg[k], rg[k], 1e-6)


def test_warmup_cosine_matches_repro():
    rf, pf = rwarmup(3e-3, 5, 40), warmup_cosine(3e-3, 5, 40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        _close(pf(step), rf(step), 1e-6)


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_sgd_momentum_matches_repro_over_steps(momentum):
    rng = np.random.default_rng(6)
    p = {"a": rng.standard_normal((4, 3)).astype(np.float32),
         "b": [rng.standard_normal(5).astype(np.float32)]}
    rinit, rupd = rsgd(momentum)
    pinit, pupd = sgd_momentum(momentum)
    rp, pp = jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p)
    rs, ps = rinit(rp), pinit(pp)
    for i in range(3):
        g = {"a": rng.standard_normal((4, 3)).astype(np.float32),
             "b": [rng.standard_normal(5).astype(np.float32)]}
        rp, rs = rupd(jax.tree.map(jnp.asarray, g), rs, rp, 0.1 / (i + 1))
        pp, ps = pupd(jax.tree.map(torch.from_numpy, g), ps, pp,
                      0.1 / (i + 1))
    assert int(ps["step"]) == int(rs["step"]) == 3
    for got, ref in ((pp, rp), (ps["m"], rs["m"])):
        _close(got["a"], ref["a"], 1e-6)
        _close(got["b"][0], ref["b"][0], 1e-6)


# ---------------------------------------------------------------------------
# the step builders
# ---------------------------------------------------------------------------

def test_prefill_and_decode_steps_match_repro():
    """``make_prefill_step`` then two ``make_decode_step`` steps on the QAT
    latents against repro's (bf16 caches in both, as their prefill
    defaults): logits within 1e-3 of their magnitude (f32 sums in another
    order, then K/V rounded to bf16 alike)."""
    rcfg, rparams, pcfg, pparams = _pair(7)
    toks = np.random.default_rng(7).integers(
        0, rcfg.vocab_size, size=(2, 10)).astype(np.int32)
    max_len = 16
    rprefill = rsteps.make_prefill_step(RLM(rcfg), rcfg, max_len)
    rdecode = rsteps.make_decode_step(RLM(rcfg), rcfg)
    pprefill = steps.make_prefill_step(LM(pcfg, "cpu"), pcfg, max_len)
    pdecode = steps.make_decode_step(LM(pcfg, "cpu"), pcfg)
    rcache, rlog = rprefill(rparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        pcache, plog = pprefill(pparams, {"tokens": torch.from_numpy(toks)})
    _close(plog, rlog, 1e-3)
    nxt = np.asarray(jnp.argmax(rlog[:, -1], axis=-1)).astype(np.int32)
    for _ in range(2):
        rlog, rcache = rdecode(rparams, rcache, jnp.asarray(nxt[:, None]))
        with torch.no_grad():
            plog, pcache = pdecode(pparams, pcache,
                                   torch.from_numpy(nxt[:, None]))
        _close(plog, rlog, 1e-3)
        nxt = np.asarray(jnp.argmax(rlog[:, -1], axis=-1)).astype(np.int32)
    assert int(pcache["pos"]) == int(rcache["pos"]) == 12


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_accum,remat", [(1, "none"), (2, "none"),
                                              (1, "full")])
def test_train_step_matches_repro(grad_accum, remat):
    rcfg, rparams, pcfg, pparams = _pair(5, grad_accum=grad_accum,
                                         remat=remat)
    rstep, ropt_init = rsteps.make_train_step(RLM(rcfg), rcfg,
                                              rwarmup(1e-2, 2, 10))
    pstep, popt_init = steps.make_train_step(LM(pcfg, "cpu"), pcfg,
                                             warmup_cosine(1e-2, 2, 10))
    rstep = jax.jit(rstep)
    ropt, popt = ropt_init(rparams), popt_init(pparams)
    rdata, pdata = RSyntheticLM(rcfg, 4, 32), SyntheticLM(pcfg, 4, 32)
    lr_sum, loose = 0.0, None
    for i, tol in ((0, 1e-5), (1, None), (2, 1e-4)):
        rparams, ropt, rmet = rstep(rparams, ropt, {
            k: jnp.asarray(v) for k, v in rdata.global_batch(i).items()})
        pparams, popt, pmet = pstep(pparams, popt, pdata.sharded_batch(i))
        lr_sum += float(rmet["lr"])
        rv = _np(ropt["v"])
        # a difference an eps-dominated step made stays in the parameter
        now = _eps_dominated(rv, i + 1)
        loose = now if loose is None else jax.tree.map(np.logical_or,
                                                       loose, now)
        if tol is None:
            continue
        assert set(pmet) == set(rmet)
        for key in ("loss", "ce", "grad_norm", "lr"):
            _close(pmet[key], rmet[key], tol)
        assert sum(int(m.sum()) for m in jax.tree.leaves(loose)) \
            < 1e-2 * sum(m.size for m in jax.tree.leaves(loose))
        _close_trees(params_to_numpy(pparams, pcfg), _np(rparams), tol,
                     loose, 1.1 * lr_sum)
        pstate = opt_state_to_numpy(popt, pcfg)
        _close_trees(pstate["m"], _np(ropt["m"]), tol)
        _close_trees(pstate["v"], rv, tol)
        assert int(pstate["step"]) == int(ropt["step"]) == i + 1


# ---------------------------------------------------------------------------
# the training CLI: checkpoint, restart, resume across packages
# ---------------------------------------------------------------------------

ARGS = ["--reduced", "--set", "ternary_min_dim=64", "--set",
        "dtype=float32", "--batch", "4", "--seq", "32", "--lr", "3e-3",
        "--ckpt-every", "5", "--log-every", "100", "--device", "cpu"]


def test_train_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    """10 steps, then 15 into the same directory: the second run restores
    step 10 and runs 5 (tests/test_system.py's check, in-process)."""
    d = str(tmp_path)
    first = train.main(ARGS + ["--ckpt-dir", d, "--steps", "10"])
    assert first["steps"] == 10 and first["last_loss"] < first["first_loss"]
    second = train.main(ARGS + ["--ckpt-dir", d, "--steps", "15"])
    assert second["steps"] == 5
    assert rckpt.latest_step(d) == 15
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"steps": 5' in last


def test_train_checkpoints_restore_across_packages(tmp_path):
    """A checkpoint the port's trainer writes restores into repro's
    training state (its tree, dtypes and values), and the port's trainer
    resumes from a checkpoint repro's trainer wrote."""
    d = str(tmp_path / "port")
    train.main(ARGS + ["--ckpt-dir", d, "--steps", "2", "--ckpt-every",
                       "2"])
    rcfg = rget_config("ternary-paper", reduced=True, ternary_min_dim=64,
                       dtype="float32")
    _, _, _, rinit, _ = rtrain.build(rcfg, 4, 32, lr=3e-3, total_steps=2)
    target = jax.eval_shape(rinit, jax.ShapeDtypeStruct((2,), jnp.uint32))
    step, rstate = rckpt.restore(d, None, target)
    assert step == 2 and int(rstate["opt"]["step"]) == 2
    pstep, flat = __import__("repro_torch").checkpoint.restore(d)
    np.testing.assert_array_equal(
        np.asarray(rstate["params"]["block0"]["mixer"]["q"]["w"]),
        flat["params/block0/mixer/q/w"].numpy())

    d2 = str(tmp_path / "repro")
    rtrain.main(["--reduced", "--set", "ternary_min_dim=64", "--set",
                 "dtype=float32", "--batch", "4", "--seq", "32", "--lr",
                 "3e-3", "--ckpt-dir", d2, "--steps", "2", "--ckpt-every",
                 "2", "--log-every", "100"])
    resumed = train.main(ARGS + ["--ckpt-dir", d2, "--steps", "4"])
    assert resumed["steps"] == 2
    assert np.isfinite(resumed["last_loss"])


def test_train_cli_refuses_the_sharded_options(tmp_path):
    """repro's refusal: --compress-grads needs --data-parallel > 1 and
    --model-parallel 1 (the meshes themselves run since the distributed
    trainer was ported: tests/test_torch_dist_train.py)."""
    for extra in (["--compress-grads"],
                  ["--compress-grads", "--model-parallel", "2"]):
        with pytest.raises(SystemExit, match="pure data-parallel"):
            train.main(ARGS + ["--ckpt-dir", str(tmp_path)] + extra)


def test_train_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduced", "--steps", "1"])
