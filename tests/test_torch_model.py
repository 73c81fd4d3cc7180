"""The port's LM and serving engine held against ``repro`` on the same
weights: a reduced packed ``ternary-paper`` is initialised and packed by
``repro``, carried over through numpy by ``params_from_numpy``, and both
packages run prefill, decode and whole serving workloads on it.

Tolerances: in float32 (``dtype`` and ``cache_dtype`` float32) logits
agree to 1e-4 of their magnitude — the sums are the same, taken in another
order, through 4 layers. In bfloat16 every layer rounds activations to
2^-8; a sum that lands on the other side of a rounding boundary moves one
value by an ulp and that propagates, so logits are held to 3e-2 of their
magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.core import weights as rweights
from repro.launch import serve as rserve
from repro.models import LM as RLM
from repro.models import layers as rlayers
from repro.serving import ContinuousScheduler as RScheduler
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.weights import Dense2Bit
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.models.layers import pack_params
from repro_torch.serving import ContinuousScheduler

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def repro_tree_to_numpy(tree):
    """repro's param tree -> nested dicts of numpy arrays, each packed
    container as {"packed", "scale", "bias", "shape"} (the bridge's input
    format)."""
    if isinstance(tree, rweights.Dense2Bit):
        def arr(v):
            return None if v is None else np.asarray(v)
        return {"packed": arr(tree.packed), "scale": arr(tree.scale),
                "bias": arr(tree.bias), "shape": tuple(tree.shape)}
    if isinstance(tree, dict):
        return {k: repro_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _configs(dtype, num_layers=4, **overrides):
    kw = dict(ternary_min_dim=64, dtype=dtype, cache_dtype=dtype,
              num_layers=num_layers, **overrides)
    rcfg = rget_config("ternary-paper", reduced=True, **kw)
    pcfg = get_config("ternary-paper", reduced=True, **kw)
    return rcfg, pcfg


def _packed_pair(dtype, num_layers=4, seed=0, **overrides):
    rcfg, pcfg = _configs(dtype, num_layers, **overrides)
    rparams = rlayers.pack_params(RLM(rcfg).init(jax.random.PRNGKey(seed)),
                                  rcfg)
    rcfg = dataclasses.replace(rcfg, quantization="ternary_packed")
    pcfg = dataclasses.replace(pcfg, quantization="ternary_packed")
    pparams = params_from_numpy(repro_tree_to_numpy(rparams), pcfg, "cpu")
    return rcfg, rparams, pcfg, pparams


def _close(got: torch.Tensor, ref, tol: float) -> None:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_repro(dtype):
    rcfg, rparams, pcfg, pparams = _packed_pair(dtype)
    cache_dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    rng = np.random.default_rng(1)
    b, s, max_len = 2, 12, 20
    toks = rng.integers(0, rcfg.vocab_size, size=(b, s)).astype(np.int32)

    rlm, plm = RLM(rcfg), LM(pcfg, "cpu")
    rcache, rlog = rlm.prefill(rparams, {"tokens": jnp.asarray(toks)},
                               max_len, cache_dtype=cache_dt)
    pcache, plog = plm.prefill(pparams, {"tokens": torch.from_numpy(toks)},
                               max_len, cache_dtype=TDT[dtype])
    assert plog.dtype == TDT[dtype] and tuple(plog.shape) == rlog.shape
    _close(plog, rlog, TOL[dtype])
    _close(pcache["layers"][1]["k"], rcache["layers"]["cache0"]["k"][1],
           TOL[dtype])

    nxt = np.asarray(jnp.argmax(rlog[:, -1], axis=-1)).astype(np.int32)
    for _ in range(3):
        rlog, rcache = rlm.decode_step(rparams, rcache,
                                       jnp.asarray(nxt[:, None]))
        plog, pcache = plm.decode_step(pparams, pcache,
                                       torch.from_numpy(nxt[:, None]))
        _close(plog, rlog, TOL[dtype])
        nxt = np.asarray(jnp.argmax(rlog[:, -1], axis=-1)).astype(np.int32)
    assert int(pcache["pos"]) == int(rcache["pos"]) == s + 3


def test_per_slot_decode_matches_repro():
    """Decode with a (B,) position vector — each row at its own offset,
    the continuous-batching path."""
    rcfg, rparams, pcfg, pparams = _packed_pair("float32", num_layers=2)
    rng = np.random.default_rng(4)
    max_len = 16
    rlm, plm = RLM(rcfg), LM(pcfg, "cpu")
    rc = rlm.init_cache(3, max_len, jnp.float32)
    pc = plm.init_cache(3, max_len, torch.float32)
    pos = np.array([0, 3, 7], np.int32)
    rc = dict(rc, pos=jnp.asarray(pos))
    pc = dict(pc, pos=torch.from_numpy(pos))
    for _ in range(3):
        tok = rng.integers(0, rcfg.vocab_size, size=(3, 1)).astype(np.int32)
        rlog, rc = rlm.decode_step(rparams, rc, jnp.asarray(tok))
        plog, pc = plm.decode_step(pparams, pc, torch.from_numpy(tok))
        _close(plog, rlog, TOL["float32"])
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(rc["pos"]))


def test_pack_params_matches_repro_on_same_latents():
    """The port's own pack_params over repro's latent weights gives the same
    words and scales as repro's pack_params."""
    rcfg, pcfg = _configs("float32", num_layers=2)
    latent = RLM(rcfg).init(jax.random.PRNGKey(3))
    rpacked = rlayers.pack_params(latent, rcfg)
    platent = params_from_numpy(repro_tree_to_numpy(latent), pcfg, "cpu")
    ppacked = pack_params(platent, pcfg)
    for i in range(2):
        got = ppacked["layers"][i]["ffn"]["gate"]["w_packed"]
        ref = rpacked["block0"]["ffn"]["gate"]["w_packed"]
        assert isinstance(got, Dense2Bit) and got.shape == tuple(ref.shape)
        np.testing.assert_array_equal(got.packed.numpy().view(np.uint32),
                                      np.asarray(ref.packed)[i])
        np.testing.assert_allclose(got.scale.numpy(),
                                   np.asarray(ref.scale)[i], rtol=1e-6,
                                   atol=1e-6)
    got = ppacked["unembed"]["w_packed"]
    np.testing.assert_array_equal(got.packed.numpy().view(np.uint32),
                                  np.asarray(rpacked["unembed"]["w_packed"]
                                             .packed))


def _record_groups(engine, log):
    orig = engine._prefill_group

    def wrapped(group):
        log.append([(req.rid, slot) for req, slot, _ in group])
        return orig(group)

    engine._prefill_group = wrapped


@pytest.mark.parametrize("slots,gen_lens", [(3, (2, 9)), (2, (1, 5, 12))])
def test_engines_give_equal_streams_in_float32(slots, gen_lens):
    """Both engines on the same prompts and weights: equal greedy streams
    per request, the same admission groups and slots, and run() metrics
    whose keys are a subset of repro's."""
    rcfg, rparams, pcfg, pparams = _packed_pair("float32", num_layers=2)
    prompts, gens, _ = rserve.build_workload(rcfg, 7, 8, gen_lens, seed=5)
    pprompts, pgens, _ = serve.build_workload(pcfg, 7, 8, gen_lens, seed=5)
    np.testing.assert_array_equal(prompts, pprompts)
    assert gens == pgens
    max_len = 8 + max(gen_lens) + 1

    reng = RScheduler(rcfg, max_slots=slots, max_len=max_len)
    reng.load(rparams)
    peng = ContinuousScheduler(pcfg, max_slots=slots, max_len=max_len,
                               device="cpu")
    peng.load(pparams)
    rlog, plog = [], []
    _record_groups(reng, rlog)
    _record_groups(peng, plog)
    routs, rmet = rserve.run_continuous(reng, prompts, gens)
    pouts, pmet = serve.run_continuous(peng, prompts, gens)
    assert len(rlog) >= 2 and plog == rlog
    for r, p in zip(routs, pouts):
        np.testing.assert_array_equal(p, r)
    assert set(pmet) <= set(rmet)
    for key in ("submitted", "drained", "generated_tokens", "prefill_steps",
                "decode_steps"):
        assert pmet[key] == rmet[key], key
    assert peng.pool.all_free
