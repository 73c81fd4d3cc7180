"""The port's MoE layer (``repro_torch.models.moe``) held against
``repro.models.moe`` on the same numpy inputs from a seed: ``moe_apply``'s
output and aux loss over latent and QAT banks, with capacity that drops
tokens, with tied gates, with a shared expert and with routing blocks;
``pack_moe``'s words and scales; the packed banks against QAT; the
top-k tie order; and the planners leave MoE nodes alone.

Tolerances: float32 outputs and aux within 1e-4 (relative and absolute,
the absolute scaled by max|ref|): the same products summed in another
order. Packed banks against QAT: 1e-3, as ``repro``'s own test holds
them. Words and indices: exact. TWN scales (an f32 mean over K, summed in
another order): within 1e-6 relative, as ``test_torch_core.py`` holds
them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.core import weights as rweights
from repro.models import moe as rmoe
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.serving.engine import _is_packed_linear

TOL = 1e-4
QAT_TOL = 1e-3
SCALE_TOL = 1e-6

CASES = {
    "base": {},
    "drops": {"capacity_factor": 1.0},
    "shared": {"n_shared_experts": 1},
    "route_blocks": {"moe_route_blocks": 2},
    "qat": {"quantization": "ternary", "ternary_min_dim": 64},
    "top1": {"num_experts_per_tok": 1, "capacity_factor": 1.25},
}


def _cfgs(**overrides):
    kw = dict(dtype="float32", **overrides)
    return (rget_config("mixtral-8x22b", reduced=True, **kw),
            get_config("mixtral-8x22b", reduced=True, **kw))


def _params(cfg, seed=0):
    """numpy MoE params as repro's moe_init shapes them."""
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff_expert

    def n(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    p = {"router": n(d, e, std=d ** -0.5),
         "w_in": n(e, d, f, std=d ** -0.5),
         "w_gate": n(e, d, f, std=d ** -0.5),
         "w_out": n(e, f, d, std=f ** -0.5)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        p.update(shared_in=n(d, fs, std=d ** -0.5),
                 shared_gate=n(d, fs, std=d ** -0.5),
                 shared_out=n(fs, d, std=fs ** -0.5))
    return p


def _x(cfg, b=2, s=12, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _close(got: torch.Tensor, ref, tol=TOL) -> None:
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()), 1e-6))


def _both(rcfg, pcfg, params, x):
    ry, raux = rmoe.moe_apply({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x), rcfg)
    py, paux = moe.moe_apply({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             torch.from_numpy(x), pcfg)
    return (np.asarray(ry), float(raux)), (py, float(paux))


def _dropped(cfg, params, x) -> int:
    """(token, chosen expert) pairs the expert's capacity did not keep."""
    t = torch.from_numpy(x).reshape(-1, cfg.d_model)
    probs = torch.softmax(t @ torch.from_numpy(params["router"]), dim=-1)
    top_p, ids = moe.top_k(probs, cfg.num_experts_per_tok)
    gates = torch.zeros_like(probs).scatter(-1, ids, top_p)
    cap = min(max(int(np.ceil(t.shape[0] * cfg.num_experts_per_tok
                              / cfg.num_experts * cfg.capacity_factor)), 1),
              t.shape[0])
    _, kept = moe.top_k(gates.T, cap)                     # (E, C)
    held = torch.zeros_like(gates.T).scatter(-1, kept, 1.0).T
    return int(((gates > 0) & (held == 0)).sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_repro(case):
    rcfg, pcfg = _cfgs(**CASES[case])
    params, x = _params(pcfg), _x(pcfg)
    (ry, raux), (py, paux) = _both(rcfg, pcfg, params, x)
    _close(py, ry)
    assert abs(paux - raux) <= TOL * max(abs(raux), 1.0)
    if case == "drops":
        assert _dropped(pcfg, params, x) > 0


def test_tied_gates_keep_repros_tokens():
    """A zero router ties every expert for every token (top-k takes the
    lowest ids) and then every token for each expert's capacity (top-C
    takes the lowest token ids); with capacity 1.0 later tokens drop."""
    rcfg, pcfg = _cfgs(capacity_factor=1.0)
    params = _params(pcfg)
    params["router"] = np.zeros_like(params["router"])
    x = _x(pcfg)
    (ry, raux), (py, paux) = _both(rcfg, pcfg, params, x)
    _close(py, ry)
    assert abs(paux - raux) <= TOL * max(abs(raux), 1.0)
    kept = np.abs(ry.reshape(-1, pcfg.d_model)).sum(-1) > 0
    assert kept.any() and not kept.all()        # early tokens kept, late dropped


def test_top_k_orders_ties_as_jax():
    a = np.array([[0.5, 0.25, 0.5, 0.25, 0.0, 0.5],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(a), 4)
    pv, pi = moe.top_k(torch.from_numpy(a), 4)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))


def test_pack_moe_words_and_scales_equal_repros():
    rcfg, pcfg = _cfgs(quantization="ternary", ternary_min_dim=64)
    params = _params(pcfg)
    rp = rmoe.pack_moe({k: jnp.asarray(v) for k, v in params.items()}, rcfg)
    pp = moe.pack_moe({k: torch.from_numpy(v) for k, v in params.items()},
                      pcfg)
    assert isinstance(pp["router"], torch.Tensor)
    for name in ("w_in", "w_gate", "w_out"):
        r, p = rp[name], pp[name]
        assert isinstance(r, rweights.Dense2Bit)
        assert tuple(p.shape) == tuple(r.shape) and p.nnz == r.nnz
        np.testing.assert_array_equal(
            p.packed.numpy().view(np.uint32), np.asarray(r.packed))
        np.testing.assert_allclose(p.scale.numpy(), np.asarray(r.scale),
                                   rtol=SCALE_TOL, atol=0)
        assert p.packed.ndim == 3                      # (E, K/16, N)
    # the gate: unquantized configs and small experts pass through
    for cfg in (_cfgs()[1], _cfgs(quantization="ternary")[1]):
        same = moe.pack_moe({k: torch.from_numpy(v)
                             for k, v in params.items()}, cfg)
        assert isinstance(same["w_in"], torch.Tensor)


def test_packed_banks_match_qat():
    """repro's test_packed_moe_matches_qat on the port's layer."""
    _, pcfg = _cfgs(quantization="ternary", ternary_min_dim=64)
    params = {k: torch.from_numpy(v) for k, v in _params(pcfg).items()}
    x = torch.from_numpy(_x(pcfg))
    qat, _ = moe.moe_apply(params, x, pcfg)
    packed = moe.pack_moe(params, pcfg)
    got, _ = moe.moe_apply(packed, x, dataclasses.replace(
        pcfg, quantization="ternary_packed"))
    _close(got, qat.numpy(), QAT_TOL)


def test_planners_leave_moe_nodes_alone():
    """Plans cover packed linears only: a MoE node is not an MLP to fuse,
    and its banks are not linears to plan."""
    _, pcfg = _cfgs(quantization="ternary", ternary_min_dim=64)
    node = moe.pack_moe({k: torch.from_numpy(v)
                         for k, v in _params(pcfg).items()}, pcfg)
    assert ops._mlp_containers(node) is None
    assert ops.precompute_fused_plans({"ffn": node}, decode_ms=(4,)) == {}
    assert ops.precompute_plans({"ffn": node}, decode_ms=(4,),
                                select=_is_packed_linear) == {}
