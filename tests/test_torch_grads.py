"""Gradients of the port's ternary GEMM rows and fused MLP held against
``repro``'s ``custom_vjp``s (``_gemm_2bit``, ``_gemm_bitplane``, and the
fused MLP's chain, pinned to ``impl="chain"``), on the same numpy-seeded
inputs in float32.

Two routes through the port are checked: the plain rows that CPU tensors
take (autograd through their torch ops), and the autograd Functions that
wrap the CUDA kernels (``_PackedGemm``, ``_FusedMlp``), driven here with
the plain version as their forward so that their backward — ``repro``'s
formula, the one the card runs — is exercised on the CPU.

Tolerance: 1e-4 of each gradient's magnitude; the same exact products are
summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rformats
from repro.core import weights as rweights
from repro.kernels import ops as rops
from repro_torch.core import weights
from repro_torch.kernels import fused_mlp as fused_lib
from repro_torch.kernels import ops

TOL = 1e-4

# (format, kernel row, pack options, K, N)
ROWS = {
    "dense2bit": ("dense2bit", "dense", {}, 64, 48),
    "tiled_skip": ("tiled", "skip", dict(tile_k=32, tile_n=16), 128, 48),
    "tiled_skip_db": ("tiled", "skip_db", dict(tile_k=32, tile_n=16), 128,
                      48),
    "tiled_dense": ("tiled", "dense", dict(tile_k=32, tile_n=16), 128, 48),
    "bitplane": ("bitplane", "bitplane", {}, 64, 48),
    "bitplane_factorized": ("bitplane", "bitplane_factorized", {}, 64, 48),
}


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL,
                               atol=TOL * max(float(np.abs(ref).max()), 1e-6))


def _matrix(fmt, k, n, seed, opts):
    rng = np.random.default_rng(seed)
    if fmt == "tiled":
        t = rformats.random_tile_ternary(rng, k, n, opts["tile_k"],
                                         opts["tile_n"], 0.125)
    else:
        t = rformats.random_ternary(rng, k, n, 0.5)
    return t.astype(np.int8)


def _repro_grads(fmt, impl, t, opts, x, scale, bias, prelu):
    wc = rweights.pack(t, fmt, **opts)

    def f(xx, s, b):
        y = rops.ternary_gemm(xx, wc, s, b, fuse_prelu=prelu, impl=impl)
        return jnp.sum(y ** 2)

    args = (jnp.asarray(x), jnp.asarray(scale),
            None if bias is None else jnp.asarray(bias))
    argnums = (0, 1) if bias is None else (0, 1, 2)
    return jax.grad(f, argnums=argnums)(*args)


def _port_grads(fmt, impl, t, opts, x, scale, bias, prelu, through_fn):
    w = weights.pack(torch.from_numpy(t), fmt, **opts)
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = None if bias is None else torch.from_numpy(bias).requires_grad_()
    if through_fn:
        def plain(x, s, b):
            return ops.ternary_gemm(x, w, s, b, fuse_prelu=prelu, impl="ref")
        y = ops._kernel_row(xt, w, st, bt, 0.25 if prelu else None, plain)
    else:
        y = ops.ternary_gemm(xt, w, st, bt, fuse_prelu=prelu, impl=impl)
    leaves = [xt, st] + ([] if bt is None else [bt])
    return torch.autograd.grad(y.square().sum(), leaves)


@pytest.mark.parametrize("row", sorted(ROWS))
@pytest.mark.parametrize("epilogue", ["scale", "scale_bias_prelu"])
@pytest.mark.parametrize("route", ["plain_row", "kernel_row_backward"])
def test_gemm_row_grads_match_repro(row, epilogue, route):
    fmt, impl, opts, k, n = ROWS[row]
    t = _matrix(fmt, k, n, 3, opts)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, k)).astype(np.float32)
    scale = (rng.random(n) + 0.5).astype(np.float32)
    prelu = epilogue != "scale"
    bias = rng.standard_normal(n).astype(np.float32) if prelu else None
    ref = _repro_grads(fmt, impl, t, opts, x, scale, bias, prelu)
    got = _port_grads(fmt, impl, t, opts, x, scale, bias, prelu,
                      route == "kernel_row_backward")
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close(g, r)


def _mlp_pair(seed, k=64, ff=96, n=48):
    rng = np.random.default_rng(seed)
    pairs = []
    for kk, nn in ((k, ff), (ff, n), (k, ff)):
        t = rformats.random_ternary(rng, kk, nn, 0.5).astype(np.int8)
        s = (rng.random(nn) + 0.5).astype(np.float32)
        b = rng.standard_normal(nn).astype(np.float32)
        pairs.append((weights.pack(torch.from_numpy(t), "dense2bit",
                                   scale=torch.from_numpy(s),
                                   bias=torch.from_numpy(b)),
                      rweights.pack(t, "dense2bit", scale=jnp.asarray(s),
                                    bias=jnp.asarray(b))))
    x = rng.standard_normal((8, k)).astype(np.float32)
    return pairs, x


@pytest.mark.parametrize("route", ["plain", "kernel_row_backward"])
def test_fused_mlp_grad_matches_repro_chain(route):
    ((wi, rwi), (wo, rwo), (wg, rwg)), x = _mlp_pair(5)
    ref = jax.grad(lambda xx: jnp.sum(rops.fused_mlp(
        xx, rwi, rwo, rwg, impl="chain") ** 2))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    if route == "plain":
        y = ops.fused_mlp(xt, wi, wo, wg)
    else:
        words = (wi.packed, wo.packed, wg.packed)
        y = ops._fused_row(xt, wi, wo, wg, "silu",
                           lambda x, *vecs: fused_lib.fused_mlp_ref(
                               x, *words, *vecs))
    (got,) = torch.autograd.grad(y.square().sum(), [xt])
    _close(got, ref)


def test_fused_mlp_kernel_row_vector_grads_match_plain():
    """The scales and biases of all three projections get the plain
    chain's gradients through ``_FusedMlp``'s backward."""
    ((wi, _), (wo, _), (wg, _)), x = _mlp_pair(6)
    x = torch.from_numpy(x)
    vecs = [wi.scale, wi.bias, wg.scale, wg.bias, wo.scale, wo.bias]
    for v in vecs:
        v.requires_grad_()
    words = (wi.packed, wo.packed, wg.packed)
    plain = ops.fused_mlp(x, wi, wo, wg)
    row = ops._fused_row(x, wi, wo, wg, "silu",
                         lambda x, *v: fused_lib.fused_mlp_ref(x, *words,
                                                               *v))
    for g, r in zip(torch.autograd.grad(row.square().sum(), vecs),
                    torch.autograd.grad(plain.square().sum(), vecs)):
        _close(g, r.numpy())


def test_kernel_row_builds_a_graph_only_when_a_gradient_is_needed():
    w = weights.pack(torch.from_numpy(_matrix("dense2bit", 64, 48, 1, {})),
                     "dense2bit", scale=torch.ones(48))
    x = torch.randn(4, 64)
    y = ops._kernel_row(x, w, w.scale, None, None,
                        lambda x, s, b: ops.ternary_gemm(x, w, s, b,
                                                         impl="ref"))
    assert y.grad_fn is None
    x.requires_grad_()
    y = ops._kernel_row(x, w, w.scale, None, None,
                        lambda x, s, b: ops.ternary_gemm(x, w, s, b,
                                                         impl="ref"))
    assert y.grad_fn is not None
    with torch.no_grad():
        y = ops._kernel_row(x, w, w.scale, None, None,
                            lambda x, s, b: ops.ternary_gemm(x, w, s, b,
                                                             impl="ref"))
    assert y.grad_fn is None
