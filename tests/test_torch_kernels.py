"""The port's ternary GEMM and fused MLP (their plain versions, which CPU
tensors take) held against ``repro`` on the same numpy-seeded inputs.

Tolerances: in float32 the two packages add the same exact products in
another order, so outputs agree to ~K·eps relative; 1e-5 of the output's
magnitude bounds that. In bfloat16 that reordering can flip the final
rounding by one bf16 ulp (2^-8 relative), so the bound is 2^-7 of the
output's magnitude; the fused block rounds three times on the way
(yi/yg, silu, the product) and gets 2^-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rformats
from repro.core import weights as rweights
from repro.kernels import ops as rops
from repro.kernels.ternary_gemm import ternary_gemm_pallas
from repro_torch.core import weights
from repro_torch.kernels import fused_mlp as fused_lib
from repro_torch.kernels import ops
from repro_torch.kernels import ternary_gemm as gemm_lib

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)}


def _close(got: torch.Tensor, ref, tol: float) -> None:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


def _inputs(rng, m, k, n, with_scale=True, with_bias=True):
    x = rng.standard_normal((m, k)).astype(np.float32)
    t = rng.integers(-1, 2, size=(k, n)).astype(np.int8)
    scale = (rng.random(n).astype(np.float32) + 0.5) if with_scale else None
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
    return x, t, scale, bias


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("epilogue", ["none", "scale_bias", "prelu"])
def test_ternary_gemm_matches_pallas_interpret(dtype, epilogue):
    """Pre-padded shapes against the Pallas kernel in interpret mode."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    m, k, n = 16, 512, 256
    x, t, scale, bias = _inputs(rng, m, k, n, epilogue != "none",
                                epilogue != "none")
    prelu = epilogue == "prelu"
    words = rformats.pack_2bit(t)
    ref = ternary_gemm_pallas(
        jnp.asarray(x, jdt), jnp.asarray(words), _j(scale), _j(bias),
        block_m=16, block_n=128, block_k=256, fuse_prelu=prelu,
        interpret=True)
    wc = weights.Dense2Bit.from_packed(
        torch.from_numpy(words.view(np.int32)), k=k, scale=_t(scale),
        bias=_t(bias))
    got = ops.ternary_gemm(torch.from_numpy(x).to(tdt), wc,
                           fuse_prelu=prelu)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    _close(got, ref, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mkn", [(5, 37, 19), (1, 16, 3), (9, 100, 64)])
def test_ternary_gemm_matches_ref_ragged(dtype, mkn):
    """Ragged M/N/K against repro's dense2bit 'ref' lowering; the port
    packs the same ternary matrix itself."""
    jdt, tdt, tol = DTYPES[dtype]
    m, k, n = mkn
    rng = np.random.default_rng(m * k)
    x, t, scale, bias = _inputs(rng, m, k, n)
    rw = rweights.pack(t, "dense2bit", scale=jnp.asarray(scale),
                       bias=jnp.asarray(bias))
    ref = rops.ternary_gemm(jnp.asarray(x, jdt), rw, impl="ref")
    wc = weights.pack(torch.from_numpy(t), scale=_t(scale), bias=_t(bias))
    got = ops.ternary_gemm(torch.from_numpy(x).to(tdt), wc)
    _close(got, ref, tol)


def _mlp_weights(rng, k, ff, n, biased):
    ws = {}
    for name, (kk, nn) in (("in", (k, ff)), ("gate", (k, ff)),
                           ("out", (ff, n))):
        t = rng.integers(-1, 2, size=(kk, nn)).astype(np.int8)
        s = (rng.random(nn).astype(np.float32) * 0.1 + 0.02)
        b = rng.standard_normal(nn).astype(np.float32) if biased else None
        ws[name] = (t, s, b)
    return ws


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("gated,activation,biased",
                         [(True, "silu", False), (True, "silu", True),
                          (False, "relu", True), (True, "none", False)])
def test_fused_mlp_matches_repro_chain(dtype, gated, activation, biased):
    """The port's fused MLP (plain version on CPU) against repro's 'chain'
    lowering — the literal unfused call chain."""
    jdt, tdt, tol = DTYPES[dtype]
    tol = tol if dtype == "float32" else 2.0 ** -6
    rng = np.random.default_rng(11)
    m, k, ff, n = 6, 64, 96, 40
    x = rng.standard_normal((m, k)).astype(np.float32)
    ws = _mlp_weights(rng, k, ff, n, biased)
    rw = {name: rweights.pack(t, "dense2bit", scale=jnp.asarray(s),
                              bias=_j(b)) for name, (t, s, b) in ws.items()}
    pw = {name: weights.pack(torch.from_numpy(t), scale=_t(s), bias=_t(b))
          for name, (t, s, b) in ws.items()}
    ref = rops.fused_mlp(jnp.asarray(x, jdt), rw["in"], rw["out"],
                         rw["gate"] if gated else None,
                         activation=activation, impl="chain")
    got = ops.fused_mlp(torch.from_numpy(x).to(tdt), pw["in"], pw["out"],
                        pw["gate"] if gated else None,
                        activation=activation)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    _close(got, ref, tol)


def test_plain_fused_is_the_plain_gemm_chain():
    """Bitwise: the fused plain version is literally the chain of plain
    GEMMs with h rounded to x.dtype."""
    rng = np.random.default_rng(2)
    ws = _mlp_weights(rng, 32, 48, 16, biased=True)
    pw = {name: weights.pack(torch.from_numpy(t), scale=_t(s), bias=_t(b))
          for name, (t, s, b) in ws.items()}
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    x = x.to(torch.bfloat16)
    got = ops.fused_mlp(x, pw["in"], pw["out"], pw["gate"])
    h = torch.nn.functional.silu(ops.ternary_gemm(x, pw["gate"])) \
        * ops.ternary_gemm(x, pw["in"])
    assert h.dtype == torch.bfloat16
    assert torch.equal(got, ops.ternary_gemm(h, pw["out"]))


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes a CPU
    tensor itself."""
    x = torch.zeros(2, 16, dtype=torch.bfloat16)
    words = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        gemm_lib.ternary_gemm_cuda(x, words)
    with pytest.raises(ValueError, match="CUDA"):
        fused_lib.fused_mlp_cuda(x, words, words)


def test_ops_validate_shapes_and_formats():
    wc = weights.pack(torch.ones(32, 8, dtype=torch.int8))
    with pytest.raises(ValueError):
        ops.ternary_gemm(torch.zeros(2, 16), wc)
    with pytest.raises(TypeError):
        ops.ternary_gemm(torch.zeros(2, 32), torch.zeros(2, 8))
    stacked = weights.pack(torch.ones(2, 32, 8, dtype=torch.int8))
    with pytest.raises(ValueError, match="stacked"):
        ops.ternary_gemm(torch.zeros(2, 32), stacked)
    with pytest.raises(ValueError):
        with ops.serving_phase("nope"):
            pass
    for phase in ("decode", "verify"):
        with ops.serving_phase(phase):
            assert ops.current_phase() == phase
    assert ops.current_phase() is None
