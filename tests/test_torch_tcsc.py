"""The paper's TCSC formats, their matmuls and exact-sparsity ternarization
in the port, against ``repro`` on the same numpy draws (CPU).

* ``TCSC``, ``BlockedTCSC`` and ``InterleavedTCSC``: every array equal to
  ``repro``'s element for element (values and int32), over ragged K and N,
  all-zero columns and rows, block sizes that do not divide K, groups 4
  and 8; ``to_dense`` round trips and ``nbytes`` equal.
* ``tcsc_matmul*``: float32 inputs, within 1e-4 of ``repro``'s (relative
  to the output's largest magnitude: the same sums in another order),
  with and without alpha, bias and PReLU.
* ``ternarize_target_sparsity``: T bitwise and alpha within 1e-6
  relative, per channel and per tensor, tied magnitudes included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rformats
from repro.core import quantize as rquantize
from repro.kernels import ref as rref
from repro_torch.core import formats, quantize
from repro_torch.kernels import ref

MATMUL_TOL = 1e-4
ALPHA_RTOL = 1e-6


def _ternary(k, n, sparsity, seed, zero_cols=(), zero_rows=()):
    w = rformats.random_ternary(np.random.default_rng(seed), k, n, sparsity)
    w[:, list(zero_cols)] = 0
    w[list(zero_rows), :] = 0
    return w


# ragged K/N, a dense-ish and a sparse matrix, empty columns and rows, an
# all-zero matrix, one column, one row
SHAPES = [
    dict(k=37, n=23, sparsity=0.5, seed=0, zero_cols=(0, 5, 22)),
    dict(k=129, n=65, sparsity=0.0625, seed=1, zero_rows=range(40, 60)),
    dict(k=200, n=7, sparsity=0.9, seed=2),
    dict(k=16, n=16, sparsity=0.0, seed=3),
    dict(k=64, n=1, sparsity=0.5, seed=4),
    dict(k=1, n=33, sparsity=0.5, seed=5),
]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _same_tcsc(p, r):
    for name in ("col_start_pos", "col_start_neg", "row_index_pos",
                 "row_index_neg"):
        _same(getattr(p, name), getattr(r, name))
    assert p.shape == r.shape
    _same(p.segment_ids_pos(), r.segment_ids_pos())
    _same(p.segment_ids_neg(), r.segment_ids_neg())
    assert p.nbytes() == r.nbytes()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s['k']}x{s['n']}")
def test_tcsc_arrays_equal_repro(shape):
    w = _ternary(**shape)
    p, r = formats.TCSC.from_dense(w), rformats.TCSC.from_dense(w)
    _same_tcsc(p, r)
    _same(p.to_dense(), w)
    _same(formats.TCSC.from_dense(torch.from_numpy(w)).row_index_neg,
          r.row_index_neg)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s['k']}x{s['n']}")
@pytest.mark.parametrize("block", [8, 50, 4096])
def test_blocked_tcsc_arrays_equal_repro(shape, block):
    w = _ternary(**shape)
    p = formats.BlockedTCSC.from_dense(w, block)
    r = rformats.BlockedTCSC.from_dense(w, block)
    assert p.block_size == r.block_size and p.shape == r.shape
    assert len(p.blocks) == len(r.blocks)
    for pb, rb in zip(p.blocks, r.blocks):
        _same_tcsc(pb, rb)
    _same(p.to_dense(), w)
    assert p.nbytes() == r.nbytes()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s['k']}x{s['n']}")
@pytest.mark.parametrize("group", [4, 8])
def test_interleaved_tcsc_arrays_equal_repro(shape, group):
    w = _ternary(**shape)
    p = formats.InterleavedTCSC.from_dense(w, group)
    r = rformats.InterleavedTCSC.from_dense(w, group)
    assert p.group == r.group and p.shape == r.shape
    _same(p.all_indices, r.all_indices)
    _same(p.col_segment_ptr, r.col_segment_ptr)
    _same(p.signs(), r.signs())
    _same(p.segment_ids(), r.segment_ids())
    _same(p.to_dense(), w)
    assert p.nbytes() == r.nbytes()


def test_interleaved_columns_with_unequal_signs():
    """Columns of only +1, only -1, and groups that leave remainders on
    either side."""
    w = np.zeros((40, 4), np.int8)
    w[:9, 0] = 1
    w[:13, 1] = -1
    w[0:30:2, 2], w[1:12:2, 2] = 1, -1
    w[0:8, 3], w[8:35, 3] = 1, -1
    for group in (4, 8):
        p = formats.InterleavedTCSC.from_dense(w, group)
        r = rformats.InterleavedTCSC.from_dense(w, group)
        _same(p.all_indices, r.all_indices)
        _same(p.col_segment_ptr, r.col_segment_ptr)
        _same(p.signs(), r.signs())
        _same(p.to_dense(), w)


EPILOGUES = {
    "plain": {},
    "alpha_bias": dict(alpha=True, bias=True),
    "alpha_bias_prelu": dict(alpha=True, bias=True, prelu_alpha=0.25),
}


def _epilogue_args(kind, n, seed):
    spec = EPILOGUES[kind]
    rng = np.random.default_rng(seed)
    alpha = (rng.uniform(0.5, 1.5, n).astype(np.float32)
             if spec.get("alpha") else None)
    bias = (rng.standard_normal(n).astype(np.float32)
            if spec.get("bias") else None)
    return alpha, bias, spec.get("prelu_alpha")


def _both(fn_p, fn_r, x, wp, wr, alpha, bias, pa):
    tp = (lambda a: None if a is None else torch.from_numpy(a))
    tj = (lambda a: None if a is None else jnp.asarray(a))
    got = fn_p(torch.from_numpy(x), wp, tp(alpha), tp(bias), pa)
    want = np.asarray(fn_r(jnp.asarray(x), wr, tj(alpha), tj(bias), pa))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=MATMUL_TOL,
                               atol=MATMUL_TOL * scale)
    dense = ref.ternary_matmul_dense(torch.from_numpy(x),
                                     torch.from_numpy(wr_dense(wr)),
                                     tp(alpha), tp(bias), pa)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=MATMUL_TOL,
                               atol=MATMUL_TOL * scale)


def wr_dense(wr):
    return np.asarray(wr.to_dense())


@pytest.mark.parametrize("kind", list(EPILOGUES))
@pytest.mark.parametrize("shape", SHAPES[:3], ids=lambda s: f"{s['k']}x{s['n']}")
@pytest.mark.parametrize("m", [1, 5])
def test_tcsc_matmuls_match_repro(kind, shape, m):
    w = _ternary(**shape)
    k, n = w.shape
    x = np.random.default_rng(7).standard_normal((m, k)).astype(np.float32)
    alpha, bias, pa = _epilogue_args(kind, n, 8)
    _both(ref.tcsc_matmul, rref.tcsc_matmul, x, formats.TCSC.from_dense(w),
          rformats.TCSC.from_dense(w), alpha, bias, pa)
    _both(ref.tcsc_matmul_blocked, rref.tcsc_matmul_blocked, x,
          formats.BlockedTCSC.from_dense(w, 50),
          rformats.BlockedTCSC.from_dense(w, 50), alpha, bias, pa)
    for group in (4, 8):
        _both(ref.tcsc_matmul_interleaved, rref.tcsc_matmul_interleaved, x,
              formats.InterleavedTCSC.from_dense(w, group),
              rformats.InterleavedTCSC.from_dense(w, group), alpha, bias, pa)


def test_tcsc_matmul_keeps_bf16_inputs_dtype():
    w = _ternary(k=64, n=32, sparsity=0.25, seed=9)
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    for fmt, fn in ((formats.TCSC.from_dense(w), ref.tcsc_matmul),
                    (formats.InterleavedTCSC.from_dense(w),
                     ref.tcsc_matmul_interleaved)):
        got = fn(x.bfloat16(), fmt)
        want = ref.ternary_matmul_dense(x.bfloat16(), torch.from_numpy(w))
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2)


def _weights(kind, k, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal((k, n)).astype(np.float32)
    # tied magnitudes: a few levels, each sign, so quantiles land on ties
    levels = np.array([0.25, 0.5, 1.0, 2.0], np.float32)
    return (rng.choice(levels, (k, n))
            * rng.choice(np.array([-1, 1], np.float32), (k, n)))


@pytest.mark.parametrize("kind", ["normal", "tied"])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("k,n,sparsity", [(1000, 96, 1 / 16), (257, 31, 0.5),
                                          (64, 8, 0.25), (33, 5, 0.125)])
def test_ternarize_target_sparsity_matches_repro(kind, per_channel, k, n,
                                                 sparsity):
    w = _weights(kind, k, n, seed=k + n)
    t, alpha = quantize.ternarize_target_sparsity(
        torch.from_numpy(w), sparsity, per_channel=per_channel)
    rt, ralpha = rquantize.ternarize_target_sparsity(
        jnp.asarray(w), sparsity, per_channel=per_channel)
    _same(t, rt)
    assert tuple(alpha.shape) == ralpha.shape
    assert alpha.dtype == torch.float32
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ralpha),
                               rtol=ALPHA_RTOL, atol=0)
    if kind == "normal" and per_channel:
        # the paper's convention: about a `sparsity` share survives
        share = float((t != 0).float().mean())
        assert abs(share - sparsity) <= 1.0 / k + 1e-6
