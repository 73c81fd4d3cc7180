"""The port's Mamba2 mixer (``repro_torch.models.ssm``) held against
``repro.models.ssm`` on the same numpy inputs from a seed: ``ssd_chunked``
over one chunk and several, with and without an initial state, in float32
and bfloat16; ``ssm_apply`` over a full sequence (output and the cache it
returns) and over single-token steps from that cache (output and the
state and conv rows it writes in place); the caches' shapes and dtypes.

Tolerances: float32 within 1e-4 (relative, and absolute scaled by
max|ref|): the same sums taken in another order. bfloat16 inputs within
3e-2: every product rounds its operands through bfloat16 at ``repro``'s
points, and a value that lands across a rounding boundary moves an ulp
(2^-8), as ``test_torch_model.py`` holds bf16 logits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import ssm as rssm
from repro_torch.configs import get_config
from repro_torch.models import ssm

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got: torch.Tensor, ref, tol) -> None:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()), 1e-6))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk,init", [(8, False), (32, False), (8, True)])
def test_ssd_chunked_matches_repro(dtype, chunk, init):
    rng = np.random.default_rng(0)
    b, l, h, p, s = 2, 32, 4, 8, 16
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    a = -rng.random((b, l, h)).astype(np.float32)
    bm = rng.standard_normal((b, l, h, s)).astype(np.float32)
    cm = rng.standard_normal((b, l, h, s)).astype(np.float32)
    st = rng.standard_normal((b, h, p, s)).astype(np.float32) if init else None
    jx, tx = _pair(x, dtype)
    jb, tb = _pair(bm, dtype)
    jc, tc = _pair(cm, dtype)
    ry, rs = rssm.ssd_chunked(jx, jnp.asarray(a), jb, jc, chunk,
                              None if st is None else jnp.asarray(st))
    py, ps = ssm.ssd_chunked(tx, torch.from_numpy(a), tb, tc, chunk,
                             None if st is None else torch.from_numpy(st))
    assert py.dtype == TDT[dtype] and ps.dtype == torch.float32
    _close(py, ry, TOL[dtype])
    _close(ps, rs, TOL[dtype])


def test_ssd_chunked_keeps_repros_assertion():
    """L must be a multiple of the chunk (no padding: it would change the
    state)."""
    z = torch.zeros(1, 24, 2, 4)
    with pytest.raises(AssertionError):
        ssm.ssd_chunked(z, torch.zeros(1, 24, 2), torch.zeros(1, 24, 2, 8),
                        torch.zeros(1, 24, 2, 8), 16)


def _cfgs(dtype, reduced=True):
    kw = dict(dtype=dtype, cache_dtype=dtype, reduced=reduced)
    return (rget_config("mamba2-130m", **kw),
            get_config("mamba2-130m", **kw))


def _params(cfg, seed=0):
    """numpy mixer params in repro's shapes (non-trivial conv bias,
    dt bias and skip, so every term shows)."""
    rng = np.random.default_rng(seed)
    d, di = cfg.d_model, cfg.d_inner
    g, s, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim, d_proj = di + 2 * g * s, 2 * di + 2 * g * s + h

    def n(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return {"in_proj": {"w": n(d, d_proj, std=d ** -0.5)},
            "out_proj": {"w": n(di, d, std=di ** -0.5)},
            "conv_w": n(cfg.ssm_conv, conv_dim, std=0.5),
            "conv_b": n(conv_dim, std=0.1),
            "a_log": np.log(np.arange(1, h + 1, dtype=np.float32)),
            "dt_bias": n(h, std=0.5),
            "d_skip": 1.0 + n(h, std=0.1),
            "norm_scale": 1.0 + n(di, std=0.1)}


def _trees(params):
    def j(node):
        return ({k: j(v) for k, v in node.items()} if isinstance(node, dict)
                else jnp.asarray(node))

    def t(node):
        return ({k: t(v) for k, v in node.items()} if isinstance(node, dict)
                else torch.from_numpy(node))

    return j(params), t(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_full_then_steps_match_repro(dtype):
    """A 32-token sequence (two 16-token chunks) with a cache: output and
    the returned state and conv tail; then three single-token steps from
    that cache: outputs, and the rows each step writes in place."""
    _full_then_steps(*_cfgs(dtype), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_at_full_widths_matches_repro(dtype):
    """The same at mamba2-130m's full widths (d 768, d_inner 1536, 24
    heads of 64, state 128, chunk 256: the 32 tokens are one chunk)."""
    _full_then_steps(*_cfgs(dtype, reduced=False), dtype)


def _full_then_steps(rcfg, pcfg, dtype):
    rp, pp = _trees(_params(pcfg))
    x = np.random.default_rng(1).standard_normal(
        (2, 32, pcfg.d_model)).astype(np.float32) * 0.5
    jx, tx = _pair(x, dtype)
    rc0 = rssm.init_ssm_cache(rcfg, 2, JDT[dtype])
    pc0 = ssm.init_ssm_cache(pcfg, 2, TDT[dtype])
    for name in ("state", "conv"):
        assert tuple(pc0[name].shape) == rc0[name].shape
        assert str(pc0[name].dtype).split(".")[-1] == str(rc0[name].dtype)
    ry, rc = rssm.ssm_apply(rp, jx, rcfg, cache=rc0)
    py, pc = ssm.ssm_apply(pp, tx, pcfg, cache=pc0)
    tol = TOL[dtype]
    _close(py, ry, tol)
    _close(pc["state"], rc["state"], tol)
    _close(pc["conv"], rc["conv"], tol)
    # the port's decode writes the rows of the cache it is given
    pc = {k: v.to(pc0[k].dtype).clone() for k, v in pc.items()}
    rc = {k: v.astype(rc0[k].dtype) for k, v in rc.items()}
    rows = {k: v.data_ptr() for k, v in pc.items()}
    for step in range(3):
        xs = np.random.default_rng(10 + step).standard_normal(
            (2, 1, pcfg.d_model)).astype(np.float32) * 0.5
        jxs, txs = _pair(xs, dtype)
        pos = np.array([32 + step] * 2, np.int32)
        ry, rc = rssm.ssm_apply(rp, jxs, rcfg, cache=rc,
                                cache_pos=jnp.asarray(pos))
        py, out = ssm.ssm_apply(pp, txs, pcfg, cache=pc,
                                cache_pos=torch.from_numpy(pos))
        assert out is pc and {k: v.data_ptr() for k, v in pc.items()} == rows
        _close(py, ry, tol)
        _close(pc["state"], rc["state"], tol)
        _close(pc["conv"], rc["conv"], tol)


def test_raw_tail_and_split_match_repro():
    rcfg, pcfg = _cfgs("float32")
    d_proj = 2 * pcfg.d_inner + 2 * pcfg.ssm_groups * pcfg.ssm_state \
        + pcfg.ssm_heads
    proj = np.random.default_rng(2).standard_normal(
        (2, 9, d_proj)).astype(np.float32)
    want = rssm.xbc_raw_tail(None, jnp.asarray(proj), rcfg)
    got = ssm.xbc_raw_tail(None, torch.from_numpy(proj), pcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(ssm._split_proj(torch.from_numpy(proj), pcfg),
                    rssm._split_proj(jnp.asarray(proj), rcfg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
