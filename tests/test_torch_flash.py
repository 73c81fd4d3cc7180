"""Full-sequence attention of the port held against ``repro``'s: B6's plain
version (``flash_attention_ref``, what CPU tensors take) against
``flash_attention_pallas`` in interpret mode and against the XLA blockwise
``flash_attention``; the port's differentiable blockwise copy
(``models.attention.flash_attention``) against the latter, forward and
gradient; and B6's lack of a gradient.

Tolerances (``tests/test_flash_kernel.py``'s): 2e-4 in float32 — the same
softmax summed over other blocks — and 5e-2 in bfloat16, where p is
rounded to bf16 before the PV product at block-dependent scales.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as rattention
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention

SHAPES = [(4, 128, 64), (2, 257, 64), (8, 96, 128)]
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(bh, s, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, s, hd)).astype(np.float32)
            for _ in range(3)]


def _close(got, ref, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,hd", SHAPES)
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_ref_matches_pallas_interpret(bh, s, hd, causal, dtype):
    q, k, v = _qkv(bh, s, hd)
    ref = flash_attention_pallas(
        *(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)), causal=causal,
        block_q=64, block_kv=64, interpret=True)
    got = fa.flash_attention(*(torch.from_numpy(a).to(TDT[dtype])
                               for a in (q, k, v)), causal=causal)
    assert got.dtype == TDT[dtype]
    _close(got, jnp.asarray(ref, jnp.float32), TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,hd", SHAPES)
def test_ref_and_blockwise_match_repro_xla_flash(bh, s, hd, causal):
    q, k, v = _qkv(bh, s, hd, seed=1)
    ref = rattention.flash_attention(
        *(jnp.asarray(a)[:, :, None] for a in (q, k, v)), causal=causal,
        window=0, block_q=64, block_kv=32)[:, :, 0]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _close(fa.flash_attention_ref(tq, tk, tv, causal=causal), ref, 2e-4)
    got = attention.flash_attention(
        tq[:, :, None], tk[:, :, None], tv[:, :, None], causal=causal,
        block_q=64, block_kv=32)[:, :, 0]
    _close(got, ref, 2e-4)


def test_blockwise_gqa_and_gradient_match_repro():
    """(B, S, H, hd) with 4 query heads over 2 KV heads, causal: forward
    and the gradient of sum(o^2) w.r.t. q, k, v."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
            for _ in range(2))

    def rf(a, b, c):
        return jnp.sum(rattention.flash_attention(
            a, b, c, causal=True, window=0, block_q=16, block_kv=32) ** 2)

    rgrads = jax.grad(rf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = attention.flash_attention(*ts, causal=True, block_q=16, block_kv=32)
    _close(o.detach(), rattention.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, window=0, block_q=16,
        block_kv=32), 2e-4)
    for g, r in zip(torch.autograd.grad(o.square().sum(), ts), rgrads):
        _close(g, r, 2e-4)


def test_b6_has_no_gradient():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(2, 64, 64))
    o = fa.flash_attention(q, k, v)
    assert o.grad_fn is not None        # joined the graph, not detached
    with pytest.raises(NotImplementedError, match="no VJP"):
        o.sum().backward()
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
