"""The port's formats, quantization and containers held against ``repro``
on the same numpy-seeded inputs: packed words bit for bit, ternary codes
exactly, TWN scales within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rformats
from repro.core import quantize as rquantize
from repro.core import weights as rweights
from repro_torch.core import formats, quantize, weights


def _ternary(rng, shape):
    return rng.integers(-1, 2, size=shape).astype(np.int8)


@pytest.mark.parametrize("shape", [(16, 8), (64, 33), (37, 5), (1, 3),
                                   (48, 128)])
def test_pack_2bit_bitwise_equal(shape):
    rng = np.random.default_rng(sum(shape))
    t = _ternary(rng, shape)
    ref = rformats.pack_2bit(t)
    got = formats.pack_2bit(torch.from_numpy(t))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


def test_pack_2bit_all_minus_one_sets_bit_31():
    # code 2 in the top slot sets the word's sign bit: the int32 view must
    # keep the uint32 bit pattern exactly
    t = -np.ones((16, 4), np.int8)
    got = formats.pack_2bit(torch.from_numpy(t)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, rformats.pack_2bit(t))
    assert (got == 0xAAAAAAAA).all()


@pytest.mark.parametrize("k", [16, 37, 64])
def test_decode_2bit_matches_repro(k):
    rng = np.random.default_rng(k)
    t = _ternary(rng, (k, 9))
    words = rformats.pack_2bit(t)
    ref = np.asarray(rformats.decode_2bit(jnp.asarray(words), k,
                                          dtype=jnp.float32))
    got = formats.decode_2bit(torch.from_numpy(words.view(np.int32)), k,
                              torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), t.astype(np.float32))


def test_pack_2bit_stacked_leading_dims():
    rng = np.random.default_rng(3)
    t = _ternary(rng, (3, 40, 7))
    got = formats.pack_2bit(torch.from_numpy(t)).numpy().view(np.uint32)
    for i in range(3):
        np.testing.assert_array_equal(got[i], rformats.pack_2bit(t[i]))


@pytest.mark.parametrize("shape,per_channel", [((64, 32), True),
                                               ((128, 48), True),
                                               ((37, 11), True),
                                               ((64, 32), False)])
def test_ternarize_matches_repro(shape, per_channel):
    rng = np.random.default_rng(shape[0])
    w = rng.standard_normal(shape).astype(np.float32)
    t_ref, a_ref = rquantize.ternarize(jnp.asarray(w), 0.7,
                                       per_channel=per_channel)
    t, a = quantize.ternarize(torch.from_numpy(w), 0.7,
                              per_channel=per_channel)
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_ref))
    assert t.dtype == torch.int8
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_pack_float_weight_matches_repro(lead):
    """weights.pack of a float matrix (stacked or not): same words, same
    per-channel scales, same nnz as repro's Dense2Bit."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal(lead + (96, 40)).astype(np.float32)
    ref = rweights.pack(w, "dense2bit")
    got = weights.pack(torch.from_numpy(w))
    np.testing.assert_array_equal(got.packed.numpy().view(np.uint32),
                                  np.asarray(ref.packed))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale),
                               rtol=1e-6, atol=1e-6)
    assert got.shape == tuple(ref.shape) and got.nnz == ref.nnz


def test_dense2bit_from_packed_and_materialize():
    rng = np.random.default_rng(5)
    t = _ternary(rng, (37, 6))
    words = torch.from_numpy(rformats.pack_2bit(t).view(np.int32))
    scale = torch.from_numpy(rng.random(6).astype(np.float32))
    wc = weights.Dense2Bit.from_packed(words, k=37, scale=scale)
    np.testing.assert_array_equal(wc.materialize().numpy(),
                                  t.astype(np.float32))
    np.testing.assert_allclose(wc.materialize(with_scale=True).numpy(),
                               t * scale.numpy()[None], rtol=0, atol=0)
    with pytest.raises(ValueError):
        weights.Dense2Bit.from_packed(words, k=49)
    with pytest.raises(ValueError, match="unknown ternary format"):
        weights.pack(torch.zeros(4, 4), "tcsc")
