"""The port's sparse formats and containers held against ``repro``'s on the
same numpy-seeded matrices: random draws, 2-bit words, tile-occupancy
metadata, bitplanes and base-3 codes bit for bit; pack-time statistics
and decodes exactly."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rformats
from repro.core import weights as rweights
from repro_torch.checkpoint.convert import params_from_numpy, weight_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import formats, weights

SPARSITIES = (0.5, 0.25, 0.125, 0.0625)
TILES = ((32, 16), (64, 32), (128, 128), (256, 128), (512, 32))


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("shape,s", [((64, 48), 0.25), ((37, 5), 0.5),
                                     ((256, 128), 0.0625)])
def test_random_ternary_same_draws(shape, s):
    a = formats.random_ternary(np.random.default_rng(3), *shape, s)
    b = rformats.random_ternary(np.random.default_rng(3), *shape, s)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.int8


@pytest.mark.parametrize("s", SPARSITIES + (0.0,))
@pytest.mark.parametrize("tile", [(32, 16), (256, 128)])
def test_random_tile_ternary_same_draws(s, tile):
    a = formats.random_tile_ternary(np.random.default_rng(5), 512, 256,
                                    *tile, s)
    b = rformats.random_tile_ternary(np.random.default_rng(5), 512, 256,
                                     *tile, s)
    np.testing.assert_array_equal(a, b)


def _tile_matrix(seed, k, n, tile_k, tile_n, s):
    """repro's test recipe: draw on the tile-padded shape, cut to (k, n)."""
    rng = np.random.default_rng(seed)
    kp, npad = -(-k // tile_k) * tile_k, -(-n // tile_n) * tile_n
    return rformats.random_tile_ternary(rng, kp, npad, tile_k, tile_n,
                                        s)[:k, :n]


def _assert_tiled_equal(got: formats.TiledTernary,
                        ref: rformats.TiledTernary):
    np.testing.assert_array_equal(_words(got.packed), ref.packed)
    for name in ("kt_indices", "kt_counts", "tile_nnz"):
        t = getattr(got, name)
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), getattr(ref, name),
                                      err_msg=name)
    assert (got.tile_k, got.tile_n, got.shape) == (ref.tile_k, ref.tile_n,
                                                   tuple(ref.shape))
    assert got.occupied_tiles() == ref.occupied_tiles()
    assert got.total_tiles() == ref.total_tiles()
    assert got.visited_tiles() == ref.visited_tiles()
    assert got.occupancy_fraction() == ref.occupancy_fraction()
    assert got.max_occ == ref.max_occ
    np.testing.assert_array_equal(got.occupancy().numpy(), ref.occupancy())
    assert got.nbytes() == ref.nbytes()


@pytest.mark.parametrize("s", SPARSITIES)
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("k,n", [(512, 256), (200, 33)])
def test_tiled_ternary_bitwise_equal(s, tile, k, n):
    w = _tile_matrix(k + n, k, n, *tile, s)
    got = formats.TiledTernary.from_dense(torch.from_numpy(w), *tile)
    ref = rformats.TiledTernary.from_dense(w, *tile)
    _assert_tiled_equal(got, ref)
    np.testing.assert_array_equal(got.to_dense().numpy(), w)


@pytest.mark.parametrize("tile", [(32, 16), (256, 128)])
def test_tiled_ternary_all_zero_and_uniform(tile):
    """No occupied tile (max_occ padded to 1), and uniform sparsity that
    occupies every tile."""
    zero = np.zeros((300, 70), np.int8)
    _assert_tiled_equal(formats.TiledTernary.from_dense(zero, *tile),
                        rformats.TiledTernary.from_dense(zero, *tile))
    full = rformats.random_ternary(np.random.default_rng(1), 300, 70, 0.5)
    _assert_tiled_equal(formats.TiledTernary.from_dense(full, *tile),
                        rformats.TiledTernary.from_dense(full, *tile))


@pytest.mark.parametrize("s", SPARSITIES)
@pytest.mark.parametrize("tile", [(32, 16), (64, 32), (512, 32)])
def test_tiled_container_matches_repro(s, tile):
    w = _tile_matrix(7, 400, 96, *tile, s)
    scale = np.random.default_rng(2).random(96).astype(np.float32)
    got = weights.pack(torch.from_numpy(w), "tiled", scale=torch.from_numpy(
        scale), tile_k=tile[0], tile_n=tile[1])
    ref = rweights.pack(w, "tiled", scale=jnp.asarray(scale),
                        tile_k=tile[0], tile_n=tile[1])
    np.testing.assert_array_equal(_words(got.packed), np.asarray(ref.packed))
    np.testing.assert_array_equal(got.kt_indices.numpy(),
                                  np.asarray(ref.kt_indices))
    np.testing.assert_array_equal(got.kt_counts.numpy(),
                                  np.asarray(ref.kt_counts))
    assert got.format_name == ref.format_name == "tiled"
    assert (got.nnz, got.occupied_tiles) == (ref.nnz, ref.occupied_tiles)
    assert isinstance(got.nnz, int) and isinstance(got.occupied_tiles, int)
    assert got.occupancy() == ref.occupancy()
    assert (got.n_ktiles, got.n_ntiles, got.max_occ) == (
        ref.n_ktiles, ref.n_ntiles, ref.max_occ)
    assert got.total_tiles() == ref.total_tiles()
    assert got.visited_tiles() == ref.visited_tiles()
    assert got.nbytes == ref.nbytes
    np.testing.assert_array_equal(got.materialize().numpy(),
                                  np.asarray(ref.materialize()))
    np.testing.assert_allclose(
        got.materialize(with_scale=True).numpy(),
        np.asarray(ref.materialize(with_scale=True)), rtol=0, atol=0)


def test_pack_tiled_float_weight_ternarizes_like_repro():
    w = np.random.default_rng(4).standard_normal((96, 48)).astype(np.float32)
    got = weights.pack(torch.from_numpy(w), "tiled", tile_k=32, tile_n=16)
    ref = rweights.pack(w, "tiled", tile_k=32, tile_n=16)
    np.testing.assert_array_equal(_words(got.packed), np.asarray(ref.packed))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="multiples of 16"):
        weights.pack(torch.from_numpy(w), "tiled", tile_k=24)


@pytest.mark.parametrize("shape", [(64, 8), (37, 5), (13, 40), (1, 3),
                                   (200, 33)])
def test_bitplanes_bitwise_equal(shape):
    t = np.random.default_rng(sum(shape)).integers(-1, 2, shape).astype(
        np.int8)
    plus, minus = formats.pack_bitplanes(torch.from_numpy(t))
    rplus, rminus = rformats.pack_bitplanes(t)
    assert plus.dtype == minus.dtype == torch.uint8
    np.testing.assert_array_equal(plus.numpy(), rplus)
    np.testing.assert_array_equal(minus.numpy(), rminus)
    dec = formats.decode_bitplanes(plus, minus, shape[0], torch.float32)
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(rformats.decode_bitplanes(
            jnp.asarray(rplus), jnp.asarray(rminus), shape[0], jnp.float32)))
    np.testing.assert_array_equal(dec.numpy(), t.astype(np.float32))


@pytest.mark.parametrize("shape", [(60, 8), (37, 5), (13, 40), (1, 3),
                                   (203, 33)])
def test_base3_bitwise_equal(shape):
    t = np.random.default_rng(sum(shape)).integers(-1, 2, shape).astype(
        np.int8)
    codes = formats.pack_base3(torch.from_numpy(t))
    rcodes = rformats.pack_base3(t)
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), rcodes)
    dec = formats.decode_base3(codes, shape[0], torch.float32)
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(rformats.decode_base3(
            jnp.asarray(rcodes), shape[0], jnp.float32)))
    np.testing.assert_array_equal(dec.numpy(), t.astype(np.float32))


def test_base3_lut_equal():
    np.testing.assert_array_equal(formats.base3_lut().numpy(),
                                  rformats.base3_lut())


@pytest.mark.parametrize("fmt", ["dense2bit", "tiled", "bitplane", "base3"])
def test_containers_materialize_and_metadata_match_repro(fmt):
    rng = np.random.default_rng(9)
    t = rformats.random_ternary(rng, 90, 40, 0.25)
    scale = (rng.random(40) + 0.5).astype(np.float32)
    bias = rng.standard_normal(40).astype(np.float32)
    got = weights.pack(torch.from_numpy(t), fmt,
                       scale=torch.from_numpy(scale),
                       bias=torch.from_numpy(bias))
    ref = rweights.pack(t, fmt, scale=jnp.asarray(scale),
                        bias=jnp.asarray(bias))
    assert type(got) is weights.FORMATS[fmt]
    assert got.format_name == fmt
    assert (got.shape, got.k, got.n, got.nnz) == (tuple(ref.shape), ref.k,
                                                  ref.n, ref.nnz)
    assert got.occupancy() == ref.occupancy()
    assert got.nbytes == ref.nbytes
    np.testing.assert_array_equal(got.materialize().numpy(), t)
    np.testing.assert_array_equal(got.materialize().numpy(),
                                  np.asarray(ref.materialize(jnp.float32)))
    np.testing.assert_allclose(
        got.materialize(with_scale=True).numpy(),
        np.asarray(ref.materialize(jnp.float32, with_scale=True)),
        rtol=0, atol=0)
    moved = got.to("cpu")
    assert type(moved) is type(got) and moved.shape == got.shape


def test_register_format_and_unknown_format():
    assert sorted(weights.FORMATS) == sorted(rweights.FORMATS)
    with pytest.raises(ValueError, match="unknown ternary format"):
        weights.pack(torch.zeros(4, 4), "tcsc")

    @weights.register_format("toy")
    class Toy(weights.Dense2Bit):
        pass

    try:
        assert weights.FORMATS["toy"] is Toy and Toy.format_name == "toy"
    finally:
        del weights.FORMATS["toy"]


def test_bitplane_from_planes_checks():
    plus, minus = formats.pack_bitplanes(torch.ones(16, 4, dtype=torch.int8))
    wc = weights.Bitplane.from_planes(plus, minus, k=13)
    assert wc.shape == (13, 4)
    with pytest.raises(ValueError, match="cover"):
        weights.Bitplane.from_planes(plus, minus, k=17)
    with pytest.raises(ValueError, match="differ"):
        weights.Bitplane.from_planes(plus, minus[:1], k=8)


def _leaves(rw):
    return {f: None if getattr(rw, f) is None else np.asarray(getattr(rw, f))
            for f in rw._leaves}


@pytest.mark.parametrize("fmt,opts", [("dense2bit", {}),
                                      ("tiled", {"tile_k": 32, "tile_n": 16}),
                                      ("bitplane", {}), ("base3", {})])
def test_weight_from_numpy_rebuilds_repro_containers(fmt, opts):
    rng = np.random.default_rng(11)
    t = rformats.random_ternary(rng, 70, 24, 0.25)
    rw = rweights.pack(t, fmt, scale=jnp.asarray(rng.random(24), jnp.float32),
                       **opts)
    aux = {f: getattr(rw, f) for f in ("tile_k", "tile_n", "nnz",
                                       "occupied_tiles") if hasattr(rw, f)}
    got = weight_from_numpy(fmt, _leaves(rw), rw.shape, device="cpu", **aux)
    assert type(got) is weights.FORMATS[fmt]
    assert got.bias is None and got.nnz == rw.nnz
    assert got.occupancy() == rw.occupancy()
    np.testing.assert_array_equal(got.materialize().numpy(), t)
    if fmt in ("dense2bit", "tiled"):
        assert got.packed.dtype == torch.int32
    with pytest.raises(ValueError, match="unknown"):
        weight_from_numpy("tcsc", {}, (1, 1), device="cpu")


def test_params_from_numpy_passes_port_containers_through():
    """A tree may carry port containers; inside a stacked block their
    leaves are stacked too and are sliced per layer."""
    cfg = get_config("ternary-paper", reduced=True, num_layers=2)
    stacked = weights.pack(torch.from_numpy(
        rformats.random_ternary(np.random.default_rng(0), 64, 16, 0.5)
    ).repeat(2, 1, 1))
    tiled = weights.pack(torch.ones(64, 16, dtype=torch.int8), "tiled",
                         tile_k=32, tile_n=16)
    tree = {"embed": {"table": np.zeros((4, 2), np.float32)},
            "final_norm": {"scale": np.ones(2, np.float32)},
            "block0": {"w": stacked, "b": np.zeros((2, 3), np.float32)}}
    out = params_from_numpy(tree, cfg, "cpu")
    for layer in out["layers"]:
        assert isinstance(layer["w"], weights.Dense2Bit)
        assert layer["w"].packed.shape == (4, 16)
        assert torch.equal(layer["w"].packed, stacked.packed[0])
    tree["block0"] = {"w": dataclasses.replace(tiled, **{
        f: getattr(tiled, f)[None] for f in ("packed", "kt_indices",
                                             "kt_counts")})}
    cfg1 = get_config("ternary-paper", reduced=True, num_layers=1)
    got = params_from_numpy(tree, cfg1, "cpu")["layers"][0]["w"]
    assert isinstance(got, weights.Tiled) and got.shape == tiled.shape
    for f in ("packed", "kt_indices", "kt_counts"):
        assert torch.equal(getattr(got, f), getattr(tiled, f))
