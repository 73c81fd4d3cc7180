"""The port's kernel registry and planner held against ``repro``'s: the same
containers plan to the same ``(format, impl)`` (and, where both packages
take them from the pack or have none, the same ``block_n``/``block_k``);
every registered row computes, on the CPU, what ``repro``'s ``ref``
lowerings compute, and what its own Pallas kernels compute in interpret
mode.

Both packages take every other block from their block-shape tuner, under
the same key (``autotune.cache_key``); the grids differ by design (the
port's are the card kernels' tiles, ``ternary_gemm.TILES``, K steps of
64; ``repro``'s the TPU's), so the keys are compared, not the blocks.

Tolerances: float32 outputs within 1e-4 x max|y| (the same exact products
summed in another order); bfloat16 within 1e-2 x max|y| (that reordering
can flip a final bf16 rounding, 2^-8 relative, and the bitplane rows round
before their bias as ``repro``'s bitplane lowering does, while its ``ref``
rounds once).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rformats
from repro.core import weights as rweights
from repro.kernels import autotune as rautotune
from repro.kernels import ops as rops
from repro_torch.core import formats, weights
from repro_torch.kernels import autotune
from repro_torch.kernels import ops
from repro_torch.kernels import ternary_gemm as gemm_lib
from repro_torch.kernels import ternary_gemm_bitplane as bitplane_lib

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
BLOCKS_FROM_PACK = {"skip", "skip_db", "ref"}


def _pair(fmt, t, scale=None, bias=None, **opts):
    """The same ternary matrix (and epilogue operands) packed by both."""
    got = weights.pack(torch.from_numpy(t), fmt,
                       scale=None if scale is None else torch.from_numpy(
                           scale),
                       bias=None if bias is None else torch.from_numpy(bias),
                       **opts)
    ref = rweights.pack(t, fmt, scale=None if scale is None else jnp.asarray(
        scale), bias=None if bias is None else jnp.asarray(bias), **opts)
    return got, ref


def _tile_matrix(seed, k, n, tile_k, tile_n, s):
    rng = np.random.default_rng(seed)
    kp, npad = -(-k // tile_k) * tile_k, -(-n // tile_n) * tile_n
    return rformats.random_tile_ternary(rng, kp, npad, tile_k, tile_n,
                                        s)[:k, :n]


def _containers():
    rng = np.random.default_rng(0)
    dense = rformats.random_ternary(rng, 256, 96, 0.5)
    return {
        "dense2bit": _pair("dense2bit", dense),
        "tiled_sparse": _pair("tiled", _tile_matrix(1, 256, 96, 32, 16,
                                                    0.0625),
                              tile_k=32, tile_n=16),
        "tiled_full": _pair("tiled", dense, tile_k=64, tile_n=32),
        "tiled_big": _pair("tiled", _tile_matrix(2, 1024, 256, 256, 128,
                                                 0.125)),
        "bitplane": _pair("bitplane", dense),
        "base3": _pair("base3", dense),
    }


CONTAINERS = _containers()


def _tuner_keys(lib, w, plan):
    """The key a package's planner looks its blocks up under: the dense
    key at sparsity 1.0, the skip key pinned to the pack's tiles, the
    bitplane key (repro's _blocks_dense / _blocks_skip_impl /
    _blocks_bitplane)."""
    if plan.impl == "dense":
        return lib.cache_key(plan.m, w.k, w.n, 1.0, "dense",
                             phase=plan.phase)
    if plan.impl in ("skip", "skip_db"):
        return lib.cache_key(plan.m, w.k, w.n, w.occupancy(), plan.impl,
                             fixed_n=w.tile_n, fixed_k=w.tile_k,
                             phase=plan.phase)
    return lib.cache_key(plan.m, w.k, w.n, impl=plan.impl, phase=plan.phase)


def _impls(fmt):
    return sorted(i for f, i in ops.kernel_registry() if f == fmt)


def test_registry_rows_match_repro():
    got = {key: ki.priority for key, ki in ops.kernel_registry().items()}
    ref = {key: ki.priority for key, ki in rops.kernel_registry().items()}
    assert got == ref
    assert ops.SKIP_OCCUPANCY_CUTOFF == rops.SKIP_OCCUPANCY_CUTOFF


@pytest.mark.parametrize("name", sorted(CONTAINERS))
@pytest.mark.parametrize("m", [1, 8, 64, 1024])
@pytest.mark.parametrize("phase", [None, "prefill", "decode"])
def test_plans_match_repro(name, m, phase):
    got_w, ref_w = CONTAINERS[name]
    for impl in ["auto"] + _impls(got_w.format_name):
        got = ops.ternary_gemm_plan(got_w, m, impl=impl, phase=phase)
        ref = rops.ternary_gemm_plan(ref_w, m, impl=impl, phase=phase)
        assert (got.format, got.impl, got.m, got.k, got.n, got.phase) == (
            ref.format, ref.impl, ref.m, ref.k, ref.n, ref.phase), impl
        assert got.occupancy == ref.occupancy
        if got.impl in BLOCKS_FROM_PACK:
            assert (got.block_n, got.block_k) == (ref.block_n, ref.block_k)
        else:
            tiles = (bitplane_lib.TILES if got.format == "bitplane"
                     else gemm_lib.TILES)
            assert (got.block_m, got.block_n) in tiles
            assert got.block_k == gemm_lib.BLOCK_K
        if got.impl != "ref":
            # the tuner key each package resolves its blocks under
            assert _tuner_keys(autotune, got_w, got) == \
                _tuner_keys(rautotune, ref_w, ref), impl


def test_auto_switches_at_the_occupancy_cutoff():
    """8 K-tiles in one N-tile column: 7 occupied (0.875) still skips,
    8 (1.0) goes dense, in both packages."""
    rng = np.random.default_rng(3)
    for occupied, want in ((7, "skip_db"), (8, "dense"), (1, "skip_db")):
        t = np.zeros((256, 16), np.int8)
        t[:32 * occupied] = rformats.random_ternary(rng, 32 * occupied, 16,
                                                    0.5)
        got_w, ref_w = _pair("tiled", t, tile_k=32, tile_n=16)
        assert got_w.occupancy() == ref_w.occupancy() == occupied / 8
        assert ops.ternary_gemm_plan(got_w, 8).impl == want
        assert rops.ternary_gemm_plan(ref_w, 8).impl == want


@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_dense2bit_plan_keeps_the_serving_tiles(phase):
    """Under a phase scope the plan is the tuner's tile for the phase's
    dense key at sparsity 1.0; outside one, the key has no phase (as in
    repro), and M 16 takes a 16-row tile while M 17 may not."""
    w = CONTAINERS["dense2bit"][0]
    tuner = autotune.get_tuner()
    with ops.serving_phase(phase):
        plan = ops.ternary_gemm_plan(w, 300)
    want = tuner.lookup(300, w.k, w.n, sparsity=1.0, impl="dense",
                        phase=phase)
    assert (plan.impl, plan.phase) == ("dense", phase)
    assert (plan.block_m, plan.block_n, plan.block_k) == (
        want.block_m, want.block_n, 64)
    assert ops.ternary_gemm_plan(w, 16).block_m == 16
    assert ops.ternary_gemm_plan(w, 17).block_m in (16, 32)


def test_plan_errors_match_repro():
    tiled, rtiled = CONTAINERS["tiled_sparse"]
    for plan in (ops.ternary_gemm_plan, rops.ternary_gemm_plan):
        w = tiled if plan is ops.ternary_gemm_plan else rtiled
        with pytest.raises(ValueError, match="no impl 'nope'"):
            plan(w, 8, impl="nope")
        with pytest.raises(ValueError, match="block_k=64 must equal"):
            plan(w, 8, impl="skip", block_k=64)
        with pytest.raises(ValueError, match="block_n=32 must equal"):
            plan(w, 8, impl="skip_db", block_n=32)
    # explicit blocks that name the pack's tiles are accepted
    assert ops.ternary_gemm_plan(tiled, 8, impl="skip", block_k=32,
                                 block_n=16).block_k == 32
    with pytest.raises(ValueError, match="block_k"):
        ops.ternary_gemm_plan(CONTAINERS["dense2bit"][0], 8, block_k=256)
    with pytest.raises(ValueError, match="tiles"):
        ops.ternary_gemm_plan(CONTAINERS["dense2bit"][0], 8, block_m=48)
    with pytest.raises(ValueError, match="block_m=48 must be one of"):
        ops.ternary_gemm_plan(tiled, 8, impl="skip", block_m=48)
    with pytest.raises(ValueError, match="phase"):
        ops.ternary_gemm_plan(tiled, 8, phase="nope")
    # "verify" is a serving phase, as in repro; it plans from the decode
    # phase's widened grid, under its own key
    tuner = autotune.get_tuner()
    for w, impl in ((tiled, "skip_db"), (CONTAINERS["dense2bit"][0],
                                         "dense")):
        plan = ops.ternary_gemm_plan(w, 40, phase="verify")
        pins = (dict(fixed_n=w.tile_n, fixed_k=w.tile_k,
                     sparsity=w.occupancy()) if impl == "skip_db" else {})
        want = tuner.lookup(40, w.k, w.n, impl=impl, phase="verify", **pins)
        assert (plan.impl, plan.block_m) == (impl, want.block_m)
        assert want in tuner.candidates(40, w.k, w.n, phase="verify",
                                        impl=impl, **{
                                            k: v for k, v in pins.items()
                                            if k != "sparsity"})


def test_raw_operands_raise_type_error_like_repro():
    t = rformats.random_ternary(np.random.default_rng(4), 64, 32, 0.5)
    x, rx = torch.zeros(2, 64), jnp.zeros((2, 64))
    words = rformats.pack_2bit(t)
    plus, minus = rformats.pack_bitplanes(t)
    cases = [
        (torch.from_numpy(words.view(np.int32)), jnp.asarray(words),
         "from_packed"),
        (formats.TiledTernary.from_dense(t, 32, 16),
         rformats.TiledTernary.from_dense(t, 32, 16), "from_tiled"),
        ((torch.from_numpy(plus), torch.from_numpy(minus)),
         (jnp.asarray(plus), jnp.asarray(minus)), "from_planes"),
    ]
    for got_w, ref_w, hint in cases:
        with pytest.raises(TypeError, match=hint):
            ops.ternary_gemm(x, got_w)
        with pytest.raises(TypeError, match=hint):
            rops.ternary_gemm(rx, ref_w)


def test_k_validation():
    w = CONTAINERS["bitplane"][0]
    with pytest.raises(ValueError, match="logical K"):
        ops.ternary_gemm(torch.zeros(2, 100), w)
    with pytest.raises(ValueError, match="k=100"):
        ops.ternary_gemm(torch.zeros(2, 256), w, k=100)


@pytest.mark.parametrize("name", ["tiled_sparse", "tiled_big", "dense2bit",
                                  "bitplane"])
@pytest.mark.parametrize("m", [8, 1024])
def test_traffic_matches_repro(name, m):
    got_w, ref_w = CONTAINERS[name]
    for impl in _impls(got_w.format_name):
        got = ops.ternary_gemm_plan(got_w, m, impl=impl)
        ref = dataclasses.replace(
            rops.ternary_gemm_plan(ref_w, m, impl=impl),
            block_m=got.block_m, block_n=got.block_n, block_k=got.block_k)
        assert got.traffic() == ref.traffic(), impl


def _epilogue_operands(rng, n, kind):
    scale = (rng.random(n) + 0.5).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return {"none": (None, None, False), "scale": (scale, None, False),
            "scale_bias_prelu": (scale, bias, True)}[kind]


def _close(got: torch.Tensor, ref, tol: float) -> None:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("fmt,opts", [
    ("dense2bit", {}), ("tiled", {"tile_k": 32, "tile_n": 16}),
    ("tiled", {"tile_k": 64, "tile_n": 32}), ("bitplane", {}),
    ("base3", {})])
@pytest.mark.parametrize("epilogue", ["none", "scale", "scale_bias_prelu"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mkn", [(5, 200, 33), (16, 256, 64)])
def test_every_row_matches_repro_ref(fmt, opts, epilogue, dtype, mkn):
    m, k, n = mkn
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(m + k + n)
    t = (_tile_matrix(k, k, n, opts["tile_k"], opts["tile_n"], 0.125)
         if fmt == "tiled" else rformats.random_ternary(rng, k, n, 0.25))
    x = rng.standard_normal((m, k)).astype(np.float32)
    scale, bias, prelu = _epilogue_operands(rng, n, epilogue)
    got_w, ref_w = _pair(fmt, t, scale, bias, **opts)
    xt = torch.from_numpy(x).to(tdt)
    want = rops.ternary_gemm(jnp.asarray(x, jdt), ref_w, fuse_prelu=prelu,
                             impl="ref")
    for impl in _impls(fmt):
        y = ops.ternary_gemm(xt, got_w, fuse_prelu=prelu, impl=impl)
        assert y.dtype == tdt and y.shape == (m, n), impl
        _close(y, want, tol)


@pytest.mark.parametrize("s", [0.5, 0.25, 0.0625])
def test_skip_rows_agree_on_the_cpu(s):
    """On the CPU the skip, skip_db and dense rows are plain versions
    that sum in different orders: equal within the float32 bound (the
    card holds the kernels bit for bit)."""
    t = _tile_matrix(5, 300, 80, 64, 16, s)
    w, _ = _pair("tiled", t, tile_k=64, tile_n=16)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (12, 300)).astype(np.float32))
    ys = {impl: ops.ternary_gemm(x, w, impl=impl)
          for impl in ("skip", "skip_db", "dense")}
    for impl in ("skip", "skip_db"):
        _close(ys[impl], ys["dense"].numpy(), 1e-5)


def test_skip_plain_version_walks_only_the_listed_tiles():
    """Dropping a tile from the occupancy list drops its contribution:
    the plain version reads the list, not the words."""
    t = _tile_matrix(8, 128, 32, 32, 16, 0.25)
    w, _ = _pair("tiled", t, tile_k=32, tile_n=16)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 128)).astype(np.float32))
    assert int(w.kt_counts[0]) >= 1
    cut = dataclasses.replace(w, kt_counts=w.kt_counts - torch.tensor(
        [1] + [0] * (w.n_ntiles - 1), dtype=torch.int32))
    full = ops.ternary_gemm(x, w, impl="skip")
    kt = int(w.kt_indices[0, int(w.kt_counts[0]) - 1])
    lost = x[:, kt * 32:(kt + 1) * 32] @ torch.from_numpy(
        t[kt * 32:(kt + 1) * 32, :16]).float()
    _close(ops.ternary_gemm(x, cut, impl="skip")[:, :16],
           (full[:, :16] - lost).numpy(), 1e-5)


@pytest.mark.parametrize("s", [0.5, 0.25, 0.125, 0.0625])
@pytest.mark.parametrize("impl", ["skip", "skip_db"])
def test_skip_rows_match_repro_pallas_interpret(s, impl):
    """Against repro's own skip kernels, interpret mode, at the shapes of
    its tests/test_sparse_skip.py."""
    m, k, n = 8, 128, 64
    t = _tile_matrix(0, k, n, 32, 16, s)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    scale, bias, _ = _epilogue_operands(rng, n, "scale_bias_prelu")
    got_w, ref_w = _pair("tiled", t, scale, bias, tile_k=32, tile_n=16)
    want = rops.ternary_gemm(jnp.asarray(x), ref_w, fuse_prelu=True,
                             impl=impl, interpret=True)
    got = ops.ternary_gemm(torch.from_numpy(x), got_w, fuse_prelu=True,
                           impl=impl)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("impl", ["bitplane", "bitplane_factorized"])
@pytest.mark.parametrize("mkn", [(8, 128, 64), (5, 96, 40)])
def test_bitplane_rows_match_repro_pallas_interpret(impl, mkn):
    m, k, n = mkn
    rng = np.random.default_rng(11)
    t = rformats.random_ternary(rng, k, n, 0.25)
    x = rng.standard_normal((m, k)).astype(np.float32)
    scale, bias, _ = _epilogue_operands(rng, n, "scale_bias_prelu")
    got_w, ref_w = _pair("bitplane", t, scale, bias)
    want = rops.ternary_gemm(jnp.asarray(x), ref_w, fuse_prelu=True,
                             impl=impl, interpret=True)
    got = ops.ternary_gemm(torch.from_numpy(x), got_w, fuse_prelu=True,
                           impl=impl)
    _close(got, want, 1e-4)


def test_new_cuda_wrappers_refuse_cpu_tensors():
    """The B2/B3 and B7 wrappers launch their kernels or raise; a CPU
    tensor takes the plain version through the registry instead."""
    from repro_torch.kernels import ternary_gemm_bitplane as bitplane_lib
    w = CONTAINERS["tiled_sparse"][0]
    x = torch.zeros(2, 256, dtype=torch.bfloat16)
    for db in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            gemm_lib.ternary_gemm_skip_cuda(
                x, w.packed, w.kt_indices, w.kt_counts, n=w.n,
                tile_k=w.tile_k, tile_n=w.tile_n, db=db)
    bp = CONTAINERS["bitplane"][0]
    with pytest.raises(ValueError, match="CUDA"):
        bitplane_lib.ternary_gemm_bitplane_cuda(x, bp.plus, bp.minus)


@pytest.mark.parametrize("tile_n,block_n", [(16, 16), (32, 32), (48, 16),
                                            (96, 32), (128, 128), (192, 64)])
def test_skip_kernel_block_width_divides_the_tile(tile_n, block_n):
    assert gemm_lib.skip_block_n(tile_n) == block_n


# tiles that end inside a 64-deep step (B3's copies land the next tile's
# words there) and K % 8 != 0 (its stages then take plain loads)
@pytest.mark.parametrize("tile,mkn", [((48, 16), (5, 203, 40)),
                                      ((80, 48), (3, 1001, 97)),
                                      ((80, 48), (17, 999, 131))])
def test_skip_db_at_ragged_tiles_matches_repro_pallas_interpret(tile, mkn):
    m, k, n = mkn
    t = _tile_matrix(3, k, n, *tile, 0.25)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((m, k)).astype(np.float32)
    scale, bias, _ = _epilogue_operands(rng, n, "scale_bias_prelu")
    got_w, ref_w = _pair("tiled", t, scale, bias, tile_k=tile[0],
                         tile_n=tile[1])
    want = rops.ternary_gemm(jnp.asarray(x), ref_w, fuse_prelu=True,
                             impl="skip_db", interpret=True)
    got = ops.ternary_gemm(torch.from_numpy(x), got_w, fuse_prelu=True,
                           impl="skip_db")
    _close(got, want, 1e-4)
