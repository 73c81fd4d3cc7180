"""The pure-Python launch planning of B1 and B4, which the CPU reaches: B1's
tile per phase (the block-shape tuner's pick, one of the kernel's tiles),
B4's chunk width (from the widths alone), cluster size, chunk count, grid
and partial-buffer size per tile. The kernels themselves run only on the
card (tests/test_torch_cuda.py)."""
import pytest
import torch

from repro_torch.core import weights
from repro_torch.kernels import autotune
from repro_torch.kernels import fused_mlp as fused_lib
from repro_torch.kernels import ops
from repro_torch.kernels import ternary_gemm as gemm_lib

H100_SMS = 132
DECODE_TILE, PREFILL_TILE = (16, 64), (64, 128)


@pytest.fixture(autouse=True)
def _fresh_tuner(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "_GLOBAL", autotune.Autotuner(
        path=str(tmp_path / "tune.json"), mode="model"))


@pytest.mark.parametrize("m,phase", [(1, "decode"), (8, "decode"),
                                     (16, "decode"), (17, "prefill"),
                                     (1024, "prefill"), (8192, "prefill")])
def test_b1_tile_follows_the_phase(m, phase):
    """A dense2bit pack and a tiled pack's dense row plan the tuner's tile
    under the dense key of the ambient phase (none outside a scope, as in
    repro), one of B1's tiles, at most M's rows bucketed (16 at least),
    K stepped by 64; the decode phase may take 16-row tiles at any M."""
    g = torch.Generator().manual_seed(0)
    tuner = autotune.get_tuner()
    for w, impl in ((weights.pack(torch.randn(256, 96, generator=g)), "auto"),
                    (weights.pack(torch.randn(256, 96, generator=g), "tiled",
                                  tile_k=64, tile_n=32), "dense")):
        for scope in (None, phase):
            with ops.serving_phase(scope):
                plan = ops.ternary_gemm_plan(w, m, impl=impl)
            want = tuner.lookup(m, 256, 96, impl="dense", phase=scope)
            assert (plan.impl, plan.phase) == ("dense", scope)
            assert (plan.block_m, plan.block_n, plan.block_k) == \
                (want.block_m, want.block_n, gemm_lib.BLOCK_K)
            assert (plan.block_m, plan.block_n) in gemm_lib.TILES
            assert plan.block_m <= max(16, autotune._pow2_bucket(m))
        if phase == "decode":
            assert plan.block_m == 16


@pytest.mark.parametrize("m,phase,cluster,grid", [
    (1, "decode", 8, (64, 1)), (8, "decode", 8, (64, 1)),
    (16, "decode", 8, (64, 1)), (17, "prefill", 4, (32, 1)),
    (129, "prefill", 4, (32, 3)), (1024, "prefill", 2, (16, 16)),
    (8192, "prefill", 1, (8, 128))])
def test_b4_plan_per_phase(m, phase, cluster, grid):
    """ff 4096, N 1024 on 132 SMs: every M and tile sums the down
    projection in 512-column chunks; the cluster doubles until the grid
    holds 7/8 of two blocks an SM (or each block keeps one strip);
    partials are (chunks, M, N) f32."""
    tile = DECODE_TILE if phase == "decode" else PREFILL_TILE
    plan = fused_lib.launch_plan(m, 4096, 1024, tile, H100_SMS)
    assert plan.tile == tile
    assert (plan.fc, plan.cluster, plan.grid) == (512, cluster, grid)
    assert plan.chunks == 8 == grid[0] // cluster
    assert plan.partial_numel == plan.chunks * m * 1024


@pytest.mark.parametrize("tile", fused_lib.TILES)
@pytest.mark.parametrize("sms", [114, 132])
def test_b4_chunk_width_ignores_m_and_the_card(tile, sms):
    """The chunk width, so every row's grouping of its down-projection
    sum, is the same for every M, tile and SM count; both tiles' strips
    divide it."""
    for ff in (200, 1100, 4096):
        fcs = {fused_lib.launch_plan(m, ff, 1024, tile, sms).fc
               for m in (1, 8, 16, 17, 129, 1024, 8192)}
        fc = fused_lib.chunk_width(ff)
        assert fcs == {fc}
        assert all(fc % s == 0 for _, s in fused_lib.TILES)


def test_b4_plan_ragged_ff_and_limits():
    # ff 200 and 1100 round up to whole 128-column strips, at most 512
    plan = fused_lib.launch_plan(5, 200, 24, PREFILL_TILE, H100_SMS)
    assert (plan.fc, plan.chunks, plan.cluster, plan.grid) == \
        (256, 1, 2, (2, 1))
    assert plan.partial_numel == 1 * 5 * 24
    plan = fused_lib.launch_plan(3, 1100, 70, DECODE_TILE, H100_SMS)
    assert (plan.fc, plan.chunks, plan.cluster) == (512, 3, 8)
    # a chunk wider than ff shrinks to ff's strips; M 0 still plans
    assert fused_lib.launch_plan(128, 300, 8, PREFILL_TILE, 1).fc == 384
    assert fused_lib.launch_plan(0, 4096, 8, PREFILL_TILE, H100_SMS).fc == 512
    assert fused_lib.chunk_width(1) == 128
    with pytest.raises(ValueError, match="tiles"):
        fused_lib.launch_plan(8, 4096, 1024, (32, 128), H100_SMS)


def test_b4_plan_fills_more_sms_on_a_larger_card():
    small = fused_lib.launch_plan(1024, 4096, 1024, PREFILL_TILE, 16)
    large = fused_lib.launch_plan(1024, 4096, 1024, PREFILL_TILE, H100_SMS)
    assert small.fc == large.fc == 512
    assert (small.cluster, large.cluster) == (1, 2)
