"""The pure-Python launch planning of B1 and B4, which the CPU reaches: B1's
phase -> tile choice, B4's chunk width, chunk count, grid and
partial-buffer size per phase. The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""
import pytest
import torch

from repro_torch.core import weights
from repro_torch.kernels import fused_mlp as fused_lib
from repro_torch.kernels import ops
from repro_torch.kernels import ternary_gemm as gemm_lib

H100_SMS = 132


@pytest.mark.parametrize("m,phase", [(1, "decode"), (8, "decode"),
                                     (16, "decode"), (17, "prefill"),
                                     (1024, "prefill"), (8192, "prefill")])
def test_b1_tile_follows_the_phase(m, phase):
    """Outside a phase scope M <= 16 takes the decode tile, else the
    prefill tile, for a dense2bit pack and for a tiled pack's dense row;
    inside a scope the scope's tile whatever M."""
    g = torch.Generator().manual_seed(0)
    tile = gemm_lib.TILES[gemm_lib.VARIANTS[phase]]
    for w, impl in ((weights.pack(torch.randn(256, 96, generator=g)), "auto"),
                    (weights.pack(torch.randn(256, 96, generator=g), "tiled",
                                  tile_k=64, tile_n=32), "dense")):
        plan = ops.ternary_gemm_plan(w, m, impl=impl)
        assert (plan.impl, plan.block_m, plan.block_n, plan.block_k) == \
            ("dense", *tile, gemm_lib.BLOCK_K)
        other = "prefill" if phase == "decode" else "decode"
        with ops.serving_phase(other):
            scoped = ops.ternary_gemm_plan(w, m, impl=impl)
        assert (scoped.block_m, scoped.block_n) == \
            gemm_lib.TILES[gemm_lib.VARIANTS[other]]


@pytest.mark.parametrize("m,phase,fc,grid", [
    (1, "decode", 64, (64, 1)), (8, "decode", 64, (64, 1)),
    (16, "decode", 64, (64, 1)), (17, "prefill", 128, (32, 1)),
    (129, "prefill", 128, (32, 3)), (1024, "prefill", 256, (16, 16)),
    (8192, "prefill", 512, (8, 128))])
def test_b4_plan_per_phase(m, phase, fc, grid):
    """ff 4096, N 1024 on 132 SMs: the chunk is halved until the grid
    holds 7/8 of two blocks an SM (or reaches one strip); partials are
    (chunks, M, N) f32."""
    variant, ff_chunk = fused_lib.VARIANTS[phase]
    plan = fused_lib.launch_plan(m, 4096, 1024, variant, ff_chunk, H100_SMS)
    assert (plan.fc, plan.grid) == (fc, grid)
    assert plan.chunks == 4096 // fc == grid[0]
    assert plan.partial_numel == plan.chunks * m * 1024


def test_b4_plan_ragged_ff_and_limits():
    # ff 200 and 1100 round up to whole strips
    plan = fused_lib.launch_plan(5, 200, 24, 1, 512, H100_SMS)
    assert (plan.fc, plan.chunks, plan.grid) == (128, 2, (2, 1))
    assert plan.partial_numel == 2 * 5 * 24
    plan = fused_lib.launch_plan(3, 1100, 70, 0, 64, H100_SMS)
    assert (plan.fc, plan.chunks) == (64, 18)
    # a chunk wider than ff shrinks to ff's strips; M 0 still plans
    assert fused_lib.launch_plan(128, 300, 8, 1, 512, 1).fc == 384
    assert fused_lib.launch_plan(0, 4096, 8, 1, 512, H100_SMS).fc == 128
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_lib.launch_plan(8, 4096, 1024, 1, 96, H100_SMS)
    with pytest.raises(ValueError, match="multiple of 64"):
        fused_lib.launch_plan(8, 4096, 1024, 0, 0, H100_SMS)
    with pytest.raises(ValueError, match="variant"):
        fused_lib.launch_plan(8, 4096, 1024, 2, 128, H100_SMS)


def test_b4_plan_fills_more_sms_on_a_larger_card():
    small = fused_lib.launch_plan(1024, 4096, 1024, 1, 512, 16)
    large = fused_lib.launch_plan(1024, 4096, 1024, 1, 512, H100_SMS)
    assert small.fc == 512 and large.fc == 256
