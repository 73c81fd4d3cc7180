"""B6's launch plan, which the CPU reaches: ``flash_attention.launch_plan``
mirrors the launch of ``csrc/flash_attention.cu`` (its constants are read
from the source here), fits the card's shared memory and grid for every
query length up to 8192, and runs the heaviest causal query tiles first.
Beside it, the plain version against ``repro``'s ``flash_attention_pallas``
in interpret mode at 128-row blocks, the kernel's query tile, with
``tests/test_flash_kernel.py``'s tolerances: 2e-4 in float32 and 5e-2 in
bfloat16 (p rounded to bf16 before the PV product at block-dependent
scales). The kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as fa

SRC = Path(fa.__file__).parent / "csrc" / "flash_attention.cu"
H100_SMEM = 232_448
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _constexpr(src: str, name: str) -> str:
    return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)


def test_plan_constants_are_the_kernels():
    """BLOCK_M, the warpgroups, threads, box width and NEG_INF are the
    literals of flash_attention.cu, and TILES is its FLASH_TILES list: one
    tile for each head dim."""
    src = SRC.read_text()
    assert int(_constexpr(src, "BM")) == fa.BLOCK_M
    assert int(_constexpr(src, "CONSUMERS")) == fa.CONSUMER_WARPGROUPS
    assert int(_constexpr(src, "BOX_COLS")) == fa.BOX_COLS
    assert _constexpr(src, "THREADS") == "(CONSUMERS * 4 + 1) * 32"
    assert float(_constexpr(src, "NEG_INF").rstrip("f")) == fa.NEG_INF
    macro = re.search(r"#define FLASH_TILES\(X\)(.*)", src).group(1)
    tiles = re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", macro)
    assert {int(hd): (int(bn), int(st), int(bl))
            for hd, bn, st, bl in tiles} == fa.TILES
    assert len(tiles) == len(fa.TILES)
    assert tuple(sorted(fa.TILES)) == fa.HEAD_DIMS
    # the shared-memory layout the plan's byte count follows
    assert "static constexpr int Q = BM * HD * 2;" in src
    assert "static constexpr int KV = BN * HD * 2;" in src
    assert "BYTES = BAR_OFF + (1 + 3 * STAGES) * 8;" in src
    assert "ALLOC = BYTES + 1024;" in src


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
def test_plan_fits_the_card_for_every_length(hd, causal):
    """Sq from 1 to 8192 (Skv the same, then a fixed 1024): the block's
    shared memory fits 232,448 bytes, the grid's y extent 65,535, a block
    holds the producer warp and two warpgroups, and every query row lies
    in exactly one tile."""
    bn, stages, blocks = fa.TILES[hd]
    for sq in range(1, 8193):
        for skv in (sq, 1024):
            plan = fa.launch_plan(16, sq, skv, hd, causal)
            assert plan.smem_bytes <= H100_SMEM
            # the blocks an SM holds fit its 228 KB (1 KB reserved each)
            assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= 233_472
            assert plan.grid == (16, -(-sq // fa.BLOCK_M))
            assert plan.grid[1] <= fa.MAX_GRID_Y
            assert (plan.block_n, plan.stages, plan.blocks_per_sm) == \
                (bn, stages, blocks)
            assert plan.threads == 288 and plan.threads % 32 == 0
            assert stages >= 2 and fa.BLOCK_M % 64 == 0
            starts = sorted(plan.q_tile(y) for y in range(plan.grid[1]))
            assert starts == list(range(0, sq, fa.BLOCK_M))


@pytest.mark.parametrize("sq,skv", [(1024, 1024), (1000, 1000), (8192, 8192),
                                    (129, 300), (300, 129), (1, 1)])
def test_plan_runs_heavy_causal_tiles_first(sq, skv):
    """blockIdx.y 0 takes the last query tile, which loads the most K/V
    tiles; the loads never rise along blockIdx.y, and a causal tile loads
    no tile that starts after its last row."""
    plan = fa.launch_plan(8, sq, skv, 64, True)
    loads = [plan.kv_tiles(y) for y in range(plan.grid[1])]
    assert loads == sorted(loads, reverse=True)
    assert loads[0] == -(-min(skv, plan.q_tile(0) + plan.block_m)
                         // plan.block_n)
    for y, n in enumerate(loads):
        assert (n - 1) * plan.block_n <= plan.q_tile(y) + plan.block_m - 1
    full = fa.launch_plan(8, sq, skv, 64, False)
    assert {full.kv_tiles(y) for y in range(full.grid[1])} == \
        {-(-skv // full.block_n)}


def test_plan_smem_follows_the_tile_and_refuses_other_head_dims():
    assert fa.launch_plan(1, 1024, 1024, 64, True).smem_bytes == \
        128 * 64 * 2 + 2 * 3 * 64 * 64 * 2 + 10 * 8 + 1024
    for hd, (bn, stages, blocks) in fa.TILES.items():
        plan = fa.launch_plan(1, 1024, 1024, hd, True)
        assert (plan.block_n, plan.stages, plan.blocks_per_sm) == \
            (bn, stages, blocks)
        assert plan.smem_bytes == (128 * hd * 2 + 2 * stages * bn * hd * 2
                                   + (1 + 3 * stages) * 8 + 1024)
        assert blocks * (plan.smem_bytes + 1024) <= 233_472
        assert bn % 64 == 0 and stages >= 2
    with pytest.raises(ValueError, match="head dim"):
        fa.launch_plan(1, 64, 64, 96, True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,hd", [(4, 128, 64), (2, 257, 64),
                                     (8, 96, 128), (2, 300, 128)])
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_ref_matches_pallas_interpret_at_128_blocks(bh, s, hd, causal,
                                                    dtype):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((bh, s, hd)).astype(np.float32)
               for _ in range(3))
    ref = flash_attention_pallas(
        *(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)), causal=causal,
        block_q=128, block_kv=128, interpret=True)
    got = fa.flash_attention(*(torch.from_numpy(a).to(TDT[dtype])
                               for a in (q, k, v)), causal=causal)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(ref, jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])
