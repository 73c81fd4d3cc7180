"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at ragged shapes (the kernels mask the M/N/K edges themselves) and at
the serving path's shapes. Marked ``gpu``: they skip on a machine without
a card. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerance: bf16 outputs of f32 sums taken in another order than the plain
version's may round one bf16 ulp (2^-8) the other way; the fused block
rounds h on the way, paged attention rounds p and the bitplane kernel
rounds before its bias, so all are held to |d| <= 1e-2*|ref| +
1e-2*max|ref|. The tile-skipping kernels (B2, B3) run the dense kernel's
(B1) MMA chunks in its order, so the three are held equal bit for bit.
This file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import formats, weights
from repro_torch.kernels import fused_mlp as fused_lib
from repro_torch.kernels import ops
from repro_torch.kernels import ternary_gemm as gemm_lib
from repro_torch.kernels import ternary_gemm_bitplane as bitplane_lib
from repro_torch.paging import Int8Pages
from repro_torch.paging import kernels as paged_lib

pytestmark = pytest.mark.gpu

RTOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    got, ref = got.float(), ref.float()
    assert bool(torch.isfinite(got).all())
    limit = RTOL * ref.abs() + RTOL * ref.abs().max()
    assert bool(((got - ref).abs() <= limit).all()), \
        float((got - ref).abs().max())


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("phase", ["decode", "prefill"])
# the serving shape, then shapes across B1's tile edges (decode 16 x 32,
# prefill 128 x 128, K steps of 64): M 1, 16, 17, 129; N off the tile
# widths; K % 64 != 0 with K % 8 == 0 (cp.async stages) and K % 8 != 0
# (plain-load stages)
@pytest.mark.parametrize("mkn", [(8, 1024, 1024), (5, 37, 19),
                                 (70, 200, 130), (1, 16, 1), (33, 64, 257),
                                 (16, 1000, 1000), (17, 1000, 100),
                                 (129, 1000, 1000), (129, 37, 300),
                                 (1, 520, 33), (1000, 1000, 1000)])
@pytest.mark.parametrize("epilogue", ["scale", "scale_bias_prelu"])
def test_ternary_gemm_kernel_matches_plain(cuda, phase, mkn, epilogue):
    m, k, n = mkn
    g = _gen(m * 7 + k)
    w = weights.pack(torch.randn(k, n, generator=g, device=cuda))
    bias = (torch.randn(n, generator=g, device=cuda)
            if epilogue != "scale" else None)
    prelu = epilogue == "scale_bias_prelu"
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    with ops.serving_phase(phase):
        got = ops.ternary_gemm(x, w, bias=bias, fuse_prelu=prelu)
    ref = gemm_lib.ternary_gemm_ref(x, w.packed, w.scale, bias,
                                    fuse_prelu=prelu)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _close(got, ref)


@pytest.mark.parametrize("mkn", [(8, 300, 100), (129, 1000, 200)])
def test_ternary_gemm_kernel_reads_padded_words(cuda, mkn):
    """A tile-padded pack (ldw > n, kw > K/16) through B1 in place: only
    the first n columns come out, equal to the plain version on the
    cut words; both B1 tiles agree bit for bit."""
    m, k, n = mkn
    w = _tiled(m + n, k, n, 256, 128, 0.5)
    assert w.packed.shape[1] > n and w.packed.shape[0] * 16 > k
    x = torch.randn(m, k, generator=_gen(m), device=cuda).to(torch.bfloat16)
    ys = {}
    for phase in ("decode", "prefill"):
        with ops.serving_phase(phase):
            ys[phase] = ops.ternary_gemm(x, w, impl="dense")
    ref = gemm_lib.ternary_gemm_ref(x, w.packed[:, :n].contiguous(), w.scale)
    torch.cuda.synchronize()
    assert ys["prefill"].shape == (m, n)
    assert torch.equal(ys["decode"], ys["prefill"])
    _close(ys["prefill"], ref)


@pytest.mark.parametrize("phase", ["decode", "prefill"])
# the serving shape, then shapes across B4's tile edges (decode 16 rows,
# prefill 64, strips of 64 / 128 columns, K steps of 64): M 1, 16, 17,
# 129; ff and N off the strips; K % 8 != 0 (plain-load stages)
@pytest.mark.parametrize("mkfn", [(8, 1024, 4096, 1024), (5, 40, 200, 24),
                                  (37, 96, 128, 70), (64, 256, 1100, 128),
                                  (1, 1024, 4096, 1024), (16, 1000, 1100, 1000),
                                  (17, 37, 200, 70), (129, 520, 640, 130)])
@pytest.mark.parametrize("variant", ["gated_silu", "gated_bias",
                                     "relu_ungated"])
def test_fused_mlp_kernel_matches_plain(cuda, phase, mkfn, variant):
    m, k, ff, n = mkfn
    g = _gen(m + ff)
    wi = weights.pack(torch.randn(k, ff, generator=g, device=cuda))
    wg = weights.pack(torch.randn(k, ff, generator=g, device=cuda))
    wo = weights.pack(torch.randn(ff, n, generator=g, device=cuda))
    if variant == "gated_bias":
        wi = weights.Dense2Bit.from_packed(
            wi.packed, k, wi.scale, torch.randn(ff, generator=g, device=cuda))
        wo = weights.Dense2Bit.from_packed(
            wo.packed, ff, wo.scale, torch.randn(n, generator=g, device=cuda))
    gate = None if variant == "relu_ungated" else wg
    act = "relu" if variant == "relu_ungated" else "silu"
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    with ops.serving_phase(phase):
        got = ops.fused_mlp(x, wi, wo, gate, activation=act)
    ref = fused_lib.fused_mlp_ref(
        x, wi.packed, wo.packed, None if gate is None else gate.packed,
        wi.scale, wi.bias, None if gate is None else gate.scale, None,
        wo.scale, wo.bias, activation=act)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _close(got, ref)


@pytest.mark.parametrize("gated", [True, False])
def test_fused_mlp_rows_do_not_depend_on_m(cuda, gated):
    """A row's output is the same bits whatever M shares the call: the
    chunk width comes from the widths, both tiles add in one order."""
    k, ff, n = 256, 1100, 200
    g = _gen(ff)
    wi, wg, wo = (weights.pack(torch.randn(a, b, generator=g, device=cuda))
                  for a, b in ((k, ff), (k, ff), (ff, n)))
    x = torch.randn(300, k, generator=g, device=cuda).to(torch.bfloat16)
    gate = wg if gated else None
    full = ops.fused_mlp(x, wi, wo, gate)
    for m in (1, 8, 16, 17, 129, 300):
        assert torch.equal(ops.fused_mlp(x[:m].contiguous(), wi, wo, gate),
                           full[:m]), m


@pytest.mark.parametrize("fmt", ["tiled", "bitplane", "base3"])
@pytest.mark.parametrize("m", [8, 129])
def test_mlp_blocks_of_every_format(cuda, fmt, m):
    """tiled packs (words padded past ff and N) run B4 in place, bitplane
    packs the chain through B7, base3 packs the chain of plain rows; each
    against the plain chain."""
    k, ff, n = 200, 520, 130
    g = _gen(m + ff)
    opts = dict(tile_k=64, tile_n=48) if fmt == "tiled" else {}
    wi, wg, wo = (weights.pack(torch.randn(a, b, generator=g, device=cuda),
                               fmt, **opts)
                  for a, b in ((k, ff), (k, ff), (ff, n)))
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    b4 = fused_lib.fused_mlp_cuda.launches
    b7 = bitplane_lib.ternary_gemm_bitplane_cuda.launches
    got = ops.fused_mlp(x, wi, wo, wg)
    torch.cuda.synchronize()
    assert fused_lib.fused_mlp_cuda.launches - b4 == (fmt == "tiled")
    assert bitplane_lib.ternary_gemm_bitplane_cuda.launches - b7 == \
        (3 if fmt == "bitplane" else 0)
    h = torch.nn.functional.silu(ops.ternary_gemm(x, wg, impl="ref")) \
        * ops.ternary_gemm(x, wi, impl="ref")
    assert got.shape == (m, n)
    _close(got, ops.ternary_gemm(h, wo, impl="ref"))


def test_wrappers_count_launches_and_refuse_bad_inputs(cuda):
    w = weights.pack(torch.randn(64, 32, device=cuda))
    x = torch.randn(4, 64, device=cuda).to(torch.bfloat16)
    before = gemm_lib.ternary_gemm_cuda.launches
    ops.ternary_gemm(x, w)
    assert gemm_lib.ternary_gemm_cuda.launches == before + 1
    with pytest.raises(ValueError, match="bfloat16"):
        gemm_lib.ternary_gemm_cuda(x.float(), w.packed)
    with pytest.raises(ValueError, match="int32"):
        gemm_lib.ternary_gemm_cuda(x, w.packed.cpu())
    with pytest.raises(ValueError, match="float32"):
        gemm_lib.ternary_gemm_cuda(x, w.packed, w.scale.double())
    with pytest.raises(ValueError, match="contiguous"):
        gemm_lib.ternary_gemm_cuda(x.t(), w.packed)
    with pytest.raises(ValueError, match="tiles"):
        gemm_lib.ternary_gemm_cuda(x, w.packed, block_m=128, block_n=128)


@pytest.mark.parametrize("m", [8, 40, 200])
def test_every_tile_gives_the_same_bits(cuda, m):
    """B1's, B7's (both modes) and B4's tiles and B2/B3's rows per block
    at a ragged N: every tile's output bitwise equal to the first's (each
    element adds the same 16-deep chunks in the same order); a tile that
    is not built raises."""
    g = _gen(m)
    k, n = 320, 200
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    w = weights.pack(torch.randn(k, n, generator=g, device=cuda))
    ys = [gemm_lib.ternary_gemm_cuda(x, w.packed, w.scale, n=n, block_m=bm,
                                     block_n=bn) for bm, bn in gemm_lib.TILES]
    assert all(torch.equal(y, ys[0]) for y in ys)
    tw = weights.pack(torch.randn(k, n, generator=g, device=cuda), "tiled",
                      tile_k=64, tile_n=32)
    for db in (False, True):
        ys = [gemm_lib.ternary_gemm_skip_cuda(
            x, tw.packed, tw.kt_indices, tw.kt_counts, tw.scale, n=n,
            tile_k=64, tile_n=32, block_m=bm, db=db)
            for bm in gemm_lib.SKIP_BLOCK_M]
        assert all(torch.equal(y, ys[0]) for y in ys)
    bp = weights.pack(torch.randn(k, n, generator=g, device=cuda),
                      "bitplane")
    for fact in (False, True):
        ys = [bitplane_lib.ternary_gemm_bitplane_cuda(
            x, bp.plus, bp.minus, bp.scale, factorized=fact, block_m=bm,
            block_n=bn) for bm, bn in bitplane_lib.TILES]
        assert all(torch.equal(y, ys[0]) for y in ys)
    with pytest.raises(ValueError, match="tiles"):
        bitplane_lib.ternary_gemm_bitplane_cuda(x, bp.plus, bp.minus,
                                                block_m=32, block_n=64)
    wi, wg = (weights.pack(torch.randn(k, 256, generator=g, device=cuda))
              for _ in range(2))
    wo = weights.pack(torch.randn(256, n, generator=g, device=cuda))
    args = (wi.packed, wo.packed, wg.packed, wi.scale, None, wg.scale, None,
            wo.scale, None)
    ys = [fused_lib.fused_mlp_cuda(x, *args, block_m=bm, strip=st)
          for bm, st in fused_lib.TILES]
    assert all(torch.equal(y, ys[0]) for y in ys)
    with pytest.raises(ValueError, match="tiles"):
        fused_lib.fused_mlp_cuda(x, *args, block_m=32, strip=128)


def _paged_inputs(g, b, h, kv, hd, ps, t, n_pages, lengths, int8):
    """Pages, a table of distinct valid pages followed by garbage entries
    (any id, never read), and the given lengths."""
    dev = "cuda"
    q = torch.randn(b, h, hd, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(n_pages, ps, kv, hd, generator=g, device=dev)
    v = torch.randn(n_pages, ps, kv, hd, generator=g, device=dev)
    if int8:
        kp, vp = Int8Pages.quantize(k), Int8Pages.quantize(v)
    else:
        kp, vp = k.to(torch.bfloat16), v.to(torch.bfloat16)
    table = torch.randint(0, n_pages, (b, t), generator=g, device=dev,
                          dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=g, device=dev)[:b * t] + 1
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for row in range(b):
        used = -(-int(lengths[row]) // ps)
        table[row, :used] = perm[row * t:row * t + used].to(torch.int32)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("heads,kv_heads", [(16, 16), (4, 2)])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hd,ps", [(64, 16), (32, 4)])
def test_paged_attention_kernel_matches_plain(cuda, heads, kv_heads, window,
                                              int8, hd, ps):
    t = 13
    # 1 token, page boundaries on both sides, a ragged middle, the full
    # table width
    lengths = [1, ps, ps + 1, 2 * ps - 1, 5 * ps + 3, t * ps]
    g = _gen(heads + window + ps)
    q, kp, vp, table, lens = _paged_inputs(g, len(lengths), heads, kv_heads,
                                           hd, ps, t, len(lengths) * t + 1,
                                           lengths, int8)
    got = ops.paged_decode_attention(q, kp, vp, table, lens, window=window)
    ref = paged_lib.paged_decode_attention_ref(q, kp, vp, table, lens,
                                               window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close(got, ref)


def test_paged_attention_serving_shape_and_large_smem(cuda):
    """The serving shape (8 rows, 16 heads, hd 64, 13 pages of 16), and a
    table wide enough that the scores need dynamic shared memory above
    48 KB."""
    for t, ps, h, kv in ((13, 16, 16, 16), (96, 16, 8, 1)):
        g = _gen(t)
        lengths = torch.randint(1, t * ps + 1, (8,), generator=g,
                                device="cuda").tolist()
        inputs = _paged_inputs(g, 8, h, kv, 64, ps, t, 8 * t + 1, lengths,
                               False)
        got = ops.paged_decode_attention(*inputs)
        ref = paged_lib.paged_decode_attention_ref(*inputs)
        torch.cuda.synchronize()
        _close(got, ref)
    assert paged_lib.smem_bytes(8, 64, 96, 16) > 48 * 1024


def test_paged_attention_bf16_head_dim_of_whole_16_byte_pieces(cuda):
    """bf16 pages need hd % 8 only (a row is copied 16 bytes at a time);
    int8 codes need hd % 16, and the wrapper says so."""
    inputs = _paged_inputs(_gen(5), 3, 4, 2, 40, 4, 3, 10, [1, 7, 12], False)
    _close(ops.paged_decode_attention(*inputs),
           paged_lib.paged_decode_attention_ref(*inputs))
    q8, kp8, vp8, table, lens = _paged_inputs(_gen(6), 3, 4, 2, 40, 4, 3, 10,
                                              [1, 7, 12], True)
    with pytest.raises(ValueError, match="multiple of 16 with int8"):
        paged_lib.paged_decode_attention_cuda(q8, kp8, vp8, table, lens)


def test_paged_attention_wrapper_counts_launches_and_refuses(cuda):
    g = _gen(1)
    q, kp, vp, table, lens = _paged_inputs(g, 2, 4, 2, 32, 4, 3, 7, [5, 12],
                                           False)
    before = paged_lib.paged_decode_attention_cuda.launches
    ops.paged_decode_attention(q, kp, vp, table, lens)
    assert paged_lib.paged_decode_attention_cuda.launches == before + 1
    cuda_fn = paged_lib.paged_decode_attention_cuda
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_fn(q.float(), kp, vp, table, lens)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_fn(q, kp.float(), vp, table, lens)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fn(q, kp.transpose(1, 2).contiguous().transpose(1, 2), vp,
                table, lens)
    with pytest.raises(ValueError, match="cuda"):
        cuda_fn(q, kp, vp, table.cpu(), lens)
    with pytest.raises(ValueError, match="int32"):
        cuda_fn(q, kp, vp, table.long(), lens)
    with pytest.raises(ValueError, match="Int8Pages"):
        cuda_fn(q, Int8Pages.quantize(kp.float()), vp, table, lens)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((1, 60000), dtype=torch.int32, device="cuda")
        cuda_fn(q[:1], kp, vp, big, lens[:1])
    assert paged_lib.paged_decode_attention_cuda.launches == before + 1
    # a length outside [1, T*ps] gives NaN for that row, not a wild read
    bad = torch.tensor([0, 12], dtype=torch.int32, device="cuda")
    out = cuda_fn(q, kp, vp, table, bad)
    torch.cuda.synchronize()
    assert bool(out[0].isnan().all()) and bool(out[1].isfinite().all())


# B5's shapes: the serving shape (B 8, 16 heads, hd 64, 13 pages of 16)
# and the long rows of the training slice's sequence lengths (64 pages,
# lengths in [513, 1024])
PAGED_SHAPES = {"serving": (13, 1, 193), "long": (64, 513, 1024)}


def _paged_shape(name, int8, seed):
    t, lo, hi = PAGED_SHAPES[name]
    g = _gen(seed)
    lengths = torch.randint(lo, hi + 1, (8,), generator=g,
                            device="cuda").tolist()
    return _paged_inputs(g, 8, 16, 16, 64, 16, t, 8 * t + 1, lengths, int8)


@pytest.mark.parametrize("shape", sorted(PAGED_SHAPES))
@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_rows_do_not_depend_on_the_batch(cuda, shape, int8):
    """B5 on a subset of the rows gives, bit for bit, what it gives those
    rows among all eight: a row's split comes from the table width alone."""
    q, kp, vp, table, lens = _paged_shape(shape, int8, 17)
    full = ops.paged_decode_attention(q, kp, vp, table, lens)
    for rows in ([5], [0, 3, 6], list(range(8))[::-1]):
        idx = torch.tensor(rows, device=cuda)
        part = ops.paged_decode_attention(q[idx].contiguous(), kp, vp,
                                          table[idx].contiguous(),
                                          lens[idx].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(part, full[idx]), rows


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [0, 300])
def test_paged_attention_long_rows(cuda, int8, window):
    inputs = _paged_shape("long", int8, 23)
    got = ops.paged_decode_attention(*inputs, window=window)
    ref = paged_lib.paged_decode_attention_ref(*inputs, window=window)
    torch.cuda.synchronize()
    _close(got, ref)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_bad_rows_give_nan(cuda, int8):
    """A length past the table, and a table entry out of range in the
    last share of a long row, give NaN for that row only; the other rows
    keep their bits."""
    q, kp, vp, table, lens = _paged_shape("long", int8, 29)
    good = ops.paged_decode_attention(q, kp, vp, table, lens)
    lens_bad, table_bad = lens.clone(), table.clone()
    lens_bad[1] = 64 * 16 + 1
    table_bad[4, (int(lens[4]) - 1) // 16] = kp.shape[0]
    got = ops.paged_decode_attention(q, kp, vp, table_bad, lens_bad)
    torch.cuda.synchronize()
    assert bool(got[1].isnan().all()) and bool(got[4].isnan().all())
    keep = [0, 2, 3, 5, 6, 7]
    assert torch.equal(got[keep], good[keep])


def _misaligned(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary (the TMA and cp.async copies need 16)."""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    off = 4 // t.element_size()
    out = flat[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16
    return out


@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("operand", ["x", "words"])
def test_skip_kernels_equal_dense_with_unaligned_operands(cuda, phase,
                                                          operand):
    """B3 (and B2) fill their stages with plain loads when an operand is
    not 16-byte aligned: still B1's bits, with and without bias+PReLU."""
    m, k, n = (8, 1024, 256) if phase == "decode" else (70, 1000, 300)
    w = _tiled(k + 3 * n, k, n, 80, 48, 0.25)
    g = _gen(k + 5)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    bias = torch.randn(n, generator=g, device=cuda)
    words = w.packed
    if operand == "x":
        x = _misaligned(x)
    else:
        words = _misaligned(words)
    bm = 16 if phase == "decode" else 64
    for kw in (dict(), dict(bias=bias, fuse_prelu=True)):
        ys = {db: gemm_lib.ternary_gemm_skip_cuda(
            x, words, w.kt_indices, w.kt_counts, w.scale, kw.get("bias"),
            n=n, tile_k=w.tile_k, tile_n=w.tile_n,
            fuse_prelu=kw.get("fuse_prelu", False), block_m=bm, db=db)
            for db in (False, True)}
        with ops.serving_phase(phase):
            dense = ops.ternary_gemm(x.contiguous(), w, impl="dense", **kw)
        torch.cuda.synchronize()
        assert torch.equal(ys[True], ys[False])
        assert torch.equal(ys[True], dense)


# tile_k 48 and 80 end inside a 64-deep step; tile_n 48 takes 16-wide
# blocks
TILES = [(32, 16), (64, 32), (128, 128), (256, 128), (512, 32), (48, 16),
         (80, 48)]


def _tiled(seed, k, n, tile_k, tile_n, sparsity, device="cuda"):
    """A tile-structured pack of logical (k, n), drawn on the padded
    shape and cut (so the last tiles are ragged)."""
    rng = np.random.default_rng(seed)
    kp, npad = -(-k // tile_k) * tile_k, -(-n // tile_n) * tile_n
    t = formats.random_tile_ternary(rng, kp, npad, tile_k, tile_n,
                                    sparsity)[:k, :n]
    scale = torch.from_numpy(rng.random(n).astype(np.float32) + 0.5)
    return weights.pack(torch.from_numpy(t).to(device), "tiled",
                        scale=scale.to(device), tile_k=tile_k, tile_n=tile_n)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("mkn", [(8, 1024, 256), (5, 200, 33),
                                 (70, 1000, 300), (3, 203, 40),
                                 (16, 520, 130), (129, 1000, 300),
                                 (17, 37, 100), (1, 1001, 97),
                                 (1000, 1003, 301)])
@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_skip_kernels_equal_dense_and_match_plain(cuda, tile, mkn, phase):
    m, k, n = mkn
    w = _tiled(k + n, k, n, *tile, 0.125)
    g = _gen(m + k)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    bias = torch.randn(n, generator=g, device=cuda)
    for kw in (dict(), dict(bias=bias, fuse_prelu=True)):
        with ops.serving_phase(phase):
            ys = {impl: ops.ternary_gemm(x, w, impl=impl, **kw)
                  for impl in ("skip", "skip_db", "dense")}
        ref = gemm_lib.ternary_gemm_skip_ref(
            x, w.packed, w.kt_indices, w.kt_counts, w.scale, kw.get("bias"),
            n=n, tile_k=w.tile_k, tile_n=w.tile_n,
            fuse_prelu=kw.get("fuse_prelu", False))
        torch.cuda.synchronize()
        assert ys["skip"].shape == (m, n)
        assert torch.equal(ys["skip"], ys["dense"])
        assert torch.equal(ys["skip_db"], ys["dense"])
        _close(ys["skip"], ref)


def test_skip_kernels_empty_columns_and_all_zero(cuda):
    """An N-tile with no occupied tile writes only its epilogue (bias);
    an all-zero pack gives exact zeros."""
    t = torch.zeros(256, 96, dtype=torch.int8)
    t[:64, :32] = 1
    w = weights.pack(t.to(cuda), "tiled", tile_k=64, tile_n=32)
    assert w.kt_counts.tolist() == [1, 0, 0]
    x = torch.randn(9, 256, generator=_gen(3), device=cuda).to(torch.bfloat16)
    bias = torch.randn(96, generator=_gen(4), device=cuda)
    for impl in ("skip", "skip_db"):
        y = ops.ternary_gemm(x, w, bias=bias, impl=impl)
        torch.cuda.synchronize()
        assert torch.equal(y, ops.ternary_gemm(x, w, bias=bias, impl="dense"))
        assert torch.equal(y[:, 32:], bias[32:].to(torch.bfloat16).expand(9, 64))
    zero = weights.pack(torch.zeros(128, 64, dtype=torch.int8, device=cuda),
                        "tiled", tile_k=32, tile_n=16)
    x = torch.randn(4, 128, generator=_gen(5), device=cuda).to(torch.bfloat16)
    assert not bool(ops.ternary_gemm(x, zero, impl="skip_db").any())


@pytest.mark.parametrize("mkn", [(8, 1024, 1024), (5, 37, 19),
                                 (70, 200, 130), (64, 512, 256),
                                 (1, 1003, 77), (17, 1001, 131),
                                 (1000, 999, 301)])
@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("epilogue", ["scale", "scale_bias_prelu"])
def test_bitplane_kernel_matches_plain(cuda, mkn, phase, epilogue):
    m, k, n = mkn
    rng = np.random.default_rng(m + k + n)
    t = torch.from_numpy(formats.random_ternary(rng, k, n, 0.25)).to(cuda)
    g = _gen(m * 3 + n)
    bias = (torch.randn(n, generator=g, device=cuda)
            if epilogue != "scale" else None)
    prelu = epilogue == "scale_bias_prelu"
    w = weights.Bitplane.from_dense(
        t, scale=torch.rand(n, generator=g, device=cuda) + 0.5, bias=bias)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    ys = {}
    for impl, fact in (("bitplane", False), ("bitplane_factorized", True)):
        with ops.serving_phase(phase):
            ys[impl] = ops.ternary_gemm(x, w, fuse_prelu=prelu, impl=impl)
        ref = bitplane_lib.ternary_gemm_bitplane_ref(
            x, w.plus, w.minus, w.scale, bias, factorized=fact,
            fuse_prelu=prelu)
        torch.cuda.synchronize()
        assert ys[impl].dtype == torch.bfloat16 and ys[impl].shape == (m, n)
        _close(ys[impl], ref)
    _close(ys["bitplane_factorized"], ys["bitplane"])


def test_new_wrappers_count_launches_and_refuse_bad_inputs(cuda):
    w = _tiled(1, 128, 64, 32, 16, 0.25)
    x = torch.randn(4, 128, generator=_gen(6), device=cuda).to(torch.bfloat16)
    skip = gemm_lib.ternary_gemm_skip_cuda
    before = (skip.launches, skip.launches_db)
    ops.ternary_gemm(x, w, impl="skip")
    ops.ternary_gemm(x, w, impl="skip_db")
    assert (skip.launches, skip.launches_db) == (before[0] + 1,
                                                before[1] + 1)
    args = (w.packed, w.kt_indices, w.kt_counts)
    kw = dict(n=64, tile_k=32, tile_n=16)
    with pytest.raises(ValueError, match="bfloat16"):
        skip(x.float(), *args, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        skip(torch.randn(128, 4, device=cuda).to(torch.bfloat16).t(), *args,
             **kw)
    with pytest.raises(ValueError, match="multiples of 16"):
        skip(x, *args, n=64, tile_k=24, tile_n=16)
    with pytest.raises(ValueError, match="whole"):
        skip(x, *args, n=64, tile_k=48, tile_n=16)
    with pytest.raises(ValueError, match="CUDA"):
        skip(x.cpu(), *args, **kw)
    with pytest.raises(ValueError, match="kt_counts"):
        skip(x, w.packed, w.kt_indices, w.kt_counts.long(), **kw)
    with pytest.raises(ValueError, match="block_m"):
        skip(x, *args, block_m=48, **kw)
    assert (skip.launches, skip.launches_db) == (before[0] + 1,
                                                before[1] + 1)
    bp = weights.pack(torch.randn(128, 64, device=cuda), "bitplane")
    before = bitplane_lib.ternary_gemm_bitplane_cuda.launches
    ops.ternary_gemm(x, bp)
    assert bitplane_lib.ternary_gemm_bitplane_cuda.launches == before + 1
    cuda_fn = bitplane_lib.ternary_gemm_bitplane_cuda
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_fn(x.float(), bp.plus, bp.minus)
    with pytest.raises(ValueError, match="uint8"):
        cuda_fn(x, bp.plus.int(), bp.minus)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fn(x.cpu(), bp.plus, bp.minus)
    with pytest.raises(ValueError, match="cover"):
        cuda_fn(x, bp.plus[:8], bp.minus[:8])
    # base3 has no kernel: its plain version runs on the card
    b3 = weights.pack(torch.randn(128, 64, device=cuda), "base3")
    y = ops.ternary_gemm(x, b3)
    assert y.is_cuda and y.shape == (4, 64)


FLASH_SHAPES = [(4, 128, 64), (2, 257, 64), (8, 96, 128), (128, 1024, 64),
                (3, 1, 64), (2, 65, 128)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,hd", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda, bh, s, hd, causal):
    g = _gen(bh + s + hd)
    q, k, v = (torch.randn(bh, s, hd, generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    from repro_torch.kernels import flash_attention as fa
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    ref = fa.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close(got, ref)


def test_flash_attention_kernel_queries_and_keys_of_other_lengths(cuda):
    from repro_torch.kernels import flash_attention as fa
    g = _gen(11)
    q = torch.randn(2, 70, 64, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(2, 150, 64, generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    for causal in (True, False):
        got = fa.flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _close(got, fa.flash_attention_ref(q, k, v, causal=causal))


# ragged query lengths across the 128-row query tiles and the K/V tiles,
# Sq != Skv both ways, hd 128 at S 1024, BH 1 (bh, sq, skv, hd)
FLASH_RAGGED = [(2, 127, 127, 64), (2, 129, 129, 64), (2, 255, 255, 128),
                (2, 1000, 1000, 64), (1, 1000, 1000, 128), (3, 129, 1000, 64),
                (3, 1000, 129, 128), (2, 1, 300, 64), (2, 300, 1, 128),
                (16, 1024, 1024, 128), (1, 1024, 1024, 64), (1, 1, 1, 128)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,skv,hd", FLASH_RAGGED)
def test_flash_attention_kernel_ragged_and_unequal_lengths(cuda, bh, sq, skv,
                                                           hd, causal):
    from repro_torch.kernels import flash_attention as fa
    g = _gen(bh + sq + 3 * skv + hd)
    q = torch.randn(bh, sq, hd, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(bh, skv, hd, generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == q.shape
    _close(got, fa.flash_attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,hd", [(100, 64), (200, 64), (1000, 64),
                                  (129, 128), (1000, 128)])
def test_flash_attention_kernel_stays_inside_its_head(cuda, s, hd, causal):
    """Odd heads' K and V hold 1e4: a copy box that ran past an even
    head's last row would bring them into its softmax and its output."""
    from repro_torch.kernels import flash_attention as fa
    g = _gen(s + hd)
    q, k, v = (torch.randn(4, s, hd, generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    k[1::2] = 1e4
    v[1::2] = 1e4
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _close(got[0::2], fa.flash_attention_ref(q[0::2], k[0::2], v[0::2],
                                             causal=causal))


def test_flash_attention_wrapper_refuses_bad_inputs(cuda):
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn(2, 64, 64, device=cuda).to(torch.bfloat16)
    before = fa.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_cuda(q.float(), q, q)
    with pytest.raises(ValueError, match="head dim"):
        h = torch.zeros(2, 64, 96, device=cuda, dtype=torch.bfloat16)
        fa.flash_attention_cuda(h, h, h)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(0, 1), q, q)
    with pytest.raises(ValueError, match="aligned"):
        odd = torch.zeros(2 * 64 * 64 + 1, device=cuda,
                          dtype=torch.bfloat16)[1:].view(2, 64, 64)
        fa.flash_attention_cuda(odd, q, q)
    assert fa.flash_attention_cuda.launches == before
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q.requires_grad_(), q, q).sum().backward()


def _grad_close(got, ref):
    for g, r in zip(got, ref):
        _close(g, r)


def _row_grads(y_fn, leaves, cot):
    y = y_fn()
    assert y.grad_fn is not None
    return torch.autograd.grad(y, leaves, cot)


@pytest.mark.parametrize("case", ["dense2bit_m8", "dense2bit_m1024",
                                  "dense2bit_prelu", "tiled_skip",
                                  "tiled_skip_db", "bitplane",
                                  "bitplane_factorized"])
def test_kernel_rows_gradients_match_plain_rows(cuda, case):
    g = _gen(len(case))
    m = 1024 if case == "dense2bit_m1024" else 8
    k = n = 1024
    if case.startswith("tiled"):
        w = _tiled(7, k, n, 256, 128, 0.125)
        impl = case[len("tiled_"):]
    elif case.startswith("bitplane"):
        rng = np.random.default_rng(8)
        w = weights.Bitplane.from_dense(
            torch.from_numpy(formats.random_ternary(rng, k, n, 0.25)).to(cuda),
            scale=torch.rand(n, generator=g, device=cuda) + 0.5)
        impl = case
    else:
        w = weights.pack(torch.randn(k, n, generator=g, device=cuda) / 32)
        impl = "dense"
    prelu = case == "dense2bit_prelu"
    x = torch.randn(m, k, generator=g, device=cuda).to(
        torch.bfloat16).requires_grad_()
    scale = w.scale.clone().requires_grad_()
    bias = torch.randn(n, generator=g, device=cuda).requires_grad_()
    cot = torch.randn(m, n, generator=g, device=cuda).to(torch.bfloat16)
    leaves = [x, scale, bias]

    def run(row):
        return lambda: ops.ternary_gemm(x, w, scale, bias, fuse_prelu=prelu,
                                        impl=row)
    _grad_close(_row_grads(run(impl), leaves, cot),
                _row_grads(run("ref"), leaves, cot))


def test_fused_mlp_kernel_gradients_match_plain(cuda):
    g = _gen(21)
    k, ff, n, m = 1024, 4096, 1024, 8
    wi, wg = (weights.pack(torch.randn(k, ff, generator=g, device=cuda))
              for _ in range(2))
    wo = weights.pack(torch.randn(ff, n, generator=g, device=cuda))
    x = torch.randn(m, k, generator=g, device=cuda).to(
        torch.bfloat16).requires_grad_()
    vecs = [wi.scale, wg.scale, wo.scale]
    for v in vecs:
        v.requires_grad_()
    cot = torch.randn(m, n, generator=g, device=cuda).to(torch.bfloat16)
    leaves = [x] + vecs
    got = _row_grads(lambda: ops.fused_mlp(x, wi, wo, wg), leaves, cot)
    ref = _row_grads(lambda: fused_lib.fused_mlp_ref(
        x, wi.packed, wo.packed, wg.packed, wi.scale, None, wg.scale, None,
        wo.scale, None), leaves, cot)
    _grad_close(got, ref)


def test_full_width_train_steps_on_the_card(cuda):
    """Full-width ternary-paper QAT (12 layers, d 1024): the card's first
    step in float32 against the CPU's on the same weights and batch (loss
    and grad norm within 1e-3 relative, every AdamW moment within 1e-3 of
    its leaf's max: the same sums in another order through 12 layers; at
    most 1e-6 of the elements on the straight-through mask's edge apart),
    then three bf16 steps with finite losses and gradient norms."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    cfg = get_config("ternary-paper")
    f32 = dataclasses.replace(cfg, dtype="float32")
    _, data, cpu_step, cpu_init = train.build(f32, 1, 128, lr=3e-3,
                                              total_steps=3, device="cpu")
    _, _, card_step, _ = train.build(f32, 1, 128, lr=3e-3, total_steps=3,
                                     device="cuda")
    state = cpu_init(0)
    to_card = (lambda t: t.to(cuda))
    batch = data.sharded_batch(0)
    gp, gopt, gmet = card_step(tree_map(to_card, state["params"]),
                               tree_map(to_card, state["opt"]),
                               tree_map(to_card, batch))
    _, opt, met = cpu_step(state["params"], state["opt"], batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(gmet[key]), float(met[key]),
                                   rtol=1e-3)
    # a weight on the straight-through mask's edge (|w| within an ulp of 2
    # mean|w|, a mean the devices sum in another order) has its gradient
    # on one side only: such elements are few and left out
    n_edge = n_all = 0
    for key in ("m", "v"):
        for got, ref in zip(tree_leaves(gopt[key]), tree_leaves(opt[key])):
            got = got.cpu()
            edge = (got == 0) != (ref == 0)
            n_edge, n_all = n_edge + int(edge.sum()), n_all + edge.numel()
            d = float(torch.where(edge, 0.0, (got - ref).abs()).max())
            assert d <= 1e-3 * max(float(ref.abs().max()), 1e-30)
    assert n_edge <= 1e-6 * n_all
    del state, gp, gopt, opt

    _, data, train_step, init_state = train.build(cfg, 4, 256, lr=3e-3,
                                                  total_steps=3,
                                                  device="cuda")
    state = init_state(0)
    params, opt = state["params"], state["opt"]
    before = params["layers"][5]["ffn"]["gate"]["w"].clone()
    for step in range(3):
        params, opt, met = train_step(params, opt,
                                      data.sharded_batch(step, device="cuda"))
        assert np.isfinite(float(met["loss"]))
        assert float(met["grad_norm"]) > 0
    assert int(opt["step"]) == 3
    assert not torch.equal(params["layers"][5]["ffn"]["gate"]["w"], before)
    assert isinstance(data, SyntheticLM)


@pytest.mark.parametrize("cache", [{}, {"cache": "paged", "page_size": 8},
                                   {"cache": "paged", "page_size": 8,
                                    "kv_dtype": "int8", "n_pages": 12}])
def test_decode_graph_matches_eager_decode(cuda, cache):
    """A reduced packed model served with the decode step replayed as a
    CUDA graph and run eagerly: equal token streams and cache metrics,
    B1/B4/B5 launches equal (B5 once a layer per replay), and the logits
    of a step bitwise equal."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import graphs
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousScheduler

    cfg = get_config("ternary-paper", reduced=True, num_layers=2,
                     ternary_min_dim=64)
    cfg, params = serve.build_params(cfg, 0, "cuda", packed=True)
    prompts, gens, _ = serve.build_workload(cfg, 6, 16, (4, 12), seed=0)
    runs = {}
    for graph in (False, True):
        eng = ContinuousScheduler(cfg, max_slots=3, max_len=29,
                                  device="cuda", cuda_graph=graph, **cache)
        eng.load(params)
        before = graphs.read_launches()
        outs, m = serve.run_continuous(eng, prompts, gens)
        after = graphs.read_launches()
        runs[graph] = (outs, m, {k: after[k] - before[k] for k in after})
        if graph:
            per = eng._graph.launches_per_replay
            assert per["paged_decode_attention"] == (
                cfg.num_layers if cache else 0)
            assert per["ternary_gemm"] > 0 and per["fused_mlp"] > 0
    (eo, em, el), (go, gm, gl) = runs[False], runs[True]
    for a, b in zip(eo, go):
        np.testing.assert_array_equal(a, b)
    assert em["cache"] == gm["cache"]
    assert el == gl

    logits = []
    for graph in (False, True):
        eng = ContinuousScheduler(cfg, max_slots=3, max_len=29,
                                  device="cuda", cuda_graph=graph, **cache)
        eng.load(params)
        for p, g in zip(prompts[:3], gens[:3]):
            eng.submit(p, g)
        eng.step()
        eng.step()
        logits.append(eng.last_logits.clone())
    assert torch.equal(*logits)


@pytest.mark.parametrize("cache", [{}, {"cache": "paged", "page_size": 8},
                                   {"cache": "paged", "page_size": 8,
                                    "kv_dtype": "int8", "n_pages": 14}])
def test_chunk_windows_graph_matches_eager(cuda, cache):
    """A reduced packed model with chunked prefill, the windows replayed as
    CUDA graphs (one a width, captured at load) and run eagerly: equal
    streams, sched metrics and launches; every captured window launches B1
    once a projection and for the lm head, B4 once a layer and, paged, B5
    once a layer; one window's logits bitwise equal."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import graphs
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousScheduler, SchedConfig

    cfg = get_config("ternary-paper", reduced=True, num_layers=2,
                     ternary_min_dim=64)
    cfg, params = serve.build_params(cfg, 0, "cuda", packed=True)
    prompts, gens, _ = serve.build_workload(cfg, 6, 16, (4, 12), seed=0)
    sched = SchedConfig(chunk_tokens=4)
    per_window = {"ternary_gemm": 4 * cfg.num_layers + 1,
                  "fused_mlp": cfg.num_layers,
                  "paged_decode_attention": cfg.num_layers if cache else 0}
    runs = {}
    for graph in (False, True):
        eng = ContinuousScheduler(cfg, max_slots=3, max_len=29,
                                  device="cuda", cuda_graph=graph,
                                  sched=sched, **cache)
        eng.load(params)
        if graph:
            assert eng.chunker.captured == (1, 2, 4)     # budget 3 + 4
            for counts in eng.chunker.launches_per_replay.values():
                assert {k: counts[k] for k in per_window} == per_window
        before = graphs.read_launches()
        outs, m = serve.run_continuous(eng, prompts, gens)
        after = graphs.read_launches()
        runs[graph] = (outs, m, {k: after[k] - before[k] for k in after})
        steps = m["decode_steps"] + m["sched"]["chunk_steps"]
        assert {k: runs[graph][2][k] for k in per_window} == {
            k: v * steps for k, v in per_window.items()}
    (eo, em, el), (go, gm, gl) = runs[False], runs[True]
    for a, b in zip(eo, go):
        np.testing.assert_array_equal(a, b)
    assert em["sched"] == gm["sched"] and em["cache"] == gm["cache"]
    assert el == gl

    logits = []
    for graph in (False, True):
        eng = ContinuousScheduler(cfg, max_slots=3, max_len=29,
                                  device="cuda", cuda_graph=graph,
                                  sched=sched, **cache)
        eng.load(params)
        for p, g in zip(prompts[:3], gens[:3]):
            eng.submit(p, g)
        eng.step()
        logits.append(eng.chunker.last_logits.clone())
    assert torch.equal(*logits)



@pytest.mark.parametrize("cache", [{}, {"cache": "paged", "page_size": 8},
                                   {"cache": "paged", "page_size": 8,
                                    "kv_dtype": "int8", "n_pages": 14}])
def test_spec_rounds_graph_match_eager(cuda, cache):
    """A reduced packed model with speculative decoding (a 1-of-2-layer
    draft, k 2), the draft round and the verify window replayed as CUDA
    graphs and run eagerly: equal streams, spec blocks, cache metrics and
    launches; a draft replay launches B1 (k+1) x 5 and B4 k+1, a verify
    replay B1 9, B4 2 and, paged, B5 2; one round's verify logits bitwise
    equal."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import graphs
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousScheduler
    from repro_torch.spec import SpecConfig

    cfg = get_config("ternary-paper", reduced=True, num_layers=2,
                     ternary_min_dim=64)
    cfg, params = serve.build_params(cfg, 0, "cuda", packed=True)
    prompts, gens, _ = serve.build_workload(cfg, 6, 16, (4, 12), seed=0)
    spec = SpecConfig(draft="layer_skip", k=2, draft_layers=1)
    want = {"draft": {"ternary_gemm": 3 * 5, "fused_mlp": 3,
                      "paged_decode_attention": 0},
            "verify": {"ternary_gemm": 9, "fused_mlp": 2,
                       "paged_decode_attention": 2 if cache else 0}}
    runs = {}
    for graph in (False, True):
        eng = ContinuousScheduler(cfg, max_slots=3, max_len=31,
                                  device="cuda", cuda_graph=graph,
                                  spec=spec, **cache)
        eng.load(params)
        if graph:
            assert {name: {k: g.launches_per_replay[k] for k in want[name]}
                    for name, g in eng.spec_graphs.items()} == want
        before = graphs.read_launches()
        outs, m = serve.run_continuous(eng, prompts, gens)
        after = graphs.read_launches()
        runs[graph] = (outs, m, {k: after[k] - before[k] for k in after})
        if cache:
            assert eng.pool.all_reclaimed
    (eo, em, el), (go, gm, gl) = runs[False], runs[True]
    for a, b in zip(eo, go):
        np.testing.assert_array_equal(a, b)
    assert em["spec"] == gm["spec"] and em["cache"] == gm["cache"]
    assert gm["spec"]["rounds"] > 0
    assert el == gl

    logits = []
    for graph in (False, True):
        eng = ContinuousScheduler(cfg, max_slots=3, max_len=31,
                                  device="cuda", cuda_graph=graph,
                                  spec=spec, **cache)
        eng.load(params)
        for p, g in zip(prompts[:3], gens[:3]):
            eng.submit(p, g)
        eng.step()                   # admission and the first round
        assert eng.spec_rounds == 1
        logits.append(eng.last_logits.clone())
    assert logits[0].shape == (3, 3, cfg.vocab_size)
    assert torch.equal(*logits)


@pytest.mark.parametrize("cache", [{}, {"cache": "paged", "page_size": 8,
                                        "prefix_cache": False}])
def test_guarded_graph_flags_a_poisoned_slot(cuda, cache):
    """A reduced packed model, the decode step replayed as a CUDA graph:
    under a NaN fault schedule the graph's guard quarantines the chosen
    slot and the streams equal the fault-free eager run's; NaN written
    into one slot's cache between two replays is flagged in that slot
    alone, eagerly and through the graph alike."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousScheduler, FaultConfig

    cfg = get_config("ternary-paper", reduced=True, num_layers=2,
                     ternary_min_dim=64)
    cfg, params = serve.build_params(cfg, 0, "cuda", packed=True)
    prompts, gens, _ = serve.build_workload(cfg, 6, 16, (4, 12), seed=0)
    ref = ContinuousScheduler(cfg, max_slots=3, max_len=29, device="cuda",
                              cuda_graph=False, **cache)
    ref.load(params)
    want, _ = serve.run_continuous(ref, prompts, gens)
    eng = ContinuousScheduler(cfg, max_slots=3, max_len=29, device="cuda",
                              faults=FaultConfig(nan_at=(3, 6)), **cache)
    eng.load(params)
    got, m = serve.run_continuous(eng, prompts, gens)
    assert m["faults"]["quarantines"] == 2
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)

    flags = []
    for graph in (False, True):
        eng = ContinuousScheduler(cfg, max_slots=3, max_len=29,
                                  device="cuda", cuda_graph=graph, **cache)
        eng.load(params)
        for p, g in zip(prompts[:3], gens[:3]):
            eng.submit(p, 12)
        eng.step()
        layer = eng.pool.layers[-1]
        if cache:
            layer["k_pages"][eng.pool.slot_pages[1][0], 0] = float("nan")
        else:
            layer["k"][1, 0] = float("nan")
        eng.step()
        torch.cuda.synchronize()
        assert eng.quarantines == 1 and 1 not in eng._live
        flags.append(eng._dev_ok.cpu().tolist())
    assert flags == [[1, 0, 1], [1, 0, 1]]


@pytest.mark.parametrize("sparsity", [0.5, 0.0625])
def test_tcsc_matmuls_on_the_card_match_the_cpu(cuda, sparsity):
    """The TCSC formats built on the card equal the CPU's arrays; their
    matmuls (float32, index_add_ in atomic order) agree with the CPU's
    within 1e-4 of max|ref|, with alpha, bias and PReLU."""
    from repro_torch.kernels import ref

    w = formats.random_ternary(np.random.default_rng(0), 300, 200, sparsity)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((5, 300)).astype(np.float32))
    alpha = torch.from_numpy(rng.uniform(0.5, 1.5, 200).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(200).astype(np.float32))
    builds = {"tcsc": (formats.TCSC.from_dense, ref.tcsc_matmul),
              "blocked": (lambda t: formats.BlockedTCSC.from_dense(t, 64),
                          ref.tcsc_matmul_blocked),
              "interleaved": (formats.InterleavedTCSC.from_dense,
                              ref.tcsc_matmul_interleaved)}
    for name, (build, fn) in builds.items():
        host = build(torch.from_numpy(w))
        card = build(torch.from_numpy(w).to(cuda))
        assert torch.equal(card.to_dense().cpu(), host.to_dense())
        want = fn(x, host, alpha, bias, 0.25)
        got = fn(x.to(cuda), card, alpha.to(cuda), bias.to(cuda), 0.25)
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("int8", [False, True])
def test_paged_rows_on_the_card(cuda, int8):
    """"auto" and "pallas" launch B5 on CUDA tensors; "jax" launches
    nothing and is the plain version itself, bitwise; with a window too."""
    inputs = _paged_inputs(_gen(11), 6, 16, 16, 64, 16, 13, 80,
                           [1, 16, 17, 31, 83, 208], int8)
    for window in (0, 64):
        ref = paged_lib.paged_decode_attention_ref(*inputs, window=window)
        for impl, launched in (("auto", 1), ("pallas", 1), ("jax", 0)):
            before = paged_lib.paged_decode_attention_cuda.launches
            got = ops.paged_decode_attention(*inputs, window=window,
                                             impl=impl)
            torch.cuda.synchronize()
            assert paged_lib.paged_decode_attention_cuda.launches == \
                before + launched, impl
            if impl == "jax":
                assert torch.equal(got, ref)
            else:
                _close(got, ref)


@pytest.mark.parametrize("m,phase", [(8, "decode"), (40, "verify"),
                                     (1024, "prefill")])
def test_fused_rows_on_the_card(cuda, m, phase):
    """"auto" and "pallas" launch B4 once, "chain" three B1 and no B4;
    the two agree within the kernel bound (B4 sums its f32 partials by ff
    chunk)."""
    g = _gen(m)
    wi, wg, wo = (weights.pack(torch.randn(a, b, generator=g, device=cuda)
                               / a ** 0.5)
                  for a, b in ((1024, 4096), (1024, 4096), (4096, 1024)))
    x = torch.randn(m, 1024, generator=g, device=cuda).to(torch.bfloat16)
    out = {}
    with ops.serving_phase(phase):
        for impl, fused, gemms in (("auto", 1, 0), ("pallas", 1, 0),
                                   ("chain", 0, 3)):
            f0 = fused_lib.fused_mlp_cuda.launches
            g0 = gemm_lib.ternary_gemm_cuda.launches
            out[impl] = ops.fused_mlp(x, wi, wo, wg, impl=impl)
            torch.cuda.synchronize()
            assert (fused_lib.fused_mlp_cuda.launches - f0,
                    gemm_lib.ternary_gemm_cuda.launches - g0) == \
                (fused, gemms), impl
    assert torch.equal(out["auto"], out["pallas"])
    _close(out["pallas"], out["chain"])


def test_cuda_tensors_reach_a_plain_version_only_when_named(cuda,
                                                            monkeypatch):
    """Serving on the card (dense and paged, graphed) never calls a plain
    version; a paged engine given paged_attn="jax" calls that row (and
    launches no B5) and serves every request."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousScheduler

    def refuse(name):
        def plain(*a, **k):
            raise AssertionError(f"{name} met a CUDA tensor")
        return plain

    monkeypatch.setattr(gemm_lib, "ternary_gemm_ref",
                        refuse("ternary_gemm_ref"))
    monkeypatch.setattr(fused_lib, "fused_mlp_ref", refuse("fused_mlp_ref"))
    monkeypatch.setattr(paged_lib, "paged_decode_attention_ref",
                        refuse("paged_decode_attention_ref"))
    jax_calls = []
    row = ops.paged_attention_registry()["jax"]

    def jax_row(*a, _fn=row.fn, **k):
        jax_calls.append(1)
        return _fn(*a, **k)

    monkeypatch.setitem(ops._PAGED_ATTN, "jax",
                        type(row)(row.impl, row.priority, row.predicate,
                                  jax_row))
    cfg = get_config("ternary-paper", reduced=True, num_layers=2,
                     ternary_min_dim=64)
    cfg, params = serve.build_params(cfg, 0, "cuda", packed=True)
    prompts, gens, _ = serve.build_workload(cfg, 4, 16, (4, 9), seed=0)
    streams = {}
    for label, kw in (("dense", {}),
                      ("paged", dict(cache="paged", page_size=16)),
                      ("paged_jax", dict(cache="paged", page_size=16,
                                         paged_attn="jax"))):
        eng = ContinuousScheduler(cfg, max_slots=2, max_len=26,
                                  device="cuda", **kw)
        eng.load(params)
        b5 = paged_lib.paged_decode_attention_cuda.launches
        streams[label], _ = serve.run_continuous(eng, prompts, gens)
        launched = paged_lib.paged_decode_attention_cuda.launches - b5
        assert (launched > 0) == (label == "paged"), label
        assert bool(jax_calls) == (label == "paged_jax"), label
    assert [len(t) for t in streams["paged_jax"]] == list(gens)


@pytest.mark.parametrize("layout", [{}, {"cache_layout": "opt"},
                                    {"decode_cache_shard": "flat"}])
def test_sliding_window_layouts_graph_match_eager(cuda, layout):
    """A rolling 8-position cache (prompts of 16 roll it) in bshd, opt and
    flat: the captured decode step launches B1 4L+1 and B4 L a replay, and
    graphed streams equal eager ones and the static server's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousScheduler

    cfg = get_config("ternary-paper", reduced=True, num_layers=2,
                     ternary_min_dim=64, sliding_window=8, **layout)
    cfg, params = serve.build_params(cfg, 0, "cuda", packed=True)
    prompts, gens, _ = serve.build_workload(cfg, 5, 16, (4, 12), seed=0)
    streams = {}
    for graph in (False, True):
        eng = ContinuousScheduler(cfg, max_slots=2, max_len=29,
                                  device="cuda", cuda_graph=graph)
        eng.load(params)
        if graph:
            per = eng._graph.launches_per_replay
            assert (per["ternary_gemm"], per["fused_mlp"]) == (9, 2)
        streams[graph], _ = serve.run_continuous(eng, prompts, gens)
    server = serve.BatchedServer(cfg, 29, "cuda")
    server.load(params)
    static, _ = serve.run_static(server, prompts, gens, 2)
    for a, b in zip(streams[False], streams[True]):
        np.testing.assert_array_equal(a, b)
    assert [len(s) for s in static] == list(gens)


@pytest.mark.parametrize("arch,cache", [
    ("jamba-v0.1-52b", {}), ("jamba-v0.1-52b", {"cache": "paged",
                                                "page_size": 8}),
    ("mamba2-130m", {"cache": "paged", "page_size": 8}),
    ("mixtral-8x22b", {})])
def test_families_graph_matches_eager(cuda, arch, cache):
    """Reduced packed MoE, SSM and hybrid models (2 layers; jamba one
    attention and one SSM layer) through the engine with the decode step
    replayed as a CUDA graph and run eagerly: equal token streams and
    launches, B5 once per attention layer a replay, the SSM rows and MoE
    scatter inside the graph, and one step's logits bitwise equal."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import graphs
    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousScheduler

    extra = (dict(attn_period=2, attn_offset=1)
             if arch.startswith("jamba") else {})
    cfg = get_config(arch, reduced=True, num_layers=2, ternary_min_dim=64,
                     quantization="ternary", **extra)
    cfg, params = serve.build_params(cfg, 0, "cuda", packed=True)
    prompts, gens, _ = serve.build_workload(cfg, 6, 16, (4, 12), seed=0)
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    runs, logits = {}, []
    for graph in (False, True):
        eng = ContinuousScheduler(cfg, max_slots=3, max_len=29,
                                  device="cuda", cuda_graph=graph, **cache)
        eng.load(params)
        before = graphs.read_launches()
        outs, _ = serve.run_continuous(eng, prompts, gens)
        after = graphs.read_launches()
        runs[graph] = (outs, {k: after[k] - before[k] for k in after})
        if graph:
            per = eng._graph.launches_per_replay
            assert per["paged_decode_attention"] == (n_attn if cache else 0)
            assert per["ternary_gemm"] > 0
        eng = ContinuousScheduler(cfg, max_slots=3, max_len=29,
                                  device="cuda", cuda_graph=graph, **cache)
        eng.load(params)
        for p, g in zip(prompts[:3], gens[:3]):
            eng.submit(p, g)
        eng.step()
        eng.step()
        logits.append(eng.last_logits.clone())
    for a, b in zip(runs[False][0], runs[True][0]):
        np.testing.assert_array_equal(a, b)
    assert runs[False][1] == runs[True][1]
    assert torch.equal(*logits)


# --- tensor-parallel shards: the f32 forms and sliced packs ------------------

@pytest.mark.parametrize("m", [8, 1024])
@pytest.mark.parametrize("kn", [(512, 1024), (1008, 200)])
def test_ternary_gemm_f32_form_matches_plain_and_bf16(cuda, m, kn):
    """B1's f32 form (a row-split shard, o at tp 2: 512 -> 1024) against
    its plain version; its output plus the bias, cast, is bitwise the bf16
    form's (the same accumulators, scale, f32 add and one rounding)."""
    k, n = kn
    g = _gen(m + k)
    full = weights.pack(torch.randn(2 * k, n, generator=g, device=cuda),
                        bias=torch.randn(n, generator=g, device=cuda))
    w = weights.shard_weight(full, "k", 1, 2)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    with ops.serving_phase("decode" if m <= 16 else "prefill"):
        got = ops.ternary_gemm(x, w, partition="k", tp=2)
        bf16 = ops.ternary_gemm(x, w)
    ref = gemm_lib.ternary_gemm_ref(x, w.packed, w.scale,
                                    out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _close(got, ref)
    assert torch.equal((got + w.bias).to(torch.bfloat16), bf16)
    with pytest.raises(ValueError, match="scale alone"):
        gemm_lib.ternary_gemm_cuda(x, w.packed, w.scale, w.bias, n=n,
                                   out_dtype=torch.float32)


@pytest.mark.parametrize("m", [8, 1024])
@pytest.mark.parametrize("gated", [True, False])
def test_fused_mlp_f32_form_matches_plain_and_bf16(cuda, m, gated):
    """B4's f32 partial at tp 2's ff slice (1024 -> 2048 -> 1024) against
    its plain version; plus the down projection's bias and cast, bitwise
    the bf16 form. The ff slice keeps B4's chunk width (512: 4 chunks)."""
    g = _gen(m * 3 + gated)
    wi, wg = (weights.shard_weight(weights.pack(
        torch.randn(1024, 4096, generator=g, device=cuda)), "n", 0, 2)
        for _ in range(2))
    wo = weights.shard_weight(weights.pack(
        torch.randn(4096, 1024, generator=g, device=cuda),
        bias=torch.randn(1024, generator=g, device=cuda)), "k", 0, 2)
    wg = wg if gated else None
    assert wi.n == 2048 and fused_lib.chunk_width(wi.n) == 512
    x = torch.randn(m, 1024, generator=g, device=cuda).to(torch.bfloat16)
    with ops.serving_phase("decode" if m <= 16 else "prefill"):
        got = ops.fused_mlp(x, wi, wo, wg, tp=2)
        bf16 = ops.fused_mlp(x, wi, wo, wg)
    ref = fused_lib.fused_mlp_ref(
        x, wi.packed, wo.packed, None if wg is None else wg.packed,
        wi.scale, None, None if wg is None else wg.scale, None, wo.scale,
        None, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    _close(got, ref)
    assert torch.equal((got + wo.bias).to(torch.bfloat16), bf16)


@pytest.mark.parametrize("part", ["k", "n"])
@pytest.mark.parametrize("m", [8, 200])
def test_skip_kernels_on_a_sliced_tiled_shard(cuda, part, m):
    """A tiled pack sliced for tp 2 (its occupancy lists recomputed over
    the shard's tiles): B2 == B3 == B1 bitwise, and within tolerance of
    the plain version."""
    g = _gen(m + len(part))
    t = formats.random_tile_ternary(np.random.default_rng(m), 1024, 512,
                                    256, 128, 0.5)
    full = weights.pack(torch.from_numpy(t).to(cuda), "tiled", tile_k=256,
                        tile_n=128,
                        scale=torch.rand(512, generator=g, device=cuda) + .5)
    w = weights.shard_weight(full, part, 1, 2)
    x = torch.randn(m, w.k, generator=g, device=cuda).to(torch.bfloat16)
    ys = [ops.ternary_gemm(x, w, impl=impl)
          for impl in ("skip", "skip_db", "dense")]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1]) and torch.equal(ys[1], ys[2])
    _close(ys[2], gemm_lib.ternary_gemm_ref(x, w.packed[:, :w.n], w.scale))


# ---------------------------------------------------------------------------
# distributed training: two ranks on this card over gloo
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp_ranks_on_card():
    """``test_torch_gloo_ranks.tp_rank_checks`` on two ranks sharing cuda:0
    (the autograd collectives, the row-split STE, the tensor-parallel
    norm), with its inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from test_torch_gloo_ranks import run_ranks, tp_rank_checks
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    w_rows = rng.standard_normal((256, 96)).astype(np.float32)
    w_cols = rng.standard_normal((256, 160)).astype(np.float32)
    w = rng.standard_normal((1024, 384)).astype(np.float32) / 32
    g = rng.standard_normal((1024, 384)).astype(np.float32)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((64, 128), (96,), (32, 64))]
    split = [True, False, True]
    got = run_ranks(2, tp_rank_checks, x, w_rows, w_cols, w, g, leaves,
                    split, "cuda:0")
    return (x, w_rows, w_cols, w, g, leaves, split), got


def _f32_close(got, ref, tol=1e-5):
    ref = ref.detach().float().cpu().numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


def test_tp_autograd_collectives_on_the_card(cuda, tp_ranks_on_card):
    """Megatron's f/g pair and the logits' gather over two ranks on cuda:0
    (gloo): forwards, x's gradient and the weight shards' gradients
    against the whole matrices' on the card, f32 within 1e-5 of each
    tensor's magnitude; g without a gradient gives the same bits."""
    (x, w_rows, w_cols, *_), got = tp_ranks_on_card
    xt = torch.from_numpy(x).to(cuda).requires_grad_()
    wr = torch.from_numpy(w_rows).to(cuda).requires_grad_()
    wc = torch.from_numpy(w_cols).to(cuda).requires_grad_()
    cols, rows = xt @ wc, xt @ wr
    ((cols * cols).sum() + rows.sin().sum()).backward()
    k, n = w_rows.shape[0] // 2, w_cols.shape[1] // 2
    for rank, out in enumerate(got):
        _f32_close(out["cols"], cols)
        _f32_close(out["rows"], rows)
        assert np.array_equal(out["rows_nograd"], out["rows"])
        _f32_close(out["gx"], xt.grad)
        _f32_close(out["gwr"], wr.grad[rank * k:(rank + 1) * k])
        _f32_close(out["gwc"], wc.grad[:, rank * n:(rank + 1) * n])
    assert np.array_equal(got[0]["gx"], got[1]["gx"])


def test_row_split_ste_on_the_card(cuda, tp_ranks_on_card):
    """The row-split STE (column statistics all-reduced over the two
    ranks) against ``ste_ternarize`` of the whole (1024, 384) matrix on
    the card: the codes equal, values and the straight-through gradient
    within 1e-6; and the tensor-parallel clip norm (split leaves summed
    over the ranks, the replicated one once) within 1e-6."""
    from repro_torch.core import quantize
    from repro_torch.optim import global_norm
    (*_, w, g, leaves, split), got = tp_ranks_on_card
    wt = torch.from_numpy(w).to(cuda).requires_grad_()
    y = quantize.ste_ternarize(wt, 0.7)
    (gw,) = torch.autograd.grad(y, [wt], torch.from_numpy(g).to(cuda))
    ys = np.concatenate([out["ste_y"] for out in got])
    gws = np.concatenate([out["ste_g"] for out in got])
    want = y.detach().cpu().numpy()
    np.testing.assert_array_equal(np.sign(ys), np.sign(want))
    np.testing.assert_allclose(ys, want, rtol=1e-6)
    np.testing.assert_allclose(gws, gw.cpu().numpy(), rtol=1e-6, atol=1e-6)
    norm = float(global_norm([torch.from_numpy(a).to(cuda)
                              for a in leaves]))
    assert all(abs(out["norm"] - norm) <= 1e-6 * norm for out in got)
