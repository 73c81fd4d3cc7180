"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at ragged shapes (the kernels mask the M/N/K edges themselves) and at
the serving path's shapes. Marked ``gpu``: they skip on a machine without
a card. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerance: bf16 outputs of f32 sums taken in another order than the plain
version's may round one bf16 ulp (2^-8) the other way; the fused block
rounds h on the way and paged attention rounds p, so all are held to
|d| <= 1e-2*|ref| + 1e-2*max|ref|.
This file imports no JAX, so it runs where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.core import weights
from repro_torch.kernels import fused_mlp as fused_lib
from repro_torch.kernels import ops
from repro_torch.kernels import ternary_gemm as gemm_lib
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
@pytest.mark.parametrize("mkn", [(8, 1024, 1024), (5, 37, 19),
                                 (70, 200, 130), (1, 16, 1), (33, 64, 257)])
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


@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("mkfn", [(8, 1024, 4096, 1024), (5, 40, 200, 24),
                                  (37, 96, 128, 70), (64, 256, 1100, 128)])
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
