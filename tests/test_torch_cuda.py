"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at ragged shapes (the kernels mask the M/N/K edges themselves) and at
the serving path's shapes. Marked ``gpu``: they skip on a machine without
a card. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerance: bf16 outputs of f32 sums taken in another order than the plain
version's may round one bf16 ulp (2^-8) the other way; the fused block
rounds h on the way, so both are held to |d| <= 1e-2*|ref| + 1e-2*max|ref|.
This file imports no JAX, so it runs where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.core import weights
from repro_torch.kernels import fused_mlp as fused_lib
from repro_torch.kernels import ops
from repro_torch.kernels import ternary_gemm as gemm_lib

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
