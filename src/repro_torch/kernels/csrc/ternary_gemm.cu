// Packed 2-bit ternary GEMM for Hopper (sm_90a), bf16 in and out:
//   Y = X @ decode(W) * scale + bias (+ PReLU), f32 accumulation.
//
// Replaces the TPU kernel repro/kernels/ternary_gemm.py::ternary_gemm_pallas
// (its _kernel body; the pallas_call at line 197).
//
// What bounds it on the H100: at decode (M = slots, 8) the product is a
// GEMV and the card can only stream the 2-bit weights (a 1024x1024 layer is
// 256 KiB, ~0.08 us at 3.35 TB/s), so launch latency and the few blocks a
// small N gives are what this kernel pays. At prefill (M = group x prompt,
// 1024+) it is operation-bound: 2*M*N*K bf16 tensor-core work.
//
// Design: one block per (BM x BN) output tile, looping over K in BK = 64
// steps. Each step stages the activation tile and the (BK/16 x BN) word
// tile, decodes the words to a bf16 +1/0/-1 tile in shared memory with
// (c & 1) - ((c >> 1) & 1), and runs WMMA 16x16x16 bf16 MMAs with f32
// accumulators (tensor cores via mma.sync). The f32 epilogue (scale, then
// bias, then optional PReLU, then the cast) runs once per tile from a
// shared-memory stage, so it rounds exactly where the plain version does.
// Weights stay 2-bit in device memory: decode happens on chip. Two fixed
// tile shapes: a narrow decode tile (BM 16, BN 64) so a GEMV still spreads
// over N/64 blocks, and a prefill tile (BM 64, BN 128) that reuses each
// decoded weight tile across 64 rows. wgmma, TMA and a multistage pipeline
// are later work.
#include "ternary_tiles.cuh"

using namespace nvcuda;
using ternary::APAD;
using ternary::BK;
using ternary::BKW;
using ternary::CPAD;
using ternary::bf16;

template <int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
ternary_gemm_kernel(const bf16* __restrict__ x, const uint32_t* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, bf16* __restrict__ y,
                    int M, int K, int N, int kw, int fuse_prelu,
                    float prelu_alpha) {
  constexpr int FM = BM / (16 * WARPS_M);
  constexpr int FN = BN / (16 * WARPS_N);
  constexpr int XS = BM * (BK + APAD);   // bf16 elements
  constexpr int WS = BK * (BN + APAD);   // bf16 elements
  constexpr int CS = BM * (BN + CPAD);   // f32 elements
  constexpr int MAIN_BYTES = (XS + WS) * 2;
  constexpr int SMEM = MAIN_BYTES > CS * 4 ? MAIN_BYTES : CS * 4;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + XS;
  float* cs = reinterpret_cast<float*>(smem);   // reused after the K loop

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (K + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    ternary::load_act_tile<BM>(xs, x, m0, t * BK, M, K, K);
    ternary::decode_weight_tile<BN>(ws, w, t * BKW, n0, kw, N);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * FM * 16 + i * 16) * (BK + APAD) + kk,
                               BK + APAD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], ws + kk * (BN + APAD) + wn * FN * 16 + j * 16,
                               BN + APAD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(
          cs + (wm * FM * 16 + i * 16) * (BN + CPAD) + wn * FN * 16 + j * 16,
          acc[i][j], BN + CPAD, wmma::mem_row_major);
  __syncthreads();

  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int r = i / BN, c = i % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) {
      float v = cs[r * (BN + CPAD) + c];
      if (scale != nullptr) v *= scale[gc];
      if (bias != nullptr) v += bias[gc];
      if (fuse_prelu && !(v >= 0.0f)) v *= prelu_alpha;
      y[(size_t)gr * N + gc] = __float2bfloat16(v);
    }
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
static int launch(const void* x, const void* w, const void* scale,
                  const void* bias, void* y, int M, int K, int N, int kw,
                  int fuse_prelu, float prelu_alpha, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ternary_gemm_kernel<BM, BN, WARPS_M, WARPS_N>
      <<<grid, WARPS_M * WARPS_N * 32, 0, stream>>>(
          static_cast<const bf16*>(x), static_cast<const uint32_t*>(w),
          static_cast<const float*>(scale), static_cast<const float*>(bias),
          static_cast<bf16*>(y), M, K, N, kw, fuse_prelu, prelu_alpha);
  return (int)cudaGetLastError();
}

// variant 0: decode tile (BM 16, BN 64, 4 warps);
// variant 1: prefill tile (BM 64, BN 128, 8 warps).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int ternary_gemm_bf16(const void* x, const void* w,
                                 const void* scale, const void* bias, void* y,
                                 int M, int K, int N, int kw, int fuse_prelu,
                                 float prelu_alpha, int variant,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    return launch<16, 64, 1, 4>(x, w, scale, bias, y, M, K, N, kw, fuse_prelu,
                                prelu_alpha, s);
  if (variant == 1)
    return launch<64, 128, 2, 4>(x, w, scale, bias, y, M, K, N, kw, fuse_prelu,
                                 prelu_alpha, s);
  return (int)cudaErrorInvalidValue;
}
