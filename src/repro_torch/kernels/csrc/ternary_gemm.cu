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

using ternary::BK;
using ternary::BKW;
using ternary::bf16;

template <int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
ternary_gemm_kernel(const bf16* __restrict__ x, const uint32_t* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, bf16* __restrict__ y,
                    int M, int K, int N, int kw, int ldw, int fuse_prelu,
                    float prelu_alpha) {
  using T = ternary::TileShape<BM, BN, WARPS_M, WARPS_N>;
  constexpr int MAIN_BYTES = (T::XS + T::WS) * 2;
  constexpr int SMEM = MAIN_BYTES > T::CS * 4 ? MAIN_BYTES : T::CS * 4;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + T::XS;
  float* cs = reinterpret_cast<float*>(smem);   // reused after the K loop

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  ternary::Acc acc[T::FM][T::FN];
  ternary::zero_acc(acc);
  const int nk = (K + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    ternary::load_act_tile<BM>(xs, x, m0, t * BK, M, K, K);
    ternary::decode_weight_tile<BN>(ws, w, t * BKW, n0, kw, N, ldw);
    __syncthreads();
    ternary::mma_tile<BN>(acc, xs, ws, wm, wn, BK);
    __syncthreads();
  }
  ternary::store_epilogue<BM, BN, T::FM, T::FN, false>(
      acc, cs, wm, wn, m0, n0, M, N, scale, bias, fuse_prelu, prelu_alpha, y);
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
static int launch(const void* x, const void* w, const void* scale,
                  const void* bias, void* y, int M, int K, int N, int kw,
                  int ldw, int fuse_prelu, float prelu_alpha,
                  cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ternary_gemm_kernel<BM, BN, WARPS_M, WARPS_N>
      <<<grid, WARPS_M * WARPS_N * 32, 0, stream>>>(
          static_cast<const bf16*>(x), static_cast<const uint32_t*>(w),
          static_cast<const float*>(scale), static_cast<const float*>(bias),
          static_cast<bf16*>(y), M, K, N, kw, ldw, fuse_prelu, prelu_alpha);
  return (int)cudaGetLastError();
}

// w is (kw, ldw) words of which the first N columns are read (ldw > N for
// a tile-padded pack). variant 0: decode tile (BM 16, BN 64, 4 warps);
// variant 1: prefill tile (BM 64, BN 128, 8 warps).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int ternary_gemm_bf16(const void* x, const void* w,
                                 const void* scale, const void* bias, void* y,
                                 int M, int K, int N, int kw, int ldw,
                                 int fuse_prelu, float prelu_alpha,
                                 int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    return launch<16, 64, 1, 4>(x, w, scale, bias, y, M, K, N, kw, ldw,
                                fuse_prelu, prelu_alpha, s);
  if (variant == 1)
    return launch<64, 128, 2, 4>(x, w, scale, bias, y, M, K, N, kw, ldw,
                                 fuse_prelu, prelu_alpha, s);
  return (int)cudaErrorInvalidValue;
}
