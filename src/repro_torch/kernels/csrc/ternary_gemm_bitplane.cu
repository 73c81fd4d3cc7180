// Bitplane ternary GEMM for Hopper (sm_90a), bf16 in and out:
//   Y = X @ (P - M) * scale, then + bias and PReLU on the bf16 values,
// where P and M are two (ceil(K/8), N) uint8 bit planes: bit r of byte
// plus[q][c] is 1 iff W[8q + r][c] == +1 (minus likewise for -1). The
// sign of a weight is which plane holds its bit: the TCSC paper's
// structural sign encoding in a form the tensor cores can consume.
//
// Replaces the TPU kernel repro/kernels/ternary_gemm_bitplane.py::
// ternary_gemm_bitplane (its _kernel body; the pallas_call at line 131).
// Its registry lowering (repro/kernels/ops.py::_lower_bitplane_common)
// applies scale in f32 inside the kernel, casts, and adds bias and PReLU
// in the output dtype after it; this kernel rounds at the same points.
//
// What bounds it on the H100: like ternary_gemm.cu, bytes at decode (two
// 1-bit planes = 2 bits a weight) and tensor-core operations at prefill.
//
// Design: ternary_gemm.cu's tiles and K loop (BK = 64, WMMA 16x16x16 bf16,
// f32 accumulators, the same fixed decode and prefill tiles). Each step
// stages the (BK/8 x BN) byte tiles of both planes (a column's K bytes are
// N apart in memory) and decodes them in shared memory. FACTORIZED = false
// decodes bit(plus) - bit(minus) into one +1/0/-1 tile. FACTORIZED = true
// is repro's matmul factorization Y = (X @ P) - (X @ M): two 0/1 tiles, two
// accumulator sets zeroed each step, and acc += accP - accM on the
// fragments after the step's MMAs. wgmma, TMA and a pipeline are later
// work.
#include "ternary_tiles.cuh"

using ternary::APAD;
using ternary::BK;
using ternary::bf16;

constexpr int BKB = BK / 8;     // plane byte rows per step

// Decode plane byte rows [b0, b0 + BKB) and columns [n0, n0 + BN) of the
// (kb, n) planes into (BK x BN) bf16 smem tiles (row stride BN + APAD):
// one +1/0/-1 tile, or (FACTORIZED) a 0/1 tile per plane. Bytes outside
// the planes decode to zero.
template <int BN, bool FACTORIZED>
__device__ __forceinline__ void decode_plane_tiles(
    bf16* dp, bf16* dm, const uint8_t* __restrict__ plus,
    const uint8_t* __restrict__ minus, int b0, int n0, int kb, int n) {
  for (int i = threadIdx.x; i < BKB * BN; i += blockDim.x) {
    const int r = i / BN, c = i % BN;
    const int gr = b0 + r, gc = n0 + c;
    const bool ok = gr < kb && gc < n;
    const unsigned p = ok ? plus[(size_t)gr * n + gc] : 0u;
    const unsigned m = ok ? minus[(size_t)gr * n + gc] : 0u;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int pb = (p >> b) & 1u, mb = (m >> b) & 1u;
      const int at = (r * 8 + b) * (BN + APAD) + c;
      if (FACTORIZED) {
        dp[at] = __float2bfloat16((float)pb);
        dm[at] = __float2bfloat16((float)mb);
      } else {
        dp[at] = __float2bfloat16((float)(pb - mb));
      }
    }
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool FACTORIZED>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
ternary_gemm_bitplane_kernel(const bf16* __restrict__ x,
                             const uint8_t* __restrict__ plus,
                             const uint8_t* __restrict__ minus,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             bf16* __restrict__ y, int M, int K, int N,
                             int kb, int fuse_prelu, float prelu_alpha) {
  using T = ternary::TileShape<BM, BN, WARPS_M, WARPS_N>;
  constexpr int TILES = FACTORIZED ? 2 : 1;
  constexpr int MAIN_BYTES = (T::XS + TILES * T::WS) * 2;
  constexpr int SMEM = MAIN_BYTES > T::CS * 4 ? MAIN_BYTES : T::CS * 4;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* wpos = xs + T::XS;
  bf16* wneg = wpos + T::WS;                   // FACTORIZED only
  float* cs = reinterpret_cast<float*>(smem);   // reused after the K loop

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  ternary::Acc acc[T::FM][T::FN];
  ternary::zero_acc(acc);
  const int nk = (K + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    ternary::load_act_tile<BM>(xs, x, m0, t * BK, M, K, K);
    decode_plane_tiles<BN, FACTORIZED>(wpos, wneg, plus, minus, t * BKB, n0,
                                       kb, N);
    __syncthreads();
    if (FACTORIZED) {
      ternary::Acc acc_p[T::FM][T::FN], acc_m[T::FM][T::FN];
      ternary::zero_acc(acc_p);
      ternary::zero_acc(acc_m);
      ternary::mma_tile<BN>(acc_p, xs, wpos, wm, wn, BK);
      ternary::mma_tile<BN>(acc_m, xs, wneg, wm, wn, BK);
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j)
#pragma unroll
          for (int e = 0; e < acc[i][j].num_elements; ++e)
            acc[i][j].x[e] += acc_p[i][j].x[e] - acc_m[i][j].x[e];
    } else {
      ternary::mma_tile<BN>(acc, xs, wpos, wm, wn, BK);
    }
    __syncthreads();
  }
  ternary::store_epilogue<BM, BN, T::FM, T::FN, true>(
      acc, cs, wm, wn, m0, n0, M, N, scale, bias, fuse_prelu, prelu_alpha, y);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool FACTORIZED>
static int launch(const void* x, const void* plus, const void* minus,
                  const void* scale, const void* bias, void* y, int M, int K,
                  int N, int kb, int fuse_prelu, float prelu_alpha,
                  cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ternary_gemm_bitplane_kernel<BM, BN, WARPS_M, WARPS_N, FACTORIZED>
      <<<grid, WARPS_M * WARPS_N * 32, 0, stream>>>(
          static_cast<const bf16*>(x), static_cast<const uint8_t*>(plus),
          static_cast<const uint8_t*>(minus), static_cast<const float*>(scale),
          static_cast<const float*>(bias), static_cast<bf16*>(y), M, K, N, kb,
          fuse_prelu, prelu_alpha);
  return (int)cudaGetLastError();
}

// x (M, K) bf16; plus/minus (kb, N) uint8 with kb * 8 >= K; y (M, N) bf16.
// variant 0: decode tile (BM 16, BN 64, 4 warps); variant 1: prefill tile
// (BM 64, BN 128, 8 warps). Returns the cudaError_t of the launch.
extern "C" int ternary_gemm_bitplane_bf16(const void* x, const void* plus,
                                          const void* minus,
                                          const void* scale, const void* bias,
                                          void* y, int M, int K, int N,
                                          int kb, int fuse_prelu,
                                          float prelu_alpha, int factorized,
                                          int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BP_ARGS x, plus, minus, scale, bias, y, M, K, N, kb, fuse_prelu, \
                prelu_alpha, s
  if (variant == 0)
    return factorized ? launch<16, 64, 1, 4, true>(BP_ARGS)
                      : launch<16, 64, 1, 4, false>(BP_ARGS);
  if (variant == 1)
    return factorized ? launch<64, 128, 2, 4, true>(BP_ARGS)
                      : launch<64, 128, 2, 4, false>(BP_ARGS);
#undef BP_ARGS
  return (int)cudaErrorInvalidValue;
}
