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
// in the output dtype after it; this kernel rounds at the same points
// (ternary::epilogue_bf16).
//
// What bounds it on the H100: like ternary_gemm.cu, bytes at decode (two
// 1-bit planes = 2 bits a weight, the same bytes as a 2-bit pack) and
// tensor-core operations at prefill.
//
// Design: ternary_gemm.cu's register-decode loop (ternary_tiles.cuh) with
// a decode of its own. A ring of STAGES cp.async stages, one 64-deep K step
// each, holds the x tile and the raw plane bytes of the step: 8 byte rows
// x BN columns of each plane, 16-byte copies when N % 16 == 0 (plain loads
// into the same stages otherwise). For the m16n8k16 B fragment of 16-deep
// chunk kk, lane (g = lane / 4, t = lane % 4) needs K rows {2t, 2t+1} and
// {2t+8, 2t+9} of its column: bits 2t and 2t+1 of byte rows 2kk and 2kk+1
// of each plane. Two bits of plus and two of minus index a 16-entry table
// of bf16x2 (p_bit - m_bit) pairs (kPlaneLut, the same constants as
// repro_torch/kernels/ternary_gemm_bitplane.py's PLANE_LUT), so a
// fragment register is four shifts and one lookup; each decoded fragment
// feeds every 16-row A fragment of the warp (ldmatrix.x4).
//  - FACTORIZED = false: one MMA per fragment over the combined planes.
//  - FACTORIZED = true is repro's matmul factorization (X @ P) - (X @ M):
//    entries 0-3 of the table are the 0/1 pairs of one plane's two bits,
//    so each plane gives its own fragment and MMA into its own accumulator
//    set; the two sets are subtracted once, after the K loop, as the plain
//    version subtracts its two products.
// Tiles (B7_TILES below; the block-shape tuner picks one): the decode
// tile BM 16 x BN 64 with 4 warps of 16 x 16 and 8 stages in both modes;
// the prefill tile BM 64 x BN 128 with 4 stages: 4 warps of 64 x 32 in
// plain mode (B1's tile), while the factorized mode's two accumulator sets
// take 8 warps of 32 x 32, so a thread holds 64 accumulators either way;
// and the 16- and 32-row tiles of 128 columns between them.
#include "ternary_tiles.cuh"

using ternary::BK;
using ternary::BKW;
using ternary::XLD;
using ternary::bf16;

constexpr int BKB = BK / 8;     // plane byte rows per step

// Entry v = p_lo | p_hi << 1 | m_lo << 2 | m_hi << 3 (the plus and minus
// bits of a fragment register's two K rows) -> the bf16x2 pair
// (p_lo - m_lo, p_hi - m_hi), low half first.
__constant__ uint32_t kPlaneLut[16] = {
    0x00000000u, 0x00003F80u, 0x3F800000u, 0x3F803F80u,
    0x0000BF80u, 0x00000000u, 0x3F80BF80u, 0x3F800000u,
    0xBF800000u, 0xBF803F80u, 0x00000000u, 0x00003F80u,
    0xBF80BF80u, 0xBF800000u, 0x0000BF80u, 0x00000000u};

template <int BM, int BN, int STAGES>
struct PlaneSmem {
  static constexpr int LUT = 128;                  // bytes
  static constexpr int X = BM * XLD * 2;           // bytes a stage
  static constexpr int P = BKB * BN;               // one plane's bytes a stage
  static constexpr int STAGE = X + 2 * P;
  static constexpr int BYTES = LUT + STAGES * STAGE;
};

// Stage byte rows [b0, b0 + BKB) and columns [n0, n0 + BN) of a (kb, N)
// plane into dst (row stride BN), zero past row kb and column N. vec:
// 16-byte cp.async copies (N % 16 == 0, plane 16-byte aligned); otherwise
// plain loads, visible after __syncthreads.
template <int BN>
__device__ __forceinline__ void ring_stage_plane(uint8_t* dst,
                                                 const uint8_t* plane, int b0,
                                                 int n0, int kb, int N,
                                                 bool vec) {
  if (vec) {
    constexpr int G = BN / 16;
    for (int i = threadIdx.x; i < BKB * G; i += blockDim.x) {
      const int r = i / G, c = (i % G) * 16;
      const bool ok = b0 + r < kb && n0 + c < N;
      ternary::cp_async16(dst + r * BN + c,
                          ok ? plane + (size_t)(b0 + r) * N + n0 + c : plane,
                          ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BKB * BN; i += blockDim.x) {
      const int r = i / BN, c = i % BN;
      const bool ok = b0 + r < kb && n0 + c < N;
      dst[i] = ok ? plane[(size_t)(b0 + r) * N + n0 + c] : (uint8_t)0;
    }
  }
}

// acc[0] += a @ (P - M) (or, NT == 2, acc[0] += a @ P and acc[1] += a @ M)
// over one staged step and this warp's FM x FN fragments of 16 x 8.
// a: this warp's first row (row stride lda); ps / ms: the staged plane
// tiles at this warp's first column (row stride BN).
template <int FM, int FN, int BN, int NT>
__device__ __forceinline__ void mma_step_planes(float (&acc)[NT][FM][FN][4],
                                                const bf16* a, int lda,
                                                const uint8_t* ps,
                                                const uint8_t* ms,
                                                const uint32_t* lut) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* arow = a + (lane & 15) * lda + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < BKW; ++kk) {
    uint32_t af[FM][4];
#pragma unroll
    for (int i = 0; i < FM; ++i) ternary::ldmatrix_x4(af[i], arow + i * 16 * lda + kk * 16);
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int c = j * 8 + g;
      const uint32_t p0 = (uint32_t)ps[(2 * kk) * BN + c] >> (2 * t);
      const uint32_t p1 = (uint32_t)ps[(2 * kk + 1) * BN + c] >> (2 * t);
      const uint32_t m0 = (uint32_t)ms[(2 * kk) * BN + c] >> (2 * t);
      const uint32_t m1 = (uint32_t)ms[(2 * kk + 1) * BN + c] >> (2 * t);
      if (NT == 1) {
        const uint32_t b[2] = {lut[(p0 & 3u) | ((m0 & 3u) << 2)],
                               lut[(p1 & 3u) | ((m1 & 3u) << 2)]};
#pragma unroll
        for (int i = 0; i < FM; ++i) ternary::mma_16816(acc[0][i][j], af[i], b);
      } else {
        const uint32_t bp[2] = {lut[p0 & 3u], lut[p1 & 3u]};
        const uint32_t bm[2] = {lut[m0 & 3u], lut[m1 & 3u]};
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          ternary::mma_16816(acc[0][i][j], af[i], bp);
          ternary::mma_16816(acc[NT - 1][i][j], af[i], bm);
        }
      }
    }
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES,
          bool FACTORIZED>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
ternary_gemm_bitplane_kernel(const bf16* __restrict__ x,
                             const uint8_t* __restrict__ plus,
                             const uint8_t* __restrict__ minus,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             bf16* __restrict__ y, int M, int K, int N,
                             int kb, int fuse_prelu, float prelu_alpha,
                             int vec_x, int vec_p) {
  constexpr int NT = FACTORIZED ? 2 : 1;
  constexpr int FM = BM / (16 * WARPS_M);
  constexpr int FN = BN / (8 * WARPS_N);
  static_assert(FM * 16 * WARPS_M == BM && FN * 8 * WARPS_N == BN,
                "tile does not split into 16 x 8 fragments per warp");
  using S = PlaneSmem<BM, BN, STAGES>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem);
  unsigned char* ring = smem + S::LUT;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int nk = (K + BK - 1) / BK;

  auto xs = [&](int s) { return reinterpret_cast<bf16*>(ring + s * S::STAGE); };
  auto ps = [&](int s) {
    return reinterpret_cast<uint8_t*>(ring + s * S::STAGE + S::X);
  };
  auto load = [&](int step) {
    const int s = step % STAGES;
    ternary::ring_stage_x<BM>(xs(s), x, m0, step * BK, M, K, K, vec_x);
    ring_stage_plane<BN>(ps(s), plus, step * BKB, n0, kb, N, vec_p);
    ring_stage_plane<BN>(ps(s) + S::P, minus, step * BKB, n0, kb, N, vec_p);
  };

  if (threadIdx.x < 16) lut[threadIdx.x] = kPlaneLut[threadIdx.x];
  float acc[NT][FM][FN][4];
  ternary::zero_frags(acc);
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    ternary::cp_async_commit();
  }
  for (int step = 0; step < nk; ++step) {
    ternary::cp_async_wait<STAGES - 2>();
    __syncthreads();      // step's stage landed; step - 1's slot is free
    if (step + STAGES - 1 < nk) load(step + STAGES - 1);
    ternary::cp_async_commit();
    const int s = step % STAGES;
    mma_step_planes<FM, FN, BN, NT>(acc, xs(s) + wm * FM * 16 * XLD, XLD,
                                    ps(s) + wn * FN * 8,
                                    ps(s) + S::P + wn * FN * 8, lut);
  }
  ternary::cp_async_wait<0>();
  if (FACTORIZED) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[0][i][j][e] = __fsub_rn(acc[0][i][j][e], acc[NT - 1][i][j][e]);
  }
  ternary::store_frags_epilogue<FM, FN, true>(
      acc[0], m0 + wm * FM * 16, n0 + wn * FN * 8, M, N, scale, bias,
      fuse_prelu, prelu_alpha, y);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES,
          bool FACTORIZED>
static int launch(const void* x, const void* plus, const void* minus,
                  const void* scale, const void* bias, void* y, int M, int K,
                  int N, int kb, int fuse_prelu, float prelu_alpha, int vec_x,
                  int vec_p, cudaStream_t stream) {
  constexpr int SMEM = PlaneSmem<BM, BN, STAGES>::BYTES;
  static_assert(SMEM <= 48 * 1024, "above 48 KB needs cudaFuncSetAttribute");
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ternary_gemm_bitplane_kernel<BM, BN, WARPS_M, WARPS_N, STAGES, FACTORIZED>
      <<<grid, WARPS_M * WARPS_N * 32, SMEM, stream>>>(
          static_cast<const bf16*>(x), static_cast<const uint8_t*>(plus),
          static_cast<const uint8_t*>(minus), static_cast<const float*>(scale),
          static_cast<const float*>(bias), static_cast<bf16*>(y), M, K, N, kb,
          fuse_prelu, prelu_alpha, vec_x, vec_p);
  return (int)cudaGetLastError();
}

// The instantiated tiles, X(BM, BN, WARPS_M, WARPS_M factorized, WARPS_N,
// STAGES): the same table as ternary_gemm_bitplane.TILES. The 16 x 128
// and 32 x 128 tiles are where the tuner's clamp of the 64 x 128 tile to
// a small M's rows lands.
#define B7_TILES(X)          \
  X(16, 64, 1, 1, 4, 8)      \
  X(16, 128, 1, 1, 4, 8)     \
  X(32, 128, 1, 2, 4, 6)     \
  X(64, 128, 1, 2, 4, 4)

// x (M, K) bf16; plus/minus (kb, N) uint8 with kb * 8 >= K; y (M, N) bf16.
// (bm, bn) names one of B7_TILES. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for another tile).
extern "C" int ternary_gemm_bitplane_bf16(const void* x, const void* plus,
                                          const void* minus,
                                          const void* scale, const void* bias,
                                          void* y, int M, int K, int N,
                                          int kb, int fuse_prelu,
                                          float prelu_alpha, int factorized,
                                          int bm, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec_x = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int vec_p = (N % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(plus) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(minus) % 16 == 0);
#define BP_ARGS x, plus, minus, scale, bias, y, M, K, N, kb, fuse_prelu, \
                prelu_alpha, vec_x, vec_p, s
#define BP_LAUNCH(BM, BN, WM, FWM, WN, ST)                          \
  if (bm == BM && bn == BN)                                         \
    return factorized ? launch<BM, BN, FWM, WN, ST, true>(BP_ARGS)  \
                      : launch<BM, BN, WM, WN, ST, false>(BP_ARGS);
  B7_TILES(BP_LAUNCH)
#undef BP_LAUNCH
#undef BP_ARGS
  return (int)cudaErrorInvalidValue;
}
