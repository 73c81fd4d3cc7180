// Packed 2-bit ternary GEMM for Hopper (sm_90a), bf16 in and out:
//   Y = X @ decode(W) * scale + bias (+ PReLU), f32 accumulation.
//
// Replaces the TPU kernel repro/kernels/ternary_gemm.py::ternary_gemm_pallas
// (its _kernel body; the pallas_call at line 197).
//
// What bounds it on the H100: at decode (M = slots, 8) the product is a
// GEMV and the card can only stream the 2-bit weights (a 1024x1024 layer is
// 256 KiB, ~0.08 us at 3.35 TB/s), so what it pays is latency: the launch,
// the dependent chain of 16-deep MMA chunks of each output, and how many
// loads a block keeps in flight. At prefill and evaluation (M 1024, 8192)
// it is operation-bound, 2*M*N*K bf16 tensor-core work, and the decode of
// the 2-bit words is ALU and shared-memory work beside the MMAs.
//
// Design (the helpers are ternary_tiles.cuh's register-decode loop):
//  - no decoded weight tile: each lane turns the packed word of its column
//    into its mma.sync B fragment in registers with a 16-entry nibble
//    table, and each decoded fragment feeds all FM 16-row A fragments of
//    the warp (4 at prefill: a 64 x 32 warp tile);
//  - a ring of STAGES cp.async stages, one 64-deep K step each, holds the
//    x tile (16-byte copies, ldmatrix.x4 for the A fragments) and the raw
//    words; K % 8 != 0 fills the same stages with plain loads;
//  - the epilogue runs from the accumulators (scale, then bias, then PReLU
//    in f32, one cast, bf16x2 stores);
//  - an f32 form (ternary_gemm_f32) for a row-split tensor-parallel
//    shard: the same accumulators and scale, no bias, no cast; the caller
//    sums the ranks' partials in f32, then adds the bias and casts, where
//    a single card would have rounded;
//  - no split-K: every output element adds its K chunks in ascending order
//    into one f32 accumulator through HMMA.16816, as B2 and B3 do, so the
//    three agree bit for bit.
// A grid of tiles (B1_TILES below), from which the block-shape tuner
// (autotune.py) picks per (M, K, N, phase): 16-row tiles for GEMV-shaped
// decode (rows 8-15 of the A fragment are zero at M 8), 32-row tiles for
// windows and prefills up to M ~512, 64 rows for wider ones (PERF.md §6).
// No tile moves a bit: every element adds the same ascending 16-deep
// chunks. wgmma and TMA would change the accumulation and come to B1, B2
// and B3 together.
#include "ternary_tiles.cuh"

using ternary::BK;
using ternary::BKW;
using ternary::XLD;
using ternary::bf16;

template <int BM, int BN, int STAGES>
struct GemmSmem {
  static constexpr int LUT = 128;                          // bytes
  static constexpr int X = BM * XLD * 2;                   // bytes a stage
  static constexpr int W = BKW * BN * 4;
  static constexpr int STAGE = X + W;
  static constexpr int BYTES = LUT + STAGES * STAGE;
};

// The f32 form's store: this warp's FM x FN fragments, scaled
// (epilogue_f32 with no bias and no PReLU) and written as f32, masked at
// the M and N edges.
template <int FM, int FN>
__device__ __forceinline__ void store_frags_f32(
    const float (&acc)[FM][FN][4], int r0, int c0, int M, int N,
    const float* __restrict__ scale, float* __restrict__ y) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = r0 + i * 16 + h * 8 + g, gc = c0 + j * 8 + 2 * t;
        if (gr >= M || gc >= N) continue;
        float* out = y + (size_t)gr * N + gc;
        out[0] = ternary::epilogue_f32(acc[i][j][2 * h], gc, scale, nullptr,
                                       0, 0.0f);
        if (gc + 1 < N)
          out[1] = ternary::epilogue_f32(acc[i][j][2 * h + 1], gc + 1, scale,
                                         nullptr, 0, 0.0f);
      }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES,
          bool F32OUT = false>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
ternary_gemm_kernel(const bf16* __restrict__ x, const uint32_t* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, void* __restrict__ y,
                    int M, int K, int N, int kw, int ldw, int fuse_prelu,
                    float prelu_alpha, int vec) {
  constexpr int FM = BM / (16 * WARPS_M);
  constexpr int FN = BN / (8 * WARPS_N);
  static_assert(FM * 16 * WARPS_M == BM && FN * 8 * WARPS_N == BN,
                "tile does not split into 16 x 8 fragments per warp");
  using S = GemmSmem<BM, BN, STAGES>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem);
  unsigned char* ring = smem + S::LUT;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int nk = (K + BK - 1) / BK;

  auto xs = [&](int s) { return reinterpret_cast<bf16*>(ring + s * S::STAGE); };
  auto ws = [&](int s) {
    return reinterpret_cast<uint32_t*>(ring + s * S::STAGE + S::X);
  };
  auto load = [&](int step) {
    const int s = step % STAGES;
    ternary::ring_stage_x<BM>(xs(s), x, m0, step * BK, M, K, K, vec);
    ternary::ring_stage_words<BN>(ws(s), w, step * BKW, n0, kw, ldw, ldw, vec);
  };

  ternary::fill_nibble_lut(lut);
  float acc[1][FM][FN][4];
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
    ternary::mma_step_2bit<FM, FN, BN, 1>(
        acc, xs(s) + wm * FM * 16 * XLD, XLD, ws(s) + wn * FN * 8, BKW, lut);
  }
  ternary::cp_async_wait<0>();
  if constexpr (F32OUT)
    store_frags_f32<FM, FN>(acc[0], m0 + wm * FM * 16, n0 + wn * FN * 8, M,
                            N, scale, static_cast<float*>(y));
  else
    ternary::store_frags_epilogue<FM, FN>(acc[0], m0 + wm * FM * 16,
                                          n0 + wn * FN * 8, M, N, scale,
                                          bias, fuse_prelu, prelu_alpha,
                                          static_cast<bf16*>(y));
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES,
          bool F32OUT = false>
static int launch(const void* x, const void* w, const void* scale,
                  const void* bias, void* y, int M, int K, int N, int kw,
                  int ldw, int fuse_prelu, float prelu_alpha, int vec,
                  cudaStream_t stream) {
  constexpr int SMEM = GemmSmem<BM, BN, STAGES>::BYTES;
  static_assert(SMEM <= 48 * 1024, "above 48 KB needs cudaFuncSetAttribute");
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ternary_gemm_kernel<BM, BN, WARPS_M, WARPS_N, STAGES, F32OUT>
      <<<grid, WARPS_M * WARPS_N * 32, SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint32_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias), y,
      M, K, N, kw, ldw, fuse_prelu, prelu_alpha, vec);
  return (int)cudaGetLastError();
}

// The instantiated tiles, X(BM, BN, WARPS_M, WARPS_N, STAGES); the same
// table as ternary_gemm.TILES (CPU-tested in tests/test_torch_autotune.py).
// A warp holds BM rows and BN / 4 columns; the stages keep 7 (BM 16), 5
// (BM 32) or 3 (BM 64) K steps in flight. A 128 x 128 tile of 8 warps was
// slower than 64 x 128 at every served key but one (PERF.md §6).
#define B1_TILES(X)     \
  X(16, 64, 1, 4, 8)    \
  X(16, 128, 1, 4, 8)   \
  X(32, 64, 1, 4, 6)    \
  X(32, 128, 1, 4, 6)   \
  X(64, 64, 1, 4, 4)    \
  X(64, 128, 1, 4, 4)

// w is (kw, ldw) words of which the first N columns are read (ldw > N for
// a tile-padded pack). (bm, bn) names one of B1_TILES. Returns the
// cudaError_t of the launch (0 = success; cudaErrorInvalidValue for a tile
// that is not instantiated).
extern "C" int ternary_gemm_bf16(const void* x, const void* w,
                                 const void* scale, const void* bias, void* y,
                                 int M, int K, int N, int kw, int ldw,
                                 int fuse_prelu, float prelu_alpha, int bm,
                                 int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = (K % 8 == 0) && (ldw % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(w) % 16 == 0);
#define B1_LAUNCH(BM, BN, WM, WN, ST)                                      \
  if (bm == BM && bn == BN)                                               \
    return launch<BM, BN, WM, WN, ST>(x, w, scale, bias, y, M, K, N, kw,  \
                                      ldw, fuse_prelu, prelu_alpha, vec, s);
  B1_TILES(B1_LAUNCH)
#undef B1_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The f32 form: y (M, N) float32 = X @ decode(W) * scale, no bias, no
// PReLU (a row-split shard's partial product). Same tiles and return
// codes as ternary_gemm_bf16.
extern "C" int ternary_gemm_f32(const void* x, const void* w,
                                const void* scale, void* y, int M, int K,
                                int N, int kw, int ldw, int bm, int bn,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = (K % 8 == 0) && (ldw % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(w) % 16 == 0);
#define B1_LAUNCH(BM, BN, WM, WN, ST)                                      \
  if (bm == BM && bn == BN)                                               \
    return launch<BM, BN, WM, WN, ST, true>(x, w, scale, nullptr, y, M, K, \
                                            N, kw, ldw, 0, 0.0f, vec, s);
  B1_TILES(B1_LAUNCH)
#undef B1_LAUNCH
  return (int)cudaErrorInvalidValue;
}
