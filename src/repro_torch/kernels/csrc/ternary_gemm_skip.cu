// Tile-skipping packed 2-bit ternary GEMM for Hopper (sm_90a), bf16 in and
// out: Y = X @ decode(W) * scale + bias (+ PReLU), f32 accumulation, where
// the K loop of each output tile visits only the K-tiles that hold a
// nonzero weight.
//
// Replaces two TPU kernels of repro/kernels/ternary_gemm.py:
//   skip    (B2, db = 0): ternary_gemm_skip_pallas    (_skip_kernel; the
//                         pallas_call at line 325);
//   skip_db (B3, db = 1): ternary_gemm_skip_db_pallas (_skip_db_kernel; the
//                         pallas_call at line 496).
//
// The weight is a tile-padded (Kp/16, Np) word matrix plus its pack-time
// occupancy: kt_counts[j] occupied K-tiles for N-tile j, listed in
// ascending order in kt_indices[j, 0:kt_counts[j]] (row stride max_occ).
// Entries past the count are padding and are never read.
//
// What bounds it on the H100: it reads the x slices and word tiles of the
// occupied tiles only. At decode (M = 8) that is bytes: the occupied words
// at 2 bits a weight. At prefill (M = 1024+) it is operations: 2 * M *
// tile_k * tile_n per occupied tile on the tensor cores, so the work falls
// with the occupied fraction of the tiles.
//
// Both: one block per (BM rows x BN columns) of one N-tile (BN divides
// tile_n, so several blocks share an N-tile's list). The block reads its
// N-tile's count and walks the list; each occupied tile is processed in
// BK = 64 deep steps (the last one shorter when tile_k is not a multiple
// of 64), step s of the walk being step s % chunks of the list's tile
// s / chunks. Every output element therefore sees the same 16-deep K
// chunks in the same ascending order as the dense kernel (ternary_gemm.cu,
// B1), through the same HMMA.16816, minus chunks whose products are all
// exact zeros, and the three agree bit for bit.
//
// B2 (ternary_gemm_skip_kernel) runs B1's register-decode loop
// (ternary_tiles.cuh) over the walk: a ring of STAGES cp.async stages
// prefetches steps s + 1 ... s + STAGES - 1 of the list, each stage the x
// slice (columns bounded by the tile's end, row stride K) and the raw
// words (rows bounded by the tile's end, row stride ldw); each lane turns
// the word of its column into its mma.sync B fragment with the nibble
// table, and the epilogue runs from the accumulators. A step at a tile's
// end never reads the next tile's words: it stages zeros past the tile's
// end and runs its four chunks, the extra ones adding exact zeros (as B1
// adds the chunks of an empty tile). Tiles are B1's per phase: decode (bm 16) 16 rows with 8
// stages, prefill (bm 64) 64 rows with 4 warps of 64 rows and 4 stages;
// bn 16, 32, 64 or 128 (the wrapper takes 64 at decode, as B1 does).
//
// B3 (ternary_gemm_skip_db_kernel) keeps the older WMMA loop: each step
// decodes its words into a bf16 +1/0/-1 tile in shared memory and runs
// the 16-deep WMMA chunks (ternary::mma_tile) and the smem epilogue
// (ternary::store_epilogue), with a two-stage pipeline: the x slice and
// raw words of step s + 1 are copied into the other stage with cp.async
// before step s is decoded and multiplied. Staging by 64-deep steps keeps
// shared memory at ~40 KB whatever tile_k is.
//
// The 16-byte copies need x rows 16-byte aligned (K % 8 == 0) and ldw % 4
// == 0; otherwise the same stages are filled with plain loads. wgmma and
// TMA are later work.
#include "ternary_tiles.cuh"

using ternary::APAD;
using ternary::BK;
using ternary::BKW;
using ternary::XLD;
using ternary::bf16;

// B2's shared memory: the nibble table, then STAGES stages of (x slice,
// raw words).
template <int BM, int BN, int STAGES>
struct RingSmem {
  static constexpr int LUT = 128;                          // bytes
  static constexpr int X = BM * XLD * 2;                   // bytes a stage
  static constexpr int W = BKW * BN * 4;
  static constexpr int STAGE = X + W;
  static constexpr int BYTES = LUT + STAGES * STAGE;
};

// Fill one stage for step (kbase, kend, wend): x slice (BM x BK) with row
// stride BK + APAD, zero past row M and column kend; raw words (BKW x BN)
// with row stride BN, zero past word row wend. vec: 16-byte cp.async
// copies (x rows 16-byte aligned, ldw % 4 == 0); otherwise plain loads.
template <int BM, int BN>
__device__ __forceinline__ void stage_async(bf16* xs, uint32_t* wr,
                                            const bf16* x, const uint32_t* w,
                                            int m0, int n0, int kbase,
                                            int kend, int wend, int M, int K,
                                            int ldw, bool vec) {
  if (vec) {
    constexpr int XG = BK / 8;    // 16-byte groups per x row
    for (int i = threadIdx.x; i < BM * XG; i += blockDim.x) {
      const int r = i / XG, g = i % XG;
      const int gr = m0 + r, gc = kbase + g * 8;
      const bool ok = gr < M && gc < kend;   // kend % 8 == 0 here
      ternary::cp_async16(xs + r * (BK + APAD) + g * 8,
                          ok ? x + (size_t)gr * K + gc : x, ok ? 16 : 0);
    }
    constexpr int WG = BN / 4;    // 16-byte groups per word row
    for (int i = threadIdx.x; i < BKW * WG; i += blockDim.x) {
      const int r = i / WG, g = i % WG;
      const int gr = kbase / 16 + r;
      const bool ok = gr < wend;
      ternary::cp_async16(wr + r * BN + g * 4,
                          ok ? w + (size_t)gr * ldw + n0 + g * 4 : w,
                          ok ? 16 : 0);
    }
  } else {
    ternary::load_act_tile<BM>(xs, x, m0, kbase, M, kend, K);
    for (int i = threadIdx.x; i < BKW * BN; i += blockDim.x) {
      const int r = i / BN, c = i % BN;
      const int gr = kbase / 16 + r;
      wr[i] = gr < wend ? w[(size_t)gr * ldw + n0 + c] : 0u;
    }
  }
  ternary::cp_async_commit();
}

// step s of an N-tile's walk -> (first K row, one past its last row, one
// past its last word row), the last two clipped to the end of its tile
__device__ __forceinline__ void step_k(const int* idx, int chunks, int tile_k,
                                       int K, int kw, int s, int& kbase,
                                       int& kend, int& wend) {
  const int k0 = idx[s / chunks] * tile_k;
  kbase = k0 + (s % chunks) * BK;
  kend = min(K, k0 + tile_k);
  wend = min(kw, (k0 + tile_k) / 16);
}

// B2: the register-decode ring over the block's occupied steps.
template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
ternary_gemm_skip_kernel(const bf16* __restrict__ x,
                         const uint32_t* __restrict__ w,
                         const int* __restrict__ kt_indices,
                         const int* __restrict__ kt_counts,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, bf16* __restrict__ y,
                         int M, int K, int N, int kw, int ldw, int tile_k,
                         int tile_n, int max_occ, int fuse_prelu,
                         float prelu_alpha, int vec) {
  constexpr int FM = BM / (16 * WARPS_M);
  constexpr int FN = BN / (8 * WARPS_N);
  static_assert(FM * 16 * WARPS_M == BM && FN * 8 * WARPS_N == BN,
                "tile does not split into 16 x 8 fragments per warp");
  using S = RingSmem<BM, BN, STAGES>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem);
  unsigned char* ring = smem + S::LUT;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int* idx = kt_indices + (size_t)(n0 / tile_n) * max_occ;
  const int chunks = (tile_k + BK - 1) / BK;    // BK steps per tile
  const int steps = kt_counts[n0 / tile_n] * chunks;

  auto xs = [&](int s) { return reinterpret_cast<bf16*>(ring + s * S::STAGE); };
  auto ws = [&](int s) {
    return reinterpret_cast<uint32_t*>(ring + s * S::STAGE + S::X);
  };
  // Steps load in order, so the next one's (list entry, chunk) is a
  // running pair. A step at a tile's end stages zeros past it (x past
  // kend, words past wend), so every step runs all BKW chunks: the extra
  // ones add exact zeros, as B1's chunks of an empty tile do.
  int lt = 0, lc = 0;
  auto load = [&](int step) {
    const int k0 = idx[lt] * tile_k;
    const int kbase = k0 + lc * BK;
    const int kend = min(K, k0 + tile_k), wend = min(kw, (k0 + tile_k) / 16);
    if (++lc == chunks) lc = 0, ++lt;
    const int s = step % STAGES;
    ternary::ring_stage_x<BM>(xs(s), x, m0, kbase, M, kend, K, vec);
    ternary::ring_stage_words<BN>(ws(s), w, kbase / 16, n0, wend, ldw, ldw,
                                  vec);
  };

  ternary::fill_nibble_lut(lut);
  float acc[1][FM][FN][4];
  ternary::zero_frags(acc);
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    ternary::cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    ternary::cp_async_wait<STAGES - 2>();
    __syncthreads();      // step's stage landed; step - 1's slot is free
    if (step + STAGES - 1 < steps) load(step + STAGES - 1);
    ternary::cp_async_commit();
    const int s = step % STAGES;
    ternary::mma_step_2bit<FM, FN, BN, 1>(
        acc, xs(s) + wm * FM * 16 * XLD, XLD, ws(s) + wn * FN * 8, BKW, lut);
  }
  ternary::cp_async_wait<0>();
  ternary::store_frags_epilogue<FM, FN>(acc[0], m0 + wm * FM * 16,
                                        n0 + wn * FN * 8, M, N, scale, bias,
                                        fuse_prelu, prelu_alpha, y);
}

// B3: the two-stage WMMA walk.
template <int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
ternary_gemm_skip_db_kernel(const bf16* __restrict__ x,
                            const uint32_t* __restrict__ w,
                            const int* __restrict__ kt_indices,
                            const int* __restrict__ kt_counts,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            bf16* __restrict__ y, int M, int K, int N, int kw,
                            int ldw, int tile_k, int tile_n, int max_occ,
                            int fuse_prelu, float prelu_alpha, int vec) {
  using T = ternary::TileShape<BM, BN, WARPS_M, WARPS_N>;
  constexpr int STAGES = 2;
  constexpr int WR = BKW * BN;                       // raw words per stage
  constexpr int MAIN_BYTES = STAGES * (T::XS * 2 + WR * 4) + T::WS * 2;
  constexpr int SMEM = MAIN_BYTES > T::CS * 4 ? MAIN_BYTES : T::CS * 4;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* xs = reinterpret_cast<bf16*>(smem);                 // STAGES x XS
  uint32_t* wr = reinterpret_cast<uint32_t*>(xs + STAGES * T::XS);
  bf16* ws = reinterpret_cast<bf16*>(wr + STAGES * WR);    // decoded tile
  float* cs = reinterpret_cast<float*>(smem);   // reused after the K loop

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int j = n0 / tile_n;                    // this block's N-tile
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int* idx = kt_indices + (size_t)j * max_occ;
  const int chunks = (tile_k + BK - 1) / BK;    // BK steps per tile
  const int steps = kt_counts[j] * chunks;

  ternary::Acc acc[T::FM][T::FN];
  ternary::zero_acc(acc);
  if (steps > 0) {
    int kbase, kend, wend;
    step_k(idx, chunks, tile_k, K, kw, 0, kbase, kend, wend);
    stage_async<BM, BN>(xs, wr, x, w, m0, n0, kbase, kend, wend, M, K, ldw,
                        vec);
  }
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) {            // next step's copies go out first
      int kbase, kend, wend;
      step_k(idx, chunks, tile_k, K, kw, s + 1, kbase, kend, wend);
      stage_async<BM, BN>(xs + (cur ^ 1) * T::XS, wr + (cur ^ 1) * WR, x, w,
                          m0, n0, kbase, kend, wend, M, K, ldw, vec);
      ternary::cp_async_wait<1>();
    } else {
      ternary::cp_async_wait<0>();
    }
    __syncthreads();
    int kbase, kend, wend;
    step_k(idx, chunks, tile_k, K, kw, s, kbase, kend, wend);
    const int rows = min(BKW, wend - kbase / 16);   // word rows of the step
    ternary::decode_weight_tile<BN>(ws, wr + cur * WR, 0, 0, rows, BN, BN);
    __syncthreads();
    ternary::mma_tile<BN>(acc, xs + cur * T::XS, ws, wm, wn,
                          min(BK, kend - kbase + 15) / 16 * 16);
    __syncthreads();                // the stage is refilled at s + 2
  }
  ternary::store_epilogue<BM, BN, T::FM, T::FN, false>(
      acc, cs, wm, wn, m0, n0, M, N, scale, bias, fuse_prelu, prelu_alpha, y);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
static int launch_ring(const void* x, const void* w, const void* idx,
                       const void* cnt, const void* scale, const void* bias,
                       void* y, int M, int K, int N, int kw, int ldw,
                       int tile_k, int tile_n, int max_occ, int fuse_prelu,
                       float prelu_alpha, int vec, cudaStream_t stream) {
  constexpr int SMEM = RingSmem<BM, BN, STAGES>::BYTES;
  static_assert(SMEM <= 48 * 1024, "above 48 KB needs cudaFuncSetAttribute");
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ternary_gemm_skip_kernel<BM, BN, WARPS_M, WARPS_N, STAGES>
      <<<grid, WARPS_M * WARPS_N * 32, SMEM, stream>>>(
          static_cast<const bf16*>(x), static_cast<const uint32_t*>(w),
          static_cast<const int*>(idx), static_cast<const int*>(cnt),
          static_cast<const float*>(scale), static_cast<const float*>(bias),
          static_cast<bf16*>(y), M, K, N, kw, ldw, tile_k, tile_n, max_occ,
          fuse_prelu, prelu_alpha, vec);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
static int launch_db(const void* x, const void* w, const void* idx,
                     const void* cnt, const void* scale, const void* bias,
                     void* y, int M, int K, int N, int kw, int ldw,
                     int tile_k, int tile_n, int max_occ, int fuse_prelu,
                     float prelu_alpha, int vec, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ternary_gemm_skip_db_kernel<BM, BN, WARPS_M, WARPS_N>
      <<<grid, WARPS_M * WARPS_N * 32, 0, stream>>>(
          static_cast<const bf16*>(x), static_cast<const uint32_t*>(w),
          static_cast<const int*>(idx), static_cast<const int*>(cnt),
          static_cast<const float*>(scale), static_cast<const float*>(bias),
          static_cast<bf16*>(y), M, K, N, kw, ldw, tile_k, tile_n, max_occ,
          fuse_prelu, prelu_alpha, vec);
  return (int)cudaGetLastError();
}

// B2's tiles: decode (bm 16) 8 stages, prefill (bm 64) 4 stages, one warp
// row; up to 4 warps across bn, each 16 or (bn 128) 32 columns wide.
template <int BM, int STAGES>
static int launch_ring_bn(int bn, const void* x, const void* w,
                          const void* idx, const void* cnt, const void* scale,
                          const void* bias, void* y, int M, int K, int N,
                          int kw, int ldw, int tile_k, int tile_n,
                          int max_occ, int fuse_prelu, float prelu_alpha,
                          int vec, cudaStream_t s) {
#define SKIP_LAUNCH(BN_, WN_)                                              \
  return launch_ring<BM, BN_, 1, WN_, STAGES>(                             \
      x, w, idx, cnt, scale, bias, y, M, K, N, kw, ldw, tile_k, tile_n,    \
      max_occ, fuse_prelu, prelu_alpha, vec, s)
  switch (bn) {
    case 16: SKIP_LAUNCH(16, 1);
    case 32: SKIP_LAUNCH(32, 2);
    case 64: SKIP_LAUNCH(64, 4);
    case 128: SKIP_LAUNCH(128, 4);
  }
#undef SKIP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// B3's tiles.
template <int BM, int WARPS_M>
static int launch_db_bn(int bn, const void* x, const void* w, const void* idx,
                        const void* cnt, const void* scale, const void* bias,
                        void* y, int M, int K, int N, int kw, int ldw,
                        int tile_k, int tile_n, int max_occ, int fuse_prelu,
                        float prelu_alpha, int vec, cudaStream_t s) {
#define SKIP_LAUNCH(BN_, WN_)                                                 \
  return launch_db<BM, BN_, WARPS_M, WN_>(x, w, idx, cnt, scale, bias, y, M, \
                                          K, N, kw, ldw, tile_k, tile_n,     \
                                          max_occ, fuse_prelu, prelu_alpha,  \
                                          vec, s)
  switch (bn) {
    case 16: SKIP_LAUNCH(16, 1);
    case 32: SKIP_LAUNCH(32, 2);
    case 64: SKIP_LAUNCH(64, 4);
    case 128: SKIP_LAUNCH(128, 4);
  }
#undef SKIP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// x (M, K) bf16; w (kw, ldw) words, ldw a multiple of tile_n; kt_indices
// (ldw / tile_n, max_occ) and kt_counts (ldw / tile_n,) int32; y (M, N)
// bf16. tile_k and tile_n are multiples of 16; bn (16, 32, 64 or 128)
// divides tile_n; bm is 16 (4 warps at most) or 64 (8 warps at most);
// db selects the cp.async two-stage variant. Returns the cudaError_t of
// the launch (0 = success).
extern "C" int ternary_gemm_skip_bf16(const void* x, const void* w,
                                      const void* kt_indices,
                                      const void* kt_counts,
                                      const void* scale, const void* bias,
                                      void* y, int M, int K, int N, int kw,
                                      int ldw, int tile_k, int tile_n,
                                      int max_occ, int fuse_prelu,
                                      float prelu_alpha, int bm, int bn,
                                      int db, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_k <= 0 || tile_k % 16 || tile_n <= 0 || tile_n % bn)
    return (int)cudaErrorInvalidValue;
  const int vec = (K % 8 == 0) && (ldw % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(w) % 16 == 0);
#define SKIP_ARGS                                                          \
  bn, x, w, kt_indices, kt_counts, scale, bias, y, M, K, N, kw, ldw,       \
      tile_k, tile_n, max_occ, fuse_prelu, prelu_alpha, vec, s
  if (bm == 16)
    return db ? launch_db_bn<16, 1>(SKIP_ARGS)
              : launch_ring_bn<16, 8>(SKIP_ARGS);
  if (bm == 64)
    return db ? launch_db_bn<64, 2>(SKIP_ARGS)
              : launch_ring_bn<64, 4>(SKIP_ARGS);
#undef SKIP_ARGS
  return (int)cudaErrorInvalidValue;
}
