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
// with the occupied fraction of the tiles. Neither kernel reaches either
// bound: both issue mma.sync with a table lookup per B fragment, and the
// time follows the occupied steps a block walks (PERF.md).
//
// Both: one block per (BM rows x BN columns) of one N-tile (BN divides
// tile_n, so several blocks share an N-tile's list). The block reads its
// N-tile's count and walks the list; each occupied tile is processed in
// BK = 64 deep steps (the last one shorter when tile_k is not a multiple
// of 64), step s of the walk being step s % chunks of the list's tile
// s / chunks. Every output element therefore sees the same 16-deep K
// chunks in the same ascending order as the dense kernel (ternary_gemm.cu,
// B1), through the same HMMA.16816, minus chunks whose products are all
// exact zeros, and the three agree bit for bit. Both run B1's register
// decode: each lane turns the word of its column into its mma.sync B
// fragment with the nibble table, and the epilogue runs from the
// accumulators. Rows per block (the tuner's block_m): 16 with 8 stages,
// 32 with 6, 64 with 4; one warp row of up to 4 warps across bn 16, 32,
// 64 or 128 (the wrapper takes at most 64 at 16 rows, as B1's 16-row
// decode tile). They differ in how a stage is filled.
//
// B2 (ternary_gemm_skip_kernel): every thread fills the ring with 16-byte
// cp.async copies, the x slice with a padded row stride (XLD), and one
// __syncthreads a step publishes a stage and frees the previous one. A
// step at a tile's end stages zeros past it (x past kend, words past
// wend) and runs its four chunks, the extra ones adding exact zeros.
//
// B3 (ternary_gemm_skip_tma_kernel), the Pallas kernel's two DMAs a step
// with their semaphores: a producer warp, beside the consumer warps, has
// the Tensor Memory Accelerator copy each step's two boxes, (BM x 64) bf16
// of x and (4 x BN) words, into a ring of stages; each stage has a "full"
// mbarrier armed with the step's bytes (expect_tx) that the copies
// complete, and an "empty" one on which each consumer warp arrives once it
// has run the step. No thread of the block waits on another except
// through those barriers: there is no __syncthreads in the loop. The x box
// lands with 128-byte rows under the 128-byte swizzle (16-byte chunk c of
// row r at chunk c ^ (r % 8)), and ldmatrix reads it through the same XOR,
// so its eight rows fall in distinct banks. The copies zero-fill rows past
// M and columns past K; a step that crosses its tile's end still lands the
// next tile's words and x columns, so the consumers zero the word rows
// past the tile's end in registers before the decode (the x columns there
// meet zero weights and add exact zeros, as in B2). Generic stores never
// precede the async proxy's writes to the same stage, so no proxy fence
// is needed. A barrier wait over two minutes traps (mbar_wait).
//
// The copies need x rows 16-byte aligned (K % 8 == 0), ldw % 4 == 0 and
// 16-byte aligned bases; otherwise B2's threads, and B3's producer warp,
// fill the same stages with plain loads (B3's still completing on the
// stage's "full" barrier, one arrival a lane).
#include <cuda.h>
#include <string.h>

#include "ternary_tiles.cuh"
#include "tma.cuh"

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

// ---------------------------------------------------------------------------
// B3: the TMA ring.

// B3's shared memory, from a 1024-byte aligned base (the swizzle's
// period): STAGES x boxes (BM x 128 bytes), STAGES word boxes (BKW x BN),
// the nibble table, then the full and empty barriers.
template <int BM, int BN, int STAGES>
struct TmaSmem {
  static constexpr int X = BM * BK * 2;       // bytes a stage
  static constexpr int W = BKW * BN * 4;
  static constexpr int W_OFF = STAGES * X;
  static constexpr int LUT_OFF = W_OFF + STAGES * W;
  static constexpr int BAR_OFF = LUT_OFF + 64;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
  static_assert(X % 1024 == 0 && W % 128 == 0, "box alignment");
};

// acc += x box (swizzled) @ decode(word box) over this warp's FM x FN
// fragments of 16 x 8; word rows from `wvalid` on (past the step's tile)
// read as zero. K chunks run in ascending order, as mma_step_2bit's.
template <int FM, int FN, int WLD>
__device__ __forceinline__ void mma_step_swizzled(float (&acc)[FM][FN][4],
                                                  const unsigned char* xs,
                                                  const uint32_t* wt,
                                                  int wvalid,
                                                  const uint32_t* lut) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = lane & 15, half = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < BKW; ++kk) {
    uint32_t af[FM][4];
#pragma unroll
    for (int i = 0; i < FM; ++i)
      ternary::ldmatrix_x4(af[i], reinterpret_cast<const bf16*>(
          xs + tma::swizzle128(i * 16 + row, 2 * kk + half)));
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      uint32_t b[2];
      const uint32_t wd = kk < wvalid ? wt[kk * WLD + j * 8 + g] : 0u;
      ternary::decode_b_frag(b, wd, t, lut);
#pragma unroll
      for (int i = 0; i < FM; ++i) ternary::mma_16816(acc[i][j], af[i], b);
    }
  }
}

// One stage by plain loads (unaligned operands), by the producer warp's 32
// lanes, in the TMA layout: x rows swizzled, zero past row M and column
// kend; words zero past word row wend.
template <int BM, int BN>
__device__ __forceinline__ void stage_plain(unsigned char* xs, uint32_t* ws,
                                            const bf16* x, const uint32_t* w,
                                            int m0, int n0, int kbase,
                                            int kend, int wend, int M, int K,
                                            int ldw, int lane) {
  for (int i = lane; i < BM * BK; i += 32) {
    const int r = i / BK, c = i % BK;
    const int gr = m0 + r, gc = kbase + c;
    bf16 v = __float2bfloat16(0.0f);
    if (gr < M && gc < kend) v = x[(size_t)gr * K + gc];
    *reinterpret_cast<bf16*>(xs + tma::swizzle128(r, c / 8) + (c % 8) * 2) = v;
  }
  for (int i = lane; i < BKW * BN; i += 32) {
    const int r = i / BN, c = i % BN;
    const int gr = kbase / 16 + r;
    ws[i] = gr < wend ? w[(size_t)gr * ldw + n0 + c] : 0u;
  }
}

// B3: WARPS_N consumer warps (one warp row, FN fragments of 16 x 8 each
// across BN) and one producer warp.
template <int BM, int BN, int WARPS_N, int STAGES>
__global__ void __launch_bounds__((WARPS_N + 1) * 32)
ternary_gemm_skip_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap wmap,
                             const bf16* __restrict__ x,
                             const uint32_t* __restrict__ w,
                             const int* __restrict__ kt_indices,
                             const int* __restrict__ kt_counts,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             bf16* __restrict__ y, int M, int K, int N,
                             int kw, int ldw, int tile_k, int tile_n,
                             int max_occ, int fuse_prelu, float prelu_alpha,
                             int use_tma) {
  constexpr int FM = BM / 16;
  constexpr int FN = BN / (8 * WARPS_N);
  static_assert(FM * 16 == BM && FN * 8 * WARPS_N == BN,
                "tile does not split into 16 x 8 fragments per warp");
  using S = TmaSmem<BM, BN, STAGES>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (tma::smem_addr(smem_raw) & 1023)) & 1023);
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem + S::LUT_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;
  auto xs = [&](int s) { return smem + s * S::X; };
  auto ws = [&](int s) {
    return reinterpret_cast<uint32_t*>(smem + S::W_OFF + s * S::W);
  };

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* idx = kt_indices + (size_t)(n0 / tile_n) * max_occ;
  const int chunks = (tile_k + BK - 1) / BK;    // BK steps per tile
  const int steps = kt_counts[n0 / tile_n] * chunks;

  // The producer issues the steps in order; (lt, lc) is the next step's
  // (list entry, chunk).
  int lt = 0, lc = 0;
  auto issue = [&](int step) {
    const int s = step % STAGES;
    const int k0 = idx[lt] * tile_k;
    const int kbase = k0 + lc * BK;
    if (++lc == chunks) lc = 0, ++lt;
    // a stage's r-th use waits for phase r of its barriers (parity r & 1);
    // a fresh barrier counts the phase of parity 1 as completed
    tma::mbar_wait(empty + s, ((step / STAGES) & 1) ^ 1);
    if (use_tma) {
      tma::mbar_arrive_expect_tx(full + s, S::X + S::W);
      tma::load_2d(xs(s), &xmap, kbase, m0, full + s);
      tma::load_2d(ws(s), &wmap, n0, kbase / 16, full + s);
    } else {
      stage_plain<BM, BN>(xs(s), ws(s), x, w, m0, n0, kbase,
                          min(K, k0 + tile_k), min(kw, (k0 + tile_k) / 16),
                          M, K, ldw, lane);
      tma::mbar_arrive(full + s);
    }
  };

  // The producer's lane 0 sets up the barriers and, with the TMA, has the
  // first ring's copies in flight before the block's one barrier.
  const bool producer = warp == WARPS_N;
  int step = 0;
  if (producer && lane == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tma::mbar_init(full + s, use_tma ? 1 : 32);
      tma::mbar_init(empty + s, WARPS_N);
    }
    tma::mbar_init_fence();
    if (use_tma)
      for (; step < min(STAGES, steps); ++step) issue(step);
  }
  ternary::fill_nibble_lut(lut);
  __syncthreads();      // the last block-wide barrier
  if (producer) {
    if (use_tma && lane != 0) return;
    for (; step < steps; ++step) issue(step);
    return;
  }

  float acc[1][FM][FN][4];
  ternary::zero_frags(acc);
  const bool whole = tile_k % BK == 0;   // no step crosses its tile's end
  for (step = 0; step < steps; ++step) {
    const int s = step % STAGES;
    // word rows of this step inside its tile (the box may run past it)
    int wvalid = BKW;
    if (!whole) {
      const int k0 = idx[lt] * tile_k;
      wvalid = min(kw, (k0 + tile_k) / 16) - (k0 + lc * BK) / 16;
      if (++lc == chunks) lc = 0, ++lt;
    }
    tma::mbar_wait(full + s, (step / STAGES) & 1);
    mma_step_swizzled<FM, FN, BN>(acc[0], xs(s), ws(s) + warp * FN * 8,
                                  wvalid, lut);
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(empty + s);
  }
  ternary::store_frags_epilogue<FM, FN>(acc[0], m0, n0 + warp * FN * 8, M, N,
                                        scale, bias, fuse_prelu, prelu_alpha,
                                        y);
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

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
static int launch_tma(const void* x, const void* w, const void* idx,
                      const void* cnt, const void* scale, const void* bias,
                      void* y, int M, int K, int N, int kw, int ldw,
                      int tile_k, int tile_n, int max_occ, int fuse_prelu,
                      float prelu_alpha, int vec, cudaStream_t stream) {
  static_assert(WARPS_M == 1, "B3 runs one warp row");
  using S = TmaSmem<BM, BN, STAGES>;
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  if (vec &&
      !(encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, K, 2, BM,
                  BK, CU_TENSOR_MAP_SWIZZLE_128B) &&
        encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT32, w, kw, ldw, ldw, 4,
                  BKW, BN, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  auto kernel = ternary_gemm_skip_tma_kernel<BM, BN, WARPS_N, STAGES>;
  if (S::ALLOC > 48 * 1024) {
    static bool raised = false;
    if (!raised) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::ALLOC);
      if (err != cudaSuccess) return (int)err;
      raised = true;
    }
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, (WARPS_N + 1) * 32, S::ALLOC, stream>>>(
      xmap, wmap, static_cast<const bf16*>(x),
      static_cast<const uint32_t*>(w), static_cast<const int*>(idx),
      static_cast<const int*>(cnt), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<bf16*>(y), M, K, N, kw,
      ldw, tile_k, tile_n, max_occ, fuse_prelu, prelu_alpha, vec);
  return (int)cudaGetLastError();
}

// The tiles of both: one warp row; up to 4 warps across bn, each 16 or
// (bn 128) 32 columns wide. DB selects B3.
template <int BM, int STAGES, bool DB>
static int launch_bn(int bn, const void* x, const void* w, const void* idx,
                     const void* cnt, const void* scale, const void* bias,
                     void* y, int M, int K, int N, int kw, int ldw,
                     int tile_k, int tile_n, int max_occ, int fuse_prelu,
                     float prelu_alpha, int vec, cudaStream_t s) {
#define SKIP_LAUNCH(BN_, WN_)                                                 \
  if constexpr (DB)                                                           \
    return launch_tma<BM, BN_, 1, WN_, STAGES>(                               \
        x, w, idx, cnt, scale, bias, y, M, K, N, kw, ldw, tile_k, tile_n,     \
        max_occ, fuse_prelu, prelu_alpha, vec, s);                            \
  else                                                                        \
    return launch_ring<BM, BN_, 1, WN_, STAGES>(                              \
        x, w, idx, cnt, scale, bias, y, M, K, N, kw, ldw, tile_k, tile_n,     \
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

// x (M, K) bf16; w (kw, ldw) words, ldw a multiple of tile_n; kt_indices
// (ldw / tile_n, max_occ) and kt_counts (ldw / tile_n,) int32; y (M, N)
// bf16. tile_k and tile_n are multiples of 16; bn (16, 32, 64 or 128)
// divides tile_n; bm is 16, 32 or 64; db selects B3 (the TMA ring) over B2
// (the cp.async ring). Returns the cudaError_t of the launch (0 =
// success).
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
    return db ? launch_bn<16, 8, true>(SKIP_ARGS)
              : launch_bn<16, 8, false>(SKIP_ARGS);
  if (bm == 32)
    return db ? launch_bn<32, 6, true>(SKIP_ARGS)
              : launch_bn<32, 6, false>(SKIP_ARGS);
  if (bm == 64)
    return db ? launch_bn<64, 4, true>(SKIP_ARGS)
              : launch_bn<64, 4, false>(SKIP_ARGS);
#undef SKIP_ARGS
  return (int)cudaErrorInvalidValue;
}
