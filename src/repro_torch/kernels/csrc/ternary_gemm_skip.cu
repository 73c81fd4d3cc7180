// Tile-skipping packed 2-bit ternary GEMM for Hopper (sm_90a), bf16 in and
// out: Y = X @ decode(W) * scale + bias (+ PReLU), f32 accumulation, where
// the K loop of each output tile visits only the K-tiles that hold a
// nonzero weight.
//
// Replaces two TPU kernels of repro/kernels/ternary_gemm.py:
//   skip    (DB = false): ternary_gemm_skip_pallas    (_skip_kernel; the
//                         pallas_call at line 325);
//   skip_db (DB = true):  ternary_gemm_skip_db_pallas (_skip_db_kernel; the
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
// Design: one block per (BM rows x BN columns) of one N-tile (BN divides
// tile_n, so several blocks share an N-tile's list). The block reads its
// N-tile's count and walks the list; each occupied tile is processed in
// BK = 64 deep steps (the last one shorter when tile_k is not a multiple
// of 64), each step staging the x slice and the word rows, decoding the
// words to a bf16 +1/0/-1 tile in shared memory and running the same
// 16-deep WMMA chunks (ternary::mma_tile) and the same epilogue
// (ternary::store_epilogue) as ternary_gemm.cu. Every output element
// therefore sees the same K chunks in the same ascending order as the
// dense kernel, minus chunks whose products are all exact zeros, and the
// two agree bit for bit.
//
// DB adds a two-stage pipeline: the x slice and raw words of step s + 1
// are copied into the other stage with cp.async before step s is decoded
// and multiplied. Staging by 64-deep steps, not whole tiles, keeps shared
// memory at ~40 KB whatever tile_k is (a whole 512-deep x tile would be
// 64 KB per stage at BM 64). The 16-byte copies need x rows 16-byte
// aligned (K % 8 == 0); otherwise the same stages are filled with plain
// loads. wgmma, TMA and deeper pipelines are later work.
#include "ternary_tiles.cuh"

using ternary::APAD;
using ternary::BK;
using ternary::BKW;
using ternary::bf16;

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

template <int BM, int BN, int WARPS_M, int WARPS_N, bool DB>
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
  using T = ternary::TileShape<BM, BN, WARPS_M, WARPS_N>;
  constexpr int STAGES = DB ? 2 : 1;
  constexpr int WR = DB ? BKW * BN : 0;              // raw words per stage
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

  // step s -> (first K row, one past its last row, one past its last word
  // row), all clipped to the end of its tile
  auto step_k = [&](int s, int& kbase, int& kend, int& wend) {
    const int k0 = idx[s / chunks] * tile_k;
    kbase = k0 + (s % chunks) * BK;
    kend = min(K, k0 + tile_k);
    wend = min(kw, (k0 + tile_k) / 16);
  };

  ternary::Acc acc[T::FM][T::FN];
  ternary::zero_acc(acc);
  if (DB) {
    if (steps > 0) {
      int kbase, kend, wend;
      step_k(0, kbase, kend, wend);
      stage_async<BM, BN>(xs, wr, x, w, m0, n0, kbase, kend, wend, M, K, ldw,
                          vec);
    }
    for (int s = 0; s < steps; ++s) {
      const int cur = s & 1;
      if (s + 1 < steps) {            // next step's copies go out first
        int kbase, kend, wend;
        step_k(s + 1, kbase, kend, wend);
        stage_async<BM, BN>(xs + (cur ^ 1) * T::XS, wr + (cur ^ 1) * WR, x, w,
                            m0, n0, kbase, kend, wend, M, K, ldw, vec);
        ternary::cp_async_wait<1>();
      } else {
        ternary::cp_async_wait<0>();
      }
      __syncthreads();
      int kbase, kend, wend;
      step_k(s, kbase, kend, wend);
      const int rows = min(BKW, wend - kbase / 16);   // word rows of the step
      ternary::decode_weight_tile<BN>(ws, wr + cur * WR, 0, 0, rows, BN, BN);
      __syncthreads();
      ternary::mma_tile<BN>(acc, xs + cur * T::XS, ws, wm, wn,
                            min(BK, kend - kbase + 15) / 16 * 16);
      __syncthreads();                // the stage is refilled at s + 2
    }
  } else {
    for (int s = 0; s < steps; ++s) {
      int kbase, kend, wend;
      step_k(s, kbase, kend, wend);
      ternary::load_act_tile<BM>(xs, x, m0, kbase, M, kend, K);
      ternary::decode_weight_tile<BN>(ws, w, kbase / 16, n0, wend, N, ldw);
      __syncthreads();
      ternary::mma_tile<BN>(acc, xs, ws, wm, wn,
                            min(BK, kend - kbase + 15) / 16 * 16);
      __syncthreads();
    }
  }
  ternary::store_epilogue<BM, BN, T::FM, T::FN, false>(
      acc, cs, wm, wn, m0, n0, M, N, scale, bias, fuse_prelu, prelu_alpha, y);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool DB>
static int launch(const void* x, const void* w, const void* idx,
                  const void* cnt, const void* scale, const void* bias,
                  void* y, int M, int K, int N, int kw, int ldw, int tile_k,
                  int tile_n, int max_occ, int fuse_prelu, float prelu_alpha,
                  int vec, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ternary_gemm_skip_kernel<BM, BN, WARPS_M, WARPS_N, DB>
      <<<grid, WARPS_M * WARPS_N * 32, 0, stream>>>(
          static_cast<const bf16*>(x), static_cast<const uint32_t*>(w),
          static_cast<const int*>(idx), static_cast<const int*>(cnt),
          static_cast<const float*>(scale), static_cast<const float*>(bias),
          static_cast<bf16*>(y), M, K, N, kw, ldw, tile_k, tile_n, max_occ,
          fuse_prelu, prelu_alpha, vec);
  return (int)cudaGetLastError();
}

template <int BM, int WARPS_M, bool DB>
static int launch_bn(int bn, const void* x, const void* w, const void* idx,
                     const void* cnt, const void* scale, const void* bias,
                     void* y, int M, int K, int N, int kw, int ldw,
                     int tile_k, int tile_n, int max_occ, int fuse_prelu,
                     float prelu_alpha, int vec, cudaStream_t s) {
#define SKIP_LAUNCH(BN_, WN_)                                                 \
  return launch<BM, BN_, WARPS_M, WN_, DB>(x, w, idx, cnt, scale, bias, y, M, \
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
    return db ? launch_bn<16, 1, true>(SKIP_ARGS)
              : launch_bn<16, 1, false>(SKIP_ARGS);
  if (bm == 64)
    return db ? launch_bn<64, 2, true>(SKIP_ARGS)
              : launch_bn<64, 2, false>(SKIP_ARGS);
#undef SKIP_ARGS
  return (int)cudaErrorInvalidValue;
}
