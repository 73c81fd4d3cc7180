// Shared tile helpers of the hand-written ternary kernels (ternary_gemm.cu,
// ternary_gemm_skip.cu, ternary_gemm_bitplane.cu, fused_mlp.cu):
// zero-filled activation tiles, the 2-bit code decode into a bf16
// shared-memory tile that WMMA reads, and cp.async wrappers.
//
// Packed weights are (kw, n) 32-bit words with row stride ldw >= n (a
// tile-padded pack has ldw > n); bits [2r, 2r+2) of
// word[q][c] hold the code of W[16q + r][c], with code 0 -> 0, 1 -> +1,
// 2 -> -1 (decode(c) = (c & 1) - ((c >> 1) & 1)), as in
// repro_torch/core/formats.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace ternary {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;          // K depth of one main-loop step
constexpr int BKW = BK / 16;    // packed word rows per step
constexpr int APAD = 8;         // bf16 row padding: 16 bytes, keeps WMMA
                                // pointers 32-byte aligned, spreads banks
constexpr int CPAD = 4;         // f32 row padding of the accumulator stage

// (ROWS x BK) tile of a row-major bf16 matrix (rows x cols, leading dim ld)
// at (r0, k0) into smem with row stride BK + APAD. Elements outside the
// matrix read as zero, which is how the ragged M and K edges are masked:
// a zero activation times any decoded weight adds nothing.
template <int ROWS>
__device__ __forceinline__ void load_act_tile(bf16* dst, const bf16* src,
                                              int r0, int k0, int rows,
                                              int cols, int ld) {
  for (int i = threadIdx.x; i < ROWS * BK; i += blockDim.x) {
    const int r = i / BK, c = i % BK;
    const int gr = r0 + r, gc = k0 + c;
    bf16 v = __float2bfloat16(0.0f);
    if (gr < rows && gc < cols) v = src[(size_t)gr * ld + gc];
    dst[r * (BK + APAD) + c] = v;
  }
}

// Decode word rows [w0, w0 + BKW) and columns [n0, n0 + BN) of the packed
// (kw, n) matrix (row stride ldw) into a (BK x BN) bf16 smem tile of
// +1/0/-1 (row stride BN + APAD). Words outside rows [0, kw) or columns
// [0, n) decode to zero (ragged edges, the end of a skip tile).
template <int BN>
__device__ __forceinline__ void decode_weight_tile(bf16* dst,
                                                   const uint32_t* words,
                                                   int w0, int n0, int kw,
                                                   int n, int ldw) {
  for (int i = threadIdx.x; i < BKW * BN; i += blockDim.x) {
    const int r = i / BN, c = i % BN;
    const int gr = w0 + r, gc = n0 + c;
    const uint32_t wd = (gr < kw && gc < n) ? words[(size_t)gr * ldw + gc] : 0u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t code = (wd >> (2 * j)) & 3u;
      const int v = (int)(code & 1u) - (int)((code >> 1) & 1u);
      dst[(r * 16 + j) * (BN + APAD) + c] = __float2bfloat16((float)v);
    }
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                   float>;

// A (BM x BN) output tile computed by WARPS_M x WARPS_N warps, each owning
// FM x FN fragments of 16 x 16; the smem sizes (in elements) of one
// activation stage, one decoded weight stage and the f32 output stage.
template <int BM, int BN, int WARPS_M, int WARPS_N>
struct TileShape {
  static constexpr int FM = BM / (16 * WARPS_M);
  static constexpr int FN = BN / (16 * WARPS_N);
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int XS = BM * (BK + APAD);   // bf16
  static constexpr int WS = BK * (BN + APAD);   // bf16
  static constexpr int CS = BM * (BN + CPAD);   // f32
  static_assert(FM * 16 * WARPS_M == BM && FN * 16 * WARPS_N == BN,
                "tile does not split into 16 x 16 fragments per warp");
};

template <int FM, int FN>
__device__ __forceinline__ void zero_acc(Acc (&acc)[FM][FN]) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
}

// acc += xs[:, 0:kend] @ ws[0:kend, :] over this warp's fragments, one
// 16-deep MMA per K chunk in ascending order (kend a multiple of 16, at
// most BK). Every kernel that must agree bit for bit with another runs its
// K chunks through this one function.
template <int BN, int FM, int FN>
__device__ __forceinline__ void mma_tile(Acc (&acc)[FM][FN], const bf16* xs,
                                         const bf16* ws, int wm, int wn,
                                         int kend) {
  using namespace nvcuda;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    if (kk >= kend) break;
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
}

// Write the (BM x BN) tile at (m0, n0) of the row-major (M, N) bf16 output
// through the f32 smem stage cs: y = acc * scale + bias, then PReLU, in
// f32 with one cast (the 2-bit kernels, as repro's Pallas epilogue); with
// BF16_TAIL the cast follows the scale and bias and PReLU run on bf16
// values (the bitplane lowering, which adds them after its kernel). The
// caller has finished reading the smem that cs overlays.
template <int BM, int BN, int FM, int FN, bool BF16_TAIL>
__device__ __forceinline__ void store_epilogue(
    Acc (&acc)[FM][FN], float* cs, int wm, int wn, int m0, int n0, int M,
    int N, const float* __restrict__ scale, const float* __restrict__ bias,
    int fuse_prelu, float prelu_alpha, bf16* __restrict__ y) {
  using namespace nvcuda;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(
          cs + (wm * FM * 16 + i * 16) * (BN + CPAD) + wn * FN * 16 + j * 16,
          acc[i][j], BN + CPAD, wmma::mem_row_major);
  __syncthreads();
  const float alpha = BF16_TAIL ? round_bf16(prelu_alpha) : prelu_alpha;
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int r = i / BN, c = i % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) {
      float v = cs[r * (BN + CPAD) + c];
      if (scale != nullptr) v *= scale[gc];
      if (BF16_TAIL) {
        v = round_bf16(v);
        if (bias != nullptr) v = round_bf16(v + round_bf16(bias[gc]));
        if (fuse_prelu && !(v >= 0.0f)) v = round_bf16(alpha * v);
      } else {
        if (bias != nullptr) v += bias[gc];
        if (fuse_prelu && !(v >= 0.0f)) v *= alpha;
      }
      y[(size_t)gr * N + gc] = __float2bfloat16(v);
    }
  }
}

// 16-byte global -> shared copy that bypasses the registers (cp.async.cg).
// src_bytes < 16 zero-fills the rest; 0 copies nothing and only zeroes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace ternary
