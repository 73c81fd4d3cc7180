// Shared tile helpers of the two hand-written ternary kernels
// (ternary_gemm.cu, fused_mlp.cu): zero-filled activation tiles and the
// 2-bit code decode into a bf16 shared-memory tile that WMMA reads.
//
// Packed weights are (kw, n) row-major 32-bit words; bits [2r, 2r+2) of
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
// (kw, n) matrix into a (BK x BN) bf16 smem tile of +1/0/-1 (row stride
// BN + APAD). Words outside the matrix decode to zero (ragged N edge).
template <int BN>
__device__ __forceinline__ void decode_weight_tile(bf16* dst,
                                                   const uint32_t* words,
                                                   int w0, int n0, int kw,
                                                   int n) {
  for (int i = threadIdx.x; i < BKW * BN; i += blockDim.x) {
    const int r = i / BN, c = i % BN;
    const int gr = w0 + r, gc = n0 + c;
    const uint32_t wd = (gr < kw && gc < n) ? words[(size_t)gr * n + gc] : 0u;
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

}  // namespace ternary
