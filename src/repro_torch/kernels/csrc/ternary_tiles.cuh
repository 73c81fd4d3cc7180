// Shared tile helpers of the hand-written ternary kernels (ternary_gemm.cu,
// ternary_gemm_skip.cu, ternary_gemm_bitplane.cu, fused_mlp.cu): cp.async
// wrappers and the register-decode loop (B1, B2, B4; B3 with its own
// staging; B7 with its own table).
//
// Packed weights are (kw, n) 32-bit words with row stride ldw >= n (a
// tile-padded pack has ldw > n); bits [2r, 2r+2) of
// word[q][c] hold the code of W[16q + r][c], with code 0 -> 0, 1 -> +1,
// 2 -> -1 (decode(c) = (c & 1) - ((c >> 1) & 1)), as in
// repro_torch/core/formats.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ternary {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;          // K depth of one main-loop step
constexpr int BKW = BK / 16;    // packed word rows per step
constexpr int APAD = 8;         // bf16 row padding: 16 bytes, spreads
                                // the ldmatrix rows over the banks

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
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

// ---------------------------------------------------------------------------
// The register-decode main loop of ternary_gemm.cu (B1),
// ternary_gemm_skip.cu (B2) and fused_mlp.cu (B4).
//
// mma.sync m16n8k16 (row.col, bf16 in, f32 accumulate) takes its B operand
// as two 32-bit registers per lane: lane (g = lane / 4, t = lane % 4)
// holds rows {2t, 2t+1} and {2t+8, 2t+9} of column g of the 16 x 8 tile,
// the lower row in the lower half. For a 16-deep K chunk of column c those
// rows are exactly one packed word, word[q][c], and the lane's rows are its
// nibbles t and t + 4 (bits [4t, 4t+4) and [16+4t, 20+4t)). So a B
// fragment is one 32-bit word load and two lookups in a 16-entry nibble ->
// bf16x2 table: no decoded tile in shared memory, and each decoded
// fragment feeds every 16-row A fragment of the warp. Each output element
// still starts from a zero f32 accumulator and adds its 16-deep chunks in
// ascending K through one HMMA.16816 each, so every kernel on this decode
// (B1, B2, B3, B4's products) agrees with the others bit for bit.
//
// Activations and raw words reach shared memory through a ring of cp.async
// stages, one BK-deep step per stage (ring_stage_x / ring_stage_words; B3
// copies the same steps with the TMA); A fragments come out with
// ldmatrix.x4.

constexpr int XLD = BK + APAD;  // row stride (bf16) of a staged x tile

__device__ __forceinline__ uint32_t code_bf16(uint32_t c) {
  return c == 1u ? 0x3F80u : (c == 2u ? 0xBF80u : 0u);   // +1, -1, else 0
}

// The 16-entry nibble table: entry v is the bf16x2 pair (decode(v & 3),
// decode(v >> 2)), low half first. Threads [0, 16) of the block fill it;
// the caller's next __syncthreads publishes it.
__device__ __forceinline__ void fill_nibble_lut(uint32_t* lut) {
  if (threadIdx.x < 16)
    lut[threadIdx.x] = code_bf16(threadIdx.x & 3u) |
                       (code_bf16(threadIdx.x >> 2) << 16);
}

// B fragment (b0, b1) of lane quad position t from the packed word of its
// column.
__device__ __forceinline__ void decode_b_frag(uint32_t (&b)[2], uint32_t wd,
                                              int t, const uint32_t* lut) {
  const uint32_t y = wd >> (4 * t);
  b[0] = lut[y & 15u];
  b[1] = lut[(y >> 16) & 15u];
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage x rows [r0, r0 + ROWS) and columns [k0, k0 + BK) of the row-major
// bf16 matrix x (M rows, row stride ldx) into dst (row stride XLD), zero
// past row M and column kend (<= ldx; a tile-skipping step stops at its
// tile's end). vec: 16-byte cp.async copies (ldx and kend multiples of 8,
// x 16-byte aligned); otherwise plain loads, visible after __syncthreads.
// Zeros past the edges are how the ragged M and K edges are masked: a zero
// activation times any decoded weight adds nothing.
template <int ROWS>
__device__ __forceinline__ void ring_stage_x(bf16* dst, const bf16* x, int r0,
                                             int k0, int M, int kend, int ldx,
                                             bool vec) {
  if (!vec) {
    for (int i = threadIdx.x; i < ROWS * BK; i += blockDim.x) {
      const int r = i / BK, c = i % BK;
      const int gr = r0 + r, gc = k0 + c;
      bf16 v = __float2bfloat16(0.0f);
      if (gr < M && gc < kend) v = x[(size_t)gr * ldx + gc];
      dst[r * XLD + c] = v;
    }
    return;
  }
  constexpr int G = BK / 8;      // 16-byte groups per row
  for (int i = threadIdx.x; i < ROWS * G; i += blockDim.x) {
    const int r = i / G, c = (i % G) * 8;
    const int gr = r0 + r, gc = k0 + c;
    const bool ok = gr < M && gc < kend;
    cp_async16(dst + r * XLD + c, ok ? x + (size_t)gr * ldx + gc : x,
               ok ? 16 : 0);
  }
}

// Stage word rows [q0, q0 + BKW) and columns [c0, c0 + COLS) of a (kw, ldw)
// word matrix into dst (row stride COLS), zero past row kw and column
// ncols (<= ldw). vec: 16-byte cp.async copies (ncols and ldw multiples
// of 4, w 16-byte aligned); otherwise plain loads.
template <int COLS>
__device__ __forceinline__ void ring_stage_words(uint32_t* dst,
                                                 const uint32_t* w, int q0,
                                                 int c0, int kw, int ldw,
                                                 int ncols, bool vec) {
  if (vec) {
    constexpr int G = COLS / 4;
    for (int i = threadIdx.x; i < BKW * G; i += blockDim.x) {
      const int r = i / G, c = (i % G) * 4;
      const bool ok = q0 + r < kw && c0 + c < ncols;
      cp_async16(dst + r * COLS + c,
                 ok ? w + (size_t)(q0 + r) * ldw + c0 + c : w, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BKW * COLS; i += blockDim.x) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = q0 + r < kw && c0 + c < ncols;
      dst[i] = ok ? w[(size_t)(q0 + r) * ldw + c0 + c] : 0u;
    }
  }
}

// acc[u] += a[:, 0:16*kchunks] @ decode(word tile u) for NT word tiles
// sharing one A operand, over this warp's FM x FN fragments of 16 x 8.
// a: this warp's first row at the step's first K column (row stride lda);
// wt: word tile 0 at this warp's first column (row stride WLD), tile u at
// wt + u * BKW * WLD. K chunks run in ascending order.
template <int FM, int FN, int WLD, int NT>
__device__ __forceinline__ void mma_step_2bit(float (&acc)[NT][FM][FN][4],
                                              const bf16* a, int lda,
                                              const uint32_t* wt, int kchunks,
                                              const uint32_t* lut) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* arow = a + (lane & 15) * lda + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < BKW; ++kk) {
    if (kk >= kchunks) break;
    uint32_t af[FM][4];
#pragma unroll
    for (int i = 0; i < FM; ++i) ldmatrix_x4(af[i], arow + i * 16 * lda + kk * 16);
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        uint32_t b[2];
        decode_b_frag(b, wt[u * BKW * WLD + kk * WLD + j * 8 + g], t, lut);
#pragma unroll
        for (int i = 0; i < FM; ++i) mma_16816(acc[u][i][j], af[i], b);
      }
  }
}

template <int NT, int FM, int FN>
__device__ __forceinline__ void zero_frags(float (&acc)[NT][FM][FN][4]) {
#pragma unroll
  for (int u = 0; u < NT; ++u)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][i][j][e] = 0.0f;
}

// The f32 epilogue of the 2-bit kernels on one accumulator value of column
// c: scale, then bias, then PReLU, each rounded on its own (no fused
// multiply-add), as the plain version rounds.
__device__ __forceinline__ float epilogue_f32(float v, int c,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ bias,
                                             int fuse_prelu, float alpha) {
  if (scale != nullptr) v = __fmul_rn(v, scale[c]);
  if (bias != nullptr) v = __fadd_rn(v, bias[c]);
  if (fuse_prelu && !(v >= 0.0f)) v = __fmul_rn(v, alpha);
  return v;
}

// The bf16-tail epilogue of the bitplane kernel: scale in f32 and a cast,
// then bias and PReLU on bf16 values, each rounded on its own (as the
// bitplane lowering adds them after its kernel). Returns a value that is
// already bf16.
__device__ __forceinline__ float epilogue_bf16(float v, int c,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ bias,
                                              int fuse_prelu, float alpha) {
  if (scale != nullptr) v = __fmul_rn(v, scale[c]);
  v = round_bf16(v);
  if (bias != nullptr) v = round_bf16(__fadd_rn(v, round_bf16(bias[c])));
  if (fuse_prelu && !(v >= 0.0f))
    v = round_bf16(__fmul_rn(round_bf16(alpha), v));
  return v;
}

// Write this warp's FM x FN fragments, whose first element is (r0, c0) of
// the row-major (M, N) bf16 output, straight from the accumulators:
// epilogue_f32 (or, BF16_TAIL, epilogue_bf16) and one cast per element,
// bf16x2 stores where two columns fit (N even), masked at the M and N
// edges.
template <int FM, int FN, bool BF16_TAIL = false>
__device__ __forceinline__ void store_frags_epilogue(
    const float (&acc)[FM][FN][4], int r0, int c0, int M, int N,
    const float* __restrict__ scale, const float* __restrict__ bias,
    int fuse_prelu, float alpha, bf16* __restrict__ y) {
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
        const float v0 = BF16_TAIL
            ? epilogue_bf16(acc[i][j][2 * h], gc, scale, bias, fuse_prelu, alpha)
            : epilogue_f32(acc[i][j][2 * h], gc, scale, bias, fuse_prelu, alpha);
        bf16* out = y + (size_t)gr * N + gc;
        if (gc + 1 < N) {
          const float v1 = BF16_TAIL
              ? epilogue_bf16(acc[i][j][2 * h + 1], gc + 1, scale, bias,
                              fuse_prelu, alpha)
              : epilogue_f32(acc[i][j][2 * h + 1], gc + 1, scale, bias,
                             fuse_prelu, alpha);
          if ((N & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(out) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            out[0] = __float2bfloat16(v0);
            out[1] = __float2bfloat16(v1);
          }
        } else {
          out[0] = __float2bfloat16(v0);
        }
      }
}

}  // namespace ternary
