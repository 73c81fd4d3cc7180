// Fused packed-ternary MLP block for Hopper (sm_90a), bf16 in and out:
//   h = act(x @ Wg * sg + bg) * (x @ Wi * si + bi)     (gate optional)
//   y = h @ Wo * so + bo
//
// Replaces the TPU kernel repro/kernels/fused_mlp.py::fused_mlp_pallas
// (its _fused_body; the pallas_call at line 297).
//
// What bounds it on the H100: at decode (M = 8) the block streams three
// 2-bit weight matrices (3 x 1024 x 4096 x 2 bits = 3 MiB) and is
// byte-bound; at prefill (M = 1024+) it is operation-bound,
// 2*M*ff*(2K + N) bf16 tensor-core work. The (M, ff) hidden activation is
// the traffic the fusion exists to remove, so h never goes to device
// memory: each block keeps its (BM x FC) slice of h in dynamic shared
// memory.
//
// Design: a (bm, 4096) bf16 h tile does not fit one block's shared memory
// (128 KiB already at bm = 16, and one block per row tile would leave
// decode, M = 8, on a single SM). So ff is split over blocks: block
// (c, r) computes the hidden slice h[rows r, ff chunk c] (up and gate
// projections, rounded to bf16 exactly where the plain chain rounds: yi and
// yg after their epilogues, act(yg), then the product) into shared memory,
// and multiplies it by the chunk's rows of Wo into an f32 partial
// down-projection in device memory. A second, fixed-order pass sums the
// chunks' partials and applies the down epilogue (so, bo, cast) — the sum
// order never depends on scheduling. Partials are (chunks, M, N) f32:
// 1 MiB at decode, 16 MiB at the prefill shape. The MMAs are WMMA
// 16x16x16 bf16 with f32 accumulators over weight tiles decoded into
// shared memory, as in ternary_gemm.cu. The h slice plus the staging tiles
// exceed the 48 KB static limit at the prefill tile, so the launch raises
// the kernel's dynamic shared memory limit with cudaFuncSetAttribute.
#include "ternary_tiles.cuh"

using namespace nvcuda;
using ternary::APAD;
using ternary::BK;
using ternary::BKW;
using ternary::CPAD;
using ternary::bf16;

constexpr int BN = 128;       // ff strip (stage 1) and N strip (stage 2)
constexpr int WARPS_N = 4;    // each warp owns a 16 x 32 slice of a strip
constexpr int FN = BN / (16 * WARPS_N);

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 0) return v / (1.0f + expf(-v));   // silu
  if (act == 1) return v > 0.0f ? v : 0.0f;     // relu
  return v;                                     // none
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Dynamic shared memory bytes for one block: the h slice, then a staging
// region shared by the main-loop tiles and the accumulator stages.
__host__ __device__ constexpr int h_bytes(int bm, int fc) {
  return round_up(bm * (fc + APAD) * 2, 128);
}
__host__ __device__ constexpr int stage_bytes(int bm) {
  return (bm * (BK + APAD) + 2 * BK * (BN + APAD)) * 2 >
                 2 * bm * (BN + CPAD) * 4
             ? (bm * (BK + APAD) + 2 * BK * (BN + APAD)) * 2
             : 2 * bm * (BN + CPAD) * 4;
}

template <int BM>
__global__ void __launch_bounds__((BM / 16) * WARPS_N * 32)
fused_mlp_kernel(const bf16* __restrict__ x, const uint32_t* __restrict__ wi,
                 const uint32_t* __restrict__ wg,
                 const uint32_t* __restrict__ wo,
                 const float* __restrict__ si, const float* __restrict__ bi,
                 const float* __restrict__ sg, const float* __restrict__ bg,
                 float* __restrict__ partial, int M, int K, int FF, int N,
                 int kw1, int kw2, int FC, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int XS = BM * (BK + APAD);
  constexpr int WS = BK * (BN + APAD);
  constexpr int CS = BM * (BN + CPAD);
  const int HLD = FC + APAD;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  unsigned char* stage = smem + h_bytes(BM, FC);
  bf16* xs = reinterpret_cast<bf16*>(stage);
  bf16* wsa = xs + XS;              // Wi tile (stage 1), Wo tile (stage 2)
  bf16* wsb = wsa + WS;             // Wg tile (stage 1)
  float* csa = reinterpret_cast<float*>(stage);   // reused after K loops
  float* csb = csa + CS;

  const int m0 = blockIdx.y * BM;
  const int chunk = blockIdx.x;
  const int f0 = chunk * FC;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const bool gated = wg != nullptr;
  const int nk1 = (K + BK - 1) / BK;

  // ---- stage 1: h[:, f0:f0+FC] = act(x@Wg) * (x@Wi), kept in smem ----
  for (int s = 0; s < FC; s += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_i[FN], acc_g[FN];
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::fill_fragment(acc_i[j], 0.0f);
      wmma::fill_fragment(acc_g[j], 0.0f);
    }
    for (int t = 0; t < nk1; ++t) {
      ternary::load_act_tile<BM>(xs, x, m0, t * BK, M, K, K);
      ternary::decode_weight_tile<BN>(wsa, wi, t * BKW, f0 + s, kw1, FF, FF);
      if (gated) ternary::decode_weight_tile<BN>(wsb, wg, t * BKW, f0 + s, kw1, FF, FF);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + (wm * 16) * (BK + APAD) + kk, BK + APAD);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          const int col = wn * FN * 16 + j * 16;
          wmma::load_matrix_sync(b, wsa + kk * (BN + APAD) + col, BN + APAD);
          wmma::mma_sync(acc_i[j], a, b, acc_i[j]);
          if (gated) {
            wmma::load_matrix_sync(b, wsb + kk * (BN + APAD) + col, BN + APAD);
            wmma::mma_sync(acc_g[j], a, b, acc_g[j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int off = (wm * 16) * (BN + CPAD) + wn * FN * 16 + j * 16;
      wmma::store_matrix_sync(csa + off, acc_i[j], BN + CPAD, wmma::mem_row_major);
      if (gated)
        wmma::store_matrix_sync(csb + off, acc_g[j], BN + CPAD, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
      const int r = i / BN, c = i % BN;
      const int gf = f0 + s + c;
      float h = 0.0f;                      // columns past ff stay zero
      if (gf < FF) {
        float yi = csa[r * (BN + CPAD) + c];
        if (si != nullptr) yi *= si[gf];
        if (bi != nullptr) yi += bi[gf];
        yi = ternary::round_bf16(yi);
        if (gated) {
          float yg = csb[r * (BN + CPAD) + c];
          if (sg != nullptr) yg *= sg[gf];
          if (bg != nullptr) yg += bg[gf];
          yg = ternary::round_bf16(yg);
          h = ternary::round_bf16(activate(yg, act)) * yi;
        } else {
          h = activate(yi, act);
        }
      }
      hs[r * HLD + s + c] = __float2bfloat16(h);
    }
    __syncthreads();
  }

  // ---- stage 2: partial[chunk] = h[:, chunk] @ Wo[chunk rows, :] ----
  const int nk2 = FC / BK;
  for (int n0 = 0; n0 < N; n0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FN];
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int t = 0; t < nk2; ++t) {
      ternary::decode_weight_tile<BN>(wsa, wo, (f0 + t * BK) / 16, n0, kw2, N, N);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, hs + (wm * 16) * HLD + t * BK + kk, HLD);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, wsa + kk * (BN + APAD) + wn * FN * 16 + j * 16,
                                 BN + APAD);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(csa + (wm * 16) * (BN + CPAD) + wn * FN * 16 + j * 16,
                              acc[j], BN + CPAD, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
      const int r = i / BN, c = i % BN;
      const int gr = m0 + r, gc = n0 + c;
      if (gr < M && gc < N)
        partial[((size_t)chunk * M + gr) * N + gc] = csa[r * (BN + CPAD) + c];
    }
    __syncthreads();
  }
}

// Fixed-order sum of the chunks' partial down-projections + the f32
// epilogue (scale, then bias, then the cast).
__global__ void fused_mlp_reduce_kernel(const float* __restrict__ partial,
                                        const float* __restrict__ so,
                                        const float* __restrict__ bo,
                                        bf16* __restrict__ y, int chunks,
                                        int M, int N) {
  const size_t total = (size_t)M * N;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float acc = 0.0f;
  for (int c = 0; c < chunks; ++c) acc += partial[(size_t)c * total + idx];
  const int n = (int)(idx % N);
  if (so != nullptr) acc *= so[n];
  if (bo != nullptr) acc += bo[n];
  y[idx] = __float2bfloat16(acc);
}

template <int BM>
static int launch(const void* x, const void* wi, const void* wg,
                  const void* wo, const void* si, const void* bi,
                  const void* sg, const void* bg, void* partial, int M, int K,
                  int FF, int N, int kw1, int kw2, int FC, int act,
                  cudaStream_t stream) {
  const int smem = h_bytes(BM, FC) + stage_bytes(BM);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (FF + FC - 1) / FC;
  dim3 grid(chunks, (M + BM - 1) / BM);
  fused_mlp_kernel<BM><<<grid, (BM / 16) * WARPS_N * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint32_t*>(wi),
      static_cast<const uint32_t*>(wg), static_cast<const uint32_t*>(wo),
      static_cast<const float*>(si), static_cast<const float*>(bi),
      static_cast<const float*>(sg), static_cast<const float*>(bg),
      static_cast<float*>(partial), M, K, FF, N, kw1, kw2, FC, act);
  return (int)cudaGetLastError();
}

// variant 0: decode tile (BM 16, 4 warps); variant 1: prefill tile (BM 32,
// 8 warps). FC (ff columns per block) must be a positive multiple of 128;
// ``partial`` holds ceil(FF / FC) * M * N floats. act: 0 silu, 1 relu,
// 2 none. Returns the cudaError_t of the launches (0 = success).
extern "C" int fused_mlp_bf16(const void* x, const void* wi, const void* wg,
                              const void* wo, const void* si, const void* bi,
                              const void* sg, const void* bg, const void* so,
                              const void* bo, void* partial, void* y, int M,
                              int K, int FF, int N, int kw1, int kw2, int FC,
                              int act, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (FC <= 0 || FC % BN != 0) return (int)cudaErrorInvalidValue;
  int err;
  if (variant == 0)
    err = launch<16>(x, wi, wg, wo, si, bi, sg, bg, partial, M, K, FF, N, kw1,
                     kw2, FC, act, s);
  else if (variant == 1)
    err = launch<32>(x, wi, wg, wo, si, bi, sg, bg, partial, M, K, FF, N, kw1,
                     kw2, FC, act, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  const int chunks = (FF + FC - 1) / FC;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  fused_mlp_reduce_kernel<<<blocks, threads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const float*>(so),
      static_cast<const float*>(bo), static_cast<bf16*>(y), chunks, M, N);
  return (int)cudaGetLastError();
}
