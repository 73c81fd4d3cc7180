// Flash attention over full sequences for Hopper (sm_90a), bf16 in and out:
//   o = softmax(q k^T / sqrt(hd), causal or full) v, f32 statistics.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_pallas
// (line 83; its _kernel body at line 32, the pallas_call at line 102).
//
// What bounds it on the H100: operations. A causal pass over (BH, S, hd)
// does 2*BH*S^2*hd flops in QK^T and PV together (half of the full
// square's 4*BH*S^2*hd), against 4*BH*S*hd*2 bytes of q, k, v and o: at the
// evaluation's shape (BH 128, S 1024, hd 64) that is 17.2 GFLOP, ~17 us at
// 989 TFLOP/s, over 67 MB, ~20 us at 3.35 TB/s, so the two bounds are close
// and the kernel must keep scores and the accumulator out of device memory.
//
// Design. The Pallas kernel walks a sequential KV grid axis with (m, l, acc)
// in VMEM scratch; here one block of 4 warps owns one (bh, 64-row query
// tile) and loops over 64-key K/V tiles itself, carrying the online-softmax
// state in registers:
//   * q is staged once in shared memory and its mma fragments stay in
//     registers; K/V tiles stream through two shared-memory stages filled by
//     cp.async, so the next tile loads while this one computes;
//   * each warp owns 16 query rows: S = q k^T on tensor cores (mma.sync
//     m16n8k16, bf16 in, f32 accumulate), scaled and masked in f32 (keys
//     >= Skv, and keys after the row when causal, get -1e30), then the
//     row max, exp, correction and row sum in f32 across the quad of lanes
//     that shares a row;
//   * p is rounded to bf16 straight from the S accumulators into the A
//     fragments of the PV mma (the Pallas kernel's p.astype(v.dtype)),
//     acc = acc * corr + p v in f32;
//   * causal: KV tiles that start after the tile's last query row are never
//     loaded (the Pallas kernel's @pl.when skip); heavy query tiles are
//     scheduled first;
//   * the epilogue writes acc / max(l, 1e-30) rounded to bf16 from registers.
// Shared memory: (64 + 4 * 64) rows of hd + 8 bf16 = 45 KB at hd 64 and 85 KB
// at hd 128 (above the 48 KB default, so the launcher opts in). wgmma, TMA
// and a warp-specialised pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;               // query rows per block, 16 per warp
constexpr int BN = 64;               // keys per K/V tile
constexpr int WARPS = BM / 16;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;               // bf16 row padding (16 bytes): spreads
                                     // the fragment loads over the banks
constexpr float NEG_INF = -1e30f;    // flash_attention.py NEG_INF

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16x16 bf16, row-major fragment) * b (16x8 bf16, col fragment)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values as one bf16x2 register, lo in the low half (lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows [r0, r0 + ROWS) of a (total, HD) row-major bf16 matrix into smem with
// row stride HD + PAD, by 16-byte cp.async; rows >= total are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int total) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const int gr = r0 + r;
    const bf16* s = src + (size_t)min(gr, total - 1) * HD + c * 8;
    cp_async16(dst + r * (HD + PAD) + c * 8, s, gr < total ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int Sq, int Skv, int causal, float scale) {
  constexpr int LD = HD + PAD;
  constexpr int KC = HD / 16;        // 16-deep chunks of q k^T
  constexpr int NT = BN / 8;         // 8-key column tiles of S
  constexpr int OT = HD / 8;         // 8-wide column tiles of o
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BM * LD;           // two stages
  bf16* vs = ks + 2 * BN * LD;       // two stages

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heavy tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + (size_t)bh * Sq * HD;
  const bf16* kb = k + (size_t)bh * Skv * HD;
  const bf16* vb = v + (size_t)bh * Skv * HD;
  const int kv_end = causal ? min(Skv, q0 + BM) : Skv;
  const int n_tiles = (kv_end + BN - 1) / BN;

  load_rows<HD, BM>(qs, qb, q0, Sq);
  load_rows<HD, BN>(ks, kb, 0, Skv);
  load_rows<HD, BN>(vs, vb, 0, Skv);
  cp_async_commit();

  uint32_t qf[KC][4];
  float acc[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.0f, 0.0f};
  const int row0 = q0 + warp * 16 + g;      // this lane's rows: row0, row0+8

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      load_rows<HD, BN>(ks + st * BN * LD, kb, (j + 1) * BN, Skv);
      load_rows<HD, BN>(vs + st * BN * LD, vb, (j + 1) * BN, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const bf16* base = qs + (warp * 16 + g) * LD + c * 16 + 2 * t;
        qf[c][0] = *reinterpret_cast<const uint32_t*>(base);
        qf[c][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
        qf[c][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        qf[c][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
      }
    }
    const bf16* kt = ks + (j & 1) * BN * LD;
    const bf16* vt = vs + (j & 1) * BN * LD;

    // S = q k^T for this warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* kr = kt + (n * 8 + g) * LD + c * 16 + 2 * t;
        mma_16816(s[n], qf[c], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }

    // scale, mask, online softmax (element e: row row0 + 8*(e/2), key
    // j*BN + 8n + 2t + e%2)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1);
        const int key = j * BN + n * 8 + 2 * t + (e & 1);
        const bool ok = key < Skv && (!causal || row >= key);
        s[n][e] = ok ? s[n][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
      corr[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_run[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + quad_sum(sum[h]);
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // acc += p v: p (bf16) from the S accumulators as A fragments, 16 keys
    // per chunk; v as B fragments (key pairs of one column)
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      const uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                             pack_bf16(s[2 * c][2], s[2 * c][3]),
                             pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                             pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int i = 0; i < OT; ++i) {
        const bf16* vr = vt + (c * 16 + 2 * t) * LD + i * 8 + g;
        mma_16816(acc[i], a, pack_bf16(vr[0], vr[LD]),
                  pack_bf16(vr[8 * LD], vr[9 * LD]));
      }
    }
    __syncthreads();   // this stage is refilled two tiles from now
  }

  const float l0 = fmaxf(l_run[0], 1e-30f), l1 = fmaxf(l_run[1], 1e-30f);
  bf16* ob = o + (size_t)bh * Sq * HD;
#pragma unroll
  for (int i = 0; i < OT; ++i) {
    const int col = i * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * HD + col) =
          pack_bf16(acc[i][0] / l0, acc[i][1] / l0);
    if (row0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)(row0 + 8) * HD + col) =
          pack_bf16(acc[i][2] / l1, acc[i][3] / l1);
  }
}

template <int HD>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int BH, int Sq, int Skv, int causal, float scale,
                  cudaStream_t stream) {
  constexpr int SMEM = (BM + 4 * BN) * (HD + PAD) * 2;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (Sq + BM - 1) / BM);
  flash_attention_kernel<HD><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, causal,
      scale);
  return (int)cudaGetLastError();
}

// q (BH, Sq, hd), k and v (BH, Skv, hd), o (BH, Sq, hd): contiguous bf16,
// 16-byte aligned; hd 64 or 128; Skv >= 1. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int BH, int Sq,
                                    int Skv, int hd, int causal, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || Sq <= 0 || Skv <= 0 || (Sq + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (hd == 64) return launch<64>(q, k, v, o, BH, Sq, Skv, causal, scale, s);
  if (hd == 128) return launch<128>(q, k, v, o, BH, Sq, Skv, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
