// Paged decode attention for Hopper (sm_90a): one query token per row
// attends that row's KV pages through its block table; bf16 q and output,
// bf16 pages or int8 pages with f32 per-(token, kv head) scales.
//
// Replaces the TPU kernel repro/paging/kernels.py::paged_decode_attention_pallas
// (line 189; its _kernel body at line 160, the pallas_call at line 224).
//
// What bounds it on the H100: bytes. A block reads the K and V of its row's
// valid tokens for one kv head once (hd bf16 values, or hd int8 codes and
// one f32 scale, per token); q, the output, the lengths and the table are
// small. At the serving shape (8 rows of up to 193 tokens, 16 kv heads,
// hd 64, bf16 pages) that is ~6.3 MB, ~1.9 us at 3.35 TB/s. The design
// does nothing about that bound yet: one block per (row, kv head) walks
// its row's pages with loads that wait on each other, 128 blocks at the
// serving shape. A later PR may split the sequence over blocks and keep
// page loads in flight.
//
// Design. The Pallas kernel stages a row's whole sequence into VMEM over a
// sequential page grid; CUDA blocks run in no order, so each block reads
// lengths[b] and its block-table row itself and visits only the pages that
// hold valid tokens: positions [lo, L), lo = max(0, L - window) when a
// window is set. Entries past those are padding and are never read.
// Three steps, the scores in shared memory:
//   1. one warp per token: q.k in f32 for each of the group's H/KV query
//      heads (lanes over hd, a shuffle reduction), times 1/sqrt(hd);
//   2. per head: max, exp, sum and divide in f32, then p rounded to bf16,
//      the gathered view's dtype, where the plain version rounds it (an
//      online softmax could not round p there, so none is used);
//   3. p.v in f32: each thread owns one (head, d) output and a strided
//      share of the tokens; the shares meet in shared memory, are summed
//      in a fixed order and cast to bf16 once.
// int8 pages dequantize code * scale in f32 and round to bf16 before use,
// as the plain version's gather does; the device-memory reads stay int8.
// A row whose length lies outside [1, T*ps], or whose visited table entries
// lie outside [0, P), gets NaN outputs instead of a wild read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;   // paging/kernels.py THREADS
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Element d of the (token, kv head) row `row` of a page array, as f32.
template <bool QUANT>
__device__ __forceinline__ float load_kv(const void* __restrict__ pages,
                                         const float* __restrict__ scales,
                                         size_t row, int d, int hd) {
  if (QUANT) {
    const int8_t* codes = static_cast<const int8_t*>(pages);
    return round_bf16(static_cast<float>(codes[row * hd + d]) * scales[row]);
  }
  const bf16* p = static_cast<const bf16*>(pages);
  return __bfloat162float(p[row * hd + d]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions; every thread gets the same value (each reads the
// per-warp results in the same order). All threads must call them.
__device__ float block_max(float v, float* scratch) {
  v = warp_max(v);
  __syncthreads();   // the previous reduction's readers are done
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, scratch[w]);
  return r;
}

__device__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < WARPS; ++w) r += scratch[w];
  return r;
}

// sum over tokens i = first, first + step, ... < n of p[i] * v(token lo+i, d)
template <bool QUANT>
__device__ float pv_share(const float* __restrict__ p, const int* pid_s,
                          const void* __restrict__ v_pages,
                          const float* __restrict__ v_scales, int lo, int n,
                          int first, int step, int d, int hd, int ps, int KV,
                          int kvh) {
  float acc = 0.f;
  for (int i = first; i < n; i += step) {
    const int t = lo + i;
    const size_t row = ((size_t)pid_s[t / ps] * ps + t % ps) * KV + kvh;
    acc += p[i] * load_kv<QUANT>(v_pages, v_scales, row, d, hd);
  }
  return acc;
}

// grid (KV, B), THREADS threads, dynamic shared memory (f32 words):
//   q_s [G*hd] | s_s [G*T*ps] | red [THREADS] | scratch [32] | pid_s [T]
template <bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const bf16* __restrict__ q,
                       const void* __restrict__ k_pages,
                       const float* __restrict__ k_scales,
                       const void* __restrict__ v_pages,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ block_table,
                       const int* __restrict__ lengths, bf16* __restrict__ out,
                       int H, int KV, int hd, int ps, int T, int P, int window,
                       float sm_scale) {
  extern __shared__ float smem[];
  __shared__ int bad;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int n_max = T * ps;
  float* q_s = smem;
  float* s_s = q_s + G * hd;
  float* red = s_s + G * n_max;
  float* scratch = red + THREADS;
  int* pid_s = reinterpret_cast<int*>(scratch + 32);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int L = lengths[b];
  const int lo = window > 0 ? max(0, L - window) : 0;
  const int n = L - lo;
  const int n_out = G * hd;
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;
  bf16* o = out + head0 * hd;

  if (threadIdx.x == 0) bad = (L < 1 || L > n_max);
  for (int i = threadIdx.x; i < n_out; i += THREADS)
    q_s[i] = __bfloat162float(q[head0 * hd + i]);
  for (int j = threadIdx.x; j < T; j += THREADS)
    pid_s[j] = block_table[(size_t)b * T + j];
  __syncthreads();
  if (!bad) {
    // only the pages that hold positions [lo, L) are read
    for (int j = lo / ps + threadIdx.x; j <= (L - 1) / ps; j += THREADS)
      if (pid_s[j] < 0 || pid_s[j] >= P) bad = 1;
  }
  __syncthreads();
  if (bad) {
    for (int i = threadIdx.x; i < n_out; i += THREADS)
      o[i] = __float2bfloat16(__int_as_float(0x7fc00000));
    return;
  }

  // 1. scores, one warp per token
  for (int i = warp; i < n; i += WARPS) {
    const int t = lo + i;
    const size_t row = ((size_t)pid_s[t / ps] * ps + t % ps) * KV + kvh;
    for (int g = 0; g < G; ++g) {
      float acc = 0.f;
      for (int d = lane; d < hd; d += 32)
        acc += q_s[g * hd + d] * load_kv<QUANT>(k_pages, k_scales, row, d, hd);
      acc = warp_sum(acc);
      if (lane == 0) s_s[g * n_max + i] = acc * sm_scale;
    }
  }
  __syncthreads();

  // 2. softmax per query head, p rounded to bf16
  for (int g = 0; g < G; ++g) {
    float* s = s_s + g * n_max;
    float m = -INFINITY;
    for (int i = threadIdx.x; i < n; i += THREADS) m = fmaxf(m, s[i]);
    m = block_max(m, scratch);
    float sum = 0.f;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const float e = expf(s[i] - m);
      s[i] = e;
      sum += e;
    }
    sum = block_sum(sum, scratch);
    for (int i = threadIdx.x; i < n; i += THREADS) s[i] = round_bf16(s[i] / sum);
  }
  __syncthreads();

  // 3. p.v
  if (n_out > THREADS) {
    for (int oi = threadIdx.x; oi < n_out; oi += THREADS) {
      const int g = oi / hd, d = oi % hd;
      o[oi] = __float2bfloat16(pv_share<QUANT>(s_s + g * n_max, pid_s, v_pages,
                                               v_scales, lo, n, 0, 1, d, hd,
                                               ps, KV, kvh));
    }
    return;
  }
  const int splits = THREADS / n_out;
  const int split = threadIdx.x / n_out, oi = threadIdx.x % n_out;
  if (split < splits) {
    const int g = oi / hd, d = oi % hd;
    red[threadIdx.x] = pv_share<QUANT>(s_s + g * n_max, pid_s, v_pages,
                                       v_scales, lo, n, split, splits, d, hd,
                                       ps, KV, kvh);
  }
  __syncthreads();
  if (threadIdx.x < n_out) {
    float tot = 0.f;
    for (int sp = 0; sp < splits; ++sp) tot += red[sp * n_out + threadIdx.x];
    o[threadIdx.x] = __float2bfloat16(tot);
  }
}

template <bool QUANT>
static int launch(const void* q, const void* k_pages, const void* k_scales,
                  const void* v_pages, const void* v_scales,
                  const void* block_table, const void* lengths, void* out,
                  int B, int H, int KV, int hd, int ps, int T, int P,
                  int window, int smem, float sm_scale, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(KV, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), k_pages, static_cast<const float*>(k_scales),
      v_pages, static_cast<const float*>(v_scales),
      static_cast<const int*>(block_table), static_cast<const int*>(lengths),
      static_cast<bf16*>(out), H, KV, hd, ps, T, P, window, sm_scale);
  return (int)cudaGetLastError();
}

// quant 0: bf16 pages (k_scales/v_scales unused); quant 1: int8 codes +
// f32 scales. smem: dynamic shared-memory bytes (paging/kernels.py
// smem_bytes). Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* block_table,
    const void* lengths, void* out, int B, int H, int KV, int hd, int ps,
    int T, int P, int window, int smem, float sm_scale, int quant,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quant)
    return launch<true>(q, k_pages, k_scales, v_pages, v_scales, block_table,
                        lengths, out, B, H, KV, hd, ps, T, P, window, smem,
                        sm_scale, s);
  return launch<false>(q, k_pages, k_scales, v_pages, v_scales, block_table,
                       lengths, out, B, H, KV, hd, ps, T, P, window, smem,
                       sm_scale, s);
}
