// Paged decode attention for Hopper (sm_90a): one query token per row
// attends that row's KV pages through its block table; bf16 q and output,
// bf16 pages or int8 pages with f32 per-(token, kv head) scales.
//
// Replaces the TPU kernel repro/paging/kernels.py::paged_decode_attention_pallas
// (line 189; its _kernel body at line 160, the pallas_call at line 224).
//
// What bounds it on the H100: bytes. The kernel reads the K and V of each
// row's valid tokens for each kv head once (hd bf16 values, or hd int8
// codes and one f32 scale, per token); q, the output, the lengths and the
// table are small. At the serving shape (8 rows of up to 193 tokens, 16 kv
// heads, hd 64, bf16 pages) that is ~2.9 MB, ~0.9 us at the H100 SXM's
// 3.35 TB/s, well below a launch, so there the kernel is bound by
// latency: the chain of dependent loads (the row's length, its table
// entries, then its pages) and the reductions of each (row, kv head). The
// design keeps that chain short: each (row, kv head) is a thread-block
// cluster of `splits` blocks, each block takes an equal share of the
// row's valid tokens, keeps its share's K and V loads in flight through a
// 4-stage ring of 16-byte cp.async copies (K chunks first, then V chunks,
// so V lands while the scores and the softmax run), and the cluster
// trades its softmax statistics and partial outputs through distributed
// shared memory. At long rows (513 to 1024 tokens) the time still sits
// about 4x above the byte bound (H100 80GB HBM3, 700 W; PERF.md), and
// neither more splits, a deeper ring nor more threads moved it: what
// holds it there is not yet known.
//
// What the plain version computes (paging/kernels.py, through the port's
// naive_attention), and the kernel keeps: the scores q.k / sqrt(hd) and
// the softmax in f32 over the row's whole valid span, p rounded to bf16
// once, after the row's max and sum are known, and p.v summed in f32 and
// cast to bf16. So the blocks of a cluster cannot each finish their share
// as flash decoding does (it rounds p before the global max is known);
// they trade statistics first:
//   1. each block writes its share's scores to shared memory: 8 lanes a
//      token, 16-byte reads, a 3-step shuffle sum, times 1/sqrt(hd), for
//      each of the group's H/KV query heads (GQA);
//   2. each block's (max m, sum of exp(s - m)) goes to the cluster in one
//      barrier; every block forms the row's max M and sum L = sum_r l_r
//      exp(m_r - M) in rank order (the same bits everywhere) and rounds
//      p = exp(s - M) / L to bf16;
//   3. each block sums p.v over its share in f32 (fixed strided splits of
//      its threads, two outputs and four tokens a step, added in split
//      order); barrier; rank 0 adds the blocks' partials in rank order and
//      casts to bf16; a last barrier keeps every block's shared memory
//      alive until rank 0 has read it.
// A row's share boundaries depend on its own length and window only: the
// cluster size and the staging sizes come from the table width, the page
// size and the window (paging/kernels.py split_plan), never from the batch
// or the other rows, so a row's bits do not depend on which rows run with
// it. int8 pages stay int8 in device memory and dequantize code * scale in
// f32, rounded to bf16, as the plain version's gather does. A row whose
// length lies outside [1, T*ps], or whose visited table entries lie
// outside [0, P), gets NaN outputs instead of a wild read: each block
// checks the pages of its share before reading them and the cluster ORs
// the verdicts.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TOKEN_LANES = 8;         // lanes of one token's q.k
constexpr int MAX_SPLITS = 4;          // paging/kernels.py MAX_SPLITS
constexpr int RING = 4;                // paging/kernels.py RING

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// Shared memory of one block, in bytes from the (16-byte aligned) base:
// the ring's nbuf stages (ch rows of hd elements each), their scales
// (int8 pages), q (f32), the share's scores, the block's partial
// output, the p.v slots, the traded statistics (max and sum per query
// head, the bad-page flag) and their cluster-wide values, the warp
// scratch, the page ids of the share. paging/kernels.py smem_bytes asks
// for its size through paged_attention_smem_bytes below.
struct Layout {
  int ring, scales, q, s, o, acc, stat, glob, scratch, pid, bytes;
};

__host__ __device__ inline Layout layout(int G, int hd, int ps, int tpb,
                                         int ch, int nbuf, bool quant) {
  const int row = hd * (quant ? 1 : 2);
  const int items = G * hd;
  Layout L;
  int off = 0;
  L.ring = off;    off += nbuf * ch * row;
  L.scales = off;  off += quant ? nbuf * ch * 4 : 0;
  L.q = off;       off += items * 4;
  L.s = off;       off += G * tpb * 4;
  L.o = off;       off += items * 4;
  L.acc = off;     off += 2 * (items / 2 > THREADS ? items / 2 : THREADS) * 4;
  L.stat = off;    off += (2 * G + 1) * 4;
  L.glob = off;    off += (2 * G + 1) * 4;
  L.scratch = off; off += 32 * 4;
  L.pid = off;     off += (tpb / ps + 2) * 4;   // pages a share can span
  L.bytes = off;
  return L;
}

// grid (splits, KV, B) in clusters of (splits, 1, 1), THREADS threads.
// tpb: most tokens a block's share can hold; ch: tokens staged at once
// (both multiples of 4, so p is read four tokens at a time); nbuf: stages
// of the ring (RING, or every chunk of a share's K and V when fewer).
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
                       float sm_scale, int tpb, int ch, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int ROW = hd * (QUANT ? 1 : 2);          // bytes of a K or V row
  const int items = G * hd;                      // outputs of the group
  const Layout lay = layout(G, hd, ps, tpb, ch, nbuf, QUANT);
  unsigned char* ring = smem + lay.ring;
  float* ring_sc = reinterpret_cast<float*>(smem + lay.scales);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  float* o_s = reinterpret_cast<float*>(smem + lay.o);
  float* acc_s = reinterpret_cast<float*>(smem + lay.acc);
  float* stat = reinterpret_cast<float*>(smem + lay.stat);   // max, sum, bad
  float* glob = reinterpret_cast<float*>(smem + lay.glob);
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch);
  int* pid_s = reinterpret_cast<int*>(smem + lay.pid);
  const int tid = threadIdx.x, lane = tid % 32;

  // this block's share of the row's valid positions [lo, L)
  const int L = lengths[b];
  const bool bad_len = L < 1 || L > T * ps;
  const int lo = window > 0 ? max(0, L - window) : 0;
  const int n = bad_len ? 0 : L - lo;
  const int per = (n + splits - 1) / splits;
  const int t0 = lo + min(n, rank * per);
  const int cnt = min(n, (rank + 1) * per) - min(n, rank * per);
  const int* table = block_table + (size_t)b * T;
  const int page0 = t0 / ps;                     // the share's first page
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;

  if (tid == 0) stat[2 * G] = 0.0f;
  for (int i = tid; i < items; i += THREADS)
    q_s[i] = __bfloat162float(q[head0 * hd + i]);
  __syncthreads();
  if (cnt > 0) {
    for (int j = page0 + tid; j <= (t0 + cnt - 1) / ps; j += THREADS) {
      const int id = table[j];
      pid_s[j - page0] = id;
      if (id < 0 || id >= P) stat[2 * G] = 1.0f;
    }
  }
  __syncthreads();
  const int my = stat[2 * G] != 0.0f ? 0 : cnt;   // tokens this block reads
  const int nch = (my + ch - 1) / ch;

  // The ring: the share's loads, K chunks 0 .. nch - 1 then V chunks 0 ..
  // nch - 1, load i in stage i % nbuf, each one cp.async group; RING
  // groups are always committed ahead (empty ones past the last load), so
  // load i has landed once all but the last RING - 1 groups have. V's
  // loads fly while the scores and the softmax run.
  const int nloads = 2 * nch;
  auto issue = [&](int i) {
    if (i < nloads) {
      const bool is_v = i >= nch;
      const int first = (is_v ? i - nch : i) * ch;
      const int rows = min(ch, my - first);
      unsigned char* dst = ring + (i % nbuf) * ch * ROW;
      const unsigned char* src =
          static_cast<const unsigned char*>(is_v ? v_pages : k_pages);
      const int pieces = ROW / 16;
      for (int e = tid; e < rows * pieces; e += THREADS) {
        const int r = e / pieces, piece = e % pieces;
        const int t = t0 + first + r;
        const size_t row =
            ((size_t)pid_s[t / ps - page0] * ps + t % ps) * KV + kvh;
        cp_async16(dst + r * ROW + piece * 16, src + row * ROW + piece * 16);
      }
      if (QUANT) {
        float* sdst = ring_sc + (i % nbuf) * ch;
        const float* ssrc = is_v ? v_scales : k_scales;
        for (int r = tid; r < rows; r += THREADS) {
          const int t = t0 + first + r;
          const size_t row =
              ((size_t)pid_s[t / ps - page0] * ps + t % ps) * KV + kvh;
          cp_async4(sdst + r, ssrc + row);
        }
      }
    }
    cp_async_commit();
  };
  // wait for load i; after reading it, free its stage for load i + RING
  auto land = [&]() {
    cp_async_wait<RING - 1>();
    __syncthreads();
  };
  auto release = [&](int i) {
    __syncthreads();
    issue(i + RING);
  };
  for (int i = 0; i < RING; ++i) issue(i);

  // 1. scores
  const int sub = lane % TOKEN_LANES;
  const int grp = tid / TOKEN_LANES;
  constexpr int GROUPS = THREADS / TOKEN_LANES;
  for (int c = 0; c < nch; ++c) {
    land();
    const int rows = min(ch, my - c * ch);
    const unsigned char* kb = ring + (c % nbuf) * ch * ROW;
    const float* ksc = ring_sc + (c % nbuf) * ch;
    for (int j0 = 0; j0 < rows; j0 += GROUPS) {
      const int j = j0 + grp;
      for (int g = 0; g < G; ++g) {
        float dot = 0.0f;
        if (j < rows) {
          for (int e0 = sub * 8; e0 < hd; e0 += TOKEN_LANES * 8) {
            const float* qv = q_s + g * hd + e0;
            if (QUANT) {
              const uint2 raw =
                  *reinterpret_cast<const uint2*>(kb + j * ROW + e0);
              const int8_t* code = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
              for (int e = 0; e < 8; ++e)
                dot += qv[e] * round_bf16((float)code[e] * ksc[j]);
            } else {
              const uint4 raw =
                  *reinterpret_cast<const uint4*>(kb + j * ROW + e0 * 2);
              const bf16* kv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
              for (int e = 0; e < 8; ++e)
                dot += qv[e] * __bfloat162float(kv[e]);
            }
          }
        }
#pragma unroll
        for (int o = TOKEN_LANES / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (j < rows && sub == 0) s_s[g * tpb + c * ch + j] = dot * sm_scale;
      }
    }
    release(c);
  }

  // 2. softmax over the whole row: each block's (max, sum of exp(s -
  // max)) traded in one cluster barrier; every block forms the row's max
  // M and sum L = sum_r l_r exp(m_r - M) in rank order (the same bits
  // everywhere), then p = exp(s - M) / L rounded to bf16
  for (int g = 0; g < G; ++g) {
    float m = -INFINITY;
    for (int i = tid; i < my; i += THREADS) m = fmaxf(m, s_s[g * tpb + i]);
    m = block_max(m, scratch);
    float l = 0.0f;
    for (int i = tid; i < my; i += THREADS) l += expf(s_s[g * tpb + i] - m);
    l = block_sum(l, scratch);
    if (tid == 0) {
      stat[g] = m;
      stat[G + g] = l;
    }
  }
  cluster.sync();
  if (tid < G) {
    float m = -INFINITY;
    for (int r = 0; r < splits; ++r)
      m = fmaxf(m, cluster.map_shared_rank(stat, r)[tid]);
    float l = 0.0f;
    for (int r = 0; r < splits; ++r) {
      const float* peer = cluster.map_shared_rank(stat, r);
      if (peer[G + tid] > 0.0f) l += peer[G + tid] * expf(peer[tid] - m);
    }
    glob[tid] = m;
    glob[G + tid] = l;
  } else if (tid == G) {
    float bad = 0.0f;
    for (int r = 0; r < splits; ++r)
      bad = fmaxf(bad, cluster.map_shared_rank(stat, r)[2 * G]);
    glob[2 * G] = bad;
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    const float m = glob[g], l = glob[G + g];
    for (int i = tid; i < my; i += THREADS)
      s_s[g * tpb + i] = round_bf16(expf(s_s[g * tpb + i] - m) / l);
  }

  // 3. p.v over the share, two adjacent outputs (a "pair") a slot: slot k
  // = (split, pair) of S token splits, owned by threads k, k + THREADS,
  // ...; split sp takes the share's tokens in fours, quads sp, sp + S, ...
  // of each chunk.
  const int pairs = items / 2;
  const int S = pairs < THREADS ? THREADS / pairs : 1;
  for (int k = tid; k < S * pairs; k += THREADS)
    acc_s[2 * k] = acc_s[2 * k + 1] = 0.0f;
  for (int c = 0; c < nch; ++c) {
    land();
    const int rows = min(ch, my - c * ch);
    const unsigned char* vb = ring + ((nch + c) % nbuf) * ch * ROW;
    const float* vsc = ring_sc + ((nch + c) % nbuf) * ch;
    for (int k = tid; k < S * pairs; k += THREADS) {
      const int sp = k / pairs, pi = k % pairs;
      const int g = 2 * pi / hd, d = 2 * pi % hd;
      const float* p = s_s + g * tpb + c * ch;
      float a0 = 0.0f, a1 = 0.0f;
      for (int j0 = 4 * sp; j0 < rows; j0 += 4 * S) {
        const float4 p4 = *reinterpret_cast<const float4*>(p + j0);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u;
          if (j >= rows) break;
          float v0, v1;
          if (QUANT) {
            const char2 code =
                *reinterpret_cast<const char2*>(vb + j * ROW + d);
            v0 = round_bf16((float)code.x * vsc[j]);
            v1 = round_bf16((float)code.y * vsc[j]);
          } else {
            const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(
                vb + j * ROW + 2 * d);
            v0 = __low2float(v2);
            v1 = __high2float(v2);
          }
          a0 += pj[u] * v0;
          a1 += pj[u] * v1;
        }
      }
      acc_s[2 * k] += a0;
      acc_s[2 * k + 1] += a1;
    }
    release(nch + c);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int it = tid; it < items; it += THREADS) {
    float a = 0.0f;
    for (int sp = 0; sp < S; ++sp) a += acc_s[2 * sp * pairs + it];
    o_s[it] = a;
  }
  cluster.sync();
  if (rank == 0) {
    const bool bad = bad_len || glob[2 * G] != 0.0f;
    for (int it = tid; it < items; it += THREADS) {
      float a = 0.0f;
      for (int r = 0; r < splits; ++r)
        a += cluster.map_shared_rank(o_s, r)[it];
      out[head0 * hd + it] =
          __float2bfloat16(bad ? __int_as_float(0x7fc00000) : a);
    }
  }
  cluster.sync();   // peers' shared memory outlives rank 0's reads
}

template <bool QUANT>
static int launch(const void* q, const void* k_pages, const void* k_scales,
                  const void* v_pages, const void* v_scales,
                  const void* block_table, const void* lengths, void* out,
                  int B, int H, int KV, int hd, int ps, int T, int P,
                  int window, float sm_scale, int splits, int tpb, int ch,
                  int nbuf, cudaStream_t stream) {
  // rows are copied 16 bytes at a time: hd bf16 values or hd int8 codes
  const int align = QUANT ? 16 : 8;
  if (KV < 1 || H % KV || hd < align || hd % align || splits < 1 ||
      splits > MAX_SPLITS || tpb < 1 || ch < 1 || ch > tpb || tpb % 4 ||
      ch % 4 || nbuf < 1 || nbuf > RING ||
      (nbuf < RING && nbuf < 2 * ((tpb + ch - 1) / ch)))
    return (int)cudaErrorInvalidValue;
  const int smem = layout(H / KV, hd, ps, tpb, ch, nbuf, QUANT).bytes;
  auto kernel = paged_attention_kernel<QUANT>;
  static int smem_set = 48 * 1024;   // the kernel's dynamic smem limit so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KV, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q), k_pages,
      static_cast<const float*>(k_scales), v_pages,
      static_cast<const float*>(v_scales),
      static_cast<const int*>(block_table), static_cast<const int*>(lengths),
      static_cast<bf16*>(out), H, KV, hd, ps, T, P, window, sm_scale, tpb, ch,
      nbuf);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block (the layout above), for the wrapper's
// check against the card's limit.
extern "C" int paged_attention_smem_bytes(int G, int hd, int ps, int tpb,
                                          int ch, int nbuf, int quant) {
  return layout(G, hd, ps, tpb, ch, nbuf, quant != 0).bytes;
}

// The most dynamic shared memory a block of `device` may take (opted in),
// or -1 if the card cannot be asked.
extern "C" int paged_attention_smem_limit(int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return limit;
}

// quant 0: bf16 pages (k_scales/v_scales unused); quant 1: int8 codes +
// f32 scales. splits, tpb, ch, nbuf: paging/kernels.py split_plan (a
// function of T, ps and window alone). Returns the cudaError_t of the
// launch (0 = success).
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* block_table,
    const void* lengths, void* out, int B, int H, int KV, int hd, int ps,
    int T, int P, int window, float sm_scale, int quant, int splits, int tpb,
    int ch, int nbuf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quant)
    return launch<true>(q, k_pages, k_scales, v_pages, v_scales, block_table,
                        lengths, out, B, H, KV, hd, ps, T, P, window,
                        sm_scale, splits, tpb, ch, nbuf, s);
  return launch<false>(q, k_pages, k_scales, v_pages, v_scales, block_table,
                       lengths, out, B, H, KV, hd, ps, T, P, window, sm_scale,
                       splits, tpb, ch, nbuf, s);
}
