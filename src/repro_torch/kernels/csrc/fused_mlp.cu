// Fused packed-ternary MLP block for Hopper (sm_90a), bf16 in and out:
//   h = act(x @ Wg * sg + bg) * (x @ Wi * si + bi)     (gate optional)
//   y = h @ Wo * so + bo
//
// Replaces the TPU kernel repro/kernels/fused_mlp.py::fused_mlp_pallas
// (its _fused_body; the pallas_call at line 297).
//
// What bounds it on the H100: at decode (M = 8) the block streams three
// 2-bit weight matrices (3 x 1024 x 4096 x 2 bits = 3 MiB) and is
// byte-bound, so what it pays is latency and how many blocks share the
// stream; at prefill and evaluation (M 1024, 8192) it is operation-bound,
// 2*M*ff*(2K + N) bf16 tensor-core work, beside which the decode of the
// 2-bit words is ALU and shared-memory work. The (M, ff) hidden activation
// is the traffic the fusion exists to remove, so h never goes to device
// memory: each block keeps its (BM x FC) slice of h in shared memory.
//
// Design: an ff chunk of FC columns is owned by a cluster of CL blocks
// (Hopper thread-block clusters) per row tile; rank q of the cluster
// computes columns [q * FC / CL, (q + 1) * FC / CL) of the chunk's h.
// Stage 1 computes that slice strip by strip (BNS columns a strip), the up
// and gate projections from one A fragment and two decoded B fragments,
// and rounds to bf16 exactly where the plain chain rounds: yi and yg after
// their epilogues, act(yg), then the product. With CL > 1 the cluster then
// exchanges slices through distributed shared memory (barrier, 16-byte
// reads of the peers' slices, barrier at exit), so every block holds the
// chunk's whole (BM x FC) h. Stage 2 multiplies it (ldmatrix from shared
// memory) by the chunk's rows of Wo for the down projection's strips q,
// q + CL, ... into an f32 partial in device memory. Both stages are one
// flattened sequence of 64-deep steps through one ring of cp.async
// stages (x tile and the Wi/Wg words, or the Wo words), so Wo's first
// words are in flight while stage 1 ends. The B fragments are decoded in
// registers from the packed words (ternary_tiles.cuh's register-decode
// loop, the same as ternary_gemm.cu). A second, fixed-order pass sums the
// chunks' partials and applies the down epilogue (so, bo, cast), so the
// sum order never depends on scheduling; partials are (chunks, M, N) f32.
// Its f32 form (fused_mlp_f32, a tensor-parallel rank's ff slice) stops
// after the scale: no bias, no cast, for the ranks' f32 all-reduce.
//
// Row independence: FC comes from the widths alone (fused_mlp.launch_plan,
// 512 at ff 4096), both tiles accumulate each element's K chunks and its
// FC-deep down-projection chunk in ascending 16-deep HMMAs from zero, and
// the reduce pass adds the same ff / FC partials in the same order, so a
// row's output does not depend on M or on the tile. CL only spreads a
// chunk over more SMs (the wrapper raises it while the grid is short of
// the card): it moves no sum.
//
// Words are read in place with a row stride per matrix (ldw_i, ldw_g,
// ldw_o >= the logical widths), so a tile-padded `tiled` pack runs with
// no copy; x past K and h past ff are zero, so padded rows add nothing.
// Two tiles (the block-shape tuner's fused plan names one), the fastest
// of the candidates timed on the H100 (PERF.md §6): the decode tile is BM
// 16 with 8 warps of 16 x 8 and 64-column strips, 8 stages; the prefill
// and evaluation tile BM 64 with 8 warps (2 x 4) of 32 x 32 and 128-column
// strips, 3 stages. At FC 1024 the h slice
// (129 KB) left one block an SM and ran 1.2x slower at M 8192; 64-row
// warp tiles and 128-row blocks were slower too.
#include "ternary_tiles.cuh"

#include <cooperative_groups.h>

using ternary::APAD;
using ternary::BK;
using ternary::BKW;
using ternary::XLD;
using ternary::bf16;

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 0) return v / (1.0f + expf(-v));   // silu
  if (act == 1) return v > 0.0f ? v : 0.0f;     // relu
  return v;                                     // none
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared memory of one block: the nibble table, the h slice (row stride
// FC + APAD), then the ring.
template <int BM, int BNS, int STAGES, int NT>
struct MlpSmem {
  static constexpr int LUT = 128;
  static constexpr int X = BM * XLD * 2;
  static constexpr int STAGE = X + NT * BKW * BNS * 4;
  static constexpr int RING = STAGES * STAGE;
  __host__ __device__ static constexpr int h_bytes(int fc) {
    return round_up(BM * (fc + APAD) * 2, 128);
  }
  __host__ __device__ static constexpr int bytes(int fc) {
    return LUT + h_bytes(fc) + RING;
  }
};

// h of one hidden column gf from its up (yi) and gate (yg) accumulators,
// rounded as the plain chain rounds; zero past ff.
__device__ __forceinline__ float hidden(float yi, float yg, int gf, int FF,
                                        bool gated,
                                        const float* __restrict__ si,
                                        const float* __restrict__ bi,
                                        const float* __restrict__ sg,
                                        const float* __restrict__ bg,
                                        int act) {
  if (gf >= FF) return 0.0f;
  yi = ternary::round_bf16(ternary::epilogue_f32(yi, gf, si, bi, 0, 0.0f));
  if (!gated) return activate(yi, act);
  yg = ternary::round_bf16(ternary::epilogue_f32(yg, gf, sg, bg, 0, 0.0f));
  return ternary::round_bf16(activate(yg, act)) * yi;
}

// Cluster exchange of the h slices (cluster size CL > 1): after the
// barrier every peer's slice of hw columns is final; copy it into the same
// columns here. The kernel's barrier at exit keeps each block's h alive
// while its peers read it.
template <int BM>
__device__ __forceinline__ void exchange_h(bf16* hs, int HLD, int hw,
                                           int rank, int CL) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  constexpr int V = 8;                          // bf16 per 16-byte copy
  const int per_row = hw / V;
  for (int q = 0; q < CL; ++q) {
    if (q == rank) continue;
    const bf16* peer = cluster.map_shared_rank(hs, q);
    for (int i = threadIdx.x; i < BM * per_row; i += blockDim.x) {
      const int r = i / per_row, c = q * hw + (i % per_row) * V;
      *reinterpret_cast<uint4*>(hs + r * HLD + c) =
          *reinterpret_cast<const uint4*>(peer + r * HLD + c);
    }
  }
}

template <int BM, int WARPS_M, int WARPS_N, int FN, int STAGES, bool GATED>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
fused_mlp_kernel(const bf16* __restrict__ x, const uint32_t* __restrict__ wi,
                 const uint32_t* __restrict__ wg,
                 const uint32_t* __restrict__ wo,
                 const float* __restrict__ si, const float* __restrict__ bi,
                 const float* __restrict__ sg, const float* __restrict__ bg,
                 float* __restrict__ partial, int M, int K, int FF, int N,
                 int kw1, int kw2, int ldw_i, int ldw_g, int ldw_o, int FC,
                 int CL, int act, int vec) {
  constexpr int NT = GATED ? 2 : 1;
  constexpr int FM = BM / (16 * WARPS_M);
  constexpr int BNS = WARPS_N * FN * 8;        // strip width
  static_assert(FM * 16 * WARPS_M == BM, "BM must split into 16-row frags");
  using S = MlpSmem<BM, BNS, STAGES, NT>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(smem + S::LUT);
  unsigned char* ring = smem + S::LUT + S::h_bytes(FC);
  const int HLD = FC + APAD;

  const int chunk = blockIdx.x / CL, f0 = chunk * FC;
  const int rank = blockIdx.x % CL;             // == the cluster block rank
  const int hw = FC / CL, hbase = rank * hw;    // this block's h columns
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nk1 = (K + BK - 1) / BK;            // stage 1: K steps a strip
  const int nk2 = FC / BK;                      // stage 2: K steps a strip
  const int steps1 = (hw / BNS) * nk1;
  const int nstrips = (N + BNS - 1) / BNS;      // down-projection strips
  const int mine = rank < nstrips ? (nstrips - rank + CL - 1) / CL : 0;
  const int steps = steps1 + mine * nk2;

  auto xs = [&](int s) { return reinterpret_cast<bf16*>(ring + s * S::STAGE); };
  auto ws = [&](int s) {
    return reinterpret_cast<uint32_t*>(ring + s * S::STAGE + S::X);
  };
  auto load = [&](int step) {
    const int s = step % STAGES;
    if (step < steps1) {
      const int c0 = f0 + hbase + (step / nk1) * BNS, kt = step % nk1;
      ternary::ring_stage_x<BM>(xs(s), x, m0, kt * BK, M, K, K, vec);
      ternary::ring_stage_words<BNS>(ws(s), wi, kt * BKW, c0, kw1, ldw_i,
                                     ldw_i, vec);
      if (GATED)
        ternary::ring_stage_words<BNS>(ws(s) + BKW * BNS, wg, kt * BKW, c0,
                                       kw1, ldw_g, ldw_g, vec);
    } else {
      const int s2 = step - steps1;
      ternary::ring_stage_words<BNS>(ws(s), wo, f0 / 16 + (s2 % nk2) * BKW,
                                     (rank + (s2 / nk2) * CL) * BNS, kw2,
                                     ldw_o, ldw_o, vec);
    }
  };

  ternary::fill_nibble_lut(lut);
  float acc[NT][FM][FN][4];
  ternary::zero_frags(acc);
  float(&acc0)[1][FM][FN][4] =
      *reinterpret_cast<float(*)[1][FM][FN][4]>(&acc[0]);
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    ternary::cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    if (CL > 1 && step == steps1) exchange_h<BM>(hs, HLD, hw, rank, CL);
    ternary::cp_async_wait<STAGES - 2>();
    __syncthreads();    // step's stage (and h, at stage 2) visible to all
    if (step + STAGES - 1 < steps) load(step + STAGES - 1);
    ternary::cp_async_commit();
    const int s = step % STAGES;
    if (step < steps1) {
      // ---- stage 1: strip f of h = act(x@Wg) * (x@Wi), into smem ----
      ternary::mma_step_2bit<FM, FN, BNS, NT>(
          acc, xs(s) + wm * FM * 16 * XLD, XLD, ws(s) + wn * FN * 8, BKW,
          lut);
      if (step % nk1 == nk1 - 1) {
        const int cl0 = hbase + (step / nk1) * BNS + wn * FN * 8;
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wm * FM * 16 + i * 16 + h * 8 + g;
              const int cl = cl0 + j * 8 + 2 * t;
              const float h0 = hidden(acc[0][i][j][2 * h],
                                      acc[NT - 1][i][j][2 * h], f0 + cl, FF,
                                      GATED, si, bi, sg, bg, act);
              const float h1 = hidden(acc[0][i][j][2 * h + 1],
                                      acc[NT - 1][i][j][2 * h + 1],
                                      f0 + cl + 1, FF, GATED, si, bi, sg, bg,
                                      act);
              *reinterpret_cast<__nv_bfloat162*>(hs + r * HLD + cl) =
                  __floats2bfloat162_rn(h0, h1);
            }
        ternary::zero_frags(acc);
      }
    } else {
      // ---- stage 2: strip of partial[chunk] = h[:, chunk] @ Wo[chunk] ----
      const int s2 = step - steps1, kt = s2 % nk2;
      ternary::mma_step_2bit<FM, FN, BNS, 1>(
          acc0, hs + wm * FM * 16 * HLD + kt * BK, HLD, ws(s) + wn * FN * 8,
          BKW, lut);
      if (kt == nk2 - 1) {
        const int c0 = (rank + (s2 / nk2) * CL) * BNS + wn * FN * 8;
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int gr = m0 + wm * FM * 16 + i * 16 + h * 8 + g;
              const int gc = c0 + j * 8 + 2 * t;
              if (gr >= M || gc >= N) continue;
              float* p = partial + ((size_t)chunk * M + gr) * N + gc;
              if (gc + 1 < N && (N & 1) == 0) {
                *reinterpret_cast<float2*>(p) =
                    make_float2(acc[0][i][j][2 * h], acc[0][i][j][2 * h + 1]);
              } else {
                p[0] = acc[0][i][j][2 * h];
                if (gc + 1 < N) p[1] = acc[0][i][j][2 * h + 1];
              }
            }
        ternary::zero_frags(acc);
      }
    }
  }
  ternary::cp_async_wait<0>();
  if (CL > 1) {
    // a block with no strip of the output still meets its peers at the
    // exchange's barrier, then at the exit's
    if (steps == steps1) cooperative_groups::this_cluster().sync();
    cooperative_groups::this_cluster().sync();
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
  y[idx] = __float2bfloat16(
      ternary::epilogue_f32(acc, (int)(idx % N), so, bo, 0, 0.0f));
}

// The f32 form of the same pass for a row-split tensor-parallel shard:
// the same fixed-order sum and scale, no bias, no cast (the caller sums
// the ranks' partials in f32, then adds the bias and casts).
__global__ void fused_mlp_reduce_f32_kernel(const float* __restrict__ partial,
                                            const float* __restrict__ so,
                                            float* __restrict__ y, int chunks,
                                            int M, int N) {
  const size_t total = (size_t)M * N;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float acc = 0.0f;
  for (int c = 0; c < chunks; ++c) acc += partial[(size_t)c * total + idx];
  y[idx] = ternary::epilogue_f32(acc, (int)(idx % N), so, nullptr, 0, 0.0f);
}

template <int BM, int WARPS_M, int WARPS_N, int FN, int STAGES, bool GATED>
static int launch(const void* x, const void* wi, const void* wg,
                  const void* wo, const void* si, const void* bi,
                  const void* sg, const void* bg, void* partial, int M, int K,
                  int FF, int N, int kw1, int kw2, int ldw_i, int ldw_g,
                  int ldw_o, int FC, int CL, int act, int vec,
                  cudaStream_t stream) {
  constexpr int BNS = WARPS_N * FN * 8;
  using S = MlpSmem<BM, BNS, STAGES, GATED ? 2 : 1>;
  if (FC <= 0 || FC % BK != 0 || CL < 1 || CL > 8 || FC % (CL * BNS) != 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = fused_mlp_kernel<BM, WARPS_M, WARPS_N, FN, STAGES, GATED>;
  const int smem = S::bytes(FC);
  static int smem_set = 0;     // the kernel's dynamic smem limit so far
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((FF + FC - 1) / FC) * CL, (M + BM - 1) / BM);
  cfg.blockDim = dim3(WARPS_M * WARPS_N * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(x),
      static_cast<const uint32_t*>(wi), static_cast<const uint32_t*>(wg),
      static_cast<const uint32_t*>(wo), static_cast<const float*>(si),
      static_cast<const float*>(bi), static_cast<const float*>(sg),
      static_cast<const float*>(bg), static_cast<float*>(partial), M, K, FF,
      N, kw1, kw2, ldw_i, ldw_g, ldw_o, FC, CL, act, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool GATED>
static int launch_tile(int bm, int strip, const void* x, const void* wi,
                       const void* wg, const void* wo, const void* si,
                       const void* bi, const void* sg, const void* bg,
                       void* partial, int M, int K, int FF, int N, int kw1,
                       int kw2, int ldw_i, int ldw_g, int ldw_o, int FC,
                       int CL, int act, int vec, cudaStream_t s) {
#define MLP_ARGS x, wi, wg, wo, si, bi, sg, bg, partial, M, K, FF, N, kw1, \
                 kw2, ldw_i, ldw_g, ldw_o, FC, CL, act, vec, s
  if (bm == 16 && strip == 64)
    return launch<16, 1, 8, 1, 8, GATED>(MLP_ARGS);
  if (bm == 64 && strip == 128)
    return launch<64, 2, 4, 4, 3, GATED>(MLP_ARGS);
#undef MLP_ARGS
  return (int)cudaErrorInvalidValue;
}

// x (M, K) bf16; wi, wg (kw1, ldw_i / ldw_g) and wo (kw2, ldw_o) int32
// words of which the first FF (wi, wg) and N (wo) columns are read.
// (bm, strip) names a tile, as fused_mlp.TILES: (16, 64), 8 warps of 16 x
// 8; or (64, 128), 8 warps of 32 x 32 (cudaErrorInvalidValue for another
// tile). FC (a multiple of 64)
// hidden columns a chunk, each chunk spread over a cluster of CL blocks
// (1 to 8, FC a multiple of CL strips). ``partial`` holds ceil(FF / FC) *
// M * N floats. act: 0 silu, 1 relu, 2 none. Returns the cudaError_t of
// the launches (0 = success).
static int fused_mlp_run(const void* x, const void* wi, const void* wg,
                         const void* wo, const void* si, const void* bi,
                         const void* sg, const void* bg, const void* so,
                         const void* bo, void* partial, void* y, int M, int K,
                         int FF, int N, int kw1, int kw2, int ldw_i,
                         int ldw_g, int ldw_o, int FC, int CL, int act,
                         int bm, int strip, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = (K % 8 == 0) && (ldw_i % 4 == 0) && (ldw_g % 4 == 0) &&
                  (ldw_o % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(wi) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(wg) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(wo) % 16 == 0);
  const int err =
      wg != nullptr
          ? launch_tile<true>(bm, strip, x, wi, wg, wo, si, bi, sg, bg,
                              partial, M, K, FF, N, kw1, kw2, ldw_i, ldw_g,
                              ldw_o, FC, CL, act, vec, s)
          : launch_tile<false>(bm, strip, x, wi, wg, wo, si, bi, sg, bg,
                               partial, M, K, FF, N, kw1, kw2, ldw_i, ldw_g,
                               ldw_o, FC, CL, act, vec, s);
  if (err != 0) return err;
  const int chunks = (FF + FC - 1) / FC;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (out_f32)
    fused_mlp_reduce_f32_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const float*>(partial), static_cast<const float*>(so),
        static_cast<float*>(y), chunks, M, N);
  else
    fused_mlp_reduce_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const float*>(partial), static_cast<const float*>(so),
        static_cast<const float*>(bo), static_cast<bf16*>(y), chunks, M, N);
  return (int)cudaGetLastError();
}

extern "C" int fused_mlp_bf16(const void* x, const void* wi, const void* wg,
                              const void* wo, const void* si, const void* bi,
                              const void* sg, const void* bg, const void* so,
                              const void* bo, void* partial, void* y, int M,
                              int K, int FF, int N, int kw1, int kw2,
                              int ldw_i, int ldw_g, int ldw_o, int FC, int CL,
                              int act, int bm, int strip, void* stream) {
  return fused_mlp_run(x, wi, wg, wo, si, bi, sg, bg, so, bo, partial, y, M,
                       K, FF, N, kw1, kw2, ldw_i, ldw_g, ldw_o, FC, CL, act,
                       bm, strip, 0, stream);
}

// The f32 form: y (M, N) float32, the down projection scaled by so, no
// bias (bo is not read). Everything before the partial-sum pass is the
// bf16 form's.
extern "C" int fused_mlp_f32(const void* x, const void* wi, const void* wg,
                             const void* wo, const void* si, const void* bi,
                             const void* sg, const void* bg, const void* so,
                             void* partial, void* y, int M, int K, int FF,
                             int N, int kw1, int kw2, int ldw_i, int ldw_g,
                             int ldw_o, int FC, int CL, int act, int bm,
                             int strip, void* stream) {
  return fused_mlp_run(x, wi, wg, wo, si, bi, sg, bg, so, nullptr, partial,
                       y, M, K, FF, N, kw1, kw2, ldw_i, ldw_g, ldw_o, FC, CL,
                       act, bm, strip, 1, stream);
}
