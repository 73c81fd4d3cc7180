// Flash attention over full sequences for Hopper (sm_90a), bf16 in and out:
//   o = softmax(q k^T / sqrt(hd), causal or full) v, f32 statistics.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_pallas
// (line 83; its _kernel body at line 32, the pallas_call at line 102).
//
// What bounds it on the H100: operations, and the exponentials beside them.
// A causal pass over (BH, S, hd) does 2*BH*S^2*hd flops in QK^T and PV
// together (half of the full square's 4*BH*S^2*hd) against 4*BH*S*hd*2
// bytes of q, k, v and o: at the evaluation's shape (BH 128, S 1024, hd 64)
// 17.2 GFLOP, ~17 us at 989 TFLOP/s, over 67 MB, ~20 us at 3.35 TB/s. At
// hd 64 the BH*S^2/2 exponentials (one per score, on the SFU) take about
// as long again as the products, so the tensor cores must run while other
// warps do the softmax, and scores and the accumulator never leave the SM.
// The design answers with asynchronous products (wgmma) fed by copies no
// thread issues (TMA), and at hd 64 with two blocks on each SM, so that
// four warpgroups take turns at the tensor cores and the SFU.
//
// Design: one block of three roles per (bh, 128-row query tile).
//   * A producer warp (warp 8, one lane) copies with the Tensor Memory
//     Accelerator: the block's q tile once, then each BN-key K tile and V
//     tile into a ring of STAGES shared-memory stages. Each stage has a
//     "full" mbarrier for K and one for V, armed with the tile's bytes and
//     completed by the copies, and an "empty" one on which every consumer
//     warp arrives once it is done with the stage. The maps are 3-D over
//     (hd, S, BH), so a box that runs past S is zero-filled by the copy
//     and never reaches the next head's rows. Boxes are 64 columns (128
//     bytes) wide under the 128-byte swizzle; hd 128 takes two.
//   * Two consumer warpgroups (warps 0-3 and 4-7), 64 query rows each, loop
//     over the K/V tiles with the online-softmax state in registers:
//     S = q k^T by wgmma m64nBNk16, both operands read from shared memory
//     through descriptors (K-major, 128-byte swizzle); then the mask, only
//     on tiles that cross the diagonal or Skv (keys >= Skv, and keys after
//     the row when causal, get the finite -1e30; a row still fully masked
//     takes 0 as its offset, so its p is exp2(-1e30 * scale) = 0, and a
//     later tile's correction exp2((-1e30 - m) * scale) = 0, never a NaN);
//     the row max, correction and exponentials in f32 across the quad of
//     lanes that shares a row;
//     p rounded to bf16 straight from the S accumulators into the A
//     registers of O += P V (the Pallas kernel's p.astype(v.dtype)), a
//     wgmma m64n64k16 with A from registers and B = V read MN-major
//     (transposed by the instruction, so V keeps its (keys, hd) layout).
//     l sums the f32 p. The exponentials are 2^x (ex2.approx.ftz) of the
//     score times log2(e)/sqrt(hd) less the row max times the same, in one
//     FFMA.
//   * Tiles (FLASH_TILES, chosen on the H100; PERF.md section 6): hd 64
//     takes 64-key tiles, 3 stages and two blocks an SM (90 registers);
//     hd 128 128-key tiles, 2 stages and one block. Issuing tile j's
//     scores while tile j - 1's PV product runs, and the two warpgroups'
//     products in turns, were slower in every run.
//   * Causal: K/V tiles that start after the tile's last query row are
//     never loaded (the Pallas kernel's @pl.when skip), and a warpgroup
//     stops at its own last row. Heavy query tiles first: blockIdx.y runs
//     the query tiles from the last (the most keys) to the first, and
//     blocks start in linear order with blockIdx.x = bh fastest, so every
//     head's longest tile is in the first waves and the short ones fill
//     the tail. That needs no tile counter, which a persistent grid would.
//   * The epilogue writes acc / max(l, 1e-30) rounded once to bf16 from
//     registers, rows past Sq skipped.
// No thread waits on another except through the barriers: one
// __syncthreads publishes them, before the roles split. A barrier wait over
// two minutes traps (tma::mbar_wait). ptxas serializes the wgmmas of a
// kernel (C7520) when it cannot prove a branch around them warp-uniform or
// finds a barrier wait between the fence and a wgmma; -Xptxas -v says so.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "tma.cuh"

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;              // query rows per block
constexpr int CONSUMERS = 2;         // warpgroups of 64 query rows each
constexpr int THREADS = (CONSUMERS * 4 + 1) * 32;   // + the producer warp
constexpr int BOX_COLS = 64;         // hd columns per box (128-byte rows)
constexpr float NEG_INF = -1e30f;    // flash_attention.py NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

// The tile of each head dim: (head dim, keys per K/V tile, ring stages,
// blocks an SM); flash_attention.py TILES holds the same.
#define FLASH_TILES(X) X(64, 64, 3, 2) X(128, 128, 2, 1)

// Shared memory, from a 1024-byte aligned base (the swizzle's period): q
// (HD / 64 boxes of BM rows), STAGES K tiles, STAGES V tiles (each HD / 64
// boxes of BN rows), then the barriers (q, K full, V full, empty).
template <int HD, int BN, int STAGES>
struct FlashSmem {
  static constexpr int Q = BM * HD * 2;        // bytes
  static constexpr int KV = BN * HD * 2;       // bytes of one K or V tile
  static constexpr int K_OFF = Q;
  static constexpr int V_OFF = K_OFF + STAGES * KV;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV;
  static constexpr int BYTES = BAR_OFF + (1 + 3 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;   // room to align the base
  static_assert(BN * 128 % 1024 == 0, "box alignment");
};

// A wgmma shared-memory descriptor of a tile of 128-byte rows under the
// 128-byte swizzle, 8-row groups 1024 bytes apart (SBO). K-major operands
// (q, K) ignore LBO; the MN-major V reads it as the distance between
// 64-column boxes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p,
                                               uint32_t lbo_bytes) {
  return (uint64_t)((tma::smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16 |
         (uint64_t)(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (m64 x n64, f32) (+)= A (64 x 16, smem) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n128, f32) (+)= A (64 x 16, smem) * B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n64, f32) += A (64 x 16, bf16 registers: the m16n8k16 A
// fragment of the warp's 16 rows) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// two values as one bf16x2 register, lo in the low half (lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// lane 0 arrives on `bar`, by a predicate rather than a branch
__device__ __forceinline__ void arrive_if_lane0(uint64_t* bar, int lane) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          tma::smem_addr(bar)),
      "r"(lane)
      : "memory");
}

// 2^x on the SFU, subnormal results flushed to 0 (exp2f adds a range fix-up
// of three instructions around the same MUFU.EX2)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int HD, int BN, int STAGES, int BLOCKS>
__global__ void __launch_bounds__(THREADS, BLOCKS)
flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       bf16* __restrict__ o, int Sq, int Skv, int causal,
                       float scale_log2) {
  using S = FlashSmem<HD, BN, STAGES>;
  constexpr int BOXES = HD / BOX_COLS;
  constexpr int NS = BN / 2;           // S accumulators a thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (tma::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;
  auto ks = [&](int s) { return smem + S::K_OFF + s * S::KV; };
  auto vs = [&](int s) { return smem + S::V_OFF + s * S::KV; };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heavy tiles first
  const int kv_end = causal ? min(Skv, q0 + BM) : Skv;
  const int n_tiles = (kv_end + BN - 1) / BN;
  // the warp index broadcast from lane 0, so that the compiler knows every
  // branch on a role or a warpgroup to be warp-uniform: a wgmma in a path
  // it takes for divergent is serialized (ptxas C7520)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  // tile j into stage j % STAGES, once the consumers have freed it: a
  // stage's r-th use waits for phase r of its barriers (parity r & 1), and
  // a fresh barrier counts the phase of parity 1 as completed
  auto issue = [&](int j) {
    const int s = j % STAGES;
    tma::mbar_wait(empty + s, ((j / STAGES) & 1) ^ 1);
    tma::mbar_arrive_expect_tx(kfull + s, S::KV);
#pragma unroll
    for (int b = 0; b < BOXES; ++b)
      tma::load_3d(ks(s) + b * BN * 128, &kmap, b * BOX_COLS, j * BN, bh,
                   kfull + s);
    tma::mbar_arrive_expect_tx(vfull + s, S::KV);
#pragma unroll
    for (int b = 0; b < BOXES; ++b)
      tma::load_3d(vs(s) + b * BN * 128, &vmap, b * BOX_COLS, j * BN, bh,
                   vfull + s);
  };

  // The producer's lane 0 sets up the barriers and has q and the first
  // ring's copies in flight before the block's one barrier.
  const bool producer = warp == CONSUMERS * 4;
  int j = 0;
  if (producer && lane == 0) {
    tma::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      tma::mbar_init(kfull + s, 1);
      tma::mbar_init(vfull + s, 1);
      tma::mbar_init(empty + s, CONSUMERS * 4);
    }
    tma::mbar_init_fence();
    tma::mbar_arrive_expect_tx(qbar, S::Q);
#pragma unroll
    for (int b = 0; b < BOXES; ++b)
      tma::load_3d(smem + b * BM * 128, &qmap, b * BOX_COLS, q0, bh, qbar);
    for (; j < min(STAGES, n_tiles); ++j) issue(j);
  }
  __syncthreads();      // the last block-wide barrier
  if (producer) {
    if (lane != 0) return;
    for (; j < n_tiles; ++j) issue(j);
    return;
  }

  const int wg = warp / 4;
  const int wq0 = q0 + wg * 64;          // this warpgroup's first row
  const int g = lane >> 2, t = lane & 3;
  const int row0 = wq0 + (warp % 4) * 16 + g;   // this lane's rows: row0,
                                                 // row0 + 8
  // causal: the warpgroup's last tile holds its last row's key (at most
  // one tile short of the block's, so no stage waits for its release)
  const int n_mine =
      causal ? (min(Skv, wq0 + 64) + BN - 1) / BN : n_tiles;
  const unsigned char* qs = smem + wg * 64 * 128;

  float sacc[NS];
  float oacc[BOXES][32];
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int i = 0; i < NS; ++i) sacc[i] = 0.0f;
#pragma unroll
  for (int b = 0; b < BOXES; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[b][i] = 0.0f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.0f, 0.0f};         // this lane's share of the row sum

  // The products are issued after their tiles' barriers were waited for
  // and the fence: a wait between the fence and a wgmma serializes them.
  // S = q k^T of tile j over hd in 16-deep steps (32 bytes along a
  // 128-byte row), issued as one group.
  auto wait_k = [&](int j) {
    tma::mbar_wait(kfull + j % STAGES, (j / STAGES) & 1);
  };
  auto wait_v = [&](int j) {
    tma::mbar_wait(vfull + j % STAGES, (j / STAGES) & 1);
  };
  auto issue_s = [&](int j) {
    const int s = j % STAGES;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int b = kk / 4, off = (kk % 4) * 32;
      wgmma_ss(sacc, sw128_desc(qs + b * BM * 128 + off, 16),
               sw128_desc(ks(s) + b * BN * 128 + off, 16), kk);
    }
    wgmma_commit();
  };
  // O += P V of tile j, 16 keys (16 rows of 128 bytes) a step, one group
  auto issue_pv = [&](int j) {
    const int s = j % STAGES;
#pragma unroll
    for (int c = 0; c < BN / 16; ++c)
#pragma unroll
      for (int b = 0; b < BOXES; ++b)
        wgmma_rs(oacc[b], pa[c],
                 sw128_desc(vs(s) + b * BN * 128 + c * 16 * 128, BN * 128));
    wgmma_commit();
  };
  auto release = [&](int j) {
    __syncwarp();
    arrive_if_lane0(empty + j % STAGES, lane);
  };
  // Tile j's mask, row max and correction; sacc becomes p (f32) in place
  // and sum its row sums.
  auto softmax = [&](int j, float (&corr)[2], float (&sum)[2]) {
    const int kv0 = j * BN;
    // element i: row row0 + 8 * ((i / 2) % 2), key kv0 + 8 * (i / 4) +
    // 2t + i % 2; masked only where the tile crosses Skv or the diagonal
    if (kv0 + BN > Skv || (causal && kv0 + BN - 1 > wq0)) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int row = row0 + 8 * ((i >> 1) & 1);
        const int key = kv0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (key >= Skv || (causal && key > row)) sacc[i] = NEG_INF;
      }
    }
    float mx[2] = {m_run[0], m_run[1]}, mb[2];
#pragma unroll
    for (int i = 0; i < NS; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      corr[h] = exp2_ftz((m_run[h] - mx[h]) * scale_log2);
      m_run[h] = mx[h];
      // a row masked so far keeps its p at 0 here: -1e30 * scale_log2
      // less its own rounding could leave a huge remainder in the FFMA
      mb[h] = mx[h] == NEG_INF ? 0.0f : mx[h] * scale_log2;
      sum[h] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      sacc[i] = exp2_ftz(fmaf(sacc[i], scale_log2, -mb[(i >> 1) & 1]));
      sum[(i >> 1) & 1] += sacc[i];
    }
  };
  // fold tile j's statistics into the running ones, and p (bf16) into the
  // A registers of the PV product: chunk c holds keys 16c .. 16c + 15
  auto rescale_pack = [&](const float (&corr)[2], const float (&sum)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + sum[h];
#pragma unroll
    for (int b = 0; b < BOXES; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[b][i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      pa[c][0] = pack_bf16(sacc[8 * c], sacc[8 * c + 1]);      // row g
      pa[c][1] = pack_bf16(sacc[8 * c + 2], sacc[8 * c + 3]);  // row g + 8
      pa[c][2] = pack_bf16(sacc[8 * c + 4], sacc[8 * c + 5]);  // row g
      pa[c][3] = pack_bf16(sacc[8 * c + 6], sacc[8 * c + 7]);  // row g + 8
    }
  };

  float corr[2], sum[2];
  tma::mbar_wait(qbar, 0);
  for (j = 0; j < n_mine; ++j) {
    wait_k(j);
    wgmma_fence();
    issue_s(j);
    wgmma_wait_all();
    softmax(j, corr, sum);
    rescale_pack(corr, sum);
    wait_v(j);
    wgmma_fence();
    issue_pv(j);
    wgmma_wait_all();
    release(j);
  }

  const float l0 = fmaxf(quad_sum(l_run[0]), 1e-30f);
  const float l1 = fmaxf(quad_sum(l_run[1]), 1e-30f);
  bf16* ob = o + (size_t)bh * Sq * HD;
#pragma unroll
  for (int b = 0; b < BOXES; ++b)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = b * BOX_COLS + n * 8 + 2 * t;
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * HD + col) =
            pack_bf16(oacc[b][4 * n] / l0, oacc[b][4 * n + 1] / l0);
      if (row0 + 8 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)(row0 + 8) * HD + col) =
            pack_bf16(oacc[b][4 * n + 2] / l1, oacc[b][4 * n + 3] / l1);
    }
}

template <int HD, int BN, int STAGES, int BLOCKS>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int BH, int Sq, int Skv, int causal, float scale,
                  cudaStream_t stream) {
  using S = FlashSmem<HD, BN, STAGES>;
  CUtensorMap qmap, kmap, vmap;
  memset(&qmap, 0, sizeof(qmap));
  memset(&kmap, 0, sizeof(kmap));
  memset(&vmap, 0, sizeof(vmap));
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!(encode_3d(&qmap, bf, q, BH, Sq, HD, 2, BM, BOX_COLS, sw) &&
        encode_3d(&kmap, bf, k, BH, Skv, HD, 2, BN, BOX_COLS, sw) &&
        encode_3d(&vmap, bf, v, BH, Skv, HD, 2, BN, BOX_COLS, sw)))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel<HD, BN, STAGES, BLOCKS>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::ALLOC);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (Sq + BM - 1) / BM);
  kernel<<<grid, THREADS, S::ALLOC, stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), Sq, Skv, causal,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

// q (BH, Sq, hd), k and v (BH, Skv, hd), o (BH, Sq, hd): contiguous bf16,
// 16-byte aligned; Skv >= 1; hd one of FLASH_TILES. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int BH, int Sq,
                                    int Skv, int hd, int causal, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || Sq <= 0 || Skv <= 0 || (Sq + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
#define FLASH_LAUNCH(HD_, BN_, ST_, BL_)                                  \
  if (hd == HD_)                                                          \
    return launch<HD_, BN_, ST_, BL_>(q, k, v, o, BH, Sq, Skv, causal,      \
                                      scale, s);
  FLASH_TILES(FLASH_LAUNCH)
#undef FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}
