// 3xTF32 GEMM for Hopper (sm_90a) on wgmma and TMA: every DST product at
// spectral_precision=HIGH.
//
// It replaces the reference's HIGH products: hp_dot_general at
// Precision.HIGH (cfd_tpu/ops/pallas/rolling.py:42-70, the bf16_3x split
// Mosaic lowers for HIGH) inside ProjectionKernels.pred_bt / corr_bwd
// (plane_dot_rl, cfd_tpu/ops/pallas/projection_kernels.py:226-250) and
// the 2D block_dot (cfd_tpu/ops/pallas/projection2d.py:97-106), and the
// XLA einsums at HIGH of the decomposed and eigen pipelines
// (cfd_tpu/solvers/poisson/spectral.py:386-391, :645-661).  One entry
// launches it: cfd_sgemm_3xtf32_batched, row-major C[b] = A[b] (M x K) *
// B[b] (K x N) with leading dimensions and batch strides, a zero stride
// sharing one matrix across the batch, column slices read and written in
// place through lda, ldb and ldc (rolling.plane_dot, right_dot,
// left_dot).  cfd_sgemm_3xtf32_plan reports a launch's tile, CTAs, tiles
// and D(K).
//
// The split.  On Hopper the bf16_3x split is TF32: each fp32 operand
// becomes big = rna_tf32(a) and small = rna_tf32(a - big) (a - big is
// exact in fp32), and each product is small*big + big*small + big*big in
// fp32, the dropped small*small term and small's own rounding about 2^-22
// relative (rolling.matmul_plain(..., "high") is the plain version).
// Each element is split once: A's in shared memory, B's in registers.
//
// The sum order, a function of K alone.  The k axis is cut into stages
// of kStageK = 32 (the ragged tail zero-filled), and each stage is one
// chunk (D = kStageK whatever K): the tensor core sums a chunk from zero,
// its small terms first (small_B*big_A, then big_B*small_A, k-steps of 8
// ascending), then its big*big terms; one IEEE add takes the chunk into
// an fp32 running sum, chunks in ascending k.  The tensor core does not
// round its fp32 sums to nearest (adding every product into the running
// sum made the error grow with the depth, 2.6e-5 * max at K = 2048), so
// the chunk is kept short and its small terms are summed while the
// partial is small.  Nothing else enters the order: not M, N, the batch
// or the tile, not the CTA count or the load path, so a row slice's,
// a plane block's and a column slice's products are those rows, planes
// and columns of the whole one.  rolling.high_sum_order mirrors it.
//
// Bound: 3 * 2 * M * N * K operations at the dense TF32 tensor-core rate
// (494.7 TFLOP/s on an H100 SXM at 700 W); at the small shapes (the 4y
// shards', the 128^2 x-DST) the operands and the output at 3.35 TB/s
// come close.  At the tensor rate the shared memory is the other limit:
// wgmma reads its shared operand at 64 bytes a cycle of the SM's 128, and
// the stage's loads, split and fragment reads take most of the rest.
//
// Design.  C^T = B^T * A^T, as the one-pass TF32 GEMM (gemm_tf32.cu):
// tf32 wgmma reads only K-major shared operands, and A (M x K,
// row-major) is K-major while B is not.  One CTA an SM, 384 threads:
// warpgroup 0 the producer, warpgroups 1 and 2 the consumers
// (setmaxnreg: 40 and 232 registers, within the launch's pool of 384 x
// 168).  One producer thread keeps TMA loads in flight into a ring of
// stages (A's BM x 32 tile with the 128-byte swizzle, B's 32 x 128 tile
// in rows padded to 136 floats), full / split / empty mbarriers; producer
// warps 1-3 split each landed A tile once, big in place and small into
// the stage's second A tile (fence.proxy.async before wgmma reads them).
// A consumer warpgroup owns 64 output columns: it reads its B fragments
// once a stage and splits them in registers (wgmma's register operand),
// then issues the chunk's twelve m64nBMk8 wgmmas (four small*big, four
// big*small, four big*big) into one accumulator, waits, and adds it into
// its running sum; while it adds, the other warpgroup's wgmmas keep the
// tensor cores busy.  The tile follows the shape (plan_launch): 128 x 128
// (4 stages of 49 KB), or 64 x 128 (6 stages of 33 KB) where the smaller
// tile fills the card's SMs clearly better over its waves (the 4y shards'
// 512-row products: 64 tiles of 128 x 128 on 132 SMs).  Every launch is
// persistent: a CTA walks tiles in steps of the grid, the dimension with
// fewer tiles fastest (its neighbours share the larger operand's tile in
// L2), so the producer loads the next tile while the consumers store the
// last one straight from their registers.  Operands whose base, leading
// dimension or batch stride is not a multiple of 16 bytes cannot use
// TMA: the same mainloop takes them through 4-byte cp.async copies by the
// whole producer warpgroup into the same layouts, zeros outside the
// operands, which the wrappers count apart (rolling's
// high_cp_async_launches).  The DST factors whose rows are off 16 bytes
// are stored padded (spectral._tma_rows), so no main-path launch takes
// them.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "async_copy.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kStageK = 32;  // k depth of a stage (A's 128-byte rows)
constexpr int kChunkK = kStageK;  // D: one chunk a stage, whatever K
constexpr int kBN = 128;          // tile columns
constexpr int kThreads = 384;
constexpr int kConsumerWarps = 8;
constexpr int kSplitWarps = 3;      // producer warps 1-3 (TMA path)
constexpr int kBStride = kBN + 8;   // 136: (8 t + g) mod 32 distinct
constexpr int kBFloats = kStageK * kBStride;
constexpr int kBBytes = kBFloats * 4;
// the 64-row tile is taken where it keeps this much more of the SMs busy
// over its waves than the 128-row one
constexpr double kSmallTileGain = 1.25;

// a tile of kBM rows: A's stage kBM x 32 floats, twice (big, small)
template <int kBM>
struct Tile {
  static constexpr int kStages = kBM == 128 ? 4 : 6;
  static constexpr int kAFloats = kBM * kStageK;
  static constexpr int kABytes = kAFloats * 4;
  static constexpr int kAcc = kBM / 2;  // accumulator registers a thread
  static constexpr int kSmem =
      kStages * (2 * kABytes + kBBytes) + 3 * kStages * 8 + 1024;
};

struct Params {
  int M, N, K;
  const float* A;
  long long lda, sA;
  const float* B;
  long long ldb, sB;
  float* C;
  long long ldc, sC;
  int m_fast;  // the row tiles walk fastest, else the column tiles
  int tiles_fast, tiles_slow, n_tiles;  // n_tiles over the batch too
};

// A's stage split once, by `n` threads (this one `i`): big = rna(a) in
// place, small = rna(a - big) into `small`; made visible to the async
// proxy, then one arrival a warp on `done`
template <int kAFloats>
__device__ __forceinline__ void split_tile(float* big, float* small, int i,
                                           int n, uint64_t* done) {
  float4* const b4 = reinterpret_cast<float4*>(big);
  float4* const s4 = reinterpret_cast<float4*>(small);
  for (int q = i; q < kAFloats / 4; q += n) {
    const float4 v = b4[q];
    float4 hi, lo;
    hi.x = tf32_rna(v.x);
    hi.y = tf32_rna(v.y);
    hi.z = tf32_rna(v.z);
    hi.w = tf32_rna(v.w);
    lo.x = tf32_rna(v.x - hi.x);
    lo.y = tf32_rna(v.y - hi.y);
    lo.z = tf32_rna(v.z - hi.z);
    lo.w = tf32_rna(v.w - hi.w);
    b4[q] = hi;
    s4[q] = lo;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(done);
}

// the cp.async path: this thread's 4-byte copies of a stage, A into the
// 128-byte swizzle that TMA writes, B's 128 columns into its padded rows
// (the padding is never read); zeros outside the operands
template <int kBM>
__device__ __forceinline__ void copy_stage(const Params& p, int bz, int m0,
                                           int n0, int k0, float* a_tile,
                                           float* b_tile) {
  const float* const A = p.A + bz * p.sA;
  const float* const B = p.B + bz * p.sB;
  const uint32_t as = smem_u32(a_tile), bs = smem_u32(b_tile);
  for (int i = 0; i < Tile<kBM>::kAFloats / 128; ++i) {
    const int e = threadIdx.x + 128 * i, r = e >> 5, c = e & 31;
    const int gm = m0 + r, gk = k0 + c;
    const bool ok = gm < p.M && gk < p.K;
    cp_async4(as + r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2)),
              ok ? A + gm * p.lda + gk : A, ok ? 4 : 0);
  }
  for (int i = 0; i < kStageK * kBN / 128; ++i) {
    const int e = threadIdx.x + 128 * i, r = e >> 7, c = e & 127;
    const int gk = k0 + r, gn = n0 + c;
    const bool ok = gk < p.K && gn < p.N;
    cp_async4(bs + (r * kBStride + c) * 4, ok ? B + gk * p.ldb + gn : B,
              ok ? 4 : 0);
  }
}

template <int kBM, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_3xtf32_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       const Params p) {
  using T = Tile<kBM>;
  constexpr int S = T::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* const a_st = reinterpret_cast<float*>(smem);  // [S][BM][32] big
  float* const a_sm = a_st + S * T::kAFloats;          // [S][BM][32] small
  float* const b_st = a_sm + S * T::kAFloats;          // [S][32][136]
  // full: the stage landed; split: its A tile is split; empty: both
  // consumer warpgroups are done with it
  uint64_t* const full = reinterpret_cast<uint64_t*>(b_st + S * kBFloats);
  uint64_t* const split = full + S;
  uint64_t* const empty = split + S;

  const int n_st = (p.K + kStageK - 1) / kStageK;
  const int tile0 = static_cast<int>(blockIdx.x);
  const int tile_step = static_cast<int>(gridDim.x);
  const int n_it = n_st * ((p.n_tiles - tile0 + tile_step - 1) / tile_step);
  // (row tile, column tile, batch) of tile `tile`
  auto coords = [&](int tile, int& m0, int& n0, int& bz) {
    const int f = tile % p.tiles_fast, r = tile / p.tiles_fast;
    const int sl = r % p.tiles_slow;
    bz = r / p.tiles_slow;
    m0 = (p.m_fast ? f : sl) * kBM;
    n0 = (p.m_fast ? sl : f) * kBN;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // one arrival a warp (full: the TMA thread, or every copying
      // thread's cp.async completion)
      mbar_init(&full[s], kTma ? 1 : 128);
      mbar_init(&split[s], kTma ? kSplitWarps : 4);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    // (the CTA's pool is the 168 registers a thread it was launched with:
    // 128 x 40 + 256 x 232 = 384 x 168; a larger request never returns)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    // `it` counts the stages through the ring across the CTA's tiles
    if constexpr (kTma) {
      if (threadIdx.x == 0 && n_st > 0) {
        asm volatile("prefetch.tensormap [%0];" ::"l"(
                         reinterpret_cast<uint64_t>(&map_a))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];" ::"l"(
                         reinterpret_cast<uint64_t>(&map_b))
                     : "memory");
        int it = 0;
        for (int tile = tile0; tile < p.n_tiles; tile += tile_step) {
          int m0, n0, bz;
          coords(tile, m0, n0, bz);
          const int ba = p.sA != 0 ? bz : 0, bb = p.sB != 0 ? bz : 0;
          for (int st = 0; st < n_st; ++st, ++it) {
            const int s = it % S;
            mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
            mbar_expect_tx(&full[s], T::kABytes + kBBytes);
            tma_load(a_st + s * T::kAFloats, &map_a, &full[s],
                     st * kStageK, m0, ba);
            tma_load(b_st + s * kBFloats, &map_b, &full[s], n0,
                     st * kStageK, bb);
          }
        }
      } else if (threadIdx.x >= 32) {
        // warps 1-3 split each landed A tile, off the consumers' path
        for (int it = 0; it < n_it; ++it) {
          const int s = it % S;
          mbar_wait(&full[s], (it / S) & 1);
          split_tile<T::kAFloats>(a_st + s * T::kAFloats,
                                  a_sm + s * T::kAFloats, threadIdx.x - 32,
                                  32 * kSplitWarps, &split[s]);
        }
      }
      __syncwarp();
    } else {
      // every thread copies; each stage is split two stages behind its
      // copies, so that loads stay in flight
      constexpr int kLag = 2;
      static_assert(kLag < S, "the lag leaves a stage to fill");
      int tile = tile0, st = 0, m0 = 0, n0 = 0, bz = 0;
      coords(tile, m0, n0, bz);
      for (int it = 0; it < n_it + kLag; ++it) {
        if (it < n_it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          copy_stage<kBM>(p, bz, m0, n0, st * kStageK,
                          a_st + s * T::kAFloats, b_st + s * kBFloats);
          cp_async_arrive(&full[s]);
          if (++st == n_st) {
            st = 0;
            tile += tile_step;
            if (tile < p.n_tiles) coords(tile, m0, n0, bz);
          }
        }
        const int r = it - kLag;
        if (r >= 0) {
          const int s = r % S;
          mbar_wait(&full[s], (r / S) & 1);
          split_tile<T::kAFloats>(a_st + s * T::kAFloats,
                                  a_sm + s * T::kAFloats, threadIdx.x, 128,
                                  &split[s]);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int ct = threadIdx.x - 128;
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's first output column in the tile (wgmma's row)
  const int nb = 64 * (ct >> 7) + 16 * warp + g;
  constexpr int kAcc = T::kAcc;
  float acc[kAcc], run[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  int it = 0;  // the stages through the ring across the CTA's tiles

  for (int tile = tile0; tile < p.n_tiles; tile += tile_step) {
    int m0, n0, bz;
    coords(tile, m0, n0, bz);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) run[i] = 0.0f;
    for (int st = 0; st < n_st; ++st, ++it) {
      const int s = it % S;
      mbar_wait(&split[s], (it / S) & 1);
      // B's fragments, split once: big = rna(b), small = rna(b - big)
      uint32_t fb[4][4], fs[4][4];
      const float* const bs = b_st + s * kBFloats + nb;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* const r0 = bs + (8 * j + t) * kBStride;
        const float v[4] = {r0[0], r0[8], r0[4 * kBStride],
                            r0[4 * kBStride + 8]};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          fb[j][q] = tf32_bits(v[q]);
          fs[j][q] = tf32_bits(v[q] - __uint_as_float(fb[j][q]));
        }
      }
      const uint64_t d_big = smem_desc(a_st + s * T::kAFloats);
      const uint64_t d_small = smem_desc(a_sm + s * T::kAFloats);
      // the chunk from zero: small*big, big*small, then big*big, each
      // over the stage's four k-steps (descriptors 32 bytes apart)
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_k8(acc, fs[j], d_big + 2 * j, j == 0 ? 0 : 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_k8(acc, fb[j], d_small + 2 * j, 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_k8(acc, fb[j], d_big + 2 * j, 1);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      wgmma_wait<0>();
      fence_acc(acc);
      keep(fb);
      keep(fs);
      if (lane == 0) mbar_arrive(&empty[s]);
      // the chunk's sum, one IEEE add into the running sum
#pragma unroll
      for (int i = 0; i < kAcc; ++i) run[i] += acc[i];
    }
    // straight from the registers: run[4 j + 2 h + e] is C[m0 + 8 j + 2 t
    // + e][n0 + nb + 8 h]; a warp's store fills 32-byte sectors
    float* const Cb = p.C + bz * p.sC;
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gm = m0 + 8 * j + 2 * t + e;
        if (gm >= p.M) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gn = n0 + nb + 8 * h;
          if (gn < p.N) Cb[gm * p.ldc + gn] = run[4 * j + 2 * h + e];
        }
      }
  }
}

// ---- host side -------------------------------------------------------------

template <int kBM, bool kTma>
int set_smem(int dev) {
  static std::mutex mu;
  static bool done[64] = {};
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (done[dev]) return 0;
  const cudaError_t rc = cudaFuncSetAttribute(
      gemm_3xtf32_kernel<kBM, kTma>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<kBM>::kSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  done[dev] = true;
  return 0;
}

// The CTAs resident at once on the current device for each tile (SMs x
// CTAs an SM: one on an H100), cached per device.
int resident(int* slots128, int* slots64) {
  struct Occ {
    int dev, s128, s64;
  };
  static std::mutex mu;
  static Occ cache[64];
  static int n_cached = 0;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n_cached; ++i)
      if (cache[i].dev == dev) {
        *slots128 = cache[i].s128;
        *slots64 = cache[i].s64;
        return 0;
      }
  }
  int src = set_smem<128, true>(dev);
  if (src == 0) src = set_smem<64, true>(dev);
  if (src != 0) return src;
  int sms = 0, per128 = 0, per64 = 0;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per128, gemm_3xtf32_kernel<128, true>, kThreads,
        Tile<128>::kSmem);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per64, gemm_3xtf32_kernel<64, true>, kThreads, Tile<64>::kSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *slots128 = sms * per128;
  *slots64 = sms * per64;
  if (*slots128 <= 0 || *slots64 <= 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  std::lock_guard<std::mutex> lock(mu);
  cache[n_cached < 64 ? n_cached++ : 63] = {dev, *slots128, *slots64};
  return 0;
}

// the share of `slots` resident CTAs that `tiles` tiles keep busy over
// their waves
double fill(long long tiles, int slots) {
  const long long waves = (tiles + slots - 1) / slots;
  return static_cast<double>(tiles) / static_cast<double>(waves * slots);
}

struct Plan {
  int bm, tiles_m, tiles_n, m_fast, n_tiles, ctas;
};

// The tile follows the shape: 64 x 128 where it fills the resident slots
// kSmallTileGain better over its waves than 128 x 128, or where M <= 64
// (as many tiles, half the zero rows), else 128 x 128; one persistent CTA
// a slot, at most one a tile.  The sum order does not depend on it.
int plan_launch(int M, int N, int batch, Plan* pl) {
  int s128 = 0, s64 = 0;
  const int rc = resident(&s128, &s64);
  if (rc != 0) return rc;
  const long long tn = (N + kBN - 1) / kBN;
  const long long t128 = ((M + 127) / 128) * tn * batch;
  const long long t64 = ((M + 63) / 64) * tn * batch;
  if (t64 > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  pl->bm = t64 == t128 || fill(t64, s64) > kSmallTileGain * fill(t128, s128)
               ? 64
               : 128;
  const int slots = pl->bm == 64 ? s64 : s128;
  pl->tiles_m = (M + pl->bm - 1) / pl->bm;
  pl->tiles_n = static_cast<int>(tn);
  pl->m_fast = pl->tiles_m <= pl->tiles_n;
  pl->n_tiles = static_cast<int>(pl->bm == 64 ? t64 : t128);
  pl->ctas = pl->n_tiles < slots ? pl->n_tiles : slots;
  return 0;
}

template <int kBM>
int launch(const Plan& pl, bool tma, Params p, int batch,
           cudaStream_t stream) {
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  if (tma && p.K > 0) {
    int rc = encode(&ma, p.A, p.K, p.M, p.lda, p.sA != 0 ? batch : 1, p.sA,
                    kStageK, kBM, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc == 0)
      rc = encode(&mb, p.B, p.N, p.K, p.ldb, p.sB != 0 ? batch : 1, p.sB,
                  kBStride, kStageK, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc != 0) return rc;
  }
  int dev = 0;
  const cudaError_t drc = cudaGetDevice(&dev);
  if (drc != cudaSuccess) return static_cast<int>(drc);
  const int rc = tma ? set_smem<kBM, true>(dev) : set_smem<kBM, false>(dev);
  if (rc != 0) return rc;
  p.m_fast = pl.m_fast;
  p.tiles_fast = pl.m_fast ? pl.tiles_m : pl.tiles_n;
  p.tiles_slow = pl.m_fast ? pl.tiles_n : pl.tiles_m;
  p.n_tiles = pl.n_tiles;
  if (tma)
    gemm_3xtf32_kernel<kBM, true>
        <<<pl.ctas, kThreads, Tile<kBM>::kSmem, stream>>>(ma, mb, p);
  else
    gemm_3xtf32_kernel<kBM, false>
        <<<pl.ctas, kThreads, Tile<kBM>::kSmem, stream>>>(ma, mb, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// spectral_precision=HIGH: C[b] = A[b] * B[b], 3xTF32
int cfd_sgemm_3xtf32_batched(int M, int N, int K, const float* A,
                             long long lda, long long sA, const float* B,
                             long long ldb, long long sB, float* C,
                             long long ldc, long long sC, int batch,
                             cudaStream_t stream) {
  if (M <= 0 || N <= 0 || batch <= 0) return 0;
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int rc = plan_launch(M, N, batch, &pl);
  if (rc != 0) return rc;
  const bool tma = aligned16(A) && lda % 4 == 0 && aligned16(B) &&
                   ldb % 4 == 0 &&
                   (batch == 1 || (sA % 4 == 0 && sB % 4 == 0));
  const Params p = {M, N, K, A, lda, sA, B, ldb, sB, C, ldc, sC,
                    0, 0, 0, 0};
  return pl.bm == 64 ? launch<64>(pl, tma, p, batch, stream)
                     : launch<128>(pl, tma, p, batch, stream);
}

// the plan of a launch of M x N x K over `batch` on the current device:
// out[0] the tile's rows, out[1] its columns, out[2] the CTAs, out[3] the
// tiles, out[4] D(K), the depth of a chunk; 0 or a CUDA error code
int cfd_sgemm_3xtf32_plan(int M, int N, int K, int batch, int* out) {
  if (M <= 0 || N <= 0 || batch <= 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int rc = plan_launch(M, N, batch, &pl);
  if (rc != 0) return rc;
  out[0] = pl.bm;
  out[1] = kBN;
  out[2] = pl.ctas;
  out[3] = pl.n_tiles;
  out[4] = kChunkK;
  return 0;
}

}  // extern "C"
