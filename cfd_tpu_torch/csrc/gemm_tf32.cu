// One-pass TF32 GEMM for Hopper (sm_90a) on wgmma and TMA: every product
// at spectral_precision=DEFAULT.
//
// It replaces the reference's DEFAULT products: hp_dot_general at
// Precision.DEFAULT (cfd_tpu/ops/pallas/rolling.py:42), the XLA matmuls
// at lax.Precision.DEFAULT outside Pallas (cfd_tpu/solvers/poisson/
// spectral.py:705-899) and the 2D y-solve's dense rescue
// (spectral.py:299-303), which on the TPU run one bf16 MXU pass; here one
// TF32 pass.  Two entries launch it: cfd_sgemm_tf32_batched (row-major
// C[b] = A[b] (M x K) * B[b] (K x N) with leading dimensions and batch
// strides, a zero stride sharing one matrix) and cfd_rescue_tf32 (one
// product, divided by lam[i, j] with IEEE '/' in the epilogue, written
// through C's leading dimension: x^'s first K columns in place).
//
// Rounding.  Every operand is rounded to TF32 to nearest, ties away
// (cvt.rna, the plain version's rolling.tf32_rna); the products of two
// TF32 values are exact in fp32 and the sums are fp32.
//
// The sum order, a function of K alone.  The k axis is cut into stages of
// kStageK = 32 (the ragged tail zero-filled) and the stages into chunks of
// D(K) = 32 * q, q = min(kMaxChunkStages, ceil(stages / kMaxChunks)), so
// at most 8 chunks up to K = 2048: D(2048) = D(2046) = 256, D(512) =
// D(510) = 64, D(128) = D(126) = 32.  The tensor core sums each chunk from
// zero, k-steps of 8 in ascending order, one m64n128k8 instruction each;
// the chunks go into an fp32 running sum in ascending order, one IEEE add
// each.  Nothing else enters the order: not M, N, the batch or the tile,
// not the cluster, the occupancy or the SM count, not the entry.  A K
// split across a thread-block cluster therefore gives the same bits as one
// CTA walking the chunks: rank r sums chunk r from zero and the partials
// are added in rank order through distributed shared memory, and the
// sequential walk's first add is 0 + c0 = c0.  A launch splits K (one
// chunk a rank) where its CTAs fit the card's resident slots (the 2048^2
// rescue's 16 tiles, plan_launch), and walks the chunks elsewhere.
// rolling.tf32_sum_order is the same formula in Python.  D is bounded by
// accuracy, since the tensor core does not round its fp32 sums to nearest:
// a constant D = 256 doubled the error of the chained 512^3 plane product
// (two TF32 roundings) against D(512) = 64.  The max error against the
// plain version (IEEE fp32 sums of the same rounded products) at each
// depth, of max|ref|, on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 38): 3.9e-6 at K = 2048, 3.8e-6 at 2046, 1.4e-6 at 512 and 510,
// 7.2e-7 at 128, 6.5e-7 at 126; at most TOL_GEMM / 2 = 1e-5.
//
// Operands.  tf32 wgmma reads only K-major operands from shared memory.
// A (M x K, row-major) is K-major; B (K x N, row-major) is not.  The
// kernel computes C^T = B^T * A^T: A is wgmma's shared-memory operand
// (TMA, 128-byte swizzle), B goes through registers as wgmma's A operand,
// its fragments read out of B's shared tile and rounded with cvt.rna on
// the way.  A's stage is rounded once in shared memory, off the
// consumers' path by the producer's idle warps (then fence.proxy.async and
// a third mbarrier), before wgmma reads it: the tensor core itself
// truncates the low 13 bits.  B's tile rows are padded to 136 floats (the
// TMA box is 8 columns wider, zero-filled past N) so that a fragment's
// 32 lanes read 32 banks.  Operands whose base, leading dimension or
// batch stride is not a multiple of 16 bytes cannot use TMA: the same
// mainloop takes them through a cp.async path (4-byte copies into the
// same layouts, zero fill), which the wrappers count apart.
//
// Layout of a CTA (384 threads, one a SM): a 128 x 128 output tile;
// warpgroup 0 the producer (one thread issues the TMA loads into a ring
// of 6 stages, 33 KB each, full / rounded / empty mbarriers, and warps
// 1-3 round; on the cp.async path all 128 threads copy and round),
// warpgroups 1 and 2 the consumers, 64 output columns each, m64n128k8
// with fp32 accumulators, one chunk sum and one running sum a thread
// (setmaxnreg: 40 registers for the producer, 232 for the consumers).
// One IEEE add a chunk, in place of one every k-step.  An unsplit launch
// is persistent: a CTA walks tiles in steps of the grid, its producer
// loading the next tile while the consumers store the last one straight
// from their registers (eight lanes fill each 32-byte sector).  A split
// launch runs one tile a CTA: the partial tiles go through shared memory
// (rows of 132 floats), are summed in rank order and divided by lam.
// Bound: the bytes or the TF32 operations (2 * M * N * K at 494.7
// TFLOP/s dense, against the operands and the output at 3.35 TB/s); the
// kernel runs well above it (PERF.md section 6), limited neither by the
// tensor core, L2 nor its fragment loads alone but by the stages' latency
// chain and the in-place rounding's shared-memory traffic.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "async_copy.cuh"
#include "wgmma_tf32.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 128;          // output tile: 128 rows x 128 columns
constexpr int kStageK = 32;         // k depth of a stage (128-byte A rows)
constexpr int kMaxChunks = 8;       // chunks the formula aims at
constexpr int kMaxChunkStages = 8;  // D(K) <= 256
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kStages = 6;
constexpr int kThreads = 384;
constexpr int kConsumers = 256;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kRounderWarps = 3;      // producer warps 1-3 (TMA path)
constexpr int kBStride = kTile + 8;   // 136: (8 t + g) mod 32 distinct
constexpr int kTStride = kTile + 4;   // 132: (8 t + g) mod 32 distinct
constexpr int kAFloats = kTile * kStageK;
constexpr int kBFloats = kStageK * kBStride;
constexpr int kABytes = kAFloats * 4;
constexpr int kBBytes = kBFloats * 4;
constexpr int kSmemBytes =
    kStages * (kABytes + kBBytes) + 3 * kStages * 8 + 1024;
static_assert(kTile * kTStride <= kStages * kAFloats,
              "the epilogue tile fits over the A stages");

// the sum order: `stages` k-stages of kStageK, chunks of `depth` stages
struct Chunks {
  int stages, depth, count;
};

__host__ __device__ inline Chunks chunk_plan(int K) {
  const int stages = K > 0 ? (K + kStageK - 1) / kStageK : 0;
  int depth = (stages + kMaxChunks - 1) / kMaxChunks;
  depth = depth < 1 ? 1 : (depth > kMaxChunkStages ? kMaxChunkStages : depth);
  return {stages, depth, (stages + depth - 1) / depth};
}

struct Params {
  int M, N, K;
  const float* A;
  long long lda, sA;
  const float* B;
  long long ldb, sB;
  float* C;
  long long ldc, sC;
  const float* lam;  // null: no divide
  long long ldl;
  int cs;      // cluster size: 1, or the chunk count (one chunk a rank)
  int m_fast;  // the row tiles walk fastest, else the column tiles
  int vec_c;   // C's rows take float4 stores
  int tiles_fast, tiles_slow, n_tiles;  // n_tiles over the batch too
};

// A's stage rounded in place, once, for wgmma's shared operand, by
// `n` threads (this one `i`), made visible to the async proxy; then one
// arrival a warp on `done`
__device__ __forceinline__ void round_tile(float* tile, int i, int n,
                                           uint64_t* done) {
  float4* const a4 = reinterpret_cast<float4*>(tile);
  for (int q = i; q < kAFloats / 4; q += n) {
    float4 v = a4[q];
    v.x = tf32_rna(v.x);
    v.y = tf32_rna(v.y);
    v.z = tf32_rna(v.z);
    v.w = tf32_rna(v.w);
    a4[q] = v;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(done);
}

// the cp.async path: this thread's 4-byte copies of a stage, A into the
// 128-byte swizzle that TMA writes, B's 128 columns into its padded rows
// (the padding is never read); zeros outside the operands
__device__ __forceinline__ void copy_stage(const Params& p, int bz, int m0,
                                           int n0, int k0, float* a_tile,
                                           float* b_tile) {
  const float* const A = p.A + bz * p.sA;
  const float* const B = p.B + bz * p.sB;
  const uint32_t as = smem_u32(a_tile), bs = smem_u32(b_tile);
  for (int i = 0; i < kAFloats / 128; ++i) {
    const int e = threadIdx.x + 128 * i, r = e >> 5, c = e & 31;
    const int gm = m0 + r, gk = k0 + c;
    const bool ok = gm < p.M && gk < p.K;
    cp_async4(as + r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2)),
              ok ? A + gm * p.lda + gk : A, ok ? 4 : 0);
  }
  for (int i = 0; i < kStageK * kTile / 128; ++i) {
    const int e = threadIdx.x + 128 * i, r = e >> 7, c = e & 127;
    const int gk = k0 + r, gn = n0 + c;
    const bool ok = gk < p.K && gn < p.N;
    cp_async4(bs + (r * kBStride + c) * 4, ok ? B + gk * p.ldb + gn : B,
              ok ? 4 : 0);
  }
}

__device__ __forceinline__ void consumer_bar() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

template <bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* const a_st = reinterpret_cast<float*>(smem);  // [6][128][32] swz
  float* const b_st = a_st + kStages * kAFloats;       // [6][32][136]
  // full: the stage landed; rounded: its A tile is rna-rounded; empty:
  // both consumer warpgroups are done with it
  uint64_t* const full = reinterpret_cast<uint64_t*>(b_st + kStages * kBFloats);
  uint64_t* const rounded = full + kStages;
  uint64_t* const empty = rounded + kStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = p.cs;
  const int rank = cs > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const Chunks ch = chunk_plan(p.K);
  // the stages of each tile: every chunk in turn, or chunk `rank` of a
  // split
  int st0 = 0, st1 = ch.stages;
  if (cs > 1) {
    st0 = min(ch.stages, rank * ch.depth);
    st1 = min(ch.stages, st0 + ch.depth);
  }
  const int n_st = st1 - st0;
  // the tiles: a split's CTA owns one (its grid is the tiles x the
  // cluster); an unsplit launch is persistent, its CTAs walk the tiles
  // in steps of the grid
  const int tile0 =
      cs > 1 ? static_cast<int>(blockIdx.x + blockIdx.y * gridDim.x +
                                (blockIdx.z / cs) * gridDim.x * gridDim.y)
             : static_cast<int>(blockIdx.x);
  const int tile_step = cs > 1 ? p.n_tiles : static_cast<int>(gridDim.x);
  // (row tile, column tile, batch) of tile `tile`
  auto coords = [&](int tile, int& m0, int& n0, int& bz) {
    const int f = tile % p.tiles_fast, r = tile / p.tiles_fast;
    const int sl = r % p.tiles_slow;
    bz = r / p.tiles_slow;
    m0 = (p.m_fast ? f : sl) * kTile;
    n0 = (p.m_fast ? sl : f) * kTile;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // one arrival a warp (full: the TMA thread, or every copying
      // thread's cp.async completion)
      mbar_init(&full[s], kTma ? 1 : 128);
      mbar_init(&rounded[s], kTma ? kRounderWarps : 4);
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
      if (threadIdx.x == 0) {
        // one thread keeps the TMA loads in flight, into the next tile's
        // stages while the consumers finish a tile
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
          for (int st = st0; st < st1; ++st, ++it) {
            const int s = it % kStages;
            mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(&full[s], kABytes + kBBytes);
            tma_load(a_st + s * kAFloats, &map_a, &full[s], st * kStageK,
                     m0, ba);
            tma_load(b_st + s * kBFloats, &map_b, &full[s], n0,
                     st * kStageK, bb);
          }
        }
      } else if (threadIdx.x >= 32) {
        // warps 1-3 round each landed A tile in place, off the
        // consumers' path
        const int n_it = n_st * ((p.n_tiles - tile0 + tile_step - 1) /
                                 tile_step);
        for (int it = 0; it < n_it; ++it) {
          const int s = it % kStages;
          mbar_wait(&full[s], (it / kStages) & 1);
          round_tile(a_st + s * kAFloats, threadIdx.x - 32,
                     32 * kRounderWarps, &rounded[s]);
        }
      }
      __syncwarp();
    } else {
      // every thread copies; each stage is rounded two stages behind its
      // copies, so that loads stay in flight
      constexpr int kLag = 2;
      static_assert(kLag < kStages, "the lag leaves a stage to fill");
      const int n_it = n_st * ((p.n_tiles - tile0 + tile_step - 1) /
                               tile_step);
      int tile = tile0, st = st0, m0 = 0, n0 = 0, bz = 0;
      coords(tile, m0, n0, bz);
      for (int it = 0; it < n_it + kLag; ++it) {
        if (it < n_it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          copy_stage(p, bz, m0, n0, st * kStageK, a_st + s * kAFloats,
                     b_st + s * kBFloats);
          cp_async_arrive(&full[s]);
          if (++st == st1) {
            st = st0;
            tile += tile_step;
            if (tile < p.n_tiles) coords(tile, m0, n0, bz);
          }
        }
        const int r = it - kLag;
        if (r >= 0) {
          const int s = r % kStages;
          mbar_wait(&full[s], (r / kStages) & 1);
          round_tile(a_st + s * kAFloats, threadIdx.x, 128, &rounded[s]);
        }
      }
    }
    // the epilogue's two cluster barriers (a split's ranks read each
    // other's partials)
    if (cs > 1) {
      cluster.sync();
      cluster.sync();
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
  float acc[64], run[64];
  uint32_t fa[4][4], fb[4][4];
  int pend = -1;  // the stage whose wgmma group may still be in flight
  int it = 0;     // the stages through the ring across the CTA's tiles

  auto stage = [&](uint32_t(&fr)[4][4], uint32_t(&prev)[4][4], int st) {
    const int s = it % kStages;
    mbar_wait(&rounded[s], (it / kStages) & 1);
    // B's fragments, rounded on the way
    const float* const bs = b_st + s * kBFloats + nb;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* const r0 = bs + (8 * j + t) * kBStride;
      fr[j][0] = tf32_bits(r0[0]);
      fr[j][1] = tf32_bits(r0[8]);
      fr[j][2] = tf32_bits(r0[4 * kBStride]);
      fr[j][3] = tf32_bits(r0[4 * kBStride + 8]);
    }
    // a chunk's first stage starts its sum from zero, its last adds it
    // into the running sum
    const bool first = st % ch.depth == 0;
    const bool last = (st + 1) % ch.depth == 0 || st + 1 == ch.stages;
    const uint64_t desc = smem_desc(a_st + s * kAFloats);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_k8(acc, fr[j], desc + 2 * j, (first && j == 0) ? 0 : 1);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (last) {
      // the chunk's sum, one IEEE add into the running sum
      wgmma_wait<0>();
      fence_acc(acc);
      keep(fr);
      keep(prev);
      if (lane == 0) {
        if (pend >= 0) mbar_arrive(&empty[pend]);
        mbar_arrive(&empty[s]);
      }
      pend = -1;
#pragma unroll
      for (int i = 0; i < 64; ++i) run[i] += acc[i];
    } else {
      wgmma_wait<1>();
      keep(prev);
      if (lane == 0 && pend >= 0) mbar_arrive(&empty[pend]);
      pend = s;
    }
    ++it;
  };

  for (int tile = tile0; tile < p.n_tiles; tile += tile_step) {
    int m0, n0, bz;
    coords(tile, m0, n0, bz);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = run[i] = 0.0f;
    // (a tile ends on a chunk's last stage: every group has completed)
    for (int st = st0; st < st1; st += 2) {
      stage(fa, fb, st);
      if (st + 1 < st1) stage(fb, fa, st + 1);
    }
    float* const Cb = p.C + bz * p.sC;
    if (cs == 1) {
      // straight from the registers: run[4 j + 2 h + e] is C[m0 + 8 j +
      // 2 t + e][n0 + nb + 8 h]; a warp's store fills 32-byte sectors
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gm = m0 + 8 * j + 2 * t + e;
          if (gm >= p.M) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gn = n0 + nb + 8 * h;
            if (gn >= p.N) continue;
            float o = run[4 * j + 2 * h + e];
            if (p.lam) o = o / p.lam[gm * p.ldl + gn];
            Cb[gm * p.ldc + gn] = o;
          }
        }
      continue;
    }
    // a split: the transposed partial tile over the A stages (every
    // wgmma of both warpgroups has completed), rows of C
    consumer_bar();
    float* const T = a_st;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          T[(8 * j + 2 * t + e) * kTStride + nb + 8 * h] =
              run[4 * j + 2 * h + e];
    // every rank's partial tile is in its shared memory
    cluster.sync();
    // rank r sums its rows over the ranks' partials in rank order,
    // divides by lam (IEEE '/') and writes them
    const int rows = (kTile + cs - 1) / cs;
    const int r0 = rank * rows, r1 = min(kTile, r0 + rows);
    for (int idx = ct; idx < (r1 - r0) * (kTile / 4); idx += kConsumers) {
      const int lr = r0 + idx / (kTile / 4), lc = (idx % (kTile / 4)) * 4;
      const int gm = m0 + lr, gn = n0 + lc;
      if (gm >= p.M || gn >= p.N) continue;
      const int off = lr * kTStride + lc;
      float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(T, 0) + off);
      for (int q = 1; q < cs; ++q) {
        const float4 w = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(T, q) + off);
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      float o[4] = {v.x, v.y, v.z, v.w};
      if (p.lam) {
        const float* const lrow = p.lam + gm * p.ldl + gn;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gn + e < p.N) o[e] = o[e] / lrow[e];
      }
      float* const row = Cb + gm * p.ldc + gn;
      if (p.vec_c && gn + 3 < p.N) {
        *reinterpret_cast<float4*>(row) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gn + e < p.N) row[e] = o[e];
      }
    }
    // no rank leaves while another may still read its partial
    cluster.sync();
  }
}

// ---- host side -------------------------------------------------------------

// the kernel's shared-memory limit on the current device, set once a
// device and instantiation
template <bool kTma>
int set_smem(int dev) {
  static std::mutex mu;
  static bool done[64] = {};
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (done[dev]) return 0;
  const cudaError_t rc = cudaFuncSetAttribute(
      gemm_tf32_kernel<kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  done[dev] = true;
  return 0;
}

cudaLaunchConfig_t launch_config(dim3 grid, int cs, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = cs;
  cfg.attrs = attr;
  // (an unsplit launch takes no cluster: the attribute costs host time)
  cfg.numAttrs = cs > 1 ? 1 : 0;
  return cfg;
}

// The occupancy queries on the current device, cached per (device,
// chunk count): `ctas`, the CTAs resident at once (SMs x CTAs an SM), and
// `clusters`, the clusters of `chunks` CTAs resident at once (0 unless
// 1 < chunks <= 8).
int occupancy(int chunks, int* ctas, int* clusters) {
  struct Occ {
    int dev, chunks, ctas, clusters;
  };
  static std::mutex mu;
  static Occ cache[64];
  static int n_cached = 0;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (chunks < 1 || chunks > kMaxCluster) chunks = 1;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n_cached; ++i)
      if (cache[i].dev == dev && cache[i].chunks == chunks) {
        *ctas = cache[i].ctas;
        *clusters = cache[i].clusters;
        return 0;
      }
  }
  const int src = set_smem<true>(dev);
  if (src != 0) return src;
  int sms = 0, per_sm = 0;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gemm_tf32_kernel<true>, kThreads, kSmemBytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *ctas = sms * per_sm;
  if (*ctas <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  *clusters = 0;
  if (chunks > 1) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        launch_config(dim3(1, 1, chunks), chunks, nullptr, &attr);
    rc = cudaOccupancyMaxActiveClusters(clusters, gemm_tf32_kernel<true>,
                                        &cfg);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  std::lock_guard<std::mutex> lock(mu);
  cache[n_cached < 64 ? n_cached++ : 63] = {dev, chunks, *ctas, *clusters};
  return 0;
}

// A launch splits K (one chunk a rank) where its split CTAs (tiles x
// chunks) fit the resident slots (SMs x CTAs an SM), and walks the chunks
// in persistent CTAs elsewhere.  On an H100 a split of four waves lost to
// the walk (the 4y shard's 64 tiles), and a lone CTA walking short chunks
// one after another lost to the split (the 128^2 rescue, 1 tile), as did
// the 2048^2 rescue's 16 CTAs (its epilogue's divides spread over 128).

struct Plan {
  Chunks ch;
  int cs, tiles_m, tiles_n, m_fast, n_tiles, ctas;
};

int plan_launch(int M, int N, int K, int batch, Plan* pl) {
  pl->ch = chunk_plan(K);
  pl->tiles_m = (M + kTile - 1) / kTile;
  pl->tiles_n = (N + kTile - 1) / kTile;
  // the dimension with fewer tiles walks fastest: neighbouring tiles
  // share the other, larger operand's tile in L2
  pl->m_fast = pl->tiles_m <= pl->tiles_n;
  const long long tiles = static_cast<long long>(pl->tiles_m) *
                          pl->tiles_n * batch;
  if (tiles > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  pl->n_tiles = static_cast<int>(tiles);
  int ctas = 0, clusters = 0;
  const int rc = occupancy(pl->ch.count, &ctas, &clusters);
  if (rc != 0) return rc;
  pl->cs = clusters > 0 && tiles * pl->ch.count <= ctas ? pl->ch.count : 1;
  // unsplit: persistent, at most one CTA a resident slot
  pl->ctas = pl->cs > 1 ? pl->n_tiles * pl->cs
                        : static_cast<int>(tiles < ctas ? tiles : ctas);
  return 0;
}

int run_gemm(int M, int N, int K, const float* A, long long lda,
             long long sA, const float* B, long long ldb, long long sB,
             float* C, long long ldc, long long sC, int batch,
             const float* lam, long long ldl, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || batch <= 0) return 0;
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  int rc = plan_launch(M, N, K, batch, &pl);
  if (rc != 0) return rc;
  const int fast = pl.m_fast ? pl.tiles_m : pl.tiles_n;
  const int slow = pl.m_fast ? pl.tiles_n : pl.tiles_m;
  if (pl.cs > 1 && (slow > 65535 || static_cast<long long>(batch) * pl.cs >
                                        65535))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool tma = aligned16(A) && lda % 4 == 0 && aligned16(B) &&
                   ldb % 4 == 0 &&
                   (batch == 1 || (sA % 4 == 0 && sB % 4 == 0));
  const Params p = {
      M,     N,   K,  A,   lda, sA,    B,         ldb,
      sB,    C,   ldc, sC, lam, ldl,   pl.cs,     pl.m_fast,
      aligned16(C) && ldc % 4 == 0 && (batch == 1 || sC % 4 == 0),
      fast, slow, pl.n_tiles};
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  if (tma) {
    rc = encode(&ma, A, K, M, lda, sA != 0 ? batch : 1, sA, kStageK, kTile,
                CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc == 0)
      rc = encode(&mb, B, N, K, ldb, sB != 0 ? batch : 1, sB, kBStride,
                  kStageK, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc != 0) return rc;
  }
  int dev = 0;
  const cudaError_t drc = cudaGetDevice(&dev);
  if (drc != cudaSuccess) return static_cast<int>(drc);
  rc = tma ? set_smem<true>(dev) : set_smem<false>(dev);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  const dim3 grid = pl.cs > 1 ? dim3(fast, slow, batch * pl.cs)
                              : dim3(pl.ctas, 1, 1);
  const cudaLaunchConfig_t cfg = launch_config(grid, pl.cs, stream, &attr);
  const cudaError_t err =
      tma ? cudaLaunchKernelEx(&cfg, gemm_tf32_kernel<true>, ma, mb, p)
          : cudaLaunchKernelEx(&cfg, gemm_tf32_kernel<false>, ma, mb, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// spectral_precision=DEFAULT: C[b] = A[b] * B[b], one TF32 pass
int cfd_sgemm_tf32_batched(int M, int N, int K, const float* A,
                           long long lda, long long sA, const float* B,
                           long long ldb, long long sB, float* C,
                           long long ldc, long long sC, int batch,
                           cudaStream_t stream) {
  return run_gemm(M, N, K, A, lda, sA, B, ldb, sB, C, ldc, sC, batch,
                  nullptr, 0, stream);
}

// the 2D rescue at DEFAULT: C = (A * B) / lam (no divide for a null lam)
int cfd_rescue_tf32(int M, int N, int K, const float* A, long long lda,
                    const float* B, long long ldb, float* C, long long ldc,
                    const float* lam, long long ldl, cudaStream_t stream) {
  return run_gemm(M, N, K, A, lda, 0, B, ldb, 0, C, ldc, 0, 1, lam, ldl,
                  stream);
}

// the plan of a launch of M x N x K over `batch` on the current device:
// out[0] D(K) in k, out[1] the cluster size, out[2] the CTAs, out[3] the
// chunk count; 0 or a CUDA error code
int cfd_gemm_tf32_plan(int M, int N, int K, int batch, int* out) {
  Plan pl;
  const int rc = plan_launch(M, N, K, batch, &pl);
  if (rc != 0) return rc;
  out[0] = pl.ch.depth * kStageK;
  out[1] = pl.cs;
  out[2] = pl.ctas;
  out[3] = pl.ch.count;
  return 0;
}

}  // extern "C"
