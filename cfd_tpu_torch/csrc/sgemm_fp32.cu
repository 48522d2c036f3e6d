// IEEE fp32 SGEMM for Hopper (sm_90a) on the CUDA cores: every DST product
// at spectral_precision=HIGHEST.
//
// It replaces the reference's HIGHEST products: hp_dot_general at
// Precision.HIGHEST (cfd_tpu/ops/pallas/rolling.py:42) inside
// ProjectionKernels.pred_bt / corr_bwd (plane_dot_rl,
// cfd_tpu/ops/pallas/projection_kernels.py:226-250) and the 2D block_dot
// (cfd_tpu/ops/pallas/projection2d.py:97-106), and the XLA einsums at
// HIGHEST that the decomposed steps and the eigen pipeline run outside
// Pallas (cfd_tpu/solvers/poisson/spectral.py:386-391, :645-661,
// :836).  One entry launches it: cfd_sgemm_batched, row-major C[b] =
// A[b] (M x K) * B[b] (K x N) with leading dimensions and batch strides,
// a zero stride sharing one matrix across the batch, column slices read
// and written in place through lda, ldb and ldc (rolling.plane_dot,
// right_dot, left_dot).  cfd_sgemm_plan reports a launch's tile, CTAs
// and tiles.
//
// The sum order, a contract.  Every output element is one fmaf chain over
// k in ascending order from zero: acc = 0, then acc = fmaf(a[m][k],
// b[k][n], acc) for k = 0, 1, .., K - 1.  No split of K, no partial sums,
// no atomics.  The k axis is cut into stages of kBK = 32 whose ragged
// tail is zero-filled, and fmaf(0, 0, acc) = acc.  The tile, the
// persistent walk, the stages and the occupancy vary with the launch;
// the chain does not, so every launch that computes an element gives its
// bits: a row slice's product those rows of the whole one, a plane
// block's those planes, a column slice written in place those columns,
// one device the bits of a decomposed step's shard.
//
// Bound: 2 M N K flops at the fp32 rate of the CUDA cores, 67 TFLOP/s on
// an H100 SXM at 700 W (one warp FFMA a cycle on each of an SM's four
// sub-partitions).  No tensor core: one TF32 pass would break the HIGHEST
// contract, and a split into TF32 parts would change the sum.  At every
// shape in use the operands and the output take less than a sixth of
// that time at 3.35 TB/s.
//
// Design.  One CTA an SM, 384 threads: warpgroup 0 the producer,
// warpgroups 1 and 2 eight consumer warps (setmaxnreg: 40 registers for
// the producer, 232 for the consumers, within the launch's pool of 384 x
// 168).  The producer fills a ring of kStages stages, each kBK deep in k:
// A's (BM x 32) tile by TMA with the 128-byte swizzle, B's (32 x 128)
// tile by TMA, one thread issuing both, full / empty mbarriers.  The
// consumers issue only shared loads and FFMAs: a consumer warp owns a
// (4 kTM) x 64 block of the tile as 4 x 8 threads, a thread kTM rows 4
// apart by 8 columns (two float4 32 apart).  Each group of 4 k-steps it
// reads its kTM rows of A along k (LDS.128, the swizzle puts a warp's
// four rows in four bank groups) and, for each k-step, its 8 columns of
// B along n (two LDS.128, a warp's 8 column groups one 128-byte row);
// then kTM x 8 fmaf a k-step: at kTM = 8, 16 shared loads a 256 FFMAs.
// The tile follows the shape (plan_launch): 128 x 128 (kTM = 8), or 64 x
// 128 (kTM = 4) where the smaller tile fills the card's resident slots
// over its waves clearly better (the 4y shards' shapes: 64 tiles of
// 128 x 128 for 132 SMs).  Every launch is persistent: a CTA walks tiles
// in steps of the grid, the dimension with fewer tiles fastest (its
// neighbours share the larger operand's tile in L2), so the producer
// loads the next tile's stages while the consumers store the last one
// from their registers (float4 where C's rows allow it).  Operands whose
// base, leading dimension or batch stride is not a multiple of 16 bytes
// cannot use TMA, nor 16-byte copies (whose sources need the same
// alignment): the same mainloop takes them through 4-byte cp.async
// copies by the whole producer warpgroup into the same layouts, zeros
// outside the operands; the wrappers count those launches apart
// (rolling's highest_cp_async_launches).
//
// Measured (chip_smoke.py phase 71 on an NVIDIA H100 80GB HBM3 at
// 700.00 W; device ms a launch, one torch.matmul with TF32 off of the
// same product in brackets, the bound after it): the 512^3 planes'
// x * right and left * t[k] 2.975 and 2.985 (2.756, 2.752; 2.051), a
// 130-plane block's 0.759 and 0.764 (0.703, 0.696; 0.521), the eigen
// z-product 2.971 (2.731; 2.051), the (2, 2) shard's x-DST and z stage
// 0.757 and 0.760 (0.703, 0.693; 0.513), the 2048^2 x-DST 0.366 (0.347;
// 0.256), the 4y shard's x-DST and y slab 0.105 each (0.101, 0.099;
// 0.064): 67-69% of the fp32 peak at the large shapes, 1.05-1.10x the
// library call.  The mainloop's SASS (cuobjdump -sass) is 93% FFMA at
// the 128-row tile and 91% at the 64-row one, the rest LDS.128 and the
// stage's few address and barrier instructions; ptxas: 168 registers,
// no spills.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "async_copy.cuh"

namespace {

constexpr int kBK = 32;       // k depth of a stage: A's rows of 128 bytes
constexpr int kBN = 128;      // tile columns
constexpr int kStages = 6;
constexpr int kThreads = 384;
constexpr int kConsumerWarps = 8;
constexpr int kBFloats = kBK * kBN;
constexpr int kBBytes = kBFloats * 4;
// the 64-row tile is taken where it keeps this much more of the resident
// slots busy than the 128-row one
constexpr double kSmallTileGain = 1.25;

// the tile of a thread with kTM rows: (16 kTM) x 128, A's stage BM rows
// of 32 floats
template <int kTM>
struct Tile {
  static constexpr int kBM = 16 * kTM;
  static constexpr int kAFloats = kBM * kBK;
  static constexpr int kABytes = kAFloats * 4;
  static constexpr int kSmem =
      kStages * (kABytes + kBBytes) + 2 * kStages * 8 + 1024;
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
  int vec_c;   // C's rows take float4 stores
  int tiles_m, tiles_n, n_tiles;  // n_tiles over the batch too
};

// the cp.async path: this thread's 4-byte copies of a stage, A into the
// 128-byte swizzle that TMA writes, B into its rows; zeros outside the
// operands
template <int kTM>
__device__ __forceinline__ void copy_stage(const Params& p, int bz, int m0,
                                           int n0, int k0, float* a_tile,
                                           float* b_tile) {
  const float* const A = p.A + bz * p.sA;
  const float* const B = p.B + bz * p.sB;
  const uint32_t as = smem_u32(a_tile), bs = smem_u32(b_tile);
  for (int i = 0; i < Tile<kTM>::kAFloats / 128; ++i) {
    const int e = threadIdx.x + 128 * i, r = e >> 5, c = e & 31;
    const int gm = m0 + r, gk = k0 + c;
    const bool ok = gm < p.M && gk < p.K;
    cp_async4(as + r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2)),
              ok ? A + gm * p.lda + gk : A, ok ? 4 : 0);
  }
  for (int i = 0; i < kBFloats / 128; ++i) {
    const int e = threadIdx.x + 128 * i, r = e >> 7, c = e & 127;
    const int gk = k0 + r, gn = n0 + c;
    const bool ok = gk < p.K && gn < p.N;
    cp_async4(bs + (r * kBN + c) * 4, ok ? B + gk * p.ldb + gn : B,
              ok ? 4 : 0);
  }
}

__device__ __forceinline__ float4 lds4(const float* base, uint32_t bytes) {
  return *reinterpret_cast<const float4*>(
      reinterpret_cast<const char*>(base) + bytes);
}

template <int kTM, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    sgemm_fp32_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const Params p) {
  using T = Tile<kTM>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* const a_st = reinterpret_cast<float*>(smem);  // [stages][BM][32]
  float* const b_st = a_st + kStages * T::kAFloats;    // [stages][32][128]
  // full: the stage landed; empty: every consumer warp is done with it
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(b_st + kStages * kBFloats);
  uint64_t* const empty = full + kStages;

  const int fast = p.m_fast ? p.tiles_m : p.tiles_n;
  const int slow = p.m_fast ? p.tiles_n : p.tiles_m;
  // (row, column, batch) of tile `tile`
  auto coords = [&](int tile, int& m0, int& n0, int& bz) {
    const int f = tile % fast, r = tile / fast;
    const int sl = r % slow;
    bz = r / slow;
    m0 = (p.m_fast ? f : sl) * T::kBM;
    n0 = (p.m_fast ? sl : f) * kBN;
  };
  const int n_k = (p.K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // full: the TMA thread's arrival, or every copying thread's
      mbar_init(&full[s], kTma ? 1 : 128);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    // `it` counts the stages through the ring across the CTA's tiles
    int it = 0;
    if constexpr (kTma) {
      if (threadIdx.x == 0 && n_k > 0) {
        asm volatile("prefetch.tensormap [%0];" ::"l"(
                         reinterpret_cast<uint64_t>(&map_a))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];" ::"l"(
                         reinterpret_cast<uint64_t>(&map_b))
                     : "memory");
        for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
          int m0, n0, bz;
          coords(tile, m0, n0, bz);
          const int ba = p.sA != 0 ? bz : 0, bb = p.sB != 0 ? bz : 0;
          for (int kt = 0; kt < n_k; ++kt, ++it) {
            const int s = it % kStages;
            mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(&full[s], T::kABytes + kBBytes);
            tma_load(a_st + s * T::kAFloats, &map_a, &full[s], kt * kBK, m0,
                     ba);
            tma_load(b_st + s * kBFloats, &map_b, &full[s], n0, kt * kBK,
                     bb);
          }
        }
      }
    } else {
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        int m0, n0, bz;
        coords(tile, m0, n0, bz);
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          copy_stage<kTM>(p, bz, m0, n0, kt * kBK, a_st + s * T::kAFloats,
                          b_st + s * kBFloats);
          cp_async_arrive(&full[s]);
        }
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int ct = threadIdx.x - 128;
  const int warp = ct >> 5, lane = ct & 31;
  const int tr = lane >> 3, tc = lane & 7;
  // this thread's rows row0 + 4 i (i < kTM), columns col0 + e and
  // col0 + 32 + e (e < 4) of the tile
  const int row0 = (warp & 3) * 4 * kTM + tr;
  const int col0 = (warp >> 2) * 64 + tc * 4;
  // A's rows: row & 7 is tr for even i and tr + 4 for odd i, the chunk
  // of k-group g at (g ^ (row & 7)) * 16 bytes
  const float* const a_rows = a_st + row0 * kBK;
  const float* const b_cols = b_st + col0;
  int it = 0;

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    int m0, n0, bz;
    coords(tile, m0, n0, bz);
    float acc[kTM][8];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const float* const as = a_rows + s * T::kAFloats;
      const float* const bs = b_cols + s * kBFloats;
#pragma unroll
      for (int g = 0; g < kBK / 4; ++g) {
        const uint32_t sw = static_cast<uint32_t>(g ^ tr) << 4;
        float4 a[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          a[i] = lds4(as, i * 4 * kBK * 4 + (sw ^ ((i & 1) << 6)));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* const brow = bs + (4 * g + kk) * kBN;
          const float4 b0 = *reinterpret_cast<const float4*>(brow);
          const float4 b1 = *reinterpret_cast<const float4*>(brow + 32);
          const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                              b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float av = kk == 0   ? a[i].x
                             : kk == 1 ? a[i].y
                             : kk == 2 ? a[i].z
                                       : a[i].w;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
          }
        }
      }
      // the warp's reads of the stage are done: one arrival a warp
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    float* const Cb = p.C + bz * p.sC;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int gm = m0 + row0 + 4 * i;
      if (gm >= p.M) continue;
      float* const row = Cb + gm * p.ldc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gn = n0 + col0 + 32 * h;
        const float* const v = &acc[i][4 * h];
        if (p.vec_c && gn + 3 < p.N) {
          *reinterpret_cast<float4*>(row + gn) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (gn + e < p.N) row[gn + e] = v[e];
        }
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

template <int kTM, bool kTma>
int set_smem(int dev) {
  static std::mutex mu;
  static bool done[64] = {};
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (done[dev]) return 0;
  const cudaError_t rc = cudaFuncSetAttribute(
      sgemm_fp32_kernel<kTM, kTma>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<kTM>::kSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  done[dev] = true;
  return 0;
}

// The CTAs resident at once on the current device for each tile (SMs x
// CTAs an SM: one on an H100), cached per device.
int resident(int* slots8, int* slots4) {
  struct Occ {
    int dev, s8, s4;
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
        *slots8 = cache[i].s8;
        *slots4 = cache[i].s4;
        return 0;
      }
  }
  int src = set_smem<8, true>(dev);
  if (src == 0) src = set_smem<4, true>(dev);
  if (src != 0) return src;
  int sms = 0, per8 = 0, per4 = 0;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per8, sgemm_fp32_kernel<8, true>, kThreads, Tile<8>::kSmem);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per4, sgemm_fp32_kernel<4, true>, kThreads, Tile<4>::kSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *slots8 = sms * per8;
  *slots4 = sms * per4;
  if (*slots8 <= 0 || *slots4 <= 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  std::lock_guard<std::mutex> lock(mu);
  cache[n_cached < 64 ? n_cached++ : 63] = {dev, *slots8, *slots4};
  return 0;
}

// the share of `slots` resident CTAs that `tiles` tiles keep busy over
// their waves
double fill(long long tiles, int slots) {
  const long long waves = (tiles + slots - 1) / slots;
  return static_cast<double>(tiles) / static_cast<double>(waves * slots);
}

struct Plan {
  int tm, tiles_m, tiles_n, m_fast, n_tiles, ctas;
};

// The tile follows the shape: 64 x 128 where it fills the resident slots
// kSmallTileGain better over its waves than 128 x 128 (fewer tiles than
// one wave of the larger), or where M <= 64 (as many tiles, half the
// zero rows), else 128 x 128; one persistent CTA a slot, at most one a
// tile.
int plan_launch(int M, int N, int batch, Plan* pl) {
  int s8 = 0, s4 = 0;
  const int rc = resident(&s8, &s4);
  if (rc != 0) return rc;
  const long long tn = (N + kBN - 1) / kBN;
  const long long t8 = ((M + 127) / 128) * tn * batch;
  const long long t4 = ((M + 63) / 64) * tn * batch;
  if (t4 > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  pl->tm = t4 == t8 || fill(t4, s4) > kSmallTileGain * fill(t8, s8) ? 4 : 8;
  const int slots = pl->tm == 4 ? s4 : s8;
  pl->tiles_m = (M + 16 * pl->tm - 1) / (16 * pl->tm);
  pl->tiles_n = static_cast<int>(tn);
  pl->m_fast = pl->tiles_m <= pl->tiles_n;
  pl->n_tiles = static_cast<int>(pl->tm == 4 ? t4 : t8);
  pl->ctas = pl->n_tiles < slots ? pl->n_tiles : slots;
  return 0;
}

template <int kTM>
int launch(const Plan& pl, bool tma, const Params& p, int batch,
           cudaStream_t stream) {
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  if (tma && p.K > 0) {
    int rc = encode(&ma, p.A, p.K, p.M, p.lda, p.sA != 0 ? batch : 1,
                    p.sA, kBK, Tile<kTM>::kBM, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc == 0)
      rc = encode(&mb, p.B, p.N, p.K, p.ldb, p.sB != 0 ? batch : 1,
                  p.sB, kBN, kBK, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc != 0) return rc;
  }
  int dev = 0;
  const cudaError_t drc = cudaGetDevice(&dev);
  if (drc != cudaSuccess) return static_cast<int>(drc);
  const int rc = tma ? set_smem<kTM, true>(dev) : set_smem<kTM, false>(dev);
  if (rc != 0) return rc;
  if (tma)
    sgemm_fp32_kernel<kTM, true>
        <<<pl.ctas, kThreads, Tile<kTM>::kSmem, stream>>>(ma, mb, p);
  else
    sgemm_fp32_kernel<kTM, false>
        <<<pl.ctas, kThreads, Tile<kTM>::kSmem, stream>>>(ma, mb, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// spectral_precision=HIGHEST: C[b] = A[b] * B[b] in IEEE fp32, one fmaf
// chain an element, k ascending
int cfd_sgemm_batched(int M, int N, int K, const float* A, long long lda,
                      long long sA, const float* B, long long ldb,
                      long long sB, float* C, long long ldc, long long sC,
                      int batch, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || batch <= 0) return 0;
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int rc = plan_launch(M, N, batch, &pl);
  if (rc != 0) return rc;
  const bool tma = aligned16(A) && lda % 4 == 0 && aligned16(B) &&
                   ldb % 4 == 0 &&
                   (batch == 1 || (sA % 4 == 0 && sB % 4 == 0));
  const Params p = {
      M,   N,  K,   A,  lda, sA, B,
      ldb, sB, C,   ldc, sC,
      pl.m_fast,
      aligned16(C) && ldc % 4 == 0 && (batch == 1 || sC % 4 == 0),
      pl.tiles_m, pl.tiles_n, pl.n_tiles};
  return pl.tm == 4 ? launch<4>(pl, tma, p, batch, stream)
                    : launch<8>(pl, tma, p, batch, stream);
}

// the plan of a launch of M x N x K over `batch` on the current device:
// out[0] the tile's rows, out[1] its columns, out[2] the CTAs, out[3] the
// tiles; 0 or a CUDA error code
int cfd_sgemm_plan(int M, int N, int K, int batch, int* out) {
  if (M <= 0 || N <= 0 || batch <= 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int rc = plan_launch(M, N, batch, &pl);
  if (rc != 0) return rc;
  out[0] = 16 * pl.tm;
  out[1] = kBN;
  out[2] = pl.ctas;
  out[3] = pl.n_tiles;
  return 0;
}

}  // extern "C"
