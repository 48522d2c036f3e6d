// Hand-written GEMM for the 2D spectral y-solve's dense low-mode rescue on
// Hopper (sm_90a), with the eigenvalue divide fused into its epilogue.
//
// It replaces the rescue's two matmuls of the reference's 2D y-solve,
// cfd_tpu/solvers/poisson/spectral.py:299-303 (jnp matmuls at the step's
// precision outside Pallas):
//
//     s = Fyp (my x ny) * a[:, :K],  then  s / (ly (x) 1 + 1 (x) lx[:K])
//     x[:, :K] = Gyp (ny x my) * s    (in place, row stride nx)
//
// which the port ran through the general 128x128-tile GEMMs
// (the SGEMM then in projection_kernels.cu, gemm_3xtf32_kernel)
// and a separate divide (PERF.md section 6, rows "2D make_tdma_y_2d" and
// "HIGH").  One kernel, templated on the precision (the DEFAULT products
// run the one-pass GEMM, gemm_tf32.cu, whose sum order is K's alone):
//
//   kPrec = 0  HIGHEST: IEEE fp32 fmaf on the CUDA cores, k ascending;
//   kPrec = 3  HIGH: 3xTF32 mma.sync, each operand split into big =
//              rna_tf32(a) and small = rna_tf32(a - big); each 8-deep
//              k-step sums small*big, big*small, then big*big into fresh
//              registers, which one IEEE add takes into the running sum
//              (the tensor cores do not round their fp32 sums to nearest;
//              adding every MMA straight into the running sum made the
//              error grow with the depth of the sum).
//
// Bound, at the rescue's 2048^2 shapes (M = 2046, N = 128, K = 2048,
// 1.07 GFLOP a product): HIGHEST the fp32 flops at 67 TFLOP/s (0.016 ms);
// HIGH three TF32 passes at 494.7 TFLOP/s (0.0065 ms).
//
// The grid.  The rescue's products are thin: N = K_rescue = 128 columns
// and M ~ 2046 rows, so the general kernels' 128x128 output tiles gave
// 16 CTAs on 132 SMs, each walking all 2048 of K alone (at 128^2, the
// Ghia cavity's shape, one CTA).  Here a CTA owns a 64-row output tile
// (64x128 at HIGHEST, 64x64 on the tensor cores) and one k-chunk of it:
// the launch splits K across a thread-block cluster of up to 8 CTAs
// (gridDim.z = cluster size), sized from the occupancy queries so that
// the whole grid is resident at once with as few CTAs as may be on the
// busiest SM (cluster_size below: 224 CTAs at HIGHEST and 320 at HIGH
// at 2048^2; 16 and 32 at 128^2).  Each CTA leaves its partial tile in
// its own shared memory; after a cluster barrier,
// cluster rank r sums rows [r*64/cs, (r+1)*64/cs) of the tile over the
// cluster's partials through distributed shared memory (map_shared_rank)
// in the fixed rank order 0, 1, .., cs-1, divides by lam[i, j] with IEEE
// '/' (the plain version's s / lam, never a reciprocal product) and
// writes the output through its leading dimension.  No atomics, no
// workspace, no second launch: the result is bit-identical from run to
// run.  A second cluster barrier keeps every partial alive until it has
// been read.  The
// tiles and the cluster rule were chosen by timing variants at the 2048^2
// shapes on an H100 (64x128 against 128x64, 64x64, 32x128 and 128x128
// tiles, 64 to 256 threads, k-tiles of 8 or 16, clusters of 1 to 8).
//
// Inside a CTA (128 threads, k-tiles of 16): HIGHEST gives each thread an
// 8x8 register tile in two 4-wide halves (rows 32 apart, columns 64
// apart) so a warp's float4 shared reads are contiguous; HIGH runs
// 2x2 warps of 32x32 on mma.sync.m16n8k8 fragments (the fragment
// layout of gemm_3xtf32.cu).  Both double-buffer shared memory: the next
// k-tile is loaded into registers while the current one is multiplied,
// then stored to the other stage, one barrier a k-tile.  Vector (float4)
// loads only where the operand's base and leading dimension are multiples
// of 4 floats (Gyp's 2046-float rows take element loads); ragged rows,
// columns and k are zero-filled on load and masked on store.  wgmma / TMA
// are later work here: at N = 128 with a row-major B the tf32 wgmma needs
// K-major operands (gemm_tf32.cu computes C^T = B^T * A^T for that).
//
// C interface: row-major C = A (M x K) * B (K x N), [/ lam (M x N)], with
// leading dimensions; lam null for no divide.  C must not overlap A, B or
// lam.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kBM = 64;             // a CTA's output rows
constexpr int kBK = 16;             // k-tile; k-chunks are multiples of it
constexpr int kMaxCluster = 8;      // the portable cluster size

// a CTA's output columns: the whole rescue (128) at HIGHEST, half of it
// on the tensor cores
template <int kPrec>
__host__ __device__ constexpr int tile_n() {
  return kPrec == 0 ? 128 : 64;
}

// shared floats: two operand stages, then (aliasing them) the partial
// tile with rows padded by 4
template <int kPrec>
__host__ __device__ constexpr int smem_floats() {
  constexpr int BN = tile_n<kPrec>();
  constexpr int ops = kPrec == 0 ? 2 * kBK * ((kBM + 4) + (BN + 4))
                                 : 2 * (kBM * (kBK + 4) + kBK * (BN + 8));
  constexpr int part = kBM * (BN + 4);
  return ops > part ? ops : part;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c += a * b on one 16x8x8 tile (the PTX ISA's .tf32 fragment layout:
// a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); b0 (k=t, n=g),
// b1 (k=t+4, n=g); c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8,
// 2t+1); g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// elements (r, c .. c+3) of an R x C row-major matrix, zero outside
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        long long ld, int r, int c, int R,
                                        int C, bool vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (r >= R) return v;
  const float* q = p + (long long)r * ld + c;
  if (vec && c + 3 < C) return __ldg(reinterpret_cast<const float4*>(q));
  if (c < C) v.x = q[0];
  if (c + 1 < C) v.y = q[1];
  if (c + 2 < C) v.z = q[2];
  if (c + 3 < C) v.w = q[3];
  return v;
}

// The k-tile at k0 from global memory into registers and from there into
// a shared stage: A (kBM x kBK) and B (kBK x BN) as float4 quads, quad
// idx = tid + q * kThreads.  kTransA stores A k-major (As[k][m], the
// SIMT loop's layout), else row-major (As[m][k], the fragments').
template <int BN, int kSA, int kSB, bool kTransA>
struct TileLoader {
  static constexpr int kQA = kBM * kBK / 4 / kThreads;
  static constexpr int kQB = kBK * BN / 4 / kThreads;
  static_assert(kQA * 4 * kThreads == kBM * kBK, "A quads");
  static_assert(kQB * 4 * kThreads == kBK * BN, "B quads");
  float4 ra[kQA], rb[kQB];

  __device__ __forceinline__ void load(const float* __restrict__ A,
                                       long long lda,
                                       const float* __restrict__ B,
                                       long long ldb, int M, int N, int K,
                                       int m0, int n0, int k0, bool vec_a,
                                       bool vec_b) {
#pragma unroll
    for (int q = 0; q < kQA; ++q) {
      const int idx = threadIdx.x + q * kThreads;
      ra[q] = load4(A, lda, m0 + idx / (kBK / 4), k0 + idx % (kBK / 4) * 4,
                    M, K, vec_a);
    }
#pragma unroll
    for (int q = 0; q < kQB; ++q) {
      const int idx = threadIdx.x + q * kThreads;
      rb[q] = load4(B, ldb, k0 + idx / (BN / 4), n0 + idx % (BN / 4) * 4, K,
                    N, vec_b);
    }
  }

  __device__ __forceinline__ void store(float* As, float* Bs) const {
#pragma unroll
    for (int q = 0; q < kQA; ++q) {
      const int idx = threadIdx.x + q * kThreads;
      const int r = idx / (kBK / 4), k = idx % (kBK / 4) * 4;
      if (kTransA) {
        As[(k + 0) * kSA + r] = ra[q].x;
        As[(k + 1) * kSA + r] = ra[q].y;
        As[(k + 2) * kSA + r] = ra[q].z;
        As[(k + 3) * kSA + r] = ra[q].w;
      } else {
        *reinterpret_cast<float4*>(&As[r * kSA + k]) = ra[q];
      }
    }
#pragma unroll
    for (int q = 0; q < kQB; ++q) {
      const int idx = threadIdx.x + q * kThreads;
      *reinterpret_cast<float4*>(
          &Bs[idx / (BN / 4) * kSB + idx % (BN / 4) * 4]) = rb[q];
    }
  }
};

// The cluster's partial tiles (row stride BN + 4) summed in rank order
// over this rank's rows, divided by lam, written to C.
template <int BN>
__device__ __forceinline__ void reduce_store(
    float* part, int m0, int n0, int M, int N, float* __restrict__ C,
    long long ldc, const float* __restrict__ lam, long long ldl) {
  constexpr int kStride = BN + 4, kQuads = BN / 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rows = (kBM + cs - 1) / cs;
  const int r0 = (int)cluster.block_rank() * rows;
  for (int idx = threadIdx.x; idx < rows * kQuads; idx += kThreads) {
    const int lr = r0 + idx / kQuads, lc = idx % kQuads * 4;
    if (lr >= kBM) break;
    const int gm = m0 + lr, gn = n0 + lc;
    const int off = lr * kStride + lc;
    float4 sum = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, 0) + off);
    for (int q = 1; q < cs; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, q) + off);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (gm >= M) continue;
    const float s[4] = {sum.x, sum.y, sum.z, sum.w};
    float* row = C + (long long)gm * ldc;
    const float* lrow = lam ? lam + (long long)gm * ldl : nullptr;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (gn + e < N) row[gn + e] = lrow ? s[e] / lrow[gn + e] : s[e];
    }
  }
}

// (at least 2 CTAs an SM at HIGHEST and 3 on the tensor cores: the
// register caps of the timed variants)
template <int kPrec>
__global__ void __launch_bounds__(kThreads, kPrec == 0 ? 2 : 3)
    rescue_gemm_kernel(
    int M, int N, int K, const float* __restrict__ A, long long lda,
    const float* __restrict__ B, long long ldb, float* __restrict__ C,
    long long ldc, const float* __restrict__ lam, long long ldl, int chunk,
    int vec_a, int vec_b) {
  constexpr int BN = tile_n<kPrec>();
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int kb = (int)cluster.block_rank() * chunk;
  const int ke = min(K, kb + chunk);
  const int tid = threadIdx.x;

  if constexpr (kPrec == 0) {
    // ---- HIGHEST: fp32 fmaf, an 8x8 register tile a thread ----
    constexpr int kSA = kBM + 4, kSB = BN + 4;
    float* const As = smem;                      // [2][kBK][kSA]
    float* const Bs = smem + 2 * kBK * kSA;      // [2][kBK][kSB]
    TileLoader<BN, kSA, kSB, true> tile;
    const int ty = tid / 16, tx = tid % 16;      // 8 x 16 threads
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;

    tile.load(A, lda, B, ldb, M, N, K, m0, n0, kb, vec_a, vec_b);
    tile.store(As, Bs);
    __syncthreads();
    int s = 0;
    for (int k0 = kb; k0 < ke; k0 += kBK) {
      const bool more = k0 + kBK < ke;
      if (more)
        tile.load(A, lda, B, ldb, M, N, K, m0, n0, k0 + kBK, vec_a, vec_b);
      const float* as = As + s * kBK * kSA;
      const float* bs = Bs + s * kBK * kSB;
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a_lo =
            *reinterpret_cast<const float4*>(as + kk * kSA + ty * 4);
        const float4 a_hi =
            *reinterpret_cast<const float4*>(as + kk * kSA + 32 + ty * 4);
        const float4 b_lo =
            *reinterpret_cast<const float4*>(bs + kk * kSB + tx * 4);
        const float4 b_hi =
            *reinterpret_cast<const float4*>(bs + kk * kSB + 64 + tx * 4);
        const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                            a_hi.x, a_hi.y, a_hi.z, a_hi.w};
        const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                            b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            acc[r][q] = fmaf(a[r], b[q], acc[r][q]);
      }
      // the other stage was last read before the previous barrier
      if (more)
        tile.store(As + (s ^ 1) * kBK * kSA, Bs + (s ^ 1) * kBK * kSB);
      __syncthreads();
      s ^= 1;
    }
    // the partial tile over the operand stages (the loop ends on a
    // barrier, after the last reads)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float* prow = smem + ((r / 4) * 32 + ty * 4 + r % 4) * (BN + 4);
      *reinterpret_cast<float4*>(prow + tx * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(prow + 64 + tx * 4) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  } else {
    // ---- HIGH: 2x2 warps of 32x32 on mma.sync fragments ----
    // (padded rows put a fragment's 32 lanes on 32 banks: A (20 g + t),
    // B (8 t + g) mod 32 distinct)
    constexpr int kSA = kBK + 4, kSB = BN + 8;
    float* const As = smem;                      // [2][kBM][kSA]
    float* const Bs = smem + 2 * kBM * kSA;      // [2][kBK][kSB]
    TileLoader<BN, kSA, kSB, false> tile;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

    tile.load(A, lda, B, ldb, M, N, K, m0, n0, kb, vec_a, vec_b);
    tile.store(As, Bs);
    __syncthreads();
    int s = 0;
    for (int k0 = kb; k0 < ke; k0 += kBK) {
      const bool more = k0 + kBK < ke;
      if (more)
        tile.load(A, lda, B, ldb, M, N, K, m0, n0, k0 + kBK, vec_a, vec_b);
      const float* as = As + s * kBM * kSA;
      const float* bs = Bs + s * kBK * kSB;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t bb[4][2], bsm[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* bc = bs + wn + j * 8 + g;
          split(bc[(kk + t) * kSB], bb[j][0], bsm[j][0]);
          split(bc[(kk + t + 4) * kSB], bb[j][1], bsm[j][1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t ab[4], asm_[4];
          const float* ar = as + (wm + i * 16 + g) * kSA + kk + t;
          split(ar[0], ab[0], asm_[0]);
          split(ar[8 * kSA], ab[1], asm_[1]);
          split(ar[4], ab[2], asm_[2]);
          split(ar[8 * kSA + 4], ab[3], asm_[3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // the k-step's MMAs into fresh registers, small terms first,
            // then one round-to-nearest add into the running sum
            float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_tf32(part, asm_, bb[j]);
            mma_tf32(part, ab, bsm[j]);
            mma_tf32(part, ab, bb[j]);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] += part[q];
          }
        }
      }
      if (more)
        tile.store(As + (s ^ 1) * kBM * kSA, Bs + (s ^ 1) * kBK * kSB);
      __syncthreads();
      s ^= 1;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* prow = smem + (wm + i * 16 + g + 8 * h) * (BN + 4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(prow + wn + j * 8 + 2 * t) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  }
  // every rank's partial tile is in its shared memory
  cluster.sync();
  reduce_store<BN>(smem, m0, n0, M, N, C, ldc, lam, ldl);
  // no rank leaves while another may still read its partial
  cluster.sync();
}

bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

cudaLaunchConfig_t launch_config(int tn, int tm, int cs, int smem_bytes,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tn, tm, cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = cs;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster size for a grid of tn x tm output tiles over `steps`
// k-tiles on the current device, cached per (device, shape).  From the
// occupancy queries: R, the CTAs an SM holds at once, and U, the SMs that
// clusters of 8 can use (their resident clusters x 8 / R, a few fewer
// than the card has: a cluster's CTAs share one GPC).  A size cs = 1..8
// (at most one rank a k-tile) whose grid puts more than R CTAs on an SM
// (p = ceil(tn*tm*cs / U)) is skipped: it would not be resident at once;
// the others are costed by the busiest SM, a rank's k-tiles times
// max(p, 4/3) (an SM with one CTA runs it faster than with two, but not
// twice as fast), the cheapest winning, the smaller on a tie.  On an
// H100 at the 2048^2 shapes this gave the fastest of the forced sizes
// 1..8: 7 at HIGHEST (at most two CTAs an SM, where 8 put three on
// some), 5 at HIGH; 8 at 128^2 (chip_smoke.py prints the choice).
template <int kPrec>
int cluster_size(int tn, int tm, int steps, int* cs_out) {
  struct Plan {
    int dev, tn, tm, steps, cs;
  };
  static std::mutex mu;
  static Plan cache[16];
  static int n_cached = 0;
  constexpr int kSmemBytes = smem_floats<kPrec>() * 4;
  std::lock_guard<std::mutex> lock(mu);
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  for (int i = 0; i < n_cached; ++i) {
    const Plan& c = cache[i];
    if (c.dev == dev && c.tn == tn && c.tm == tm && c.steps == steps) {
      *cs_out = c.cs;
      return 0;
    }
  }
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaFuncSetAttribute(rescue_gemm_kernel<kPrec>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  int per_sm = 0, clusters = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rescue_gemm_kernel<kPrec>, kThreads, kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(tn, tm, kMaxCluster, kSmemBytes, nullptr, &attr);
  rc = cudaOccupancyMaxActiveClusters(&clusters, rescue_gemm_kernel<kPrec>,
                                      &cfg);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm <= 0 || clusters <= 0)
    return (int)cudaErrorInvalidConfiguration;
  long long usable = (long long)clusters * kMaxCluster / per_sm;
  usable = usable < 1 ? 1 : (usable > sms ? sms : usable);
  int best = 1;
  long long best_cost = -1;
  for (int cs = 1; cs <= kMaxCluster && cs <= steps; ++cs) {
    const long long p = ((long long)tn * tm * cs + usable - 1) / usable;
    if (p > per_sm && cs > 1) continue;
    // a rank's k-tiles x max(p, 4/3), in thirds
    const long long cost = ((steps + cs - 1) / cs) * (p > 1 ? 3 * p : 4);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = cs;
    }
  }
  cache[n_cached < 16 ? n_cached++ : 15] = {dev, tn, tm, steps, best};
  *cs_out = best;
  return 0;
}

template <int kPrec>
int launch_rescue(int M, int N, int K, const float* A, long long lda,
                  const float* B, long long ldb, float* C, long long ldc,
                  const float* lam, long long ldl, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  constexpr int BN = tile_n<kPrec>();
  const int tn = (N + BN - 1) / BN, tm = (M + kBM - 1) / kBM;
  const int steps = (K + kBK - 1) / kBK;
  int cs = 1;
  const int rc = cluster_size<kPrec>(tn, tm, steps, &cs);
  if (rc != 0) return rc;
  const int chunk = (steps + cs - 1) / cs * kBK;
  const int vec_a = aligned4(A) && lda % 4 == 0;
  const int vec_b = aligned4(B) && ldb % 4 == 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      tn, tm, cs, smem_floats<kPrec>() * 4, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, rescue_gemm_kernel<kPrec>, M, N, K, A, lda, B, ldb, C, ldc, lam,
      ldl, chunk, vec_a, vec_b);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// spectral_precision=HIGHEST: IEEE fp32 on the CUDA cores
int cfd_rescue_sgemm(int M, int N, int K, const float* A, long long lda,
                     const float* B, long long ldb, float* C, long long ldc,
                     const float* lam, long long ldl, cudaStream_t stream) {
  return launch_rescue<0>(M, N, K, A, lda, B, ldb, C, ldc, lam, ldl,
                          stream);
}

// spectral_precision=HIGH: 3xTF32 on the tensor cores
int cfd_rescue_3xtf32(int M, int N, int K, const float* A, long long lda,
                      const float* B, long long ldb, float* C, long long ldc,
                      const float* lam, long long ldl, cudaStream_t stream) {
  return launch_rescue<3>(M, N, K, A, lda, B, ldb, C, ldc, lam, ldl,
                          stream);
}

// the cluster size a launch of precision `passes` (0 HIGHEST, 3 HIGH)
// takes for M x N x K on the current device, or a negative CUDA error code
int cfd_rescue_cluster(int passes, int M, int N, int K) {
  const int steps = (K + kBK - 1) / kBK, tm = (M + kBM - 1) / kBM;
  int cs = 0, rc;
  if (passes == 0)
    rc = cluster_size<0>((N + tile_n<0>() - 1) / tile_n<0>(), tm, steps,
                         &cs);
  else if (passes == 3)
    rc = cluster_size<3>((N + tile_n<3>() - 1) / tile_n<3>(), tm, steps,
                         &cs);
  else
    return -static_cast<int>(cudaErrorInvalidValue);
  return rc != 0 ? -rc : cs;
}

}  // extern "C"
