// Hand-written 3xTF32 tensor-core GEMM for Hopper (sm_90a).
//
// It replaces the in-kernel DST dots of the reference's projection mega
// kernels at Precision.HIGH: rolling.hp_dot_general
// (cfd_tpu/ops/pallas/rolling.py:42-70), the manual bf16_3x split that
// Mosaic lowers for HIGH, called from ProjectionKernels' plane_dot_rl
// (projection_kernels.py:226-250) and the 2D block_dot
// (projection2d.py:97-106).  On Hopper the split is TF32: each fp32
// operand becomes big = rna_tf32(a) and small = rna_tf32(a - big) (a - big
// is exact in fp32), and a product is accumulated in fp32 as
//
//     small*big + big*small + big*big
//
// per 8-deep k-step, the small terms first (CUTLASS's "fast accurate
// fp32" order), each step's three MMAs into fresh registers that one
// IEEE add then takes into the running sum.  The dropped small*small
// term and small's own rounding are about 2^-22 relative: fp32-class,
// where one TF32 pass keeps only about 2^-11.
//
// Bound: the tensor cores.  3 * 2*M*N*K operations at the dense TF32
// rate (494.7 TFLOP/s on an H100 SXM); the fp32 SGEMM it replaces for
// HIGH runs on the CUDA cores at 67 TFLOP/s.  Design: a 128x128 output
// tile a CTA, k-tiles of 16, 256 threads as 2x4 warps of 64x32; each
// warp issues mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 on 4x4
// fragments, three a fragment pair.  The next k-tile is loaded from
// global memory into registers while the current one is multiplied and
// stored to the other of two shared-memory stages, so one barrier a
// k-tile suffices.  At most 128 registers a thread (one m-tile's A
// fragments live at a time), so two CTAs share an SM.  The shared rows
// are padded (A by 4, B by 8 floats) so the 32 lanes of a fragment load
// hit 32 banks.  The split runs on the fragments, as they are loaded.
// wgmma, TMA and a persistent schedule are later work (the one-pass
// DEFAULT GEMM has them: gemm_tf32.cu).
//
// Same C interface as cfd_sgemm_batched: row-major C[b] = A[b] (M x K)
// * B[b] (K x N) with leading dimensions and batch strides (a zero batch
// stride shares one matrix), so a caller may pass column slices.  Vector
// (float4) loads only where every base, leading dimension and batch
// stride is a multiple of 4 floats; element loads with bounds otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;
constexpr int kAStride = kBK + 4;   // 20: (20 g + t) mod 32 distinct
constexpr int kBStride = kBN + 8;   // 136: (8 t + g) mod 32 distinct

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

// c += a * b on one 16x8x8 tile (fragments in the PTX ISA's layout for
// .tf32: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); b0 (k=t,
// n=g), b1 (k=t+4, n=g); c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
// c3 (g+8, 2t+1); g = lane / 4, t = lane % 4).
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

__global__ void __launch_bounds__(kThreads, 2) gemm_3xtf32_kernel(
    int M, int N, int K, const float* __restrict__ A, long long lda,
    long long sA, const float* __restrict__ B, long long ldb, long long sB,
    float* __restrict__ C, long long ldc, long long sC, int vec) {
  __shared__ __align__(16) float As[2][kBM][kAStride];
  __shared__ __align__(16) float Bs[2][kBK][kBStride];
  const long long bz = blockIdx.z;
  A += bz * sA;
  B += bz * sB;
  C += bz * sC;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  // global -> shared: A as 2 x (64 rows x 4 quads), B as 2 x (8 rows x
  // 32 quads); a warp reads 8 A rows of 64 bytes or one B row of 512
  const int a_row = tid >> 2, a_k = (tid & 3) * 4;
  const int b_k = tid >> 5, b_col = (tid & 31) * 4;

  float4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      ra[q] = load4(A, lda, m0 + a_row + 64 * q, k0 + a_k, M, K, vec);
      rb[q] = load4(B, ldb, k0 + b_k + 8 * q, n0 + b_col, K, N, vec);
    }
  };
  auto store = [&](int s) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      *reinterpret_cast<float4*>(&As[s][a_row + 64 * q][a_k]) = ra[q];
      *reinterpret_cast<float4*>(&Bs[s][b_k + 8 * q][b_col]) = rb[q];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  load(0);
  store(0);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + g;
        split(Bs[s][kk + t][c], bb[j][0], bs[j][0]);
        split(Bs[s][kk + t + 4][c], bb[j][1], bs[j][1]);
      }
      // one m-tile's A fragments at a time keeps the live fragments to
      // 24 registers.  Each tile's step sums small*big, big*small, then
      // big*big into fresh registers, and one round-to-nearest add takes
      // that partial into the accumulator: the tensor core does not round
      // its fp32 sums to nearest, and adding every MMA straight into the
      // running sum made the error grow with the depth of the sum
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t ab[4], as[4];
        const int r = wm + i * 16 + g;
        split(As[s][r][kk + t], ab[0], as[0]);
        split(As[s][r + 8][kk + t], ab[1], as[1]);
        split(As[s][r][kk + t + 4], ab[2], as[2]);
        split(As[s][r + 8][kk + t + 4], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(part, as, bb[j]);
          mma_tf32(part, ab, bs[j]);
          mma_tf32(part, ab, bb[j]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += part[q];
        }
      }
    }
    // the other stage was last read before the previous barrier
    if (more) store(s ^ 1);
    __syncthreads();
    s ^= 1;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm + i * 16 + g + 8 * h;
      if (gm >= M) continue;
      float* row = C + (long long)gm * ldc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + wn + j * 8 + 2 * t;
        if (gn < N) row[gn] = acc[i][j][2 * h];
        if (gn + 1 < N) row[gn + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int launch_gemm(int M, int N, int K, const float* A, long long lda,
                long long sA, const float* B, long long ldb, long long sB,
                float* C, long long ldc, long long sC, int batch,
                cudaStream_t stream) {
  const int vec = aligned4(A) && aligned4(B) && lda % 4 == 0 &&
                  ldb % 4 == 0 && sA % 4 == 0 && sB % 4 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  gemm_3xtf32_kernel<<<grid, kThreads, 0, stream>>>(
      M, N, K, A, lda, sA, B, ldb, sB, C, ldc, sC, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cfd_sgemm_3xtf32_batched(int M, int N, int K, const float* A,
                             long long lda, long long sA, const float* B,
                             long long ldb, long long sB, float* C,
                             long long ldc, long long sC, int batch,
                             cudaStream_t stream) {
  return launch_gemm(M, N, K, A, lda, sA, B, ldb, sB, C, ldc, sC, batch,
                     stream);
}

}  // extern "C"
