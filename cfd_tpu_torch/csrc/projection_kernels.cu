// Hand-written CUDA kernels for the 3D spectral projection step on Hopper.
//
// They replace the two TPU mega kernels of the reference
// (cfd_tpu/ops/pallas/projection_kernels.py):
//
//   A1  ProjectionKernels.pred_bt   (pred_bt_compute)   predictor, b~,
//       forward xy DST, Thomas forward sweep
//       -> pred_star_kernel, poisson_input_kernel, sgemm_kernel (x2),
//          tdma_fwd_kernel; with emit="rhs" (the CG step) only the first
//          two, poisson_input_kernel emitting (rho/dt) div u*
//   A2  ProjectionKernels.corr_bwd  (corr_bwd_compute)  Thomas back
//       substitution, inverse xy DST, corrector, three max reductions
//       -> tdma_bwd_kernel, sgemm_kernel (x2), corrector_kernel,
//          reduce_max3_kernel
//
// The TPU kernels march z-planes through a ring of VMEM buffers so every
// plane is read from HBM once and the DST dots hide under the streaming.
// On Hopper the plane-wide DST (1 MiB per 512x512 plane) does not fit one
// block's shared memory, and blocks cannot carry state from one z-plane
// to the next, so each TPU kernel becomes a short chain of kernels that
// meet in device memory:
//
// * The stencil kernels (predictor, b~, corrector) are bound by device
//   memory bandwidth: a few flops per byte.  One thread per grid point;
//   neighbours are plain loads that hit L1/L2.  Interior points only read
//   their neighbours, so nothing outside the array is ever touched (the
//   TPU kernel instead read ring garbage at the z-ends and discarded it).
// * The DST products are dense fp32 GEMMs (2*n^4 flops per product at
//   n^3), bound by the fp32 FMA rate of the CUDA cores: TF32 would break
//   the HIGHEST-precision contract.  A shared-memory-tiled SGEMM with an
//   8x8 register tile per thread keeps the FMA units fed from registers.
// * The Thomas sweeps are sequential in z and independent per (y, x)
//   mode: one thread per mode marches all planes, so each plane access
//   is coalesced across a warp.  Bound by memory bandwidth.
//
// NaN must survive the clamps and the maxima (the step reports
// DIVERGED from a NaN maximum): the clamp is written as selects that pass
// NaN through, and the max reduction is a two-pass tree with a
// NaN-propagating combine (fminf / fmaxf and integer atomicMax would drop
// NaN).
//
// Built with -fmad=false: every multiply and add rounds separately, in the
// operation order of the plain PyTorch versions; the GEMM uses explicit
// fmaf.  Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kClamp = 100.0f;            // PROJ_MAX_VELOCITY
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kTileX = 32, kTileY = 8;     // stencil blocks: 256 threads

// jnp.clip semantics: a NaN input compares false both ways and passes.
__device__ __forceinline__ float clamp_keep_nan(float x) {
  return x < -kClamp ? -kClamp : (x > kClamp ? kClamp : x);
}

// jnp.maximum semantics: NaN in either argument wins.
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// u* = clamp(f + dt * (-(u f_x + v f_y + w f_z) + nu lap f + src)) at an
// interior point, in the reference kernel's operation order.
__device__ __forceinline__ float star(const float* __restrict__ f,
                                      long long c, long long sy,
                                      long long sz, float uc, float vc,
                                      float wc, float src, float dt,
                                      float nu, float inv_2dx, float inv_2dy,
                                      float inv_2dz, float inv_dx2,
                                      float inv_dy2, float inv_dz2) {
  const float fc = f[c];
  const float xm = f[c - 1], xp = f[c + 1];
  const float ym = f[c - sy], yp = f[c + sy];
  const float zm = f[c - sz], zp = f[c + sz];
  const float conv = (uc * ((xp - xm) * inv_2dx) + vc * ((yp - ym) * inv_2dy))
                     + wc * ((zp - zm) * inv_2dz);
  const float c2 = 2.0f * fc;
  const float lap = (((xp - c2) + xm) * inv_dx2 + ((yp - c2) + ym) * inv_dy2)
                    + ((zp - c2) + zm) * inv_dz2;
  return clamp_keep_nan(fc + dt * ((-conv + nu * lap) + src));
}

__global__ void pred_star_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, float* __restrict__ us,
    float* __restrict__ vs, float* __restrict__ ws,
    const float* __restrict__ scal, int nz, int ny, int nx, float nu,
    float inv_2dx, float inv_2dy, float inv_2dz, float inv_dx2,
    float inv_dy2, float inv_dz2, float xmin, float ymin, float dx, float dy,
    int with_sources) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nx || j >= ny) return;
  const long long sy = nx, sz = (long long)ny * nx;
  const long long c = k * sz + j * sy + i;
  if (k == 0 || k == nz - 1 || j == 0 || j == ny - 1 || i == 0 ||
      i == nx - 1) {
    us[c] = u[c];  // caller shells pass through (save/restore idiom)
    vs[c] = v[c];
    ws[c] = w[c];
    return;
  }
  const float dt = scal[0], su = scal[1], sv = scal[2];
  const float uc = u[c], vc = v[c], wc = w[c];
  float src_u = 0.0f, src_v = 0.0f;
  if (with_sources) {
    src_u = su * sinf(kPi * (ymin + (float)j * dy));
    src_v = sv * sinf(kTwoPi * (xmin + (float)i * dx));
  }
  us[c] = star(u, c, sy, sz, uc, vc, wc, src_u, dt, nu, inv_2dx, inv_2dy,
               inv_2dz, inv_dx2, inv_dy2, inv_dz2);
  vs[c] = star(v, c, sy, sz, uc, vc, wc, src_v, dt, nu, inv_2dx, inv_2dy,
               inv_2dz, inv_dx2, inv_dy2, inv_dz2);
  ws[c] = star(w, c, sy, sz, uc, vc, wc, 0.0f, dt, nu, inv_2dx, inv_2dy,
               inv_2dz, inv_dx2, inv_dy2, inv_dz2);
}

// b~ = face_coeff * p - (rho/dt) div u* on the interior, 0 on the shell;
// with emit_rhs the iterative solvers' rhs = (rho/dt) div u* instead
// (projection_kernels.py:699-701: no face term, no minus; p is not read).
__global__ void poisson_input_kernel(
    const float* __restrict__ us, const float* __restrict__ vs,
    const float* __restrict__ ws, const float* __restrict__ p,
    float* __restrict__ bt, const float* __restrict__ rod_ptr, int nz,
    int ny, int nx, float inv_2dx, float inv_2dy, float inv_2dz,
    float inv_dx2, float inv_dy2, float inv_dz2, int emit_rhs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nx || j >= ny) return;
  const long long sy = nx, sz = (long long)ny * nx;
  const long long c = k * sz + j * sy + i;
  if (k == 0 || k == nz - 1 || j == 0 || j == ny - 1 || i == 0 ||
      i == nx - 1) {
    bt[c] = 0.0f;
    return;
  }
  const float div = ((us[c + 1] - us[c - 1]) * inv_2dx
                     + (vs[c + sy] - vs[c - sy]) * inv_2dy)
                    + (ws[c + sz] - ws[c - sz]) * inv_2dz;
  if (emit_rhs) {
    bt[c] = (*rod_ptr) * div;
    return;
  }
  const float cx = inv_dx2 * (float)((i == 1) + (i == nx - 2));
  const float cy = inv_dy2 * (float)((j == 1) + (j == ny - 2));
  const float cz = inv_dz2 * (float)((k == 1) + (k == nz - 2));
  bt[c] = ((cx + cy) + cz) * p[c] - (*rod_ptr) * div;
}

// Batched row-major C[b] = A[b] (M x K) * B[b] (K x N); a zero batch
// stride shares one matrix across the batch.  128x128 block tile, k-step
// 8, 256 threads, each thread an 8x8 register tile split into two 4-wide
// halves 64 apart so the float4 shared-memory reads of a warp are
// contiguous.  Two shared-memory stages: the next k-tile is loaded from
// global memory into registers while the current one is multiplied, then
// stored to the other stage, so one barrier per k-step suffices and the
// global latency hides under the FMAs.  Accumulates k in ascending order
// with fmaf.
constexpr int kBM = 128, kBN = 128, kBK = 8;

__global__ void __launch_bounds__(256) sgemm_kernel(
    int M, int N, int K, const float* __restrict__ A, long long lda,
    long long sA, const float* __restrict__ B, long long ldb, long long sB,
    float* __restrict__ C, long long ldc, long long sC) {
  __shared__ __align__(16) float As[2][kBK][kBM + 4];
  __shared__ __align__(16) float Bs[2][kBK][kBN + 4];
  const long long bz = blockIdx.z;
  A += bz * sA;
  B += bz * sB;
  C += bz * sC;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;   // A tile: 128 x 8
  const int b_k = tid >> 5, b_col = (tid & 31) * 4;  // B tile: 8 x 128

  float ra[4], rb[4];  // the k-tile in flight, global -> shared
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gm = m0 + a_row, gk = k0 + a_k + q;
      ra[q] = (gm < M && gk < K) ? A[gm * lda + gk] : 0.0f;
      const int gk2 = k0 + b_k, gn = n0 + b_col + q;
      rb[q] = (gk2 < K && gn < N) ? B[gk2 * ldb + gn] : 0.0f;
    }
  };
  auto store = [&](int s) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      As[s][a_k + q][a_row] = ra[q];
      Bs[s][b_k][b_col + q] = rb[q];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;

  load(0);
  store(0);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a_lo =
          *reinterpret_cast<const float4*>(&As[s][kk][ty * 4]);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(&As[s][kk][64 + ty * 4]);
      const float4 b_lo =
          *reinterpret_cast<const float4*>(&Bs[s][kk][tx * 4]);
      const float4 b_hi =
          *reinterpret_cast<const float4*>(&Bs[s][kk][64 + tx * 4]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                          a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                          b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(a[r], b[q], acc[r][q]);
    }
    // the other stage was last read before the previous barrier
    if (more) store(s ^ 1);
    __syncthreads();
    s ^= 1;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gm = m0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int gn = n0 + (q < 4 ? tx * 4 + q : 64 + tx * 4 + q - 4);
      if (gn < N) C[gm * ldc + gn] = acc[r][q];
    }
  }
}

// Thomas forward sweep along z for every (y, x) mode of the transformed
// b~: rec = 1/(mu + 2w - w t), t = w rec, d' = (b^ + w d') rec for
// k = 1..nz-2 from a zero carry; d' and t have zero z-shells.
__global__ void tdma_fwd_kernel(const float* __restrict__ r,
                                const float* __restrict__ mu, float w,
                                float* __restrict__ d, float* __restrict__ t,
                                int nz, long long plane) {
  const long long m = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (m >= plane) return;
  const float b = mu[m] + 2.0f * w;
  float tc = 0.0f, dc = 0.0f;
  d[m] = 0.0f;
  t[m] = 0.0f;
  for (int k = 1; k < nz - 1; ++k) {
    const long long c = k * plane + m;
    const float rec = 1.0f / (b - w * tc);
    tc = w * rec;
    dc = (r[c] + w * dc) * rec;
    d[c] = dc;
    t[c] = tc;
  }
  d[(nz - 1) * plane + m] = 0.0f;
  t[(nz - 1) * plane + m] = 0.0f;
}

// Thomas back substitution x^ = d' + t x^ for k = nz-2 down to 1 from a
// zero carry, with mirror z-shells x^[0] = x^[1], x^[nz-1] = x^[nz-2].
__global__ void tdma_bwd_kernel(const float* __restrict__ d,
                                const float* __restrict__ t,
                                float* __restrict__ x, int nz,
                                long long plane) {
  const long long m = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (m >= plane) return;
  float xc = 0.0f;
  for (int k = nz - 2; k >= 1; --k) {
    const long long c = k * plane + m;
    xc = d[c] + t[c] * xc;
    x[c] = xc;
    if (k == nz - 2) x[(nz - 1) * plane + m] = xc;
  }
  x[m] = xc;
}

// Corrector u = clamp(u* - (dt/rho) grad p) on the interior (shells pass
// through from u*), plus per-block maxima of |u|^2, p and |p| over the
// planes k = 1..nz-2 into partials[3 * block + q].
__global__ void __launch_bounds__(kTileX * kTileY) corrector_kernel(
    const float* __restrict__ us, const float* __restrict__ vs,
    const float* __restrict__ ws, const float* __restrict__ p,
    float* __restrict__ u, float* __restrict__ v, float* __restrict__ w,
    const float* __restrict__ s_ptr, float* __restrict__ partials, int nz,
    int ny, int nx, float inv_2dx, float inv_2dy, float inv_2dz) {
  __shared__ float red[3][kTileX * kTileY];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  float m2 = -INFINITY, pm = -INFINITY, pa = -INFINITY;
  if (i < nx && j < ny) {
    const long long sy = nx, sz = (long long)ny * nx;
    const long long c = k * sz + j * sy + i;
    const bool zint = k > 0 && k < nz - 1;
    float uo = us[c], vo = vs[c], wo = ws[c];
    if (zint && j > 0 && j < ny - 1 && i > 0 && i < nx - 1) {
      const float s = *s_ptr;
      uo = clamp_keep_nan(uo - s * ((p[c + 1] - p[c - 1]) * inv_2dx));
      vo = clamp_keep_nan(vo - s * ((p[c + sy] - p[c - sy]) * inv_2dy));
      wo = clamp_keep_nan(wo - (s * (p[c + sz] - p[c - sz])) * inv_2dz);
    }
    u[c] = uo;
    v[c] = vo;
    w[c] = wo;
    if (zint) {
      const float pc = p[c];
      m2 = (uo * uo + vo * vo) + wo * wo;
      pm = pc;
      pa = fabsf(pc);
    }
  }
  red[0][tid] = m2;
  red[1][tid] = pm;
  red[2][tid] = pa;
  __syncthreads();
  for (int half = kTileX * kTileY / 2; half > 0; half >>= 1) {
    if (tid < half) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        red[q][tid] = max_keep_nan(red[q][tid], red[q][tid + half]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    const long long blk =
        ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
        blockIdx.x;
#pragma unroll
    for (int q = 0; q < 3; ++q) partials[3 * blk + q] = red[q][0];
  }
}

// Second pass: one block folds the per-block partials into out[0..2].
constexpr int kReduceThreads = 1024;

__global__ void __launch_bounds__(kReduceThreads) reduce_max3_kernel(
    const float* __restrict__ partials, long long n, float* __restrict__ out) {
  __shared__ float red[3][kReduceThreads];
  const int tid = threadIdx.x;
  float acc[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (long long b = tid; b < n; b += kReduceThreads) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
      acc[q] = max_keep_nan(acc[q], partials[3 * b + q]);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) red[q][tid] = acc[q];
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (tid < half) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        red[q][tid] = max_keep_nan(red[q][tid], red[q][tid + half]);
    }
    __syncthreads();
  }
  if (tid < 3) out[tid] = red[tid][0];
}

dim3 stencil_grid(int nz, int ny, int nx) {
  return dim3((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY, nz);
}

unsigned int mode_blocks(long long plane) {
  return (unsigned int)((plane + 255) / 256);
}

}  // namespace

extern "C" {

const char* cfd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int cfd_pred_star(const float* u, const float* v, const float* w, float* us,
                  float* vs, float* ws, const float* scal, int nz, int ny,
                  int nx, float nu, float inv_2dx, float inv_2dy,
                  float inv_2dz, float inv_dx2, float inv_dy2, float inv_dz2,
                  float xmin, float ymin, float dx, float dy,
                  int with_sources, cudaStream_t stream) {
  pred_star_kernel<<<stencil_grid(nz, ny, nx), dim3(kTileX, kTileY), 0,
                     stream>>>(u, v, w, us, vs, ws, scal, nz, ny, nx, nu,
                               inv_2dx, inv_2dy, inv_2dz, inv_dx2, inv_dy2,
                               inv_dz2, xmin, ymin, dx, dy, with_sources);
  return (int)cudaGetLastError();
}

int cfd_poisson_input(const float* us, const float* vs, const float* ws,
                      const float* p, float* bt, const float* rod, int nz,
                      int ny, int nx, float inv_2dx, float inv_2dy,
                      float inv_2dz, float inv_dx2, float inv_dy2,
                      float inv_dz2, int emit_rhs, cudaStream_t stream) {
  poisson_input_kernel<<<stencil_grid(nz, ny, nx), dim3(kTileX, kTileY), 0,
                         stream>>>(us, vs, ws, p, bt, rod, nz, ny, nx,
                                   inv_2dx, inv_2dy, inv_2dz, inv_dx2,
                                   inv_dy2, inv_dz2, emit_rhs);
  return (int)cudaGetLastError();
}

int cfd_sgemm_batched(int M, int N, int K, const float* A, long long lda,
                      long long sA, const float* B, long long ldb,
                      long long sB, float* C, long long ldc, long long sC,
                      int batch, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  sgemm_kernel<<<grid, 256, 0, stream>>>(M, N, K, A, lda, sA, B, ldb, sB, C,
                                         ldc, sC);
  return (int)cudaGetLastError();
}

int cfd_tdma_fwd(const float* r, const float* mu, float w, float* d,
                 float* t, int nz, long long plane, cudaStream_t stream) {
  tdma_fwd_kernel<<<mode_blocks(plane), 256, 0, stream>>>(r, mu, w, d, t, nz,
                                                           plane);
  return (int)cudaGetLastError();
}

int cfd_tdma_bwd(const float* d, const float* t, float* x, int nz,
                 long long plane, cudaStream_t stream) {
  tdma_bwd_kernel<<<mode_blocks(plane), 256, 0, stream>>>(d, t, x, nz,
                                                           plane);
  return (int)cudaGetLastError();
}

long long cfd_corrector_partials(int nz, int ny, int nx) {
  const dim3 g = stencil_grid(nz, ny, nx);
  return (long long)g.x * g.y * g.z;
}

int cfd_corrector(const float* us, const float* vs, const float* ws,
                  const float* p, float* u, float* v, float* w,
                  const float* s, float* partials, float* out, int nz,
                  int ny, int nx, float inv_2dx, float inv_2dy,
                  float inv_2dz, cudaStream_t stream) {
  const dim3 grid = stencil_grid(nz, ny, nx);
  corrector_kernel<<<grid, dim3(kTileX, kTileY), 0, stream>>>(
      us, vs, ws, p, u, v, w, s, partials, nz, ny, nx, inv_2dx, inv_2dy,
      inv_2dz);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_max3_kernel<<<1, kReduceThreads, 0, stream>>>(
      partials, cfd_corrector_partials(nz, ny, nx), out);
  return (int)cudaGetLastError();
}

}  // extern "C"
