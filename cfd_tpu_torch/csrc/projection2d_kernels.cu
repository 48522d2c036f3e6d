// Hand-written CUDA kernels for the 2D spectral projection step on Hopper.
//
// They replace the three TPU kernels of the reference's DST-fused 2D step:
//
//   Projection2DKernels.pred_bt   (cfd_tpu/ops/pallas/projection2d.py,
//       pred_bt_compute)  predictor, b~, forward x-DST of each block
//       -> pred_star_2d_kernel, poisson_input_2d_kernel, then the forward
//          x-DST as one sgemm_kernel launch (projection_kernels.cu)
//   make_tdma_y_2d                (cfd_tpu/ops/pallas/tdma.py)  both Thomas
//       sweeps of the per-x-mode y-lines
//       -> no kernel here: an (ny, nx) rhs is an (ny, 1, nx) stack of
//          one-row planes, so projection_kernels.cu's tdma_fwd_kernel and
//          tdma_bwd_kernel solve it (the dense low-mode rescue that follows
//          is two sgemm_kernel launches)
//   Projection2DKernels.corr      (projection2d.py, corr_compute and its
//       arrival hook)  inverse x-DST of each arriving block, corrector
//       -> the inverse x-DST as one sgemm_kernel launch, then
//          corrector_2d_kernel
//
// The TPU kernels march y-blocks through a VMEM ring and run the x-DST as
// an in-kernel MXU dot per block.  On Hopper a block cannot carry state to
// the next y-block, so the chain meets in device memory:
//
// * The stencils are bound by device-memory bandwidth (a few flops per
//   byte).  One thread per grid point; neighbours are plain loads that
//   hit L1/L2.  Only interior points read their neighbours, so nothing
//   outside the array is touched (the TPU kernel read wrapped columns and
//   uninitialised ring rows at the first and last block and discarded
//   them).  The predictor writes u*, v*, w* once and the b~ kernel
//   re-reads u*, v* at the four neighbours, where the TPU kernel recomputed
//   the predictor on a two-row-extended window: one extra read of two
//   fields instead of four times the predictor's flops and reads.
//
// NaN must survive the clamps (the step reports DIVERGED from a NaN
// maximum): the clamp is a select that passes NaN through.
//
// Built with -fmad=false: every multiply and add rounds separately, in the
// operation order of the plain PyTorch versions.  Every entry point
// returns cudaGetLastError().

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

// u* = clamp(f + dt * ((-(u f_x + v f_y) + nu lap f) + src)) at an
// interior point, in the reference kernel's operation order
// (projection2d.py:155-164).
__device__ __forceinline__ float star2(const float* __restrict__ f, int c,
                                       int sy, float uc, float vc, float src,
                                       float dt, float nu, float inv_2dx,
                                       float inv_2dy, float inv_dx2,
                                       float inv_dy2) {
  const float fc = f[c];
  const float xm = f[c - 1], xp = f[c + 1];
  const float ym = f[c - sy], yp = f[c + sy];
  const float conv = uc * ((xp - xm) * inv_2dx) + vc * ((yp - ym) * inv_2dy);
  const float c2 = 2.0f * fc;
  const float lap = ((xp - c2) + xm) * inv_dx2 + ((yp - c2) + ym) * inv_dy2;
  return clamp_keep_nan(fc + dt * ((-conv + nu * lap) + src));
}

__global__ void pred_star_2d_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, float* __restrict__ us,
    float* __restrict__ vs, float* __restrict__ ws,
    const float* __restrict__ scal, int ny, int nx, float nu, float inv_2dx,
    float inv_2dy, float inv_dx2, float inv_dy2, float xmin, float ymin,
    float dx, float dy, int with_sources) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int c = j * nx + i;
  if (j == 0 || j == ny - 1 || i == 0 || i == nx - 1) {
    us[c] = u[c];  // caller shells pass through (save/restore idiom)
    vs[c] = v[c];
    ws[c] = w[c];
    return;
  }
  const float dt = scal[0], su = scal[1], sv = scal[2];
  const float uc = u[c], vc = v[c];
  float src_u = 0.0f, src_v = 0.0f;
  if (with_sources) {
    src_u = su * sinf(kPi * (ymin + (float)j * dy));
    src_v = sv * sinf(kTwoPi * (xmin + (float)i * dx));
  }
  us[c] = star2(u, c, nx, uc, vc, src_u, dt, nu, inv_2dx, inv_2dy, inv_dx2,
                inv_dy2);
  vs[c] = star2(v, c, nx, uc, vc, src_v, dt, nu, inv_2dx, inv_2dy, inv_dx2,
                inv_dy2);
  ws[c] = star2(w, c, nx, uc, vc, 0.0f, dt, nu, inv_2dx, inv_2dy, inv_dx2,
                inv_dy2);
}

// b~ = face_coeff * p - (rho/dt) div u* on the interior, 0 on the shell
// (projection2d.py:186-191); with emit_rhs the iterative solvers' rhs =
// (rho/dt) div u* instead (projection2d.py:196-197; p is not read).
__global__ void poisson_input_2d_kernel(
    const float* __restrict__ us, const float* __restrict__ vs,
    const float* __restrict__ p, float* __restrict__ bt,
    const float* __restrict__ rod_ptr, int ny, int nx, float inv_2dx,
    float inv_2dy, float inv_dx2, float inv_dy2, int emit_rhs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int c = j * nx + i;
  if (j == 0 || j == ny - 1 || i == 0 || i == nx - 1) {
    bt[c] = 0.0f;
    return;
  }
  const float div = (us[c + 1] - us[c - 1]) * inv_2dx
                    + (vs[c + nx] - vs[c - nx]) * inv_2dy;
  if (emit_rhs) {
    bt[c] = (*rod_ptr) * div;
    return;
  }
  const float cx = inv_dx2 * (float)((i == 1) + (i == nx - 2));
  const float cy = inv_dy2 * (float)((j == 1) + (j == ny - 2));
  bt[c] = (cx + cy) * p[c] - (*rod_ptr) * div;
}

// Corrector u = clamp(u* - (dt/rho) p_x), v = clamp(v* - (dt/rho) p_y) on
// the interior; shells pass through from u*, v* (projection2d.py:259-267).
__global__ void corrector_2d_kernel(
    const float* __restrict__ us, const float* __restrict__ vs,
    const float* __restrict__ p, float* __restrict__ u,
    float* __restrict__ v, const float* __restrict__ s_ptr, int ny, int nx,
    float inv_2dx, float inv_2dy) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int c = j * nx + i;
  float uo = us[c], vo = vs[c];
  if (j > 0 && j < ny - 1 && i > 0 && i < nx - 1) {
    const float s = *s_ptr;
    uo = clamp_keep_nan(uo - s * ((p[c + 1] - p[c - 1]) * inv_2dx));
    vo = clamp_keep_nan(vo - s * ((p[c + nx] - p[c - nx]) * inv_2dy));
  }
  u[c] = uo;
  v[c] = vo;
}

dim3 stencil_grid_2d(int ny, int nx) {
  return dim3((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY, 1);
}

}  // namespace

extern "C" {

int cfd_pred_star_2d(const float* u, const float* v, const float* w,
                     float* us, float* vs, float* ws, const float* scal,
                     int ny, int nx, float nu, float inv_2dx, float inv_2dy,
                     float inv_dx2, float inv_dy2, float xmin, float ymin,
                     float dx, float dy, int with_sources,
                     cudaStream_t stream) {
  pred_star_2d_kernel<<<stencil_grid_2d(ny, nx), dim3(kTileX, kTileY), 0,
                        stream>>>(u, v, w, us, vs, ws, scal, ny, nx, nu,
                                  inv_2dx, inv_2dy, inv_dx2, inv_dy2, xmin,
                                  ymin, dx, dy, with_sources);
  return (int)cudaGetLastError();
}

int cfd_poisson_input_2d(const float* us, const float* vs, const float* p,
                         float* bt, const float* rod, int ny, int nx,
                         float inv_2dx, float inv_2dy, float inv_dx2,
                         float inv_dy2, int emit_rhs,
                         cudaStream_t stream) {
  poisson_input_2d_kernel<<<stencil_grid_2d(ny, nx), dim3(kTileX, kTileY),
                            0, stream>>>(us, vs, p, bt, rod, ny, nx, inv_2dx,
                                         inv_2dy, inv_dx2, inv_dy2,
                                         emit_rhs);
  return (int)cudaGetLastError();
}

int cfd_corrector_2d(const float* us, const float* vs, const float* p,
                     float* u, float* v, const float* s, int ny, int nx,
                     float inv_2dx, float inv_2dy, cudaStream_t stream) {
  corrector_2d_kernel<<<stencil_grid_2d(ny, nx), dim3(kTileX, kTileY), 0,
                        stream>>>(us, vs, p, u, v, s, ny, nx, inv_2dx,
                                  inv_2dy);
  return (int)cudaGetLastError();
}

}  // extern "C"
