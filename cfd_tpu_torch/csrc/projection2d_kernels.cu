// Hand-written CUDA kernels for the 2D spectral projection step on Hopper.
//
// They replace the three TPU kernels of the reference's DST-fused 2D step:
//
//   Projection2DKernels.pred_bt   (cfd_tpu/ops/pallas/projection2d.py,
//       pred_bt_compute)  predictor (Boussinesq buoyancy with T as one
//       more input), b~, forward x-DST of each block
//       -> pred_star_2d_kernel, poisson_input_2d_kernel, then the forward
//          x-DST as one SGEMM launch (sgemm_fp32.cu)
//   Projection2DKernels.pred_only / bt_only  (the split pair the
//       bc_refresh step runs, the caller's hook between them)
//       -> the same two kernels: the port's pred_bt was already that chain
//   make_tdma_y_2d                (cfd_tpu/ops/pallas/tdma.py)  both Thomas
//       sweeps of the per-x-mode y-lines
//       -> no kernel here: an (ny, nx) rhs is an (ny, 1, nx) stack of
//          one-row planes, so projection_kernels.cu's tdma_fwd_kernel and
//          tdma_bwd_kernel solve it (the dense low-mode rescue that follows
//          is two rescue_gemm.cu launches)
//   Projection2DKernels.corr      (projection2d.py, corr_compute and its
//       arrival hook)  inverse x-DST of each arriving block, corrector
//       -> the inverse x-DST as one SGEMM launch, then
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
// The y-decomposed step (Projection2DKernels(global_ny=...),
// projection2d.py:46-110, 113-123, 200-216, 252-282) is the kRows
// instantiation of the three stencil kernels: a shard's rows padded with
// its neighbours' (2 a side for the predictor, whose u*, v* the b~ kernel
// reads at the owned rows +- 1; 1 of the pressure for the corrector), the
// interior masks, b~'s y face term and the sin(pi y) source at the global
// row y_base + j of an ny_g-row domain, the global y-shells (and the halo
// rows past them) passed through or zero; b~ and the corrector cover the
// owned window only and write it owned-size.  The reference pads four
// rows a side (its 8-row sublane tile); two are what the stencils read.
//
// The consistent scheme on a stretched grid is the kCons instantiation of
// the three stencil kernels, which read per-axis weight vectors (x rows
// [wm, wc, wp, lm, lc, lp, sin(2 pi x)] of length nx, y rows of length ny,
// ops/kernels/stretch.py) in place of the scalar inverse spacings: the
// reference runs that step as jnp (projection.py:292-293), so these
// follow its operators (common.spacing_operators) in the order of the 3D
// kernels (projection_kernels.cu), without the z terms.
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

struct Weights2 {
  const float* x;  // 7 rows of nx
  const float* y;  // 7 rows of ny
  int nx, ny;
  __device__ __forceinline__ float wx(int r, int i) const {
    return x[r * nx + i];
  }
  __device__ __forceinline__ float wy(int r, int j) const {
    return y[r * ny + j];
  }
};

// (f[i-1] wm + f wc) + f[i+1] wp along x (d = 1) or y (d = nx).
__device__ __forceinline__ float d1_cons(const float* __restrict__ f, int c,
                                         int d, float wm, float wc,
                                         float wp) {
  return (f[c - d] * wm + f[c] * wc) + f[c + d] * wp;
}

// The consistent scheme's star: the Laplacian one chain, x then y.
__device__ __forceinline__ float star2_cons(const float* __restrict__ f,
                                            int c, int sy, int j, int i,
                                            float uc, float vc, float src,
                                            float dt, float nu,
                                            const Weights2& wt) {
  const float fc = f[c];
  const float xm = f[c - 1], xp = f[c + 1];
  const float ym = f[c - sy], yp = f[c + sy];
  const float d1x = (xm * wt.wx(0, i) + fc * wt.wx(1, i)) + xp * wt.wx(2, i);
  const float d1y = (ym * wt.wy(0, j) + fc * wt.wy(1, j)) + yp * wt.wy(2, j);
  const float conv = uc * d1x + vc * d1y;
  const float lap =
      ((((xm * wt.wx(3, i) + fc * wt.wx(4, i)) + xp * wt.wx(5, i)) +
        ym * wt.wy(3, j)) +
       fc * wt.wy(4, j)) +
      yp * wt.wy(5, j);
  return clamp_keep_nan(fc + dt * ((-conv + nu * lap) + src));
}

// With buoyancy (buoy_mask bit c set where g[c] != 0), component c's
// source also takes bcoef[c] * (T - T_ref), bcoef[c] = (-beta) * g[c]
// rounded in float32 on the host (projection2d.py:166-176); T is read
// only then and may be null.
struct Buoyancy2 {
  float coef[3], tref;
  int mask;
};

// The y-shell test: the block's own end rows, and with kRows the global
// y-shells and the rows past them (local row j is global row y_base + j
// of an ny_g-row domain).
template <bool kRows>
__device__ __forceinline__ bool y_shell_2d(int j, int ny, int y_base,
                                           int ny_g) {
  if (j == 0 || j == ny - 1) return true;
  const int jg = y_base + j;
  return kRows && (jg <= 0 || jg >= ny_g - 1);
}

template <bool kCons, bool kRows>
__global__ void pred_star_2d_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, float* __restrict__ us,
    float* __restrict__ vs, float* __restrict__ ws,
    const float* __restrict__ scal, const float* __restrict__ T, int ny,
    int nx, float nu, float inv_2dx, float inv_2dy, float inv_dx2,
    float inv_dy2, float xmin, float ymin, float dx, float dy,
    int with_sources, Buoyancy2 buoy, Weights2 wt, int y_base, int ny_g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int c = j * nx + i;
  if (y_shell_2d<kRows>(j, ny, y_base, ny_g) || i == 0 || i == nx - 1) {
    us[c] = u[c];  // caller shells pass through (save/restore idiom)
    vs[c] = v[c];
    ws[c] = w[c];
    return;
  }
  const float dt = scal[0], su = scal[1], sv = scal[2];
  const float uc = u[c], vc = v[c];
  float src_u = 0.0f, src_v = 0.0f, src_w = 0.0f;
  if (with_sources) {
    if (kCons) {  // true coordinates
      src_u = su * wt.wy(6, j);
      src_v = sv * wt.wx(6, i);
    } else {
      const int jg = kRows ? y_base + j : j;  // the global row
      src_u = su * sinf(kPi * (ymin + (float)jg * dy));
      src_v = sv * sinf(kTwoPi * (xmin + (float)i * dx));
    }
  }
  if (buoy.mask) {
    const float dT = T[c] - buoy.tref;
    if (buoy.mask & 1) src_u = src_u + buoy.coef[0] * dT;
    if (buoy.mask & 2) src_v = src_v + buoy.coef[1] * dT;
    if (buoy.mask & 4) src_w = src_w + buoy.coef[2] * dT;
  }
  if (kCons) {
    us[c] = star2_cons(u, c, nx, j, i, uc, vc, src_u, dt, nu, wt);
    vs[c] = star2_cons(v, c, nx, j, i, uc, vc, src_v, dt, nu, wt);
    ws[c] = star2_cons(w, c, nx, j, i, uc, vc, src_w, dt, nu, wt);
    return;
  }
  us[c] = star2(u, c, nx, uc, vc, src_u, dt, nu, inv_2dx, inv_2dy, inv_dx2,
                inv_dy2);
  vs[c] = star2(v, c, nx, uc, vc, src_v, dt, nu, inv_2dx, inv_2dy, inv_dx2,
                inv_dy2);
  ws[c] = star2(w, c, nx, uc, vc, src_w, dt, nu, inv_2dx, inv_2dy, inv_dx2,
                inv_dy2);
}

// b~ = face_coeff * p - (rho/dt) div u* on the interior, 0 on the shell
// (projection2d.py:186-191); with emit_rhs the iterative solvers' rhs =
// (rho/dt) div u* instead (projection2d.py:196-197; p is not read).
// kCons: the consistent divergence, and face[] = (cxm, cxp, cym, cyp) the
// face weights at i = 1, nx - 2, j = 1, ny - 2.
// kRows: the grid covers the owned window of the block, h rows in from
// each side; p and bt are window-sized, the y shells and face rows global.
template <bool kCons, bool kRows>
__global__ void poisson_input_2d_kernel(
    const float* __restrict__ us, const float* __restrict__ vs,
    const float* __restrict__ p, float* __restrict__ bt,
    const float* __restrict__ rod_ptr, int ny, int nx, float inv_2dx,
    float inv_2dy, float inv_dx2, float inv_dy2, int emit_rhs, Weights2 wt,
    float4 face, int y_base, int ny_g, int h) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int jw = blockIdx.y * blockDim.y + threadIdx.y;
  const int ny_w = kRows ? ny - 2 * h : ny;  // the output's rows
  if (i >= nx || jw >= ny_w) return;
  const int j = kRows ? jw + h : jw;
  const int c = j * nx + i;
  const int o = kRows ? jw * nx + i : c;  // the output's (and p's) index
  if (y_shell_2d<kRows>(j, ny, y_base, ny_g) || i == 0 || i == nx - 1) {
    bt[o] = 0.0f;
    return;
  }
  float div;
  if (kCons) {
    div = d1_cons(us, c, 1, wt.wx(0, i), wt.wx(1, i), wt.wx(2, i)) +
          d1_cons(vs, c, nx, wt.wy(0, j), wt.wy(1, j), wt.wy(2, j));
  } else {
    div = (us[c + 1] - us[c - 1]) * inv_2dx
          + (vs[c + nx] - vs[c - nx]) * inv_2dy;
  }
  if (emit_rhs) {
    bt[o] = (*rod_ptr) * div;
    return;
  }
  float cxy;
  if (kCons) {
    cxy = ((face.x * (float)(i == 1) + face.y * (float)(i == nx - 2)) +
           face.z * (float)(j == 1)) +
          face.w * (float)(j == ny - 2);
  } else {
    const int jg = kRows ? y_base + j : j;  // the global row
    const int ng = kRows ? ny_g : ny;
    cxy = inv_dx2 * (float)((i == 1) + (i == nx - 2)) +
          inv_dy2 * (float)((jg == 1) + (jg == ng - 2));
  }
  bt[o] = cxy * p[o] - (*rod_ptr) * div;
}

// Corrector u = clamp(u* - (dt/rho) p_x), v = clamp(v* - (dt/rho) p_y) on
// the interior; shells pass through from u*, v* (projection2d.py:259-267).
// kCons: the gradients take the consistent weights.
// kRows: p is a shard's rows padded one a side (ny its padded count,
// local row j the global row y_base + j of ny_g); the grid covers its
// owned rows, u* and v* come from their own block hs rows a side, and u,
// v and the owned p (pout) are written owned-size; the global y-shells an
// edge shard owns pass through from u*, v*.
template <bool kCons, bool kRows>
__global__ void corrector_2d_kernel(
    const float* __restrict__ us, const float* __restrict__ vs,
    const float* __restrict__ p, float* __restrict__ u,
    float* __restrict__ v, const float* __restrict__ s_ptr, int ny, int nx,
    float inv_2dx, float inv_2dy, Weights2 wt, float* __restrict__ pout,
    int y_base, int ny_g, int hs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int jw = blockIdx.y * blockDim.y + threadIdx.y;
  const int ny_w = kRows ? ny - 2 : ny;  // the output's rows
  if (i >= nx || jw >= ny_w) return;
  const int j = kRows ? jw + 1 : jw;
  const int c = j * nx + i;
  const int cs = kRows ? (jw + hs) * nx + i : c;  // u*'s index
  const int o = kRows ? jw * nx + i : c;          // the output's
  const int jg = kRows ? y_base + j : j;
  const int ng = kRows ? ny_g : ny;
  float uo = us[cs], vo = vs[cs];
  if (kRows) pout[o] = p[c];
  if (jg > 0 && jg < ng - 1 && i > 0 && i < nx - 1) {
    const float s = *s_ptr;
    float gx, gy;
    if (kCons) {
      gx = d1_cons(p, c, 1, wt.wx(0, i), wt.wx(1, i), wt.wx(2, i));
      gy = d1_cons(p, c, nx, wt.wy(0, j), wt.wy(1, j), wt.wy(2, j));
    } else {
      gx = (p[c + 1] - p[c - 1]) * inv_2dx;
      gy = (p[c + nx] - p[c - nx]) * inv_2dy;
    }
    uo = clamp_keep_nan(uo - s * gx);
    vo = clamp_keep_nan(vo - s * gy);
  }
  u[o] = uo;
  v[o] = vo;
}

dim3 stencil_grid_2d(int ny, int nx) {
  return dim3((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY, 1);
}

}  // namespace

extern "C" {

int cfd_pred_star_2d(const float* u, const float* v, const float* w,
                     float* us, float* vs, float* ws, const float* scal,
                     const float* T, int ny, int nx, float nu, float inv_2dx,
                     float inv_2dy, float inv_dx2, float inv_dy2, float xmin,
                     float ymin, float dx, float dy, int with_sources,
                     float b0, float b1, float b2, float tref, int buoy_mask,
                     cudaStream_t stream) {
  const Buoyancy2 buoy = {{b0, b1, b2}, tref, buoy_mask};
  pred_star_2d_kernel<false, false><<<stencil_grid_2d(ny, nx),
                                      dim3(kTileX, kTileY), 0, stream>>>(
      u, v, w, us, vs, ws, scal, T, ny, nx, nu, inv_2dx, inv_2dy, inv_dx2,
      inv_dy2, xmin, ymin, dx, dy, with_sources, buoy,
      Weights2{nullptr, nullptr, nx, ny}, 0, ny);
  return (int)cudaGetLastError();
}

// The consistent predictor: xw (7 x nx) and yw (7 x ny) weight rows.
int cfd_pred_star_2d_cons(const float* u, const float* v, const float* w,
                          float* us, float* vs, float* ws, const float* scal,
                          const float* T, const float* xw, const float* yw,
                          int ny, int nx, float nu, int with_sources,
                          float b0, float b1, float b2, float tref,
                          int buoy_mask, cudaStream_t stream) {
  const Buoyancy2 buoy = {{b0, b1, b2}, tref, buoy_mask};
  pred_star_2d_kernel<true, false><<<stencil_grid_2d(ny, nx),
                                     dim3(kTileX, kTileY), 0, stream>>>(
      u, v, w, us, vs, ws, scal, T, ny, nx, nu, 0.0f, 0.0f, 0.0f, 0.0f,
      0.0f, 0.0f, 0.0f, 0.0f, with_sources, buoy, Weights2{xw, yw, nx, ny},
      0, ny);
  return (int)cudaGetLastError();
}

int cfd_poisson_input_2d(const float* us, const float* vs, const float* p,
                         float* bt, const float* rod, int ny, int nx,
                         float inv_2dx, float inv_2dy, float inv_dx2,
                         float inv_dy2, int emit_rhs,
                         cudaStream_t stream) {
  poisson_input_2d_kernel<false, false><<<stencil_grid_2d(ny, nx),
                                          dim3(kTileX, kTileY), 0, stream>>>(
      us, vs, p, bt, rod, ny, nx, inv_2dx, inv_2dy, inv_dx2, inv_dy2,
      emit_rhs, Weights2{nullptr, nullptr, nx, ny},
      make_float4(0.0f, 0.0f, 0.0f, 0.0f), 0, ny, 0);
  return (int)cudaGetLastError();
}

// The consistent b~ (face weights cxm, cxp, cym, cyp) or rhs.
int cfd_poisson_input_2d_cons(const float* us, const float* vs,
                              const float* p, float* bt, const float* rod,
                              const float* xw, const float* yw, int ny,
                              int nx, float cxm, float cxp, float cym,
                              float cyp, int emit_rhs, cudaStream_t stream) {
  poisson_input_2d_kernel<true, false><<<stencil_grid_2d(ny, nx),
                                         dim3(kTileX, kTileY), 0, stream>>>(
      us, vs, p, bt, rod, ny, nx, 0.0f, 0.0f, 0.0f, 0.0f, emit_rhs,
      Weights2{xw, yw, nx, ny}, make_float4(cxm, cxp, cym, cyp), 0, ny, 0);
  return (int)cudaGetLastError();
}

int cfd_corrector_2d(const float* us, const float* vs, const float* p,
                     float* u, float* v, const float* s, int ny, int nx,
                     float inv_2dx, float inv_2dy, cudaStream_t stream) {
  corrector_2d_kernel<false, false><<<stencil_grid_2d(ny, nx),
                                      dim3(kTileX, kTileY), 0, stream>>>(
      us, vs, p, u, v, s, ny, nx, inv_2dx, inv_2dy,
      Weights2{nullptr, nullptr, nx, ny}, nullptr, 0, ny, 0);
  return (int)cudaGetLastError();
}

// The consistent corrector: the gradient weights are rows 0-2 of xw, yw.
int cfd_corrector_2d_cons(const float* us, const float* vs, const float* p,
                          float* u, float* v, const float* s,
                          const float* xw, const float* yw, int ny, int nx,
                          cudaStream_t stream) {
  corrector_2d_kernel<true, false><<<stencil_grid_2d(ny, nx),
                                     dim3(kTileX, kTileY), 0, stream>>>(
      us, vs, p, u, v, s, ny, nx, 0.0f, 0.0f, Weights2{xw, yw, nx, ny},
      nullptr, 0, ny, 0);
  return (int)cudaGetLastError();
}

// The global-row instantiations (a y-decomposed shard's block; y_base
// the global row of its row 0, ny_g the global row count).  The
// predictor runs on the whole padded block; b~ on its owned window h rows
// in (p and bt window-sized); the corrector on the owned rows of a p
// block padded one row a side, u* and v* padded hs rows a side, u, v and
// the owned p (pout) owned-size.
int cfd_pred_star_2d_rows(const float* u, const float* v, const float* w,
                          float* us, float* vs, float* ws, const float* scal,
                          const float* T, int ny, int nx, float nu,
                          float inv_2dx, float inv_2dy, float inv_dx2,
                          float inv_dy2, float xmin, float ymin, float dx,
                          float dy, int with_sources, float b0, float b1,
                          float b2, float tref, int buoy_mask, int y_base,
                          int ny_g, cudaStream_t stream) {
  const Buoyancy2 buoy = {{b0, b1, b2}, tref, buoy_mask};
  pred_star_2d_kernel<false, true><<<stencil_grid_2d(ny, nx),
                                     dim3(kTileX, kTileY), 0, stream>>>(
      u, v, w, us, vs, ws, scal, T, ny, nx, nu, inv_2dx, inv_2dy, inv_dx2,
      inv_dy2, xmin, ymin, dx, dy, with_sources, buoy,
      Weights2{nullptr, nullptr, nx, ny}, y_base, ny_g);
  return (int)cudaGetLastError();
}

int cfd_poisson_input_2d_rows(const float* us, const float* vs,
                              const float* p, float* bt, const float* rod,
                              int ny, int nx, float inv_2dx, float inv_2dy,
                              float inv_dx2, float inv_dy2, int emit_rhs,
                              int y_base, int ny_g, int h,
                              cudaStream_t stream) {
  poisson_input_2d_kernel<false, true><<<stencil_grid_2d(ny - 2 * h, nx),
                                         dim3(kTileX, kTileY), 0, stream>>>(
      us, vs, p, bt, rod, ny, nx, inv_2dx, inv_2dy, inv_dx2, inv_dy2,
      emit_rhs, Weights2{nullptr, nullptr, nx, ny},
      make_float4(0.0f, 0.0f, 0.0f, 0.0f), y_base, ny_g, h);
  return (int)cudaGetLastError();
}

int cfd_corrector_2d_rows(const float* us, const float* vs, const float* p,
                          float* u, float* v, float* pout, const float* s,
                          int ny, int nx, float inv_2dx, float inv_2dy,
                          int y_base, int ny_g, int hs,
                          cudaStream_t stream) {
  corrector_2d_kernel<false, true><<<stencil_grid_2d(ny - 2, nx),
                                     dim3(kTileX, kTileY), 0, stream>>>(
      us, vs, p, u, v, s, ny, nx, inv_2dx, inv_2dy,
      Weights2{nullptr, nullptr, nx, ny}, pout, y_base, ny_g, hs);
  return (int)cudaGetLastError();
}

}  // extern "C"
