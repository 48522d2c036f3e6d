// Hand-written CUDA kernels for the 3D spectral projection step on Hopper.
//
// They replace the two TPU mega kernels of the reference
// (cfd_tpu/ops/pallas/projection_kernels.py):
//
//   A1  ProjectionKernels.pred_bt   (pred_bt_compute)   predictor, b~,
//       forward xy DST, Thomas forward sweep; Boussinesq buoyancy with T
//       as one more input
//       -> pred_star_kernel, poisson_input_kernel, sgemm_fp32_kernel
//          (x2, sgemm_fp32.cu), tdma_fwd_kernel; with emit="rhs" (the CG
//          step) only the first two, poisson_input_kernel emitting (rho/dt)
//          div u*
//   A5  the per-component family the bc_refresh step runs
//       (make_predictor -> pred_u/v/w, btilde_k, divergence): the same
//       kernels, the caller's hook between pred_star_kernel and
//       poisson_input_kernel
//   A2  ProjectionKernels.corr_bwd  (corr_bwd_compute)  Thomas back
//       substitution, inverse xy DST, corrector, three max reductions
//       -> tdma_bwd_kernel, sgemm_fp32_kernel (x2), corrector_kernel,
//          reduce_max3_kernel
//   A5  corr_all's DST form (the nz = 3 step): the same chain after the
//       standalone back substitution (tdma.py's make_tdma_z_bwd)
//
// The consistent scheme on a stretched grid (nonuniform_scheme=
// "consistent", projection_kernels.py:594-670 and :735-742) is the kCons
// instantiation of the same three stencil kernels: instead of the six
// scalar inverse spacings they read per-axis weight vectors, x rows
// [wm, wc, wp, lm, lc, lp, sin(2 pi x)] of length nx and y rows of
// length ny (ops/kernels/stretch.py).  A warp's x weights are one
// coalesced load and its y weights one broadcast, and both stay in L1
// across the z-march; the uniform instantiation keeps its registers.  The
// DST products then carry the generalized eigenbasis of the stretched
// axes (solvers/poisson/nonuniform.py) in place of the sines; the GEMMs
// and the Thomas sweeps do not change.
//
// The z-decomposed step (cfd_tpu_torch/parallel/fused.py) runs the
// predictor and b~ kernels in the global_nz mode of
// projection_kernels.py:561-567 and :464-510 on a shard's halo-padded
// block: z_base is the global index of local plane 0 and nz_g the global
// plane count, so the z-shells and b~'s z face term sit at global planes
// (z_shell below); one device passes z_base = 0, nz_g = nz.  The Thomas
// pair runs unchanged on the shard's y-pencil with its rows of mu, and
// the inverse DST and corrector on its 1-halo x^ block.
//
// The (z, y)-decomposed step adds the global-row mode (the reference's
// ProjectionKernels(global_nz, global_ny): rows_cols / interior_mask /
// source_plane, projection_kernels.py:262-281, the per-component y_off
// of pred_u/v/w, divergence, btilde_k, corr_u/v/w, :306-312, :343-344,
// :475-478, :519-520, :536-537), each a kRows / kGlobal instantiation, not
// a runtime switch (a runtime switch cost the Euler kernel 28%):
//   pred_star_kernel<false, true>  the y-shell test at the global row
//       y_base + j of an ny_g-row domain (y_shell below) and the source
//       sin(pi y) at the global row, on the shard's block padded 2 planes
//       and 2 rows a side (v* at the owned rows +- 1 and w* at the owned
//       planes +- 1 for b~, whose stencil reads them, with no second
//       exchange; the reference pads 4 rows for the TPU's 8-row sublanes);
//   poisson_input_kernel<false, true>  b~ (or the CG rhs) on the owned
//       window of that block (h planes and rows in from each side), the y
//       face term on the global rows 1 and ny_g - 2, written to an
//       owned-size output with an owned-size p: no copy of a y-sliced view;
//   corrector_kernel<false, true>  the owned window of a p block padded 1
//       plane and 1 row a side (the stencil's reach), u*, v*, w* read from
//       their own hs-padded block, u, v, w and the owned p written
//       owned-size, the shells (the global z planes and y rows an edge
//       shard owns) passed through from u*, the maxima over every owned
//       point, so the shards' maxima fold with comm.max alone.
//
// At spectral_precision=HIGH the DST products run on the 3xTF32
// tensor-core GEMM (gemm_3xtf32.cu) instead of the SGEMM, the forward
// sweep writes no t, and the back substitution rebuilds t analytically
// (tdma_bwd_kernel<true>), as the reference's HIGH step does.
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
//   the HIGHEST-precision contract.  They run in sgemm_fp32.cu (one fmaf
//   chain an output element, k ascending; TMA-fed stages, consumer warps
//   that issue only shared loads and FFMAs).
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

// jnp.maximum semantics: NaN in either argument wins.
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The y-shell test of the global-row mode (kRows): local row j of a
// shard's y-padded block is global row jg = y_base + j of an ny_g-row
// domain; the global shells and the rows past them (an edge shard's halo
// rows, received as zeros) pass through or give a zero b~, and so do the
// block's own end rows, which have no neighbour in the block.  One device
// (kRows false) tests j == 0 || j == ny - 1.
template <bool kRows>
__device__ __forceinline__ bool y_shell(int j, int ny, int y_base,
                                        int ny_g) {
  if (!kRows) return j == 0 || j == ny - 1;
  const int jg = y_base + j;
  return j == 0 || j == ny - 1 || jg <= 0 || jg >= ny_g - 1;
}

// The z-shell test of the predictor and b~ kernels.  On one device
// (z_base = 0, nz_g = nz) it is k == 0 || k == nz - 1.  On a z-decomposed
// shard's halo-padded block (projection_kernels.py's global_nz mode) local
// plane k is global plane kg = z_base + k of an nz_g-plane domain: the
// global shells kg == 0 and kg == nz_g - 1 pass through (or give a zero
// b~), and so do planes past them, which lie outside the domain (an edge
// shard's halo planes, received as zeros); the block's own end planes,
// which have no neighbour in the block, too (the caller trims them).
__device__ __forceinline__ bool z_shell(int k, int nz, int z_base,
                                        int nz_g) {
  const int kg = z_base + k;
  return k == 0 || k == nz - 1 || kg <= 0 || kg >= nz_g - 1;
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

// The consistent scheme's star: f_x = (f[i-1] wm + f wc) + f[i+1] wp (and
// f_y likewise), the Laplacian one unclamped chain x, then y, then z
// (projection_kernels.py:601-617), sources from the weight rows (row 6).
struct Weights {
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

__device__ __forceinline__ float star_cons(const float* __restrict__ f,
                                           long long c, long long sy,
                                           long long sz, int j, int i,
                                           float uc, float vc, float wc,
                                           float src, float dt, float nu,
                                           float inv_2dz, float inv_dz2,
                                           const Weights& wt) {
  const float fc = f[c];
  const float xm = f[c - 1], xp = f[c + 1];
  const float ym = f[c - sy], yp = f[c + sy];
  const float zm = f[c - sz], zp = f[c + sz];
  const float d1x = (xm * wt.wx(0, i) + fc * wt.wx(1, i)) + xp * wt.wx(2, i);
  const float d1y = (ym * wt.wy(0, j) + fc * wt.wy(1, j)) + yp * wt.wy(2, j);
  const float conv = (uc * d1x + vc * d1y) + wc * ((zp - zm) * inv_2dz);
  const float lap =
      (((((xm * wt.wx(3, i) + fc * wt.wx(4, i)) + xp * wt.wx(5, i)) +
         ym * wt.wy(3, j)) +
        fc * wt.wy(4, j)) +
       yp * wt.wy(5, j)) +
      ((zp - 2.0f * fc) + zm) * inv_dz2;
  return clamp_keep_nan(fc + dt * ((-conv + nu * lap) + src));
}

// With buoyancy (buoy_mask bit c set where g[c] != 0), component c's
// source also takes bcoef[c] * (T - T_ref), bcoef[c] = (-beta) * g[c]
// rounded in float32 on the host: the reference kernels' term
// ((-beta) * g[c]) * (T - T_ref) (projection_kernels.py:319-321), added
// after the decaying sin source.  T is read only then and may be null.
struct Buoyancy {
  float coef[3], tref;
  int mask;
};

template <bool kCons, bool kRows>
__global__ void pred_star_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, float* __restrict__ us,
    float* __restrict__ vs, float* __restrict__ ws,
    const float* __restrict__ scal, const float* __restrict__ T, int nz,
    int ny, int nx, float nu, float inv_2dx, float inv_2dy, float inv_2dz,
    float inv_dx2, float inv_dy2, float inv_dz2, float xmin, float ymin,
    float dx, float dy, int with_sources, Buoyancy buoy, Weights wt,
    int z_base, int nz_g, int y_base, int ny_g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nx || j >= ny) return;
  const long long sy = nx, sz = (long long)ny * nx;
  const long long c = k * sz + j * sy + i;
  if (z_shell(k, nz, z_base, nz_g) || y_shell<kRows>(j, ny, y_base, ny_g) ||
      i == 0 || i == nx - 1) {
    us[c] = u[c];  // caller shells pass through (save/restore idiom)
    vs[c] = v[c];
    ws[c] = w[c];
    return;
  }
  const float dt = scal[0], su = scal[1], sv = scal[2];
  const float uc = u[c], vc = v[c], wc = w[c];
  float src_u = 0.0f, src_v = 0.0f, src_w = 0.0f;
  if (with_sources) {
    if (kCons) {  // true coordinates (the pinned source basis)
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
    us[c] = star_cons(u, c, sy, sz, j, i, uc, vc, wc, src_u, dt, nu,
                      inv_2dz, inv_dz2, wt);
    vs[c] = star_cons(v, c, sy, sz, j, i, uc, vc, wc, src_v, dt, nu,
                      inv_2dz, inv_dz2, wt);
    ws[c] = star_cons(w, c, sy, sz, j, i, uc, vc, wc, src_w, dt, nu,
                      inv_2dz, inv_dz2, wt);
    return;
  }
  us[c] = star(u, c, sy, sz, uc, vc, wc, src_u, dt, nu, inv_2dx, inv_2dy,
               inv_2dz, inv_dx2, inv_dy2, inv_dz2);
  vs[c] = star(v, c, sy, sz, uc, vc, wc, src_v, dt, nu, inv_2dx, inv_2dy,
               inv_2dz, inv_dx2, inv_dy2, inv_dz2);
  ws[c] = star(w, c, sy, sz, uc, vc, wc, src_w, dt, nu, inv_2dx, inv_2dy,
               inv_2dz, inv_dx2, inv_dy2, inv_dz2);
}

// b~ = face_coeff * p - (rho/dt) div u* on the interior, 0 on the shell;
// with emit_rhs the iterative solvers' rhs = (rho/dt) div u* instead
// (projection_kernels.py:699-701: no face term, no minus; p is not read).
// kCons: the consistent divergence and the four nonuniform face weights
// face[] = (cxm, cxp, cym, cyp) at i = 1, nx - 2, j = 1, ny - 2
// (projection_kernels.py:656-670).  kRows: the grid covers the owned
// window of the (nz, ny, nx) block, h planes and rows in from each side;
// p and bt are window-sized, the y shells and face rows global.
template <bool kCons, bool kRows>
__global__ void poisson_input_kernel(
    const float* __restrict__ us, const float* __restrict__ vs,
    const float* __restrict__ ws, const float* __restrict__ p,
    float* __restrict__ bt, const float* __restrict__ rod_ptr, int nz,
    int ny, int nx, float inv_2dx, float inv_2dy, float inv_2dz,
    float inv_dx2, float inv_dy2, float inv_dz2, int emit_rhs, Weights wt,
    float4 face, int z_base, int nz_g, int y_base, int ny_g, int h) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int jw = blockIdx.y * blockDim.y + threadIdx.y;
  const int kw = blockIdx.z;
  const int ny_w = kRows ? ny - 2 * h : ny;  // the output's rows
  if (i >= nx || jw >= ny_w) return;
  const int j = kRows ? jw + h : jw, k = kRows ? kw + h : kw;
  const long long sy = nx, sz = (long long)ny * nx;
  const long long c = k * sz + j * sy + i;
  const long long o = kRows ? ((long long)kw * ny_w + jw) * nx + i : c;
  if (z_shell(k, nz, z_base, nz_g) || y_shell<kRows>(j, ny, y_base, ny_g) ||
      i == 0 || i == nx - 1) {
    bt[o] = 0.0f;
    return;
  }
  float div;
  if (kCons) {
    div = (((us[c - 1] * wt.wx(0, i) + us[c] * wt.wx(1, i)) +
            us[c + 1] * wt.wx(2, i)) +
           ((vs[c - sy] * wt.wy(0, j) + vs[c] * wt.wy(1, j)) +
            vs[c + sy] * wt.wy(2, j))) +
          (ws[c + sz] - ws[c - sz]) * inv_2dz;
  } else {
    div = ((us[c + 1] - us[c - 1]) * inv_2dx
           + (vs[c + sy] - vs[c - sy]) * inv_2dy)
          + (ws[c + sz] - ws[c - sz]) * inv_2dz;
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
  const int kg = z_base + k;  // the global plane (k on one device)
  const float cz = inv_dz2 * (float)((kg == 1) + (kg == nz_g - 2));
  bt[o] = (cxy + cz) * p[o] - (*rod_ptr) * div;
}

// Thomas forward sweep along z for every (y, x) mode of the transformed
// b~: rec = 1/(mu + 2w - w t), t = w rec, d' = (b^ + w d') rec for
// k = 1..nz-2 from a zero carry; d' and t have zero z-shells.  With
// write_t = 0 (the analytic back substitution rebuilds t) t is not
// written and may be null: the sweep streams 2 fields, not 3.
__global__ void tdma_fwd_kernel(const float* __restrict__ r,
                                const float* __restrict__ mu, float w,
                                float* __restrict__ d, float* __restrict__ t,
                                int nz, long long plane, int write_t) {
  const long long m = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (m >= plane) return;
  const float b = mu[m] + 2.0f * w;
  float tc = 0.0f, dc = 0.0f;
  d[m] = 0.0f;
  if (write_t) t[m] = 0.0f;
  for (int k = 1; k < nz - 1; ++k) {
    const long long c = k * plane + m;
    const float rec = 1.0f / (b - w * tc);
    tc = w * rec;
    dc = (r[c] + w * dc) * rec;
    d[c] = dc;
    if (write_t) t[c] = tc;
  }
  d[(nz - 1) * plane + m] = 0.0f;
  if (write_t) t[(nz - 1) * plane + m] = 0.0f;
}

// Thomas back substitution x^ = d' + t x^ for k = nz-2 down to 1 from a
// zero carry, with mirror z-shells x^[0] = x^[1], x^[nz-1] = x^[nz-2].
// Stored form: t is read from the forward sweep's output.  Analytic form
// (the counterpart of tdma.py's variant="analytic"): t is rebuilt from
// the closed form t_k = sinh(k phi)/sinh((k+1) phi)
//     = e^-phi * expm1(-2k phi) / expm1(-2(k+1) phi)
// from two host-made (float64, rounded once) coefficient planes, coef =
// [e^-phi | 2 phi]; expm1f avoids the e^-2k phi - 1 cancellation the TPU
// kernel had to take (Mosaic lowers no expm1).  One read of d' and the
// two planes, one write of x^.
template <bool kAnalytic>
__global__ void tdma_bwd_kernel(const float* __restrict__ d,
                                const float* __restrict__ t_or_coef,
                                float* __restrict__ x, int nz,
                                long long plane) {
  const long long m = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (m >= plane) return;
  float einv = 0.0f, p2 = 0.0f;
  if (kAnalytic) {
    einv = t_or_coef[m];
    p2 = t_or_coef[plane + m];
  }
  float xc = 0.0f;
  for (int k = nz - 2; k >= 1; --k) {
    const long long c = k * plane + m;
    float tk;
    if (kAnalytic) {
      const float kf = (float)k;
      tk = einv * expm1f(-kf * p2) / expm1f(-(kf + 1.0f) * p2);
    } else {
      tk = t_or_coef[c];
    }
    xc = d[c] + tk * xc;
    x[c] = xc;
    if (k == nz - 2) x[(nz - 1) * plane + m] = xc;
  }
  x[m] = xc;
}

// Corrector u = clamp(u* - (dt/rho) grad p) on the interior (shells pass
// through from u*), plus per-block maxima of |u|^2, p and |p| over the
// planes k = 1..nz-2 into partials[3 * block + q].  kCons: the x and y
// gradients (p[i-1] wm + p wc) + p[i+1] wp (projection_kernels.py:735-742).
// kGlobal (the (z, y)-decomposed step): p is a shard's block padded one
// plane and one row a side, local (k, j) the global (z_base + k, y_base +
// j) of an (nz_g, ny_g) domain; the grid covers its owned window, u*, v*,
// w* come from their own hs-padded block, u, v, w and the owned p (pout)
// are written owned-size, and the maxima take every owned point: the
// global shells an edge shard owns pass through from u*, as the
// reference's fix_shell does.
template <bool kCons, bool kGlobal>
__global__ void __launch_bounds__(kTileX * kTileY) corrector_kernel(
    const float* __restrict__ us, const float* __restrict__ vs,
    const float* __restrict__ ws, const float* __restrict__ p,
    float* __restrict__ u, float* __restrict__ v, float* __restrict__ w,
    const float* __restrict__ s_ptr, float* __restrict__ partials, int nz,
    int ny, int nx, float inv_2dx, float inv_2dy, float inv_2dz,
    Weights wt, float* __restrict__ pout, int z_base, int nz_g, int y_base,
    int ny_g, int hs) {
  __shared__ float red[3][kTileX * kTileY];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int jw = blockIdx.y * blockDim.y + threadIdx.y;
  const int kw = blockIdx.z;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int ny_w = kGlobal ? ny - 2 : ny;  // the output's rows
  float m2 = -INFINITY, pm = -INFINITY, pa = -INFINITY;
  if (i < nx && jw < ny_w) {
    const int j = kGlobal ? jw + 1 : jw, k = kGlobal ? kw + 1 : kw;
    const long long sy = nx, sz = (long long)ny * nx;
    const long long c = k * sz + j * sy + i;
    // u*'s index (its block hs planes and rows around the owned ones) and
    // the output's
    const long long cs =
        kGlobal ? ((long long)(kw + hs) * (ny_w + 2 * hs) + jw + hs) * nx + i
                : c;
    const long long o = kGlobal ? ((long long)kw * ny_w + jw) * nx + i : c;
    const int kg = kGlobal ? z_base + k : k, jg = kGlobal ? y_base + j : j;
    const int ngz = kGlobal ? nz_g : nz, ngy = kGlobal ? ny_g : ny;
    const bool zint = kg > 0 && kg < ngz - 1;
    float uo = us[cs], vo = vs[cs], wo = ws[cs];
    if (zint && jg > 0 && jg < ngy - 1 && i > 0 && i < nx - 1) {
      const float s = *s_ptr;
      float gx, gy;
      if (kCons) {
        const float pc = p[c];
        gx = (p[c - 1] * wt.wx(0, i) + pc * wt.wx(1, i)) +
             p[c + 1] * wt.wx(2, i);
        gy = (p[c - sy] * wt.wy(0, j) + pc * wt.wy(1, j)) +
             p[c + sy] * wt.wy(2, j);
      } else {
        gx = (p[c + 1] - p[c - 1]) * inv_2dx;
        gy = (p[c + sy] - p[c - sy]) * inv_2dy;
      }
      uo = clamp_keep_nan(uo - s * gx);
      vo = clamp_keep_nan(vo - s * gy);
      wo = clamp_keep_nan(wo - (s * (p[c + sz] - p[c - sz])) * inv_2dz);
    }
    u[o] = uo;
    v[o] = vo;
    w[o] = wo;
    if (kGlobal) pout[o] = p[c];
    if (kGlobal || zint) {
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
                  float* vs, float* ws, const float* scal, const float* T,
                  int nz, int ny, int nx, float nu, float inv_2dx,
                  float inv_2dy, float inv_2dz, float inv_dx2, float inv_dy2,
                  float inv_dz2, float xmin, float ymin, float dx, float dy,
                  int with_sources, float b0, float b1, float b2, float tref,
                  int buoy_mask, int z_base, int nz_g, cudaStream_t stream) {
  const Buoyancy buoy = {{b0, b1, b2}, tref, buoy_mask};
  pred_star_kernel<false, false><<<stencil_grid(nz, ny, nx),
                                   dim3(kTileX, kTileY), 0, stream>>>(
      u, v, w, us, vs, ws, scal, T, nz, ny, nx, nu, inv_2dx, inv_2dy,
      inv_2dz, inv_dx2, inv_dy2, inv_dz2, xmin, ymin, dx, dy, with_sources,
      buoy, Weights{nullptr, nullptr, nx, ny}, z_base, nz_g, 0, ny);
  return (int)cudaGetLastError();
}

// The global-row predictor: a (z, y)-decomposed shard's padded block,
// y_base the global row of its row 0, ny_g the global row count.
int cfd_pred_star_rows(const float* u, const float* v, const float* w,
                       float* us, float* vs, float* ws, const float* scal,
                       const float* T, int nz, int ny, int nx, float nu,
                       float inv_2dx, float inv_2dy, float inv_2dz,
                       float inv_dx2, float inv_dy2, float inv_dz2,
                       float xmin, float ymin, float dx, float dy,
                       int with_sources, float b0, float b1, float b2,
                       float tref, int buoy_mask, int z_base, int nz_g,
                       int y_base, int ny_g, cudaStream_t stream) {
  const Buoyancy buoy = {{b0, b1, b2}, tref, buoy_mask};
  pred_star_kernel<false, true><<<stencil_grid(nz, ny, nx),
                                  dim3(kTileX, kTileY), 0, stream>>>(
      u, v, w, us, vs, ws, scal, T, nz, ny, nx, nu, inv_2dx, inv_2dy,
      inv_2dz, inv_dx2, inv_dy2, inv_dz2, xmin, ymin, dx, dy, with_sources,
      buoy, Weights{nullptr, nullptr, nx, ny}, z_base, nz_g, y_base, ny_g);
  return (int)cudaGetLastError();
}

// The consistent predictor: xw (7 x nx) and yw (7 x ny) weight rows.
int cfd_pred_star_cons(const float* u, const float* v, const float* w,
                       float* us, float* vs, float* ws, const float* scal,
                       const float* T, const float* xw, const float* yw,
                       int nz, int ny, int nx, float nu, float inv_2dz,
                       float inv_dz2, int with_sources, float b0, float b1,
                       float b2, float tref, int buoy_mask, int z_base,
                       int nz_g, cudaStream_t stream) {
  const Buoyancy buoy = {{b0, b1, b2}, tref, buoy_mask};
  pred_star_kernel<true, false><<<stencil_grid(nz, ny, nx),
                                  dim3(kTileX, kTileY), 0, stream>>>(
      u, v, w, us, vs, ws, scal, T, nz, ny, nx, nu, 0.0f, 0.0f, inv_2dz,
      0.0f, 0.0f, inv_dz2, 0.0f, 0.0f, 0.0f, 0.0f, with_sources, buoy,
      Weights{xw, yw, nx, ny}, z_base, nz_g, 0, ny);
  return (int)cudaGetLastError();
}

int cfd_poisson_input(const float* us, const float* vs, const float* ws,
                      const float* p, float* bt, const float* rod, int nz,
                      int ny, int nx, float inv_2dx, float inv_2dy,
                      float inv_2dz, float inv_dx2, float inv_dy2,
                      float inv_dz2, int emit_rhs, int z_base, int nz_g,
                      cudaStream_t stream) {
  poisson_input_kernel<false, false><<<stencil_grid(nz, ny, nx),
                                       dim3(kTileX, kTileY), 0, stream>>>(
      us, vs, ws, p, bt, rod, nz, ny, nx, inv_2dx, inv_2dy, inv_2dz,
      inv_dx2, inv_dy2, inv_dz2, emit_rhs, Weights{nullptr, nullptr, nx, ny},
      make_float4(0.0f, 0.0f, 0.0f, 0.0f), z_base, nz_g, 0, ny, 0);
  return (int)cudaGetLastError();
}

// The global-row b~ (or rhs): the owned window of a (z, y)-decomposed
// shard's (nz, ny, nx) block, h planes and rows in from each side, into
// window-sized bt (p window-sized too; not read for the rhs).
int cfd_poisson_input_rows(const float* us, const float* vs, const float* ws,
                           const float* p, float* bt, const float* rod,
                           int nz, int ny, int nx, float inv_2dx,
                           float inv_2dy, float inv_2dz, float inv_dx2,
                           float inv_dy2, float inv_dz2, int emit_rhs,
                           int z_base, int nz_g, int y_base, int ny_g, int h,
                           cudaStream_t stream) {
  poisson_input_kernel<false, true><<<stencil_grid(nz - 2 * h, ny - 2 * h,
                                                   nx),
                                      dim3(kTileX, kTileY), 0, stream>>>(
      us, vs, ws, p, bt, rod, nz, ny, nx, inv_2dx, inv_2dy, inv_2dz,
      inv_dx2, inv_dy2, inv_dz2, emit_rhs, Weights{nullptr, nullptr, nx, ny},
      make_float4(0.0f, 0.0f, 0.0f, 0.0f), z_base, nz_g, y_base, ny_g, h);
  return (int)cudaGetLastError();
}

// The consistent b~ (face weights cxm, cxp, cym, cyp) or rhs.
int cfd_poisson_input_cons(const float* us, const float* vs, const float* ws,
                           const float* p, float* bt, const float* rod,
                           const float* xw, const float* yw, int nz, int ny,
                           int nx, float inv_2dz, float inv_dz2, float cxm,
                           float cxp, float cym, float cyp, int emit_rhs,
                           int z_base, int nz_g, cudaStream_t stream) {
  poisson_input_kernel<true, false><<<stencil_grid(nz, ny, nx),
                                      dim3(kTileX, kTileY), 0, stream>>>(
      us, vs, ws, p, bt, rod, nz, ny, nx, 0.0f, 0.0f, inv_2dz, 0.0f, 0.0f,
      inv_dz2, emit_rhs, Weights{xw, yw, nx, ny},
      make_float4(cxm, cxp, cym, cyp), z_base, nz_g, 0, ny, 0);
  return (int)cudaGetLastError();
}

int cfd_tdma_fwd(const float* r, const float* mu, float w, float* d,
                 float* t, int nz, long long plane, int write_t,
                 cudaStream_t stream) {
  tdma_fwd_kernel<<<mode_blocks(plane), 256, 0, stream>>>(r, mu, w, d, t, nz,
                                                           plane, write_t);
  return (int)cudaGetLastError();
}

int cfd_tdma_bwd(const float* d, const float* t, float* x, int nz,
                 long long plane, cudaStream_t stream) {
  tdma_bwd_kernel<false><<<mode_blocks(plane), 256, 0, stream>>>(
      d, t, x, nz, plane);
  return (int)cudaGetLastError();
}

int cfd_tdma_bwd_analytic(const float* d, const float* coef, float* x,
                          int nz, long long plane, cudaStream_t stream) {
  tdma_bwd_kernel<true><<<mode_blocks(plane), 256, 0, stream>>>(
      d, coef, x, nz, plane);
  return (int)cudaGetLastError();
}

long long cfd_corrector_partials(int nz, int ny, int nx) {
  const dim3 g = stencil_grid(nz, ny, nx);
  return (long long)g.x * g.y * g.z;
}

}  // extern "C"

namespace {

template <bool kCons, bool kGlobal = false>
int launch_corrector(const float* us, const float* vs, const float* ws,
                     const float* p, float* u, float* v, float* w,
                     const float* s, float* partials, float* out, int nz,
                     int ny, int nx, float inv_2dx, float inv_2dy,
                     float inv_2dz, Weights wt, cudaStream_t stream,
                     float* pout = nullptr, int z_base = 0, int nz_g = 0,
                     int y_base = 0, int ny_g = 0, int hs = 0) {
  const dim3 grid = kGlobal ? stencil_grid(nz - 2, ny - 2, nx)
                            : stencil_grid(nz, ny, nx);
  corrector_kernel<kCons, kGlobal><<<grid, dim3(kTileX, kTileY), 0,
                                     stream>>>(
      us, vs, ws, p, u, v, w, s, partials, nz, ny, nx, inv_2dx, inv_2dy,
      inv_2dz, wt, pout, z_base, nz_g, y_base, ny_g, hs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_max3_kernel<<<1, kReduceThreads, 0, stream>>>(
      partials, (long long)grid.x * grid.y * grid.z, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cfd_corrector(const float* us, const float* vs, const float* ws,
                  const float* p, float* u, float* v, float* w,
                  const float* s, float* partials, float* out, int nz,
                  int ny, int nx, float inv_2dx, float inv_2dy,
                  float inv_2dz, cudaStream_t stream) {
  return launch_corrector<false>(us, vs, ws, p, u, v, w, s, partials, out,
                                 nz, ny, nx, inv_2dx, inv_2dy, inv_2dz,
                                 Weights{nullptr, nullptr, nx, ny}, stream);
}

// The global-row corrector: p a (z, y)-decomposed shard's block padded
// one plane and one row a side (nz, ny its padded counts), z_base and
// y_base its global plane and row of local (0, 0), u*, v*, w* padded hs
// a side; u, v, w, pout owned-size; partials sized for the owned window
// (cfd_corrector_partials(nz - 2, ny - 2, nx)).
int cfd_corrector_rows(const float* us, const float* vs, const float* ws,
                       const float* p, float* u, float* v, float* w,
                       float* pout, const float* s, float* partials,
                       float* out, int nz, int ny, int nx, float inv_2dx,
                       float inv_2dy, float inv_2dz, int z_base, int nz_g,
                       int y_base, int ny_g, int hs, cudaStream_t stream) {
  return launch_corrector<false, true>(
      us, vs, ws, p, u, v, w, s, partials, out, nz, ny, nx, inv_2dx,
      inv_2dy, inv_2dz, Weights{nullptr, nullptr, nx, ny}, stream, pout,
      z_base, nz_g, y_base, ny_g, hs);
}

// The consistent corrector: the gradient weights are rows 0-2 of xw, yw.
int cfd_corrector_cons(const float* us, const float* vs, const float* ws,
                       const float* p, float* u, float* v, float* w,
                       const float* s, float* partials, float* out,
                       const float* xw, const float* yw, int nz, int ny,
                       int nx, float inv_2dz, cudaStream_t stream) {
  return launch_corrector<true>(us, vs, ws, p, u, v, w, s, partials, out,
                                nz, ny, nx, 0.0f, 0.0f, inv_2dz,
                                Weights{xw, yw, nx, ny}, stream);
}

}  // extern "C"
