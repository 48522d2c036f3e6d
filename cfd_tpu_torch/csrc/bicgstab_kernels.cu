// Hand-written CUDA kernels for the BiCGSTAB pressure solve on Hopper.
//
// They replace the TPU kernels of the reference's BiCGSTAB solve:
//
//   B1  bicg_pv_kernel + bicg_pv_finalize, bicg_st_kernel +
//       bicg_st_finalize, bicg_xr_kernel + bicg_xr_finalize
//       <- BiCGSTABKernels.pass_pv / pass_st / pass_xr
//          (cfd_tpu/ops/pallas/bicgstab_kernels.py:147-156, built at
//          :94-143), three passes an iteration in the Dirichlet-0
//          correction space (zero shells):
//            pv: p' = r + beta (p - omega v), v' = -lap p', <rhat, v'>
//            st: s = r - alpha v', t = -lap s, <s, s>, <t, s>, <t, t>
//            xr: x += alpha p' + omega s, r = s - omega t (x's shell kept),
//                <r, r>, <rhat, r> (the next iteration's rho)
//          The finalize blocks carry the scalar recurrence of
//          make_bicgstab_fused (cfd_tpu/solvers/poisson/krylov.py:328-361):
//          beta, alpha with the rhv breakdown, omega with the early s-exit
//          and the tt breakdown, the effective alpha and omega (zeroed on
//          breakdown or early exit), the residual, convergence, the omega
//          breakdown, stagnation and the running flag.
//   B1s the same three kernels' <true> instantiations + bicg_fold_kernel,
//       then bicg_pv/st/xr_recur_kernel on the shards' sums
//       <- BiCGSTABKernels(global_nz=...) (bicgstab_kernels.py:56-130): pv
//          and st on a z-shard's halo-padded block, outputs masked at
//          global planes, dots over the owned planes; xr on the owned
//          block (the reference runs its plain xr on a zero-padded owned
//          block, parallel/fused_bicgstab.py:229-232).
//   B1r the three kernels' <true, true> instantiations + bicg_fold_kernel
//       <- BiCGSTABKernels(global_nz=..., global_ny=...)
//          (bicgstab_kernels.py:56-90): on a (z, y)-decomposed shard every
//          buffer is its block padded one plane and one row a side, the
//          launch covers the owned points, the Dirichlet-0 space, the
//          shells and the neighbour tests are at the global plane and row,
//          and the dots take the owned points only.  xr skips only the
//          global shells too: every owned row of an inner y-shard is
//          updated, where the one-device kernel on the owned block would
//          skip its first and last rows.
//   B2  bicg_solve_kernel
//       <- make_bicgstab_vmem_solve (cfd_tpu/ops/pallas/vmem_small.py:326):
//          the whole un-rotated BiCGSTAB loop (:364-404) in one cooperative
//          launch, with the early s-exit, breakdowns 1-4, stagnation and
//          the stats rules of :411-416 (3D volumes, and planes too large
//          for one cluster).
//   B2c bicg_solve_cluster_kernel
//       <- the same, for a 2D plane whose stencil vectors fit one
//          thread-block cluster (vmem_small.krylov_cluster_plan): the loop
//          in one cluster launch on cluster_band.cuh's engine.
//
// What bounds them on an H100, and what the design does:
//
// * B1 is three passes over the field an iteration, a few flops per byte:
//   bound by device-memory bandwidth, 17 fields an iteration (pv 4 in and
//   2 out, st 2 and 2, xr 5 and 2).  One thread per point, as the CG
//   passes (cg_kernels.cu): pv forms p' at the six neighbours from r, p
//   and v, st forms s from r and v' (L1/L2 hits), so p', v', s and t go to
//   buffers of their own.  The TPU kernels march z-planes and carry the
//   dots in scratch; here each block writes its partial sums and a
//   one-block finalize folds them in a fixed order, no float atomics.
// * Every dot is accumulated in float64 (a product of two floats is exact
//   there) and rounded to float once, in the plain versions too.  In
//   float32 sums, rho = <rhat, r> falls below the sum's rounding once r is
//   nearly orthogonal to rhat = r0 — from a Taylor-Green start on grids
//   of 80^3 and more, within 90-140 iterations — and the solve stops on
//   the rho breakdown far from its tolerance (the reference's float32
//   algorithm does the same); accumulated in float64 it converges.
// * The loop runs on the host, but its scalars stay on the card in a state
//   vector (bicgstab_kernels.py holds the slot layout).  Once the running
//   flag drops every kernel returns at once, so iterations the host queued
//   past the stop are no-ops.
// * B2 is for small grids (2D planes, small volumes): latency bounds it.
//   One cooperative launch sized by the occupancy API, grid-stride loops
//   over the interior in one fixed point-to-thread mapping (so pointwise
//   in-place updates need no barrier), five grid barriers an iteration
//   (after the p update, then one per dot group).  Each dot group is a
//   per-block partial, a barrier, then every block folds the partials in
//   one order, so all blocks agree on every scalar and leave the loop
//   together.  The next rho = <rhat, r> is folded with the x/r update, the
//   value the un-rotated loop forms at the top of the next iteration.
//
// * B2c keeps the plane in one cluster of up to 16 CTAs by bands of rows
//   (cluster_band.cuh): p and s, which the Laplacians read at their
//   neighbours, then r, v, rhat, x and t as far as the CTA's 227 KB go,
//   the rest in device memory.  Three dots an iteration, each one
//   exchange of partials pushed into every CTA's shared memory and
//   counted on its mbarrier ({<rhat, v>}, {<s, s>, <t, s>, <t, t>},
//   {<r, r>, <rhat, r>}), no cluster barrier: the p update opens the v
//   pass and the s update the t pass (a CTA barrier between), and the
//   rows a band reads beyond its edges are formed there, p as r + beta
//   (p - omega v) from the (r, p, v) the neighbour pushed with the last
//   dot, s as r - alpha v from its r and the v it pushed with the first.
//   The dots fold in double as B2's.
//
// Built with -fmad=false in the plain versions' operation order, so the
// pass fields match them bit for bit on identical scalars; the dots differ
// in summation order.  Every entry point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "block_reduce.cuh"
#include "cluster_band.cuh"
#include "volume.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTileX = 32, kTileY = 8;  // B1: 256-thread tiles
constexpr int kThreads = kTileX * kTileY;
constexpr int kFoldThreads = 1024;      // the finalize blocks
constexpr float kBreakdown = 1e-30f;    // krylov.BREAKDOWN

// slots of the solver state vector (bicgstab_kernels.py: RHO_PREV ...)
enum {
  kRhoPrev = 0, kRho, kAlpha, kOmega, kBeta, kIt, kRes, kRunning,
  kStagnated, kTol, kAbsTol, kBd1, kRhv, kAlphaNew, kBd, kSS, kTS, kTT,
  kEarly, kBd3, kOmegaNew, kAlphaEff, kOmegaEff, kRR, kRhatR
};

__device__ __forceinline__ bool inside(int k, int j, int i, int nz, int ny,
                                       int nx) {
  return k > 0 && k < nz - 1 && j > 0 && j < ny - 1 && i > 0 && i < nx - 1;
}

__device__ __forceinline__ long long tile_block() {
  return ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
         blockIdx.x;
}

// A thread's row in a pass's block: the grid covers every row of the
// block, or with kRows its owned rows 1..ny-2 only.
template <bool kRows>
__device__ __forceinline__ int tile_row() {
  return blockIdx.y * kTileY + threadIdx.y + (kRows ? 1 : 0);
}

__device__ __forceinline__ float flag(bool b) { return b ? 1.0f : 0.0f; }

// beta = (rho / rho_prev) (alpha / omega), each divisor 1 on breakdown
__device__ __forceinline__ float bicg_beta(float rho, float rho_prev,
                                           float alpha, float omega) {
  return (rho / (fabsf(rho) < kBreakdown ? 1.0f : rho_prev)) *
         (alpha / (fabsf(omega) < kBreakdown ? 1.0f : omega));
}

// 7-point Laplacian of a field g given pointwise (0 on the shell), at the
// interior point (k, j, i): the plain version's order
template <typename G>
__device__ __forceinline__ float lap7(G g, long long c, int k, int j, int i,
                                      int nz, int ny, int nx, long long sy,
                                      long long sz, float inv_dx2,
                                      float inv_dy2, float inv_dz2,
                                      float gc) {
  const float c2 = 2.0f * gc;
  return (((g(c + 1, i < nx - 2) - c2) + g(c - 1, i > 1)) * inv_dx2 +
          ((g(c + sy, j < ny - 2) - c2) + g(c - sy, j > 1)) * inv_dy2) +
         ((g(c + sz, k < nz - 2) - c2) + g(c - sz, k > 1)) * inv_dz2;
}

// ---- B1 pv: p', v', <rhat, v'> ---------------------------------------------
//
// kSharded (the passes' global_nz mode, bicgstab_kernels.py:56-130): pv and
// st take a z-shard's halo-padded block of nz = nzl + 2 planes and launch
// over its owned planes k = 1..nz-2, writing owned-size outputs (plane k to
// plane k-1; r-hat is read owned-size too); local plane k is global plane
// kg = z_base + k of nz_g.  The stencil outputs are zero outside the global
// Dirichlet-0 interior; the work-vector combinations at the neighbours read
// the halo planes as they are, the neighbour shard's values.  xr is
// pointwise: its sharded form runs on the owned block (nz = nzl) and skips
// the global shells only.  One device is the same code with kg = k and
// nz_g = nz.
// kRows (with kSharded): B1r — every buffer, r-hat, x, s and t too, is the
// block padded one plane and one row a side (nz, ny its padded counts);
// the grid covers its owned points, the outputs are written in the padded
// layout (index c), and the rows are global too (jg = y_base + j of
// ny_g).  The halo rows of p' and v' are the neighbours' and are filled
// by the caller.

template <bool kSharded, bool kRows = false>
__global__ void __launch_bounds__(kThreads) bicg_pv_kernel(
    const float* __restrict__ r, const float* __restrict__ p,
    const float* __restrict__ v, const float* __restrict__ rhat,
    float* __restrict__ pn, float* __restrict__ vn,
    const float* __restrict__ st, double* __restrict__ part, int nz, int ny,
    int nx, float inv_dx2, float inv_dy2, float inv_dz2, int z_base,
    int nz_g, int y_base = 0, int ny_g = 0) {
  if (st[kRunning] == 0.0f) return;  // uniform: the whole grid returns
  const int i = blockIdx.x * kTileX + threadIdx.x;
  const int j = tile_row<kRows>();
  const int k = kSharded ? blockIdx.z + 1 : blockIdx.z;
  const int kg = kSharded ? z_base + k : k;
  const int ng = kSharded ? nz_g : nz;
  const int jg = kRows ? y_base + j : j;
  const int ngy = kRows ? ny_g : ny;
  double acc = 0.0;
  if (i < nx && j < (kRows ? ny - 1 : ny)) {
    const long long sy = nx, sz = (long long)ny * nx;
    const long long c = k * sz + j * sy + i;
    // the output's index: owned-size planes in the z-only form
    const long long o = (kSharded && !kRows) ? c - sz : c;
    if (inside(kg, jg, i, ng, ngy, nx)) {
      const float beta = st[kBeta], omega = st[kOmega];
      // p' at a neighbour: 0 on the shell (the correction space)
      auto pp = [&](long long q, bool in) {
        return in ? r[q] + beta * (p[q] - omega * v[q]) : 0.0f;
      };
      const float pc = pp(c, true);
      const float a = -lap7(pp, c, kg, jg, i, ng, ngy, nx, sy, sz, inv_dx2,
                            inv_dy2, inv_dz2, pc);
      pn[o] = pc;
      vn[o] = a;
      acc = (double)rhat[o] * a;
    } else {
      pn[o] = 0.0f;
      vn[o] = 0.0f;
    }
  }
  const double s =
      block_sum_d<kThreads>(acc, threadIdx.y * kTileX + threadIdx.x);
  if (threadIdx.x == 0 && threadIdx.y == 0) part[tile_block()] = s;
}

// <rhat, v'>, the rho and rhv breakdowns, alpha = rho / <rhat, v'>
__device__ __forceinline__ void pv_recur(float rhv, float* st) {
  const float rho = st[kRho];
  const bool bd1 = fabsf(rho) < kBreakdown;
  const bool bd2 = fabsf(rhv) < kBreakdown;
  st[kRhv] = rhv;
  st[kBd1] = flag(bd1);
  st[kAlphaNew] = rho / (bd2 ? 1.0f : rhv);
  st[kBd] = flag(bd1 || bd2);
}

__global__ void __launch_bounds__(kFoldThreads) bicg_pv_finalize(
    const double* __restrict__ part, long long n, float* __restrict__ st) {
  if (st[kRunning] == 0.0f) return;
  const float rhv = (float)fold_d<kFoldThreads>(part, n, threadIdx.x);
  if (threadIdx.x == 0) pv_recur(rhv, st);
}

// ---- B1 st: s, t, <s, s>, <t, s>, <t, t> ------------------------------------

template <bool kSharded, bool kRows = false>
__global__ void __launch_bounds__(kThreads) bicg_st_kernel(
    const float* __restrict__ r, const float* __restrict__ vn,
    float* __restrict__ s, float* __restrict__ t,
    const float* __restrict__ st, double* __restrict__ part, int nz, int ny,
    int nx, float inv_dx2, float inv_dy2, float inv_dz2, int z_base,
    int nz_g, int y_base = 0, int ny_g = 0) {
  if (st[kRunning] == 0.0f) return;
  const int i = blockIdx.x * kTileX + threadIdx.x;
  const int j = tile_row<kRows>();
  const int k = kSharded ? blockIdx.z + 1 : blockIdx.z;
  const int kg = kSharded ? z_base + k : k;
  const int ng = kSharded ? nz_g : nz;
  const int jg = kRows ? y_base + j : j;
  const int ngy = kRows ? ny_g : ny;
  double ss = 0.0, ts = 0.0, tt = 0.0;
  if (i < nx && j < (kRows ? ny - 1 : ny)) {
    const long long sy = nx, sz = (long long)ny * nx;
    const long long c = k * sz + j * sy + i;
    const long long o = (kSharded && !kRows) ? c - sz : c;
    if (inside(kg, jg, i, ng, ngy, nx)) {
      const float alpha = st[kAlphaNew];
      auto sv = [&](long long q, bool in) {
        return in ? r[q] - alpha * vn[q] : 0.0f;
      };
      const float sc = sv(c, true);
      const float tv = -lap7(sv, c, kg, jg, i, ng, ngy, nx, sy, sz, inv_dx2,
                             inv_dy2, inv_dz2, sc);
      s[o] = sc;
      t[o] = tv;
      ss = (double)sc * sc;
      ts = (double)tv * sc;
      tt = (double)tv * tv;
    } else {
      s[o] = 0.0f;
      t[o] = 0.0f;
    }
  }
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const long long nb = (long long)gridDim.x * gridDim.y * gridDim.z;
  const long long b = tile_block();
  ss = block_sum_d<kThreads>(ss, tid);
  ts = block_sum_d<kThreads>(ts, tid);
  tt = block_sum_d<kThreads>(tt, tid);
  if (tid == 0) {
    part[b] = ss;
    part[nb + b] = ts;
    part[2 * nb + b] = tt;
  }
}

// omega = <t, s> / <t, t> with the tt breakdown, the early s-exit, and the
// alpha and omega the x/r pass applies
__device__ __forceinline__ void st_recur(float ss, float ts, float tt,
                                         float* st) {
  const float s_norm = sqrtf(ss);
  const bool early = s_norm < st[kTol] || s_norm < st[kAbsTol];
  const bool bd3 = fabsf(tt) < kBreakdown;
  const float omega_new = ts / (bd3 ? 1.0f : tt);
  const bool bd = st[kBd] != 0.0f;
  st[kSS] = ss;
  st[kTS] = ts;
  st[kTT] = tt;
  st[kEarly] = flag(early);
  st[kBd3] = flag(bd3);
  st[kOmegaNew] = omega_new;
  st[kAlphaEff] = bd ? 0.0f : st[kAlphaNew];
  st[kOmegaEff] = (bd || early || bd3) ? 0.0f : omega_new;
}

__global__ void __launch_bounds__(kFoldThreads) bicg_st_finalize(
    const double* __restrict__ part, long long n, float* __restrict__ st) {
  if (st[kRunning] == 0.0f) return;
  const float ss = (float)fold_d<kFoldThreads>(part, n, threadIdx.x);
  const float ts = (float)fold_d<kFoldThreads>(part + n, n, threadIdx.x);
  const float tt = (float)fold_d<kFoldThreads>(part + 2 * n, n, threadIdx.x);
  if (threadIdx.x == 0) st_recur(ss, ts, tt, st);
}

// ---- B1 xr: x', r', <r', r'>, <rhat, r'> ------------------------------------

template <bool kSharded, bool kRows = false>
__global__ void __launch_bounds__(kThreads) bicg_xr_kernel(
    float* __restrict__ x, float* __restrict__ r,
    const float* __restrict__ pn, const float* __restrict__ s,
    const float* __restrict__ t, const float* __restrict__ rhat,
    const float* __restrict__ st, double* __restrict__ part, int nz, int ny,
    int nx, int z_base, int nz_g, int y_base = 0, int ny_g = 0) {
  if (st[kRunning] == 0.0f) return;
  const int i = blockIdx.x * kTileX + threadIdx.x;
  const int j = tile_row<kRows>();
  const int k = kRows ? blockIdx.z + 1 : blockIdx.z;
  const int kg = kSharded ? z_base + k : k;
  const int ng = kSharded ? nz_g : nz;
  const int jg = kRows ? y_base + j : j;
  const int ngy = kRows ? ny_g : ny;
  double rr = 0.0, rh = 0.0;
  if (i < nx && j < (kRows ? ny - 1 : ny) &&
      inside(kg, jg, i, ng, ngy, nx)) {
    const long long c = (k * (long long)ny + j) * nx + i;
    const float alpha = st[kAlphaEff], omega = st[kOmegaEff];
    const float x2 = (x[c] + alpha * pn[c]) + omega * s[c];
    const float r2 = s[c] - omega * t[c];
    x[c] = x2;
    r[c] = r2;
    rr = (double)r2 * r2;
    rh = (double)rhat[c] * r2;
  }
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const long long nb = (long long)gridDim.x * gridDim.y * gridDim.z;
  const long long b = tile_block();
  rr = block_sum_d<kThreads>(rr, tid);
  rh = block_sum_d<kThreads>(rh, tid);
  if (tid == 0) {
    part[b] = rr;
    part[nb + b] = rh;
  }
}

// The rest of the iteration (krylov.py:352-361): residual, convergence
// every ci iterations, the omega breakdown, stagnation, the running flag,
// the carried scalars, and the next iteration's beta.
__device__ __forceinline__ void xr_recur(float rr, float rh, float* st,
                                         int ci) {
  const bool bd = st[kBd] != 0.0f, early = st[kEarly] != 0.0f;
  const bool bd3 = st[kBd3] != 0.0f;
  const float res_new = bd ? st[kRes] : sqrtf(rr);
  const int it = (int)st[kIt];
  const bool conv =
      early || ((it % ci) == 0 &&
                (res_new < st[kTol] || res_new < st[kAbsTol]));
  const float omega_new = st[kOmegaNew];
  const bool bd4 = fabsf(omega_new) < kBreakdown;
  const bool stagnated = bd || bd3 || (bd4 && !conv);
  const float rho_prev = st[kRho], alpha = st[kAlphaNew];
  st[kRR] = rr;
  st[kRhatR] = rh;
  st[kRhoPrev] = rho_prev;
  st[kRho] = rh;
  st[kAlpha] = alpha;
  st[kOmega] = omega_new;
  st[kBeta] = bicg_beta(rh, rho_prev, alpha, omega_new);
  st[kIt] = (float)(it + 1);
  st[kRes] = res_new;
  st[kStagnated] = flag(stagnated);
  st[kRunning] = flag(!(stagnated || conv));
}

__global__ void __launch_bounds__(kFoldThreads) bicg_xr_finalize(
    const double* __restrict__ part, long long n, float* __restrict__ st,
    int ci) {
  if (st[kRunning] == 0.0f) return;
  const float rr = (float)fold_d<kFoldThreads>(part, n, threadIdx.x);
  const float rh = (float)fold_d<kFoldThreads>(part + n, n, threadIdx.x);
  if (threadIdx.x == 0) xr_recur(rr, rh, st, ci);
}

// ---- the sharded finalize, split in two --------------------------------
//
// A shard folds each of its pass's partial regions to one float64 value
// (its share of the dot over its owned planes); the communicator sums the
// shards' values in float64 (comm.sum, the reference's lax.psum); the
// recurrence reads the sums and rounds each to float once, as the
// one-device finalize rounds its fold.

__global__ void __launch_bounds__(kFoldThreads) bicg_fold_kernel(
    const double* __restrict__ part, long long n, int n_dots,
    const float* __restrict__ st, double* __restrict__ out) {
  if (st[kRunning] == 0.0f) return;
  for (int q = 0; q < n_dots; ++q) {
    const double v = fold_d<kFoldThreads>(part + q * n, n, threadIdx.x);
    if (threadIdx.x == 0) out[q] = v;
  }
}

__global__ void bicg_pv_recur_kernel(const double* __restrict__ sum,
                                     float* __restrict__ st) {
  if (st[kRunning] == 0.0f || threadIdx.x != 0) return;
  pv_recur((float)sum[0], st);
}

__global__ void bicg_st_recur_kernel(const double* __restrict__ sum,
                                     float* __restrict__ st) {
  if (st[kRunning] == 0.0f || threadIdx.x != 0) return;
  st_recur((float)sum[0], (float)sum[1], (float)sum[2], st);
}

__global__ void bicg_xr_recur_kernel(const double* __restrict__ sum,
                                     float* __restrict__ st, int ci) {
  if (st[kRunning] == 0.0f || threadIdx.x != 0) return;
  xr_recur((float)sum[0], (float)sum[1], st, ci);
}

// ---- B2: the whole solve ----------------------------------------------------

__global__ void __launch_bounds__(kThreads) bicg_solve_kernel(
    const float* __restrict__ x0, const float* __restrict__ rhs, float* x,
    float* r, float* rhat, float* p, float* v, float* s, float* t,
    double* part, float* stats, int nz, int ny, int nx, float inv_dx2,
    float inv_dy2, float inv_dz2, float tolerance, float abs_tol,
    int max_iter, int ci) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, nblk = gridDim.x;
  const Volume vol(nz, ny, nx);
  const long long stride = (long long)nblk * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + tid;
  int group = 0;

  // up to three dots: per-block partials, a grid barrier, then every block
  // folds them in one order.  Two partial regions alternate, so a block
  // racing ahead never overwrites a partial another block has to read.
  auto dots = [&](int n_dots, double a0, double a1, double a2, float* out) {
    double* reg = part + (group & 1) * 3 * nblk;
    ++group;
    const double vals[3] = {a0, a1, a2};
    for (int q = 0; q < n_dots; ++q) {
      const double b = block_sum_d<kThreads>(vals[q], tid);
      if (tid == 0) reg[q * nblk + blockIdx.x] = b;
    }
    grid.sync();
    for (int q = 0; q < n_dots; ++q)
      out[q] = (float)fold_d<kThreads>(reg + q * nblk, nblk, tid);
  };
  auto lap = [&](const float* f, long long c) {
    return vol.lap(f, c, inv_dx2, inv_dy2, inv_dz2);
  };

  // x = mirror(x0); p and v start at zero; p and s keep zero shells for
  // the whole solve (the Laplacians read them)
  for (long long c = first; c < vol.n; c += stride) {
    x[c] = x0[vol.mirror(c)];
    p[c] = 0.0f;
    v[c] = 0.0f;
    s[c] = 0.0f;
  }
  grid.sync();
  // r0 = lap x - rhs on the interior, rhat = r0, <r0, r0>
  double acc = 0.0;
  for (long long m = first; m < vol.n_in; m += stride) {
    const long long c = vol.interior_point(m);
    const float rv = lap(x, c) - rhs[c];
    r[c] = rv;
    rhat[c] = rv;
    acc += (double)rv * rv;
  }
  float got[3];
  dots(1, acc, 0.0, 0.0, got);
  const float rr0 = got[0];
  const float init_res = sqrtf(rr0);
  const float tl = tolerance * init_res;
  const float tol = (tl > abs_tol || tl != tl) ? tl : abs_tol;  // NaN kept
  const bool already = init_res < abs_tol;
  // <rhat, r> of the first iteration is <r0, r0>
  float rho = 1.0f, alpha = 1.0f, omega = 1.0f, res = init_res;
  float rho_new = rr0;
  int it = 0;
  bool running = !already, stagnated = false;

  while (running && it < max_iter) {
    const bool bd1 = fabsf(rho_new) < kBreakdown;
    const float beta = bicg_beta(rho_new, rho, alpha, omega);
    for (long long m = first; m < vol.n_in; m += stride) {
      const long long c = vol.interior_point(m);
      p[c] = r[c] + beta * (p[c] - omega * v[c]);
    }
    grid.sync();
    // v = A p, <rhat, v>
    acc = 0.0;
    for (long long m = first; m < vol.n_in; m += stride) {
      const long long c = vol.interior_point(m);
      const float a = -lap(p, c);
      v[c] = a;
      acc += (double)rhat[c] * a;
    }
    dots(1, acc, 0.0, 0.0, got);
    const float rhv = got[0];
    const bool bd2 = fabsf(rhv) < kBreakdown;
    const float alpha_new = rho_new / (bd2 ? 1.0f : rhv);
    // s = r - alpha v, <s, s>
    acc = 0.0;
    for (long long m = first; m < vol.n_in; m += stride) {
      const long long c = vol.interior_point(m);
      const float sv = r[c] - alpha_new * v[c];
      s[c] = sv;
      acc += (double)sv * sv;
    }
    dots(1, acc, 0.0, 0.0, got);
    const float s_norm = sqrtf(got[0]);
    const bool early = s_norm < tol || s_norm < abs_tol;
    // t = A s, <t, s>, <t, t>
    double ts = 0.0, tt = 0.0;
    for (long long m = first; m < vol.n_in; m += stride) {
      const long long c = vol.interior_point(m);
      const float tv = -lap(s, c);
      t[c] = tv;
      ts += (double)tv * s[c];
      tt += (double)tv * tv;
    }
    dots(2, ts, tt, 0.0, got);
    const bool bd3 = fabsf(got[1]) < kBreakdown;
    const float omega_new = got[0] / (bd3 ? 1.0f : got[1]);
    // x and r by the reference's selections (:391-393); <r_full, r_full>
    // and <rhat, r_full> (the next rho whenever the loop goes on)
    const bool bd = bd1 || bd2, partial = early || bd3;
    double rr = 0.0, rh = 0.0;
    for (long long m = first; m < vol.n_in; m += stride) {
      const long long c = vol.interior_point(m);
      const float xa = x[c] + alpha_new * p[c];
      const float rf = s[c] - omega_new * t[c];
      if (!bd) x[c] = partial ? xa : xa + omega_new * s[c];
      if (!(bd || partial)) r[c] = rf;
      rr += (double)rf * rf;
      rh += (double)rhat[c] * rf;
    }
    dots(2, rr, rh, 0.0, got);
    const float res_full = sqrtf(got[0]);
    res = bd ? res : (partial ? s_norm : res_full);
    const bool conv =
        early || ((it % ci) == 0 && (res_full < tol || res_full < abs_tol));
    const bool bd4 = fabsf(omega_new) < kBreakdown;
    stagnated = bd || bd3 || (bd4 && !conv);
    running = !(stagnated || conv);
    rho = rho_new;
    rho_new = got[1];
    alpha = alpha_new;
    omega = omega_new;
    ++it;
  }

  // the Neumann mirror of the result: shell points read interior ones,
  // whose last writes came before the last barrier
  for (long long c = first; c < vol.n; c += stride) {
    const long long src = vol.mirror(c);
    if (src != c) x[c] = x[src];
  }
  if (blockIdx.x == 0 && tid == 0) {
    stats[0] = init_res;
    stats[1] = already ? init_res : res;
    stats[2] = already ? 0.0f : (float)it;
    stats[3] = flag(stagnated);
  }
}

// ---- B2c: the whole solve in one cluster ------------------------------------

// vectors of the band (cluster_band.cuh), in the order the plan keeps them
// resident; x not resident lives in x itself, the others in ws's planes
enum { kVecP = 0, kVecS, kVecR, kVecV, kVecRhat, kVecX, kVecT, kBicgVecs };
// a halo column: the neighbour's edge (r, p, v) pushed with <r, r> (and
// <r0, r0>), and its edge v' pushed with <rhat, v'>
enum { kHaloR = 0, kHaloP, kHaloV, kHaloVNew, kBicgHalo };

// B2's loop on a 2D plane (nz == 1) in the band layout, three dots an
// iteration.  The p update opens the v pass and the s update the t pass
// (a CTA barrier between); the rows a band reads beyond its edges are
// formed there: p as r + beta (p - omega v) from the neighbour's pushed
// (r, p, v), s as r - alpha v' from its r and its pushed v'.  x0 and rhs
// are read from device memory once.
__global__ void __launch_bounds__(kBandMaxThreads, 1)
    bicg_solve_cluster_kernel(const float* __restrict__ x0,
                              const float* __restrict__ rhs, float* x,
                              float* ws, float* stats, int ny, int nx,
                              float inv_dx2, float inv_dy2, float tolerance,
                              float abs_tol, int max_iter, int ci, int rmax,
                              int resident) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  const Band b(ny, nx, rmax);
  const BandSmem sm(band_smem, kBicgHalo, nx);
  const long long plane = (long long)ny * nx;
  auto vec = [&](int k) {
    return band_vec(k, resident, sm, b, k == kVecX ? x : ws + k * plane);
  };
  float *p = vec(kVecP), *s = vec(kVecS), *r = vec(kVecR), *v = vec(kVecV),
        *rhat = vec(kVecRhat), *xv = vec(kVecX), *t = vec(kVecT);
  BandDots dots;
  band_init(sm);
  const BandLinks links(sm, b);
  const int halo_rpv = halo_bytes(b, 12), halo_v = halo_bytes(b, 4);
  // an edge point's (r, p, v), or its v', to the neighbour across that edge
  auto push_rpv = [&](int jl, int i, float rv, float pv, float vv) {
    for (int to = 0; to < 2; ++to) {
      if (to == 1 ? (jl != 0 || !b.has_up())
                  : (jl != b.rows - 1 || !b.has_down()))
        continue;
      const uint32_t bar = links.bar[to][dots.slot()];
      band_push2(links.dst(to, i, kHaloR), rv, pv, bar);
      band_push(links.dst(to, i, kHaloV), vv, bar);
    }
  };
  auto push_v = [&](int jl, int i, float vv) {
    if (jl == 0 && b.has_up())
      band_push(links.dst(1, i, kHaloVNew), vv, links.bar[1][dots.slot()]);
    if (jl == b.rows - 1 && b.has_down())
      band_push(links.dst(0, i, kHaloVNew), vv, links.bar[0][dots.slot()]);
  };

  // x = x0 on the interior, r0 = lap(mirror x0) - rhs, rhat = r0, p = v =
  // 0, p's and s's shell columns 0; <r0, r0>
  auto x0m = [&](int j, int i) {
    return x0[(long long)band_clamp(j, ny) * nx + band_clamp(i, nx)];
  };
  double acc = 0.0;
  band_points(b, [&](int jl, int i, int c) {
    const int j = b.first + jl;
    const float xc = x0[(long long)j * nx + i];
    const float c2 = 2.0f * xc;
    const float l = ((x0m(j, i + 1) - c2) + x0m(j, i - 1)) * inv_dx2 +
                    ((x0m(j + 1, i) - c2) + x0m(j - 1, i)) * inv_dy2;
    const float rv = l - rhs[(long long)j * nx + i];
    xv[c] = xc;
    r[c] = rv;
    rhat[c] = rv;
    p[c] = 0.0f;
    v[c] = 0.0f;
    acc += (double)rv * rv;
    push_rpv(jl, i, rv, 0.0f, 0.0f);
  });
  band_zero_shell(p, b);
  band_zero_shell(s, b);
  double got[3] = {acc, 0.0, 0.0};
  cluster_sum<double, 1>(got, sm, b, dots, halo_rpv);
  const float rr0 = (float)got[0];
  const float init_res = sqrtf(rr0);
  const float tl = tolerance * init_res;
  const float tol = (tl > abs_tol || tl != tl) ? tl : abs_tol;  // NaN kept
  const bool already = init_res < abs_tol;
  // <rhat, r> of the first iteration is <r0, r0>
  float rho = 1.0f, alpha = 1.0f, omega = 1.0f, res = init_res;
  float rho_new = rr0;
  int it = 0, ci_phase = 0;  // ci_phase: it % ci, without a divide
  bool running = !already, stagnated = false;

  while (running && it < max_iter) {
    const bool bd1 = fabsf(rho_new) < kBreakdown;
    const float beta = bicg_beta(rho_new, rho, alpha, omega);
    // p = r + beta (p - omega v); v = A p, <rhat, v>; the neighbour's edge
    // p formed as it forms its own from its pushed (r, p, v)
    band_points(b, [&](int, int, int c) {
      p[c] = r[c] + beta * (p[c] - omega * v[c]);
    });
    __syncthreads();
    auto p_edge = [&](int side, int i) {
      const float* h = sm.halo_at(side, i, nx, 0);
      return h[kHaloR] + beta * (h[kHaloP] - omega * h[kHaloV]);
    };
    acc = 0.0;
    band_points(b, [&](int jl, int i, int c) {
      const float up = jl == 0 && b.has_up() ? p_edge(0, i) : 0.0f;
      const float dn = jl == b.rows - 1 && b.has_down() ? p_edge(1, i)
                                                        : 0.0f;
      const float a =
          -band_lap(p, jl, c, b.rows, nx, up, dn, inv_dx2, inv_dy2);
      v[c] = a;
      acc += (double)rhat[c] * a;
      push_v(jl, i, a);
    });
    got[0] = acc;
    cluster_sum<double, 1>(got, sm, b, dots, halo_v);
    const float rhv = (float)got[0];
    const bool bd2 = fabsf(rhv) < kBreakdown;
    const float alpha_new = rho_new / (bd2 ? 1.0f : rhv);
    // s = r - alpha v; t = A s, <s, s>, <t, s>, <t, t>; the neighbour's edge
    // s formed from its r and its pushed v
    band_points(b, [&](int, int, int c) { s[c] = r[c] - alpha_new * v[c]; });
    __syncthreads();
    auto s_edge = [&](int side, int i) {
      const float* h = sm.halo_at(side, i, nx, 0);
      return h[kHaloR] - alpha_new * h[kHaloVNew];
    };
    double ss = 0.0, ts = 0.0, tt = 0.0;
    band_points(b, [&](int jl, int i, int c) {
      const float up = jl == 0 && b.has_up() ? s_edge(0, i) : 0.0f;
      const float dn = jl == b.rows - 1 && b.has_down() ? s_edge(1, i)
                                                        : 0.0f;
      const float tv =
          -band_lap(s, jl, c, b.rows, nx, up, dn, inv_dx2, inv_dy2);
      const float sv = s[c];
      t[c] = tv;
      ss += (double)sv * sv;
      ts += (double)tv * sv;
      tt += (double)tv * tv;
    });
    got[0] = ss;
    got[1] = ts;
    got[2] = tt;
    cluster_sum<double, 3>(got, sm, b, dots, 0);
    const float s_norm = sqrtf((float)got[0]);
    const bool early = s_norm < tol || s_norm < abs_tol;
    const float tds = (float)got[1], tdt = (float)got[2];
    const bool bd3 = fabsf(tdt) < kBreakdown;
    const float omega_new = tds / (bd3 ? 1.0f : tdt);
    // x and r by the reference's selections (vmem_small.py:391-393);
    // <r_full, r_full> and <rhat, r_full>; the edge (r, p, v) to the
    // neighbours
    const bool bd = bd1 || bd2, partial = early || bd3;
    double rr = 0.0, rh = 0.0;
    band_points(b, [&](int jl, int i, int c) {
      const float pv = p[c];
      const float xa = xv[c] + alpha_new * pv;
      const float rf = s[c] - omega_new * t[c];
      if (!bd) xv[c] = partial ? xa : xa + omega_new * s[c];
      const bool keep = bd || partial;
      if (!keep) r[c] = rf;
      rr += (double)rf * rf;
      rh += (double)rhat[c] * rf;
      push_rpv(jl, i, keep ? r[c] : rf, pv, v[c]);
    });
    got[0] = rr;
    got[1] = rh;
    cluster_sum<double, 2>(got, sm, b, dots, halo_rpv);
    const float res_full = sqrtf((float)got[0]);
    res = bd ? res : (partial ? s_norm : res_full);
    const bool conv =
        early || (ci_phase == 0 && (res_full < tol || res_full < abs_tol));
    const bool bd4 = fabsf(omega_new) < kBreakdown;
    stagnated = bd || bd3 || (bd4 && !conv);
    running = !(stagnated || conv);
    rho = rho_new;
    rho_new = (float)got[1];
    alpha = alpha_new;
    omega = omega_new;
    ++it;
    if (++ci_phase == ci) ci_phase = 0;
  }

  // the Neumann mirror of the result into x; no CTA leaves while a push to
  // it may be in flight
  band_mirror_out(xv, !((resident >> kVecX) & 1), b, x);
  cooperative_groups::this_cluster().sync();
  if (b.q == 0 && threadIdx.x == 0) {
    stats[0] = init_res;
    stats[1] = already ? init_res : res;
    stats[2] = already ? 0.0f : (float)it;
    stats[3] = flag(stagnated);
  }
}

dim3 tile_grid(int nz, int ny, int nx) {
  return dim3((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY, nz);
}

}  // namespace

extern "C" {

long long cfd_bicg_partials(int nz, int ny, int nx) {
  const dim3 g = tile_grid(nz, ny, nx);
  return (long long)g.x * g.y * g.z;
}

int cfd_bicg_pv(const float* r, const float* p, const float* v,
                const float* rhat, float* pn, float* vn, float* st,
                double* part, int nz, int ny, int nx, float inv_dx2,
                float inv_dy2, float inv_dz2, cudaStream_t stream) {
  bicg_pv_kernel<false><<<tile_grid(nz, ny, nx), dim3(kTileX, kTileY), 0,
                          stream>>>(r, p, v, rhat, pn, vn, st, part, nz, ny,
                                    nx, inv_dx2, inv_dy2, inv_dz2, 0, nz);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bicg_pv_finalize<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_bicg_partials(nz, ny, nx), st);
  return (int)cudaGetLastError();
}

int cfd_bicg_st(const float* r, const float* vn, float* s, float* t,
                float* st, double* part, int nz, int ny, int nx, float inv_dx2,
                float inv_dy2, float inv_dz2, cudaStream_t stream) {
  bicg_st_kernel<false><<<tile_grid(nz, ny, nx), dim3(kTileX, kTileY), 0,
                          stream>>>(r, vn, s, t, st, part, nz, ny, nx,
                                    inv_dx2, inv_dy2, inv_dz2, 0, nz);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bicg_st_finalize<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_bicg_partials(nz, ny, nx), st);
  return (int)cudaGetLastError();
}

int cfd_bicg_xr(float* x, float* r, const float* pn, const float* s,
                const float* t, const float* rhat, float* st, double* part,
                int nz, int ny, int nx, int ci, cudaStream_t stream) {
  bicg_xr_kernel<false><<<tile_grid(nz, ny, nx), dim3(kTileX, kTileY), 0,
                          stream>>>(x, r, pn, s, t, rhat, st, part, nz, ny,
                                    nx, 0, nz);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bicg_xr_finalize<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_bicg_partials(nz, ny, nx), st, ci);
  return (int)cudaGetLastError();
}

// The sharded passes: the pass, then the shard's float64 fold of each of
// its partial regions into out[0..].  pv and st take the (nzl + 2)-plane
// halo-padded blocks (nz = nzl + 2) and launch over the nzl owned planes;
// xr takes the nzl-plane owned block.  z_base is the global plane of the
// block's plane 0, nz_g the global plane count.
int cfd_bicg_pv_sharded(const float* r, const float* p, const float* v,
                        const float* rhat, float* pn, float* vn, float* st,
                        double* part, double* out, int nz, int ny, int nx,
                        float inv_dx2, float inv_dy2, float inv_dz2,
                        int z_base, int nz_g, cudaStream_t stream) {
  bicg_pv_kernel<true><<<tile_grid(nz - 2, ny, nx), dim3(kTileX, kTileY), 0,
                         stream>>>(r, p, v, rhat, pn, vn, st, part, nz, ny,
                                   nx, inv_dx2, inv_dy2, inv_dz2, z_base,
                                   nz_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bicg_fold_kernel<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_bicg_partials(nz - 2, ny, nx), 1, st, out);
  return (int)cudaGetLastError();
}

int cfd_bicg_st_sharded(const float* r, const float* vn, float* s, float* t,
                        float* st, double* part, double* out, int nz, int ny,
                        int nx, float inv_dx2, float inv_dy2, float inv_dz2,
                        int z_base, int nz_g, cudaStream_t stream) {
  bicg_st_kernel<true><<<tile_grid(nz - 2, ny, nx), dim3(kTileX, kTileY), 0,
                         stream>>>(r, vn, s, t, st, part, nz, ny, nx,
                                   inv_dx2, inv_dy2, inv_dz2, z_base, nz_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bicg_fold_kernel<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_bicg_partials(nz - 2, ny, nx), 3, st, out);
  return (int)cudaGetLastError();
}

int cfd_bicg_xr_sharded(float* x, float* r, const float* pn, const float* s,
                        const float* t, const float* rhat, float* st,
                        double* part, double* out, int nz, int ny, int nx,
                        int z_base, int nz_g, cudaStream_t stream) {
  bicg_xr_kernel<true><<<tile_grid(nz, ny, nx), dim3(kTileX, kTileY), 0,
                         stream>>>(x, r, pn, s, t, rhat, st, part, nz, ny,
                                   nx, z_base, nz_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bicg_fold_kernel<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_bicg_partials(nz, ny, nx), 2, st, out);
  return (int)cudaGetLastError();
}

// The (z, y) passes, B1r: every buffer the shard's block padded one plane
// and one row a side (nz, ny its padded counts), the launch over its owned
// points, then the fold; z_base, y_base the global plane and row of the
// block's (0, 0), nz_g, ny_g the global counts.
int cfd_bicg_pv_rows(const float* r, const float* p, const float* v,
                     const float* rhat, float* pn, float* vn, float* st,
                     double* part, double* out, int nz, int ny, int nx,
                     float inv_dx2, float inv_dy2, float inv_dz2, int z_base,
                     int nz_g, int y_base, int ny_g, cudaStream_t stream) {
  bicg_pv_kernel<true, true><<<tile_grid(nz - 2, ny - 2, nx),
                               dim3(kTileX, kTileY), 0, stream>>>(
      r, p, v, rhat, pn, vn, st, part, nz, ny, nx, inv_dx2, inv_dy2,
      inv_dz2, z_base, nz_g, y_base, ny_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bicg_fold_kernel<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_bicg_partials(nz - 2, ny - 2, nx), 1, st, out);
  return (int)cudaGetLastError();
}

int cfd_bicg_st_rows(const float* r, const float* vn, float* s, float* t,
                     float* st, double* part, double* out, int nz, int ny,
                     int nx, float inv_dx2, float inv_dy2, float inv_dz2,
                     int z_base, int nz_g, int y_base, int ny_g,
                     cudaStream_t stream) {
  bicg_st_kernel<true, true><<<tile_grid(nz - 2, ny - 2, nx),
                               dim3(kTileX, kTileY), 0, stream>>>(
      r, vn, s, t, st, part, nz, ny, nx, inv_dx2, inv_dy2, inv_dz2, z_base,
      nz_g, y_base, ny_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bicg_fold_kernel<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_bicg_partials(nz - 2, ny - 2, nx), 3, st, out);
  return (int)cudaGetLastError();
}

int cfd_bicg_xr_rows(float* x, float* r, const float* pn, const float* s,
                     const float* t, const float* rhat, float* st,
                     double* part, double* out, int nz, int ny, int nx,
                     int z_base, int nz_g, int y_base, int ny_g,
                     cudaStream_t stream) {
  bicg_xr_kernel<true, true><<<tile_grid(nz - 2, ny - 2, nx),
                               dim3(kTileX, kTileY), 0, stream>>>(
      x, r, pn, s, t, rhat, st, part, nz, ny, nx, z_base, nz_g, y_base,
      ny_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bicg_fold_kernel<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_bicg_partials(nz - 2, ny - 2, nx), 2, st, out);
  return (int)cudaGetLastError();
}

// The recurrences on the shards' summed dots (comm.sum of the folds).
int cfd_bicg_pv_recur(const double* sum, float* st, cudaStream_t stream) {
  bicg_pv_recur_kernel<<<1, 32, 0, stream>>>(sum, st);
  return (int)cudaGetLastError();
}

int cfd_bicg_st_recur(const double* sum, float* st, cudaStream_t stream) {
  bicg_st_recur_kernel<<<1, 32, 0, stream>>>(sum, st);
  return (int)cudaGetLastError();
}

int cfd_bicg_xr_recur(const double* sum, float* st, int ci,
                      cudaStream_t stream) {
  bicg_xr_recur_kernel<<<1, 32, 0, stream>>>(sum, st, ci);
  return (int)cudaGetLastError();
}

// B2's grid: as many blocks as fit on the card at once (a cooperative
// launch needs every block resident), and no more than the points need.
long long cfd_bicg_solve_blocks(int nz, int ny, int nx) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bicg_solve_kernel,
                                                  kThreads, 0);
    resident = sms * per_sm;
  }
  const long long want =
      ((long long)nz * ny * nx + kThreads - 1) / kThreads;
  return want < resident ? want : resident;
}

int cfd_bicg_solve(const float* x0, const float* rhs, float* x, float* r,
                   float* rhat, float* p, float* v, float* s, float* t,
                   double* part, float* stats, int nz, int ny, int nx,
                   float inv_dx2, float inv_dy2, float inv_dz2,
                   float tolerance, float abs_tol, int max_iter, int ci,
                   cudaStream_t stream) {
  const long long nblk = cfd_bicg_solve_blocks(nz, ny, nx);
  if (nblk < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&x0,      &rhs,      &x,        &r,       &rhat,
                  &p,       &v,        &s,        &t,       &part,
                  &stats,   &nz,       &ny,       &nx,      &inv_dx2,
                  &inv_dy2, &inv_dz2,  &tolerance, &abs_tol, &max_iter,
                  &ci};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)bicg_solve_kernel, dim3((unsigned int)nblk),
      dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// B2c: the plan's cluster (cs CTAs of `threads`), rmax rows a resident
// vector, `resident` the bit mask of the vectors kept in shared memory
// (kVecP ... kVecT); ws holds the planes of the ones that are not, at
// their indices (x not resident is x itself).
int cfd_bicg_solve_cluster(const float* x0, const float* rhs, float* x,
                           float* ws, float* stats, int ny, int nx,
                           float inv_dx2, float inv_dy2, float tolerance,
                           float abs_tol, int max_iter, int ci, int cs,
                           int threads, int rmax, int resident,
                           cudaStream_t stream) {
  const int my = ny - 2;
  if (ny < 3 || nx < 3 || cs < 1 || cs > my || rmax < (my + cs - 1) / cs ||
      resident < 0 || resident >= (1 << kBicgVecs))
    return (int)cudaErrorInvalidValue;
  const long long smem = band_smem_bytes(
      kBicgHalo, __builtin_popcount(resident), rmax, nx);
  return band_launch(bicg_solve_cluster_kernel, cs, threads, smem, stream,
                     x0, rhs, x, ws, stats, ny, nx, inv_dx2, inv_dy2,
                     tolerance, abs_tol, max_iter, ci, rmax, resident);
}

}  // extern "C"
