// Hand-written CUDA kernels for the CG pressure solve on Hopper.
//
// They replace the TPU kernels of the reference's CG solve:
//
//   K1  cg_lap_dot_kernel + cg_lap_dot_finalize
//       <- make_lap_dot_rolling / make_lap_dot_fused
//          (cfd_tpu/ops/pallas/cg_kernels.py:75, :249): p' = scale r + beta p
//          on the interior (zero shell), Ap' = -lap p' (7-point, Dirichlet-0),
//          <p', Ap'>; the finalize also forms alpha = rho / <p', Ap'>.
//   K2  cg_update_kernel + cg_update_finalize
//       <- make_cg_update (cg_kernels.py:360): x += alpha p', r -= alpha Ap'
//          on the interior (shells untouched), <r, r>; the finalize carries
//          the rest of the iteration's scalar recurrence
//          (cfd_tpu/solvers/poisson/krylov.py:174-182).
//   K1s cg_lap_dot_kernel<true> + cg_fold_kernel, then
//       cg_lap_dot_recur_kernel on the shards' sum
//       <- make_lap_dot_sharded (cg_kernels.py:437), global_nz mode: K1 on
//          a z-shard's halo-padded block, the Dirichlet-0 space and the
//          shells at global planes, the dot over the owned planes.
//   K2s cg_update_kernel<true> + cg_fold_kernel, then
//       cg_update_recur_kernel: K2 on a shard's owned block (the
//       reference does this update in jnp, parallel/fused_cg.py:216-219).
//   K1r, K2r  cg_lap_dot_kernel<true, true>, cg_update_kernel<true, true>
//       <- make_lap_dot_sharded's global_ny mode (cg_kernels.py:469-480)
//       and the owned-block update on a (z, y)-decomposed shard: every
//       buffer (x, r, p, p', Ap') is the shard's block padded one plane
//       and one row a side, the grid covers its owned points, and the
//       Dirichlet-0 space, the shells and p''s neighbour tests are at the
//       global plane z_base + k and row y_base + j; the dots take the
//       owned points only (the halo rows are the neighbours').
//   K3  cg_solve_kernel
//       <- make_cg_vmem_solve (cfd_tpu/ops/pallas/vmem_small.py:243): the
//          whole CG/PCG loop in one cooperative launch (3D volumes and
//          planes too large for one cluster).
//   K3c cg_solve_cluster_kernel
//       <- the same, for a 2D plane whose vectors fit one thread-block
//          cluster (vmem_small.krylov_cluster_plan): the whole loop in one
//          cluster launch on cluster_band.cuh's engine.
//
// What bounds them on an H100, and what the design does:
//
// * K1 and K2 are two passes over the field per iteration, a few flops per
//   byte: bound by device-memory bandwidth (4 and 6 fields per pass).  One
//   thread per point, as the other stencil kernels; K1 forms p' at the six
//   neighbours from r and p (L1/L2 hits) instead of reading a p' plane
//   ring, so p' and Ap' go to buffers other than p.  The TPU kernels march
//   z-planes in one program and carry the dot in scratch; here each block
//   writes its partial sum and a one-block finalize folds the partials in
//   a fixed order: no float atomics, so a solve's iteration count does not
//   change from run to run.
// * The loop runs on the host, but its scalars stay on the card: alpha and
//   beta are read by K1 and K2 from the state vector (cg_kernels.py holds
//   the slot layout), and the finalize blocks carry the recurrence.  Once
//   the state's running flag drops, every kernel returns at once, so the
//   iterations the host queued past the stop are no-ops and the count,
//   residual and x are those of the device loop.
// * K3 is for small grids (2D planes; at 512^2 the vectors fit the 50 MB
//   L2): latency, not bandwidth, bounds it.  One cooperative launch, the
//   grid sized by the occupancy API and capped by the work, grid-stride
//   loops over the interior, three grid barriers per iteration
//   (cooperative_groups::this_grid().sync()).  Each dot is a per-block
//   partial, a barrier, then every block folds the same partials in the
//   same order, so all blocks agree on every scalar and leave the loop
//   together; the host launches once per solve.
// * K3c keeps the plane resident in one cluster of up to 16 CTAs, as the
//   TPU kernel keeps it in VMEM: p and r (and Ap and x where they fit) in
//   the CTAs' shared memory by bands of rows, what one CTA needs of
//   another pushed into its shared memory by st.async and counted on its
//   mbarrier, each dot one such exchange and no cluster barrier
//   (cluster_band.cuh).  Two dots an iteration and no pass of its own for
//   the p update: it opens the next iteration, and the row a band reads
//   beyond its edge is formed there as scale r + beta p from the edge r
//   and p the neighbour pushed with the second dot (K1's trick), so no
//   band waits for a neighbour's update.
//
// Shells: p' and Ap' get exact zeros by selection (never a multiply by a
// mask, which would turn uninitialised NaN into NaN); x and r keep the
// caller's shells bit for bit.  Built with -fmad=false, in the plain
// versions' operation order, so the fields match them bit for bit on
// identical inputs; the dots differ in summation order.  Every entry point
// returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "block_reduce.cuh"
#include "cluster_band.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTileX = 32, kTileY = 8;  // K1, K2: 256-thread tiles
constexpr int kThreads = kTileX * kTileY;
constexpr int kFoldThreads = 1024;      // the finalize blocks
constexpr float kBreakdown = 1e-30f;    // krylov.BREAKDOWN

// slots of the solver state vector (cg_kernels.py: RHO ... BD1)
enum {
  kRho = 0, kBeta, kAlpha, kRes, kIt, kRunning, kTol, kAbsTol, kPAp, kRR,
  kBd1
};

__device__ __forceinline__ bool inside(int k, int j, int i, int nz, int ny,
                                       int nx) {
  return k > 0 && k < nz - 1 && j > 0 && j < ny - 1 && i > 0 && i < nx - 1;
}

// A thread's (k, j) in a pass's block: the grid covers every row of the
// block, or with kRows its owned rows 1..ny-2 only.
template <bool kRows>
__device__ __forceinline__ int tile_row() {
  return blockIdx.y * kTileY + threadIdx.y + (kRows ? 1 : 0);
}

__device__ __forceinline__ long long tile_block() {
  return ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
         blockIdx.x;
}

// ---- K1: p', Ap', <p', Ap'> ----------------------------------------------

// kSharded: a z-decomposed shard's halo-padded block of nz = nzl + 2 planes
// (the TPU kernel make_lap_dot_sharded, cg_kernels.py:437).  The grid
// covers the owned planes k = 1..nz-2 only and writes them to owned-size
// outputs (plane k to plane k-1 of pn and ap); local plane k is global
// plane kg = z_base + k of an nz_g-plane domain, and the Dirichlet-0
// correction space is the global one, so p' at a halo plane is the
// neighbour shard's own p' and the global shells give zeros.  One device
// is the same code with kg = k and nz_g = nz.
// kRows (with kSharded): the (z, y) form, K1r above — the block padded one
// row a side too, the grid over its owned rows, p' and Ap' written in the
// padded layout (index c), the rows global (y_base + j of ny_g).
template <bool kSharded, bool kRows = false>
__global__ void __launch_bounds__(kThreads) cg_lap_dot_kernel(
    const float* __restrict__ r, const float* __restrict__ p,
    float* __restrict__ pn, float* __restrict__ ap,
    const float* __restrict__ st, float* __restrict__ part, int nz, int ny,
    int nx, float inv_dx2, float inv_dy2, float inv_dz2, float scale,
    int z_base, int nz_g, int y_base = 0, int ny_g = 0) {
  if (st[kRunning] == 0.0f) return;  // uniform: the whole grid returns
  const int i = blockIdx.x * kTileX + threadIdx.x;
  const int j = tile_row<kRows>();
  const int k = kSharded ? blockIdx.z + 1 : blockIdx.z;
  const int kg = kSharded ? z_base + k : k;
  const int ng = kSharded ? nz_g : nz;
  const int jg = kRows ? y_base + j : j;
  const int ngy = kRows ? ny_g : ny;
  float acc = 0.0f;
  if (i < nx && j < (kRows ? ny - 1 : ny)) {
    const long long sy = nx, sz = (long long)ny * nx;
    const long long c = k * sz + j * sy + i;
    // the output's index: owned-size planes in the z-only form
    const long long o = (kSharded && !kRows) ? c - sz : c;
    if (inside(kg, jg, i, ng, ngy, nx)) {
      const float beta = st[kBeta];
      // p' at a neighbour: 0 on the shell (the correction space)
      auto pp = [&](long long q, bool in) {
        return in ? scale * r[q] + beta * p[q] : 0.0f;
      };
      const float pc = scale * r[c] + beta * p[c];
      const float xm = pp(c - 1, i > 1), xp = pp(c + 1, i < nx - 2);
      const float ym = pp(c - sy, jg > 1), yp = pp(c + sy, jg < ngy - 2);
      const float zm = pp(c - sz, kg > 1), zp = pp(c + sz, kg < ng - 2);
      const float c2 = 2.0f * pc;
      const float lap =
          (((xp - c2) + xm) * inv_dx2 + ((yp - c2) + ym) * inv_dy2) +
          ((zp - c2) + zm) * inv_dz2;
      const float a = -lap;
      pn[o] = pc;
      ap[o] = a;
      acc = a * pc;
    } else {
      pn[o] = 0.0f;
      ap[o] = 0.0f;
    }
  }
  const float s = block_sum<kThreads>(acc, threadIdx.y * kTileX + threadIdx.x);
  if (threadIdx.x == 0 && threadIdx.y == 0) part[tile_block()] = s;
}

// <p', Ap'>, breakdown and alpha = rho / <p', Ap'> (0 on breakdown).
__device__ __forceinline__ void lap_dot_recur(float pap, float* st) {
  const bool bd1 = fabsf(pap) < kBreakdown;
  st[kPAp] = pap;
  st[kBd1] = bd1 ? 1.0f : 0.0f;
  st[kAlpha] = bd1 ? 0.0f : st[kRho] / pap;
}

__global__ void __launch_bounds__(kFoldThreads) cg_lap_dot_finalize(
    const float* __restrict__ part, long long n, float* __restrict__ st) {
  if (st[kRunning] == 0.0f) return;
  const float pap = fold<kFoldThreads>(part, n, threadIdx.x);
  if (threadIdx.x == 0) lap_dot_recur(pap, st);
}

// ---- K2: x', r', <r', r'> ------------------------------------------------

// kSharded: a shard's owned block (nz = nzl planes, plane k is global
// plane z_base + k): every owned plane is updated but the global shells.
// kRows: K2r — every buffer the padded block (nz, ny its padded counts),
// the grid over its owned planes and rows, global plane z_base + k and
// row y_base + j.
template <bool kSharded, bool kRows = false>
__global__ void __launch_bounds__(kThreads) cg_update_kernel(
    float* __restrict__ x, float* __restrict__ r,
    const float* __restrict__ pn, const float* __restrict__ ap,
    const float* __restrict__ st, float* __restrict__ part, int nz, int ny,
    int nx, int z_base, int nz_g, int y_base = 0, int ny_g = 0) {
  if (st[kRunning] == 0.0f) return;
  const int i = blockIdx.x * kTileX + threadIdx.x;
  const int j = tile_row<kRows>();
  const int k = kRows ? blockIdx.z + 1 : blockIdx.z;
  const int kg = kSharded ? z_base + k : k;
  const int ng = kSharded ? nz_g : nz;
  const int jg = kRows ? y_base + j : j;
  const int ngy = kRows ? ny_g : ny;
  float acc = 0.0f;
  if (i < nx && j < (kRows ? ny - 1 : ny) &&
      inside(kg, jg, i, ng, ngy, nx)) {
    const long long c = (k * (long long)ny + j) * nx + i;
    const float alpha = st[kAlpha];
    const float x2 = x[c] + alpha * pn[c];
    const float r2 = r[c] - alpha * ap[c];
    x[c] = x2;
    r[c] = r2;
    acc = r2 * r2;
  }
  const float s = block_sum<kThreads>(acc, threadIdx.y * kTileX + threadIdx.x);
  if (threadIdx.x == 0 && threadIdx.y == 0) part[tile_block()] = s;
}

// The rest of one iteration (krylov.py:174-182): rho, residual, the
// convergence check every ci iterations, breakdown, beta, the counter and
// the running flag.
__device__ __forceinline__ void update_recur(float rr, float* st,
                                             float scale, int ci) {
  const float rho = st[kRho];
  const float rho_new = scale * rr;
  const float res_new = sqrtf(rr);
  const int it = (int)st[kIt];
  const bool conv =
      (it % ci) == 0 && (res_new < st[kTol] || res_new < st[kAbsTol]);
  const bool bd1 = st[kBd1] != 0.0f;
  const bool bd2 = fabsf(rho) < kBreakdown;
  st[kRR] = rr;
  st[kRho] = rho_new;
  st[kBeta] = rho_new / (bd2 ? 1.0f : rho);
  st[kIt] = (float)(it + 1);
  if (!bd1) st[kRes] = res_new;
  st[kRunning] = (conv || bd1 || bd2) ? 0.0f : 1.0f;
}

__global__ void __launch_bounds__(kFoldThreads) cg_update_finalize(
    const float* __restrict__ part, long long n, float* __restrict__ st,
    float scale, int ci) {
  if (st[kRunning] == 0.0f) return;
  const float rr = fold<kFoldThreads>(part, n, threadIdx.x);
  if (threadIdx.x == 0) update_recur(rr, st, scale, ci);
}

// ---- the sharded finalize, split in two --------------------------------
//
// A shard folds its own partials to one value (its share of the dot over
// its owned planes); the shards' values are summed by the communicator
// (comm.sum, the reference's lax.psum); the recurrence then reads the sum.
// Every shard keeps its own copy of the state and runs the same
// recurrence on the same sum.

__global__ void __launch_bounds__(kFoldThreads) cg_fold_kernel(
    const float* __restrict__ part, long long n,
    const float* __restrict__ st, float* __restrict__ out) {
  if (st[kRunning] == 0.0f) return;
  const float v = fold<kFoldThreads>(part, n, threadIdx.x);
  if (threadIdx.x == 0) out[0] = v;
}

__global__ void cg_lap_dot_recur_kernel(const float* __restrict__ sum,
                                        float* __restrict__ st) {
  if (st[kRunning] == 0.0f || threadIdx.x != 0) return;
  lap_dot_recur(sum[0], st);
}

__global__ void cg_update_recur_kernel(const float* __restrict__ sum,
                                       float* __restrict__ st, float scale,
                                       int ci) {
  if (st[kRunning] == 0.0f || threadIdx.x != 0) return;
  update_recur(sum[0], st, scale, ci);
}

// ---- K3: the whole solve ---------------------------------------------------

// Each dot: a per-block partial, a grid barrier, then every block folds
// all partials in one order.  Two partial regions alternate (<p, Ap> in
// the first, <r, r> in the second) so a block racing ahead never
// overwrites a partial another block has still to read.
__global__ void __launch_bounds__(kThreads) cg_solve_kernel(
    const float* __restrict__ x0, const float* __restrict__ rhs, float* x,
    float* r, float* p, float* ap, float* part, float* stats, int nz, int ny,
    int nx, float inv_dx2, float inv_dy2, float inv_dz2, float scale,
    float tolerance, float abs_tol, int max_iter, int ci) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, nblk = gridDim.x;
  const bool three_d = nz > 1;
  const long long sy = nx, sz = (long long)ny * nx;
  const long long n = nz * sz;
  const long long stride = (long long)nblk * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + tid;
  // the interior as a dense index range: planes k0.., rows 1.., cols 1..
  const int k0 = three_d ? 1 : 0, mz = three_d ? nz - 2 : 1;
  const int my = ny - 2, mx = nx - 2;
  const long long n_in = (long long)mz * my * mx;
  float* part_pap = part;
  float* part_rr = part + nblk;

  auto interior_point = [&](long long m) {
    const long long row = m / mx;
    const int i = 1 + (int)(m - row * mx);
    const int kk = (int)(row / my);
    const int j = 1 + (int)(row - (long long)kk * my);
    return (k0 + kk) * sz + j * sy + i;
  };
  // the Neumann mirror (x faces, then y, then z; later faces own the
  // corners): the source of every point, an interior point for a shell one
  auto mirror = [&](long long c) {
    const int k = (int)(c / sz);
    const long long q = c - k * sz;
    const int j = (int)(q / nx);
    const int i = (int)(q - (long long)j * nx);
    const int ks = !three_d ? k : (k == 0 ? 1 : (k == nz - 1 ? nz - 2 : k));
    const int js = j == 0 ? 1 : (j == ny - 1 ? ny - 2 : j);
    const int is = i == 0 ? 1 : (i == nx - 1 ? nx - 2 : i);
    return ks * sz + js * sy + is;
  };
  auto lap = [&](const float* f, long long c) {
    const float c2 = 2.0f * f[c];
    float l = ((f[c + 1] - c2) + f[c - 1]) * inv_dx2 +
              ((f[c + sy] - c2) + f[c - sy]) * inv_dy2;
    if (three_d) l = l + ((f[c + sz] - c2) + f[c - sz]) * inv_dz2;
    return l;
  };

  // x = mirror(x0); p keeps a zero shell for the whole solve
  for (long long c = first; c < n; c += stride) {
    x[c] = x0[mirror(c)];
    p[c] = 0.0f;
  }
  grid.sync();
  // r0 = lap x - rhs on the interior, p0 = scale r0, <r0, r0>
  float acc = 0.0f;
  for (long long m = first; m < n_in; m += stride) {
    const long long c = interior_point(m);
    const float rv = lap(x, c) - rhs[c];
    r[c] = rv;
    p[c] = scale * rv;
    acc += rv * rv;
  }
  float s = block_sum<kThreads>(acc, tid);
  if (tid == 0) part_rr[blockIdx.x] = s;
  grid.sync();
  const float rr0 = fold<kThreads>(part_rr, nblk, tid);
  const float init_res = sqrtf(rr0);
  const float t = tolerance * init_res;
  const float tol = (t > abs_tol || t != t) ? t : abs_tol;  // NaN kept
  const bool already = init_res < abs_tol;
  float rho = scale * rr0, res = init_res;
  int it = 0;
  bool running = !already;

  while (running && it < max_iter) {
    // Ap = -lap p on the interior, <p, Ap>
    acc = 0.0f;
    for (long long m = first; m < n_in; m += stride) {
      const long long c = interior_point(m);
      const float a = -lap(p, c);
      ap[c] = a;
      acc += p[c] * a;
    }
    s = block_sum<kThreads>(acc, tid);
    if (tid == 0) part_pap[blockIdx.x] = s;
    grid.sync();
    const float pap = fold<kThreads>(part_pap, nblk, tid);
    const bool bd1 = fabsf(pap) < kBreakdown;
    const float alpha = rho / (bd1 ? 1.0f : pap);
    // x += alpha p, r -= alpha Ap (held on breakdown), <r, r>
    acc = 0.0f;
    for (long long m = first; m < n_in; m += stride) {
      const long long c = interior_point(m);
      if (!bd1) {
        x[c] = x[c] + alpha * p[c];
        r[c] = r[c] - alpha * ap[c];
      }
      const float rv = r[c];
      acc += rv * rv;
    }
    s = block_sum<kThreads>(acc, tid);
    if (tid == 0) part_rr[blockIdx.x] = s;
    grid.sync();
    const float rr = fold<kThreads>(part_rr, nblk, tid);
    const float rho_new = scale * rr, res_new = sqrtf(rr);
    const bool conv =
        (it % ci) == 0 && (res_new < tol || res_new < abs_tol);
    const bool bd2 = fabsf(rho) < kBreakdown;
    const float beta = rho_new / (bd2 ? 1.0f : rho);
    const bool stop = conv || bd1 || bd2;
    if (!stop) {
      for (long long m = first; m < n_in; m += stride) {
        const long long c = interior_point(m);
        p[c] = scale * r[c] + beta * p[c];
      }
      grid.sync();
    }
    rho = rho_new;
    ++it;
    if (!bd1) res = res_new;
    running = !stop;
  }

  // the Neumann mirror of the result: shell points read interior ones,
  // whose last writes came before the last barrier
  for (long long c = first; c < n; c += stride) {
    const long long src = mirror(c);
    if (src != c) x[c] = x[src];
  }
  if (blockIdx.x == 0 && tid == 0) {
    stats[0] = init_res;
    stats[1] = already ? init_res : res;
    stats[2] = already ? 0.0f : (float)it;
    stats[3] = running ? 1.0f : 0.0f;
  }
}

// ---- K3c: the whole solve in one cluster ------------------------------------

// vectors of the band (cluster_band.cuh), in the order the plan keeps them
// resident; x not resident lives in x itself, the others in ws's planes
enum { kVecP = 0, kVecR, kVecAp, kVecX, kCgVecs };
// a halo column: the neighbour's edge (r, p), pushed with <r, r>
constexpr int kCgHalo = 2;

// The recurrence of cg_solve_kernel on a 2D plane (nz == 1) in the band
// layout, two dots an iteration.  p is updated at the top of the next
// iteration; the row a band reads beyond its edge is formed there as
// scale r + beta p from the neighbour's edge r and p pushed with the last
// dot (p0 as pushed).  x0 and rhs are read from device memory once.
__global__ void __launch_bounds__(kBandMaxThreads, 1) cg_solve_cluster_kernel(
    const float* __restrict__ x0, const float* __restrict__ rhs, float* x,
    float* ws, float* stats, int ny, int nx, float inv_dx2, float inv_dy2,
    float scale, float tolerance, float abs_tol, int max_iter, int ci,
    int rmax, int resident) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  const Band b(ny, nx, rmax);
  const BandSmem sm(band_smem, kCgHalo, nx);
  const long long plane = (long long)ny * nx;
  float* p = band_vec(kVecP, resident, sm, b, ws);
  float* r = band_vec(kVecR, resident, sm, b, ws + plane);
  float* ap = band_vec(kVecAp, resident, sm, b, ws + 2 * plane);
  float* xv = band_vec(kVecX, resident, sm, b, x);
  BandDots dots;
  band_init(sm);
  const BandLinks links(sm, b);
  const int halo = halo_bytes(b, 4 * kCgHalo);
  // an edge point's (r, p) to the neighbour across that edge
  auto push_edges = [&](int jl, int i, float rv, float pv) {
    if (jl == 0 && b.has_up())
      band_push2(links.dst(1, i, 0), rv, pv, links.bar[1][dots.slot()]);
    if (jl == b.rows - 1 && b.has_down())
      band_push2(links.dst(0, i, 0), rv, pv, links.bar[0][dots.slot()]);
  };

  // x = x0 on the interior, r0 = lap(mirror x0) - rhs, p0 = scale r0 (its
  // shell columns 0), <r0, r0>
  auto x0m = [&](int j, int i) {
    return x0[(long long)band_clamp(j, ny) * nx + band_clamp(i, nx)];
  };
  float acc = 0.0f;
  band_points(b, [&](int jl, int i, int c) {
    const int j = b.first + jl;
    const float xc = x0[(long long)j * nx + i];
    const float c2 = 2.0f * xc;
    const float l = ((x0m(j, i + 1) - c2) + x0m(j, i - 1)) * inv_dx2 +
                    ((x0m(j + 1, i) - c2) + x0m(j - 1, i)) * inv_dy2;
    const float rv = l - rhs[(long long)j * nx + i];
    const float pv = scale * rv;
    xv[c] = xc;
    r[c] = rv;
    p[c] = pv;
    acc += rv * rv;
    push_edges(jl, i, rv, pv);
  });
  band_zero_shell(p, b);
  float dot[1] = {acc};
  cluster_sum<float, 1>(dot, sm, b, dots, halo);
  const float rr0 = dot[0];
  const float init_res = sqrtf(rr0);
  const float t = tolerance * init_res;
  const float tol = (t > abs_tol || t != t) ? t : abs_tol;  // NaN kept
  const bool already = init_res < abs_tol;
  float rho = scale * rr0, res = init_res, beta = 0.0f;
  int it = 0, ci_phase = 0;  // ci_phase: it % ci, without a divide
  bool running = !already;

  while (running && it < max_iter) {
    // p = scale r + beta p (the last iteration's beta)
    if (it > 0)
      band_points(b, [&](int, int, int c) {
        p[c] = scale * r[c] + beta * p[c];
      });
    __syncthreads();
    // Ap = -lap p, <p, Ap>; the neighbour's edge p formed as it forms its
    // own from the pushed (r, p) (p0 as pushed)
    auto edge = [&](int side, int i) {
      const float* h = sm.halo_at(side, i, nx, 0);
      return it == 0 ? h[1] : scale * h[0] + beta * h[1];
    };
    acc = 0.0f;
    band_points(b, [&](int jl, int i, int c) {
      const float up = jl == 0 && b.has_up() ? edge(0, i) : 0.0f;
      const float dn = jl == b.rows - 1 && b.has_down() ? edge(1, i) : 0.0f;
      const float a =
          -band_lap(p, jl, c, b.rows, nx, up, dn, inv_dx2, inv_dy2);
      ap[c] = a;
      acc += p[c] * a;
    });
    dot[0] = acc;
    cluster_sum<float, 1>(dot, sm, b, dots, 0);
    const float pap = dot[0];
    const bool bd1 = fabsf(pap) < kBreakdown;
    const float alpha = rho / (bd1 ? 1.0f : pap);
    // x += alpha p, r -= alpha Ap (held on breakdown), <r, r>; the edge
    // (r, p) to the neighbours
    acc = 0.0f;
    band_points(b, [&](int jl, int i, int c) {
      const float pv = p[c];
      float rv = r[c];
      if (!bd1) {
        xv[c] = xv[c] + alpha * pv;
        rv = rv - alpha * ap[c];
        r[c] = rv;
      }
      acc += rv * rv;
      push_edges(jl, i, rv, pv);
    });
    dot[0] = acc;
    cluster_sum<float, 1>(dot, sm, b, dots, halo);
    const float rr = dot[0];
    const float rho_new = scale * rr, res_new = sqrtf(rr);
    const bool conv =
        ci_phase == 0 && (res_new < tol || res_new < abs_tol);
    const bool bd2 = fabsf(rho) < kBreakdown;
    beta = rho_new / (bd2 ? 1.0f : rho);
    rho = rho_new;
    ++it;
    if (++ci_phase == ci) ci_phase = 0;
    if (!bd1) res = res_new;
    running = !(conv || bd1 || bd2);
  }

  // the Neumann mirror of the result into x (every x write came before the
  // last dot); no CTA leaves while a push to it may be in flight
  band_mirror_out(xv, !((resident >> kVecX) & 1), b, x);
  cooperative_groups::this_cluster().sync();
  if (b.q == 0 && threadIdx.x == 0) {
    stats[0] = init_res;
    stats[1] = already ? init_res : res;
    stats[2] = already ? 0.0f : (float)it;
    stats[3] = running ? 1.0f : 0.0f;
  }
}

// ---- the barrier probe -------------------------------------------------------

// iters barriers in a row; block 0's thread 0 reads the SM clock and
// %globaltimer around them: out[0] cycles, out[1] nanoseconds.  kKind 0:
// grid.sync() of a cooperative grid; 1: cluster.sync() of one cluster;
// 2: a one-value dot of cluster_band.cuh (a cluster's partials pushed to
// every rank, each rank's mbarrier wait, the rank-order sum).
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int kKind>
__global__ void barrier_probe_kernel(int iters, long long* out) {
  namespace cgs = cooperative_groups;
  extern __shared__ __align__(16) unsigned char band_smem[];
  if constexpr (kKind == 0) {
    cgs::this_grid().sync();
  } else {
    const Band b(cgs::this_cluster().num_blocks() + 2, 3, 1);
    const BandSmem sm(band_smem, 0, 3);
    BandDots dots;
    band_init(sm);
    (void)b;
    (void)dots;
  }
  const long long c0 = clock64();
  const unsigned long long n0 = global_ns();
  if constexpr (kKind == 2) {
    const Band b(cgs::this_cluster().num_blocks() + 2, 3, 1);
    const BandSmem sm(band_smem, 0, 3);
    BandDots dots;
    float v[1] = {0.0f};
    for (int k = 0; k < iters; ++k) {
      v[0] = 1.0f;
      cluster_sum<float, 1>(v, sm, b, dots, 0);
    }
    if (v[0] != (float)(b.cs * (int)blockDim.x)) out[2] = 1;
  } else {
    for (int k = 0; k < iters; ++k) {
      if constexpr (kKind == 0)
        cgs::this_grid().sync();
      else
        cgs::this_cluster().sync();
    }
  }
  const long long c1 = clock64();
  const unsigned long long n1 = global_ns();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = (long long)(n1 - n0);
  }
  if constexpr (kKind != 0) cgs::this_cluster().sync();
}

dim3 tile_grid(int nz, int ny, int nx) {
  return dim3((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY, nz);
}

}  // namespace

extern "C" {

long long cfd_cg_partials(int nz, int ny, int nx) {
  const dim3 g = tile_grid(nz, ny, nx);
  return (long long)g.x * g.y * g.z;
}

int cfd_cg_lap_dot(const float* r, const float* p, float* pn, float* ap,
                   float* st, float* part, int nz, int ny, int nx,
                   float inv_dx2, float inv_dy2, float inv_dz2, float scale,
                   cudaStream_t stream) {
  cg_lap_dot_kernel<false><<<tile_grid(nz, ny, nx), dim3(kTileX, kTileY),
                             0, stream>>>(r, p, pn, ap, st, part, nz, ny, nx,
                                          inv_dx2, inv_dy2, inv_dz2, scale,
                                          0, nz);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cg_lap_dot_finalize<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_cg_partials(nz, ny, nx), st);
  return (int)cudaGetLastError();
}

int cfd_cg_update(float* x, float* r, const float* pn, const float* ap,
                  float* st, float* part, int nz, int ny, int nx, float scale,
                  int ci, cudaStream_t stream) {
  cg_update_kernel<false><<<tile_grid(nz, ny, nx), dim3(kTileX, kTileY), 0,
                            stream>>>(x, r, pn, ap, st, part, nz, ny, nx, 0,
                                      nz);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cg_update_finalize<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_cg_partials(nz, ny, nx), st, scale, ci);
  return (int)cudaGetLastError();
}

// The sharded passes (make_lap_dot_sharded and the owned-block update):
// the pass, then the shard's fold of its partials into out[0].  K1 takes
// the (nzl + 2)-plane halo-padded block (nz = nzl + 2) and launches over
// its nzl owned planes; K2 the nzl-plane owned block.  z_base is the
// global plane of the block's plane 0, nz_g the global plane count.
int cfd_cg_lap_dot_sharded(const float* r, const float* p, float* pn,
                           float* ap, float* st, float* part, float* out,
                           int nz, int ny, int nx, float inv_dx2,
                           float inv_dy2, float inv_dz2, float scale,
                           int z_base, int nz_g, cudaStream_t stream) {
  cg_lap_dot_kernel<true><<<tile_grid(nz - 2, ny, nx), dim3(kTileX, kTileY),
                            0, stream>>>(r, p, pn, ap, st, part, nz, ny, nx,
                                         inv_dx2, inv_dy2, inv_dz2, scale,
                                         z_base, nz_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cg_fold_kernel<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_cg_partials(nz - 2, ny, nx), st, out);
  return (int)cudaGetLastError();
}

int cfd_cg_update_sharded(float* x, float* r, const float* pn,
                          const float* ap, float* st, float* part, float* out,
                          int nz, int ny, int nx, int z_base, int nz_g,
                          cudaStream_t stream) {
  cg_update_kernel<true><<<tile_grid(nz, ny, nx), dim3(kTileX, kTileY), 0,
                           stream>>>(x, r, pn, ap, st, part, nz, ny, nx,
                                     z_base, nz_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cg_fold_kernel<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_cg_partials(nz, ny, nx), st, out);
  return (int)cudaGetLastError();
}

// The (z, y) passes, K1r and K2r: every buffer the shard's block padded
// one plane and one row a side (nz, ny its padded counts), the launch
// over its owned points, then the fold; z_base, y_base the global plane
// and row of the block's (0, 0), nz_g, ny_g the global counts.
int cfd_cg_lap_dot_rows(const float* r, const float* p, float* pn, float* ap,
                        float* st, float* part, float* out, int nz, int ny,
                        int nx, float inv_dx2, float inv_dy2, float inv_dz2,
                        float scale, int z_base, int nz_g, int y_base,
                        int ny_g, cudaStream_t stream) {
  cg_lap_dot_kernel<true, true><<<tile_grid(nz - 2, ny - 2, nx),
                                  dim3(kTileX, kTileY), 0, stream>>>(
      r, p, pn, ap, st, part, nz, ny, nx, inv_dx2, inv_dy2, inv_dz2, scale,
      z_base, nz_g, y_base, ny_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cg_fold_kernel<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_cg_partials(nz - 2, ny - 2, nx), st, out);
  return (int)cudaGetLastError();
}

int cfd_cg_update_rows(float* x, float* r, const float* pn, const float* ap,
                       float* st, float* part, float* out, int nz, int ny,
                       int nx, int z_base, int nz_g, int y_base, int ny_g,
                       cudaStream_t stream) {
  cg_update_kernel<true, true><<<tile_grid(nz - 2, ny - 2, nx),
                                 dim3(kTileX, kTileY), 0, stream>>>(
      x, r, pn, ap, st, part, nz, ny, nx, z_base, nz_g, y_base, ny_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cg_fold_kernel<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_cg_partials(nz - 2, ny - 2, nx), st, out);
  return (int)cudaGetLastError();
}

// The recurrences on the shards' summed dots (comm.sum of the folds).
int cfd_cg_lap_dot_recur(const float* sum, float* st, cudaStream_t stream) {
  cg_lap_dot_recur_kernel<<<1, 32, 0, stream>>>(sum, st);
  return (int)cudaGetLastError();
}

int cfd_cg_update_recur(const float* sum, float* st, float scale, int ci,
                        cudaStream_t stream) {
  cg_update_recur_kernel<<<1, 32, 0, stream>>>(sum, st, scale, ci);
  return (int)cudaGetLastError();
}

// K3's grid: as many blocks as fit on the card at once (a cooperative
// launch needs every block resident), and no more than the points need.
long long cfd_cg_solve_blocks(int nz, int ny, int nx) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cg_solve_kernel,
                                                  kThreads, 0);
    resident = sms * per_sm;
  }
  const long long want =
      ((long long)nz * ny * nx + kThreads - 1) / kThreads;
  return want < resident ? want : resident;
}

int cfd_cg_solve(const float* x0, const float* rhs, float* x, float* r,
                 float* p, float* ap, float* part, float* stats, int nz,
                 int ny, int nx, float inv_dx2, float inv_dy2, float inv_dz2,
                 float scale, float tolerance, float abs_tol, int max_iter,
                 int ci, cudaStream_t stream) {
  const long long nblk = cfd_cg_solve_blocks(nz, ny, nx);
  if (nblk < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&x0,      &rhs,     &x,       &r,     &p,         &ap,
                  &part,    &stats,   &nz,      &ny,    &nx,        &inv_dx2,
                  &inv_dy2, &inv_dz2, &scale,   &tolerance, &abs_tol,
                  &max_iter, &ci};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)cg_solve_kernel, dim3((unsigned int)nblk), dim3(kThreads),
      args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K3c: the plan's cluster (cs CTAs of `threads`), rmax rows a resident
// vector, `resident` the bit mask of the vectors kept in shared memory
// (kVecP, kVecR, kVecAp, kVecX); ws holds the planes of p, r and Ap for
// the ones that are not (x not resident is x itself).
int cfd_cg_solve_cluster(const float* x0, const float* rhs, float* x,
                         float* ws, float* stats, int ny, int nx,
                         float inv_dx2, float inv_dy2, float scale,
                         float tolerance, float abs_tol, int max_iter, int ci,
                         int cs, int threads, int rmax, int resident,
                         cudaStream_t stream) {
  const int my = ny - 2;
  if (ny < 3 || nx < 3 || cs < 1 || cs > my || rmax < (my + cs - 1) / cs ||
      resident < 0 || resident >= (1 << kCgVecs))
    return (int)cudaErrorInvalidValue;
  const long long smem =
      band_smem_bytes(kCgHalo, __builtin_popcount(resident), rmax, nx);
  return band_launch(cg_solve_cluster_kernel, cs, threads, smem, stream, x0,
                     rhs, x, ws, stats, ny, nx, inv_dx2, inv_dy2, scale,
                     tolerance, abs_tol, max_iter, ci, rmax, resident);
}

// The barrier floor: `iters` barriers of `blocks` CTAs of `threads` each
// (kind 0: grid.sync() of a cooperative grid; 1: cluster.sync() and 2:
// cluster_band.cuh's dot, of one cluster); out[0] SM cycles, out[1]
// nanoseconds of block 0 over them, out[2] 1 if a dot summed wrong.
int cfd_barrier_probe(int kind, int blocks, int threads, int iters,
                      long long* out, cudaStream_t stream) {
  if (kind == 1)
    return band_launch(barrier_probe_kernel<1>, blocks, threads,
                       kBandHeader, stream, iters, out);
  if (kind == 2)
    return band_launch(barrier_probe_kernel<2>, blocks, threads,
                       kBandHeader, stream, iters, out);
  if (kind != 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&iters, &out};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)barrier_probe_kernel<0>, dim3((unsigned)blocks),
      dim3((unsigned)threads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
