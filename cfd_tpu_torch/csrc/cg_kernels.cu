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
//   K3  cg_solve_kernel
//       <- make_cg_vmem_solve (cfd_tpu/ops/pallas/vmem_small.py:243): the
//          whole CG/PCG loop in one cooperative launch.
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

__device__ __forceinline__ long long tile_block() {
  return ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
         blockIdx.x;
}

// ---- K1: p', Ap', <p', Ap'> ----------------------------------------------

__global__ void __launch_bounds__(kThreads) cg_lap_dot_kernel(
    const float* __restrict__ r, const float* __restrict__ p,
    float* __restrict__ pn, float* __restrict__ ap,
    const float* __restrict__ st, float* __restrict__ part, int nz, int ny,
    int nx, float inv_dx2, float inv_dy2, float inv_dz2, float scale) {
  if (st[kRunning] == 0.0f) return;  // uniform: the whole grid returns
  const int i = blockIdx.x * kTileX + threadIdx.x;
  const int j = blockIdx.y * kTileY + threadIdx.y;
  const int k = blockIdx.z;
  float acc = 0.0f;
  if (i < nx && j < ny) {
    const long long sy = nx, sz = (long long)ny * nx;
    const long long c = k * sz + j * sy + i;
    if (inside(k, j, i, nz, ny, nx)) {
      const float beta = st[kBeta];
      // p' at a neighbour: 0 on the shell (the correction space)
      auto pp = [&](long long q, bool in) {
        return in ? scale * r[q] + beta * p[q] : 0.0f;
      };
      const float pc = scale * r[c] + beta * p[c];
      const float xm = pp(c - 1, i > 1), xp = pp(c + 1, i < nx - 2);
      const float ym = pp(c - sy, j > 1), yp = pp(c + sy, j < ny - 2);
      const float zm = pp(c - sz, k > 1), zp = pp(c + sz, k < nz - 2);
      const float c2 = 2.0f * pc;
      const float lap =
          (((xp - c2) + xm) * inv_dx2 + ((yp - c2) + ym) * inv_dy2) +
          ((zp - c2) + zm) * inv_dz2;
      const float a = -lap;
      pn[c] = pc;
      ap[c] = a;
      acc = a * pc;
    } else {
      pn[c] = 0.0f;
      ap[c] = 0.0f;
    }
  }
  const float s = block_sum<kThreads>(acc, threadIdx.y * kTileX + threadIdx.x);
  if (threadIdx.x == 0 && threadIdx.y == 0) part[tile_block()] = s;
}

// <p', Ap'>, breakdown and alpha = rho / <p', Ap'> (0 on breakdown).
__global__ void __launch_bounds__(kFoldThreads) cg_lap_dot_finalize(
    const float* __restrict__ part, long long n, float* __restrict__ st) {
  if (st[kRunning] == 0.0f) return;
  const float pap = fold<kFoldThreads>(part, n, threadIdx.x);
  if (threadIdx.x == 0) {
    const bool bd1 = fabsf(pap) < kBreakdown;
    st[kPAp] = pap;
    st[kBd1] = bd1 ? 1.0f : 0.0f;
    st[kAlpha] = bd1 ? 0.0f : st[kRho] / pap;
  }
}

// ---- K2: x', r', <r', r'> ------------------------------------------------

__global__ void __launch_bounds__(kThreads) cg_update_kernel(
    float* __restrict__ x, float* __restrict__ r,
    const float* __restrict__ pn, const float* __restrict__ ap,
    const float* __restrict__ st, float* __restrict__ part, int nz, int ny,
    int nx) {
  if (st[kRunning] == 0.0f) return;
  const int i = blockIdx.x * kTileX + threadIdx.x;
  const int j = blockIdx.y * kTileY + threadIdx.y;
  const int k = blockIdx.z;
  float acc = 0.0f;
  if (i < nx && j < ny && inside(k, j, i, nz, ny, nx)) {
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
__global__ void __launch_bounds__(kFoldThreads) cg_update_finalize(
    const float* __restrict__ part, long long n, float* __restrict__ st,
    float scale, int ci) {
  if (st[kRunning] == 0.0f) return;
  const float rr = fold<kFoldThreads>(part, n, threadIdx.x);
  if (threadIdx.x == 0) {
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
  cg_lap_dot_kernel<<<tile_grid(nz, ny, nx), dim3(kTileX, kTileY), 0,
                      stream>>>(r, p, pn, ap, st, part, nz, ny, nx, inv_dx2,
                                inv_dy2, inv_dz2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cg_lap_dot_finalize<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_cg_partials(nz, ny, nx), st);
  return (int)cudaGetLastError();
}

int cfd_cg_update(float* x, float* r, const float* pn, const float* ap,
                  float* st, float* part, int nz, int ny, int nx, float scale,
                  int ci, cudaStream_t stream) {
  cg_update_kernel<<<tile_grid(nz, ny, nx), dim3(kTileX, kTileY), 0,
                     stream>>>(x, r, pn, ap, st, part, nz, ny, nx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cg_update_finalize<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_cg_partials(nz, ny, nx), st, scale, ci);
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

}  // extern "C"
