// The whole 2D multigrid solve in one cooperative launch, on Hopper.
//
// It replaces the TPU kernel make_mg_vmem_solve
// (cfd_tpu/ops/pallas/vmem_mg.py:114, through vmem_small._make_call :136):
// the outer convergence loop, every level's red-black Gauss-Seidel sweeps,
// the residuals, full-weighting restriction, bilinear prolongation and the
// coarsest level's 40 sweeps, all in one kernel.  The algorithm is
// make_multigrid's 2D body (cfd_tpu/solvers/poisson/multigrid.py:332-346),
// the correction form:
//
//   x = mirror(x0);  B = -(rhs - lap x) on the interior;  E = 0
//   repeat: b0 = B - A E;  E += V(b0);  res = |B - A E|  (A = -lap)
//   until res < max(tol |B|, abs_tol) on a check iteration (it % ci == 0)
//   x = mirror(x + E)
//
// V is the non-symmetric V-cycle from zero: pre red-first sweeps, the
// residual, restriction, the coarser cycle, prolongation added, post
// sweeps; 40 sweeps at the coarsest level.
//
// What bounds it on an H100, and what the design does:
//
// * A 129^2 hierarchy is under 1 MB: the passes are L2-resident and the
//   solve is bound by latency, the grid barriers between passes (2 per
//   sweep on the levels the whole grid runs: 26 a V-cycle at 129^2) and
//   the dependent loads.  The level arrays live in one device buffer
//   (offsets in Levels).
// * One cooperative launch, the grid sized by the occupancy API and capped
//   by the fine level's points; grid-stride loops; grid.sync() between
//   passes.  The coarse levels (at most kOneBlockPoints points) would
//   leave almost every block idle and pay a grid barrier per colour, so
//   block 0 runs them alone with __syncthreads() between passes, framed
//   by one grid barrier on the way down and one on the way up.
// * Restriction and prolongation are the strided stencils of the jnp
//   _fw_axis / _interp_axis, computed per coarse (per fine) point in the
//   separable order (y, then x), not the TPU's weight matrices (an MXU
//   workaround).
// * The residual norm is a per-block partial, a grid barrier, then every
//   block folds all partials in one order: no float atomics, every block
//   takes the same branch, and the iteration count does not change from
//   run to run.
// * Built with -fmad=false in the plain version's operation order; the
//   norm is summed in another order than torch.sum, so counts may differ
//   from the plain version by one V-cycle at the margin.
//
// Every entry point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "block_reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 12;          // multigrid._build_levels' cap
constexpr int kCoarseSweeps = 40;       // mg_kernels.COARSE_SWEEPS
constexpr int kOneBlockPoints = 4096;   // levels block 0 runs alone

// The hierarchy: level l is (ny[l], nx[l]); its iterate, right-hand side
// and residual at work + x[l], b[l], r[l]; the fine B and E at big_b,
// big_e.
struct Levels {
  int n;
  int one_block_from;  // first level run by block 0 alone (n: none)
  int ny[kMaxLevels], nx[kMaxLevels];
  float inv_dx2[kMaxLevels], inv_dy2[kMaxLevels], inv_factor[kMaxLevels];
  long long x[kMaxLevels], b[kMaxLevels], r[kMaxLevels];
  long long big_b, big_e;
};

// Who runs a pass: the whole grid (grid-stride) or block 0 alone.
struct Team {
  long long first, stride;
  bool grid;
};

__device__ __forceinline__ void team_sync(cg::grid_group& g, const Team& t) {
  if (t.grid)
    g.sync();
  else
    __syncthreads();
}

__device__ __forceinline__ float lap2d(const float* f, long long c, int nx,
                                       float inv_dx2, float inv_dy2) {
  const float c2 = 2.0f * f[c];
  return ((f[c + 1] - c2) + f[c - 1]) * inv_dx2 +
         ((f[c + nx] - c2) + f[c - nx]) * inv_dy2;
}

// One colour of a sweep at level l: (i + j) % 2 == parity, interior.
__device__ void color_pass(float* w, const Levels& L, int l, int parity,
                           const Team& t) {
  float* x = w + L.x[l];
  const float* b = w + L.b[l];
  const int ny = L.ny[l], nx = L.nx[l], half = (nx + 1) / 2;
  const float idx2 = L.inv_dx2[l], idy2 = L.inv_dy2[l];
  const float inv_factor = L.inv_factor[l];
  const long long n = (long long)(ny - 2) * half;
  for (long long m = t.first; m < n; m += t.stride) {
    const int row = (int)(m / half);
    const int j = 1 + row;
    const int i = 2 * (int)(m - (long long)row * half) + ((parity + j) & 1);
    if (i < 1 || i > nx - 2) continue;
    const long long c = (long long)j * nx + i;
    const float nb =
        (x[c + 1] + x[c - 1]) * idx2 + (x[c + nx] + x[c - nx]) * idy2;
    x[c] = (b[c] + nb) * inv_factor;
  }
}

__device__ void sweeps(cg::grid_group& g, float* w, const Levels& L, int l,
                       int count, const Team& t) {
  for (int s = 0; s < count; ++s) {
    color_pass(w, L, l, 0, t);
    team_sync(g, t);
    color_pass(w, L, l, 1, t);
    team_sync(g, t);
  }
}

// r = b + lap x (b - A x) on level l's interior.
__device__ void residual_pass(float* w, const Levels& L, int l,
                              const Team& t) {
  const float* x = w + L.x[l];
  const float* b = w + L.b[l];
  float* r = w + L.r[l];
  const int ny = L.ny[l], nx = L.nx[l], mx = nx - 2;
  const long long n = (long long)(ny - 2) * mx;
  for (long long m = t.first; m < n; m += t.stride) {
    const int row = (int)(m / mx);
    const long long c = (long long)(1 + row) * nx + 1 + (m - (long long)row * mx);
    r[c] = b[c] + lap2d(x, c, nx, L.inv_dx2[l], L.inv_dy2[l]);
  }
}

// b[l+1] = full weighting of r[l] (y, then x) on the coarse interior, 0 on
// its shell; x[l+1] = 0 everywhere (the coarser cycle starts from zero).
__device__ void restrict_pass(float* w, const Levels& L, int l,
                              const Team& t) {
  const float* rf = w + L.r[l];
  float* bc = w + L.b[l + 1];
  float* xc = w + L.x[l + 1];
  const int nxf = L.nx[l], nyc = L.ny[l + 1], nxc = L.nx[l + 1];
  const long long n = (long long)nyc * nxc;
  for (long long m = t.first; m < n; m += t.stride) {
    const int J = (int)(m / nxc);
    const int I = (int)(m - (long long)J * nxc);
    xc[m] = 0.0f;
    if (J < 1 || J > nyc - 2 || I < 1 || I > nxc - 2) {
      bc[m] = 0.0f;
      continue;
    }
    const float* r0 = rf + (long long)(2 * J - 1) * nxf;
    const float* r1 = r0 + nxf;
    const float* r2 = r1 + nxf;
    float tcol[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int i = 2 * I - 1 + q;
      tcol[q] = (0.25f * r0[i] + 0.5f * r1[i]) + 0.25f * r2[i];
    }
    bc[m] = (0.25f * tcol[0] + 0.5f * tcol[1]) + 0.25f * tcol[2];
  }
}

// x[l] += bilinear interpolation of x[l+1] (y, then x) on the fine
// interior.
__device__ void prolong_pass(float* w, const Levels& L, int l,
                             const Team& t) {
  float* xf = w + L.x[l];
  const float* xc = w + L.x[l + 1];
  const int ny = L.ny[l], nx = L.nx[l], mx = nx - 2, nxc = L.nx[l + 1];
  const long long n = (long long)(ny - 2) * mx;
  // the y-interpolated coarse value at fine row jj, coarse column I
  auto ty = [&](int jj, int I) {
    if ((jj & 1) == 0) return xc[(long long)(jj / 2) * nxc + I];
    return 0.5f * (xc[(long long)((jj - 1) / 2) * nxc + I] +
                   xc[(long long)((jj + 1) / 2) * nxc + I]);
  };
  for (long long m = t.first; m < n; m += t.stride) {
    const int row = (int)(m / mx);
    const int j = 1 + row, i = 1 + (int)(m - (long long)row * mx);
    const float p = (i & 1) == 0
                        ? ty(j, i / 2)
                        : 0.5f * (ty(j, (i - 1) / 2) + ty(j, (i + 1) / 2));
    const long long c = (long long)j * nx + i;
    xf[c] = xf[c] + p;
  }
}

// Level l on the way down: pre sweeps, residual, restriction.
__device__ void descend(cg::grid_group& g, float* w, const Levels& L, int l,
                        int pre, const Team& t) {
  sweeps(g, w, L, l, pre, t);
  residual_pass(w, L, l, t);
  team_sync(g, t);
  restrict_pass(w, L, l, t);
  team_sync(g, t);
}

// Level l on the way up: prolongation added, post sweeps.
__device__ void ascend(cg::grid_group& g, float* w, const Levels& L, int l,
                       int post, const Team& t) {
  prolong_pass(w, L, l, t);
  team_sync(g, t);
  sweeps(g, w, L, l, post, t);
}

// One V-cycle from zero at level 0 (b[0] set and x[0] zeroed by the
// caller, a grid barrier since).
__device__ void v_cycle(cg::grid_group& g, float* w, const Levels& L,
                        int pre, int post, const Team& grid_team,
                        const Team& block_team) {
  const int n = L.n, s = L.one_block_from;
  const int top = s < n - 1 ? s : n - 1;  // levels 0..top-1 on the grid
  for (int l = 0; l < top; ++l) descend(g, w, L, l, pre, grid_team);
  if (s < n) {
    if (blockIdx.x == 0) {
      for (int l = s; l < n - 1; ++l) descend(g, w, L, l, pre, block_team);
      sweeps(g, w, L, n - 1, kCoarseSweeps, block_team);
      for (int l = n - 2; l >= s; --l) ascend(g, w, L, l, post, block_team);
    }
    g.sync();
  } else {
    sweeps(g, w, L, n - 1, kCoarseSweeps, grid_team);
  }
  for (int l = top - 1; l >= 0; --l) ascend(g, w, L, l, post, grid_team);
}

__global__ void __launch_bounds__(kThreads) mg_solve_kernel(
    const float* __restrict__ x0, const float* __restrict__ rhs, float* x,
    float* w, float* part, float* stats, Levels L, float tolerance,
    float abs_tol, int max_iter, int ci, int pre, int post) {
  cg::grid_group g = cg::this_grid();
  const int tid = threadIdx.x, nblk = gridDim.x;
  const Team grid_team{(long long)blockIdx.x * kThreads + tid,
                       (long long)nblk * kThreads, true};
  const Team block_team{tid, kThreads, false};
  const int ny = L.ny[0], nx = L.nx[0], mx = nx - 2;
  const float idx2 = L.inv_dx2[0], idy2 = L.inv_dy2[0];
  const long long n = (long long)ny * nx, n_in = (long long)(ny - 2) * mx;
  float* B = w + L.big_b;
  float* E = w + L.big_e;
  float* b0 = w + L.b[0];
  float* xl0 = w + L.x[0];

  auto interior_point = [&](long long m) {
    const long long row = m / mx;
    return (1 + row) * nx + 1 + (m - row * mx);
  };
  // the Neumann mirror (x faces, then y; the y faces own the corners)
  auto mirror = [&](long long c) {
    const int j = (int)(c / nx), i = (int)(c - (long long)j * nx);
    const int js = j == 0 ? 1 : (j == ny - 1 ? ny - 2 : j);
    const int is = i == 0 ? 1 : (i == nx - 1 ? nx - 2 : i);
    return (long long)js * nx + is;
  };
  auto norm_of_residual = [&]() {  // |B - A E| over the interior
    float acc = 0.0f;
    for (long long m = grid_team.first; m < n_in; m += grid_team.stride) {
      const long long c = interior_point(m);
      const float rv = B[c] + lap2d(E, c, nx, idx2, idy2);
      acc += rv * rv;
    }
    const float s = block_sum<kThreads>(acc, tid);
    if (tid == 0) part[blockIdx.x] = s;
    g.sync();
    return sqrtf(fold<kThreads>(part, nblk, tid));
  };

  // x = mirror(x0); B and E start at zero
  for (long long c = grid_team.first; c < n; c += grid_team.stride) {
    x[c] = x0[mirror(c)];
    B[c] = 0.0f;
    E[c] = 0.0f;
  }
  g.sync();
  // B = -(rhs - lap x) on the interior, |B|
  float acc = 0.0f;
  for (long long m = grid_team.first; m < n_in; m += grid_team.stride) {
    const long long c = interior_point(m);
    const float bv = -(rhs[c] - lap2d(x, c, nx, idx2, idy2));
    B[c] = bv;
    acc += bv * bv;
  }
  float s = block_sum<kThreads>(acc, tid);
  if (tid == 0) part[blockIdx.x] = s;
  g.sync();
  const float init_res = sqrtf(fold<kThreads>(part, nblk, tid));
  const float tt = tolerance * init_res;
  const float tol = (tt > abs_tol || tt != tt) ? tt : abs_tol;  // NaN kept
  const bool already = init_res < abs_tol;
  float res = init_res;
  int it = 0;
  bool running = !already;

  while (running && it < max_iter) {
    // b0 = B - A E on the interior (0 on the shell), x[0] = 0
    for (long long c = grid_team.first; c < n; c += grid_team.stride) {
      xl0[c] = 0.0f;
      const int j = (int)(c / nx), i = (int)(c - (long long)j * nx);
      b0[c] = (j > 0 && j < ny - 1 && i > 0 && i < nx - 1)
                  ? B[c] + lap2d(E, c, nx, idx2, idy2)
                  : 0.0f;
    }
    g.sync();
    v_cycle(g, w, L, pre, post, grid_team, block_team);
    for (long long m = grid_team.first; m < n_in; m += grid_team.stride) {
      const long long c = interior_point(m);
      E[c] = E[c] + xl0[c];
    }
    g.sync();
    const float res_new = norm_of_residual();
    const bool conv = (it % ci) == 0 && (res_new < tol || res_new < abs_tol);
    ++it;
    res = res_new;
    running = !conv;
  }

  // x = mirror(x + E): the interior first, then the shell reads it
  for (long long m = grid_team.first; m < n_in; m += grid_team.stride) {
    const long long c = interior_point(m);
    x[c] = x[c] + E[c];
  }
  g.sync();
  for (long long c = grid_team.first; c < n; c += grid_team.stride) {
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

}  // namespace

extern "C" {

// The grid: as many blocks as fit on the card at once (a cooperative
// launch needs every block resident), and no more than the fine level's
// points need.
long long cfd_mg_solve_blocks(int nz, int ny, int nx) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mg_solve_kernel,
                                                  kThreads, 0);
    resident = sms * per_sm;
  }
  const long long want =
      ((long long)nz * ny * nx + kThreads - 1) / kThreads;
  return want < resident ? want : resident;
}

// dims: (ny, nx) per level; coefs: (inv_dx2, inv_dy2, inv_factor) per
// level (host arrays).  work holds B, E (fine), then x, b, r of each level:
// 2 n0 + 3 sum(n_l) floats; part holds cfd_mg_solve_blocks(1, ny0, nx0).
int cfd_mg_solve(const float* x0, const float* rhs, float* x, float* work,
                 float* part, float* stats, int n_levels, const int* dims,
                 const float* coefs, float tolerance, float abs_tol,
                 int max_iter, int ci, int pre, int post,
                 cudaStream_t stream) {
  if (n_levels < 2 || n_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  Levels L;
  L.n = n_levels;
  L.one_block_from = n_levels;
  long long off = 0;
  const long long n0 = (long long)dims[0] * dims[1];
  L.big_b = off;
  off += n0;
  L.big_e = off;
  off += n0;
  for (int l = 0; l < n_levels; ++l) {
    L.ny[l] = dims[2 * l];
    L.nx[l] = dims[2 * l + 1];
    L.inv_dx2[l] = coefs[3 * l];
    L.inv_dy2[l] = coefs[3 * l + 1];
    L.inv_factor[l] = coefs[3 * l + 2];
    const long long nl = (long long)L.ny[l] * L.nx[l];
    L.x[l] = off;
    L.b[l] = off + nl;
    L.r[l] = off + 2 * nl;
    off += 3 * nl;
    if (l > 0 && nl <= kOneBlockPoints && L.one_block_from == n_levels)
      L.one_block_from = l;
  }
  const long long nblk = cfd_mg_solve_blocks(1, dims[0], dims[1]);
  if (nblk < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&x0,      &rhs,      &x,   &work, &part, &stats, &L,
                  &tolerance, &abs_tol, &max_iter, &ci, &pre, &post};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)mg_solve_kernel, dim3((unsigned int)nblk), dim3(kThreads),
      args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
