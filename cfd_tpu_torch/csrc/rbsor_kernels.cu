// Hand-written CUDA kernels for the Red-Black SOR and Jacobi pressure
// solves on Hopper.
//
// They replace these TPU kernels:
//
//   S1  rbsor_color_kernel x2 + rbsor_mirror_residual_kernel +
//       rbsor_finalize
//       <- make_rbsor_sweep (cfd_tpu/ops/pallas/rbsor_kernels.py:53, its
//          pallas_call :243): one sweep is the red half ((i+j+k) even),
//          the black half on the red-updated x, the Neumann mirror
//          x -> y -> z, and the interior infinity-norm of lap x - rhs on
//          the mirrored iterate.  At one colour
//            gs = -(rhs - nb) inv_factor,  x = x + omega (gs - x)
//          with nb the weighted neighbour sum (stationary.py:264-269).
//   S2  stationary_solve_kernel<false> (Red-Black SOR) and
//       stationary_solve_kernel<true> (Jacobi)
//       <- make_rbsor_vmem_solve (cfd_tpu/ops/pallas/vmem_small.py:167)
//          and make_jacobi_vmem_solve (:430), one loop with two sweeps:
//          check_interval chunks of min(ci, max_iter - it) sweeps, the
//          infinity-norm residual at the end of each chunk, the stats
//          rules of :226-229 / :487-490.
//
// What bounds them on an H100, and what the design does:
//
// * S1 is a few flops per byte: bound by device-memory bandwidth, 3 fields
//   a sweep (x and rhs in, x out).  The TPU kernel streams z-planes through
//   a VMEM ring, red one plane ahead of black and the residual one more
//   behind.  On Hopper the blocks run in no order, so this first form
//   works by colour, as the multigrid sweep (mg_kernels.cu): one launch a
//   colour, one thread a point of that colour, in place (a colour reads
//   only the other), then a third launch for the mirror and the residual,
//   then a one-block fold.  The mirror is a gather from the clamped index,
//   x[clamp(k), clamp(j), clamp(i)]: shell threads write it with no
//   ordering between them, and interior threads form the residual through
//   the same clamped reads (the TPU kernel's z-shell substitution,
//   rbsor_kernels.py:207-222, on every face).  About 8 fields move a sweep.
// * The sweeps of a solve queue on the host, but the loop state stays on
//   the card (rbsor_kernels.py holds the slot layout): the fold block
//   writes the residual and the count, and drops the running flag at the
//   end of a check_interval chunk that converged; every launch after that
//   returns at once.
// * S2 is for small grids (the reference's published 100^2 solves):
//   latency bounds it.  One cooperative launch sized by the occupancy API,
//   grid-stride loops, grid barriers between passes: red, black and the
//   mirror (3 a Red-Black sweep), or the double-buffered Jacobi sweep and
//   the mirror (2).  The residual is a per-block NaN-keeping maximum, a
//   barrier, then every block folds the partials in one order, so all
//   blocks take the same branch.
// * The maxima fold with nan_max (block_reduce.cuh): jnp.max and
//   torch.amax propagate NaN, fmaxf would drop it.
//
// Built with -fmad=false in the plain versions' operation order, so x and
// the residual match them bit for bit.  Every entry point returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "block_reduce.cuh"
#include "volume.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTileX = 32, kTileY = 8;
constexpr int kThreads = kTileX * kTileY;
constexpr int kFoldThreads = 1024;

// slots of the sweep loop's state vector (rbsor_kernels.py: RES ...)
enum { kRes = 0, kIt, kRunning, kTol, kAbsTol };

__device__ __forceinline__ long long tile_block() {
  return ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
         blockIdx.x;
}

// x + omega (gs - x) with gs = -(rhs - nb) inv_factor
__device__ __forceinline__ float sor_update(float xc, float rhs, float nb,
                                            float inv_factor, float omega) {
  const float gs = -(rhs - nb) * inv_factor;
  return xc + omega * (gs - xc);
}

// ---- S1: one colour, in place ----------------------------------------------

__global__ void __launch_bounds__(kThreads) rbsor_color_kernel(
    float* x, const float* __restrict__ rhs, const float* __restrict__ st,
    int nz, int ny, int nx, float inv_dx2, float inv_dy2, float inv_dz2,
    float inv_factor, float omega, int parity) {
  if (st[kRunning] == 0.0f) return;  // uniform: the whole grid returns
  const bool three_d = nz > 1;
  const int k = blockIdx.z + (three_d ? 1 : 0);
  const int j = blockIdx.y * kTileY + threadIdx.y;
  // every other point of row (j, k): i = 2 q + s, i + j + k = parity mod 2
  const int s = (parity + j + k) & 1;
  const int i = 2 * (blockIdx.x * kTileX + threadIdx.x) + s;
  if (j < 1 || j > ny - 2 || i < 1 || i > nx - 2) return;
  const long long sy = nx, sz = (long long)ny * nx;
  const long long c = k * sz + j * sy + i;
  float nb = (x[c + 1] + x[c - 1]) * inv_dx2 + (x[c + sy] + x[c - sy]) * inv_dy2;
  if (three_d) nb = nb + (x[c + sz] + x[c - sz]) * inv_dz2;
  x[c] = sor_update(x[c], rhs[c], nb, inv_factor, omega);
}

// ---- S1: the mirror and the residual ---------------------------------------

__global__ void __launch_bounds__(kThreads) rbsor_mirror_residual_kernel(
    float* x, const float* __restrict__ rhs, const float* __restrict__ st,
    float* __restrict__ part, int nz, int ny, int nx, float inv_dx2,
    float inv_dy2, float inv_dz2) {
  if (st[kRunning] == 0.0f) return;
  const bool three_d = nz > 1;
  const int i = blockIdx.x * kTileX + threadIdx.x;
  const int j = blockIdx.y * kTileY + threadIdx.y;
  const int k = blockIdx.z;
  float m = 0.0f;
  if (i < nx && j < ny) {
    const long long sy = nx, sz = (long long)ny * nx;
    auto at = [&](int kk, int jj, int ii) {
      return (three_d ? clamp_index(kk, nz) : kk) * sz +
             clamp_index(jj, ny) * sy + clamp_index(ii, nx);
    };
    const long long c = k * sz + j * sy + i;
    const long long src = at(k, j, i);
    if (src != c) {
      x[c] = x[src];  // a shell point: its mirror source is interior
    } else {
      // interior: the residual of the mirrored iterate, every read through
      // the clamp (interior points only, none of which this launch writes)
      const float c2 = 2.0f * x[c];
      float lap = ((x[at(k, j, i + 1)] - c2) + x[at(k, j, i - 1)]) * inv_dx2 +
                  ((x[at(k, j + 1, i)] - c2) + x[at(k, j - 1, i)]) * inv_dy2;
      if (three_d)
        lap = lap + ((x[at(k + 1, j, i)] - c2) + x[at(k - 1, j, i)]) * inv_dz2;
      m = fabsf(lap - rhs[c]);
    }
  }
  m = block_nan_max<kThreads>(m, threadIdx.y * kTileX + threadIdx.x);
  if (threadIdx.x == 0 && threadIdx.y == 0) part[tile_block()] = m;
}

// The residual, the sweep count, and the check at the end of a chunk.
__global__ void __launch_bounds__(kFoldThreads) rbsor_finalize(
    const float* __restrict__ part, long long n, float* __restrict__ st,
    int ci, int max_iter) {
  if (st[kRunning] == 0.0f) return;
  const float res = fold_nan_max<kFoldThreads>(part, n, threadIdx.x);
  if (threadIdx.x == 0) {
    const int it = (int)st[kIt] + 1;
    const bool chunk_end = (it % ci) == 0 || it == max_iter;
    st[kRes] = res;
    st[kIt] = (float)it;
    if (chunk_end && (res < st[kTol] || res < st[kAbsTol]))
      st[kRunning] = 0.0f;
  }
}

// ---- S2: the whole Red-Black SOR or Jacobi solve ----------------------------

template <bool kJacobi>
__global__ void __launch_bounds__(kThreads) stationary_solve_kernel(
    const float* __restrict__ x0, const float* __restrict__ rhs, float* x,
    float* xb, float* part, float* stats, int nz, int ny, int nx,
    float inv_dx2, float inv_dy2, float inv_dz2, float inv_factor,
    float omega, float tolerance, float abs_tol, int max_iter, int ci) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, nblk = gridDim.x;
  const Volume vol(nz, ny, nx);
  const long long stride = (long long)nblk * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + tid;
  float* cur = x;   // the iterate
  float* nxt = xb;  // Jacobi's second buffer
  int group = 0;

  // the infinity norm of lap cur - rhs on the interior: per-block partial,
  // a grid barrier, every block folds (two regions alternate)
  auto residual = [&]() {
    float m = 0.0f;
    for (long long q = first; q < vol.n_in; q += stride) {
      const long long c = vol.interior_point(q);
      m = nan_max(m, fabsf(vol.lap(cur, c, inv_dx2, inv_dy2, inv_dz2) -
                           rhs[c]));
    }
    float* reg = part + (group & 1) * nblk;
    ++group;
    m = block_nan_max<kThreads>(m, tid);
    if (tid == 0) reg[blockIdx.x] = m;
    grid.sync();
    return fold_nan_max<kThreads>(reg, nblk, tid);
  };
  // the Neumann mirror of f: shell points from interior ones
  auto mirror = [&](float* f) {
    for (long long c = first; c < vol.n; c += stride) {
      const long long src = vol.mirror(c);
      if (src != c) f[c] = f[src];
    }
    grid.sync();
  };

  for (long long c = first; c < vol.n; c += stride) x[c] = x0[c];
  grid.sync();
  const float r0 = residual();
  const float tl = tolerance * r0;
  const float tol = (tl > abs_tol || tl != tl) ? tl : abs_tol;  // NaN kept
  const bool already = r0 < abs_tol;
  int it = 0;
  float res = r0;
  bool conv = already;

  while (it < max_iter && !conv) {
    const int n_sweeps = ci < max_iter - it ? ci : max_iter - it;
    for (int q = 0; q < n_sweeps; ++q) {
      if (kJacobi) {
        for (long long m = first; m < vol.n_in; m += stride) {
          const long long c = vol.interior_point(m);
          const float nb =
              vol.neighbour_sum(cur, c, inv_dx2, inv_dy2, inv_dz2);
          nxt[c] = -(rhs[c] - nb) * inv_factor;
        }
        grid.sync();
        mirror(nxt);
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
      } else {
        for (int parity = 0; parity < 2; ++parity) {
          for (long long m = first; m < vol.n_in; m += stride) {
            int k, j, i;
            vol.interior_coords(m, k, j, i);
            if (((i + j + k) & 1) != parity) continue;
            const long long c = vol.at(k, j, i);
            const float nb =
                vol.neighbour_sum(cur, c, inv_dx2, inv_dy2, inv_dz2);
            cur[c] = sor_update(cur[c], rhs[c], nb, inv_factor, omega);
          }
          grid.sync();
        }
        mirror(cur);
      }
    }
    res = residual();
    conv = res < tol || res < abs_tol;
    it += n_sweeps;
  }

  if (cur != x) {  // Jacobi ended in its second buffer
    for (long long c = first; c < vol.n; c += stride) x[c] = cur[c];
  }
  if (blockIdx.x == 0 && tid == 0) {
    stats[0] = r0;
    stats[1] = already ? r0 : res;
    stats[2] = already ? 0.0f : (float)it;
    stats[3] = (conv || already) ? 1.0f : 0.0f;
  }
}

dim3 tile_grid(int nz, int ny, int nx) {
  return dim3((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY, nz);
}

int resident_blocks(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * per_sm;
}

}  // namespace

extern "C" {

long long cfd_rbsor_partials(int nz, int ny, int nx) {
  const dim3 g = tile_grid(nz, ny, nx);
  return (long long)g.x * g.y * g.z;
}

// One sweep: red, black, the mirror and the residual, the fold.
int cfd_rbsor_sweep(float* x, const float* rhs, float* st, float* part,
                    int nz, int ny, int nx, float inv_dx2, float inv_dy2,
                    float inv_dz2, float inv_factor, float omega, int ci,
                    int max_iter, cudaStream_t stream) {
  const int half = (nx + 1) / 2;
  const dim3 block(kTileX, kTileY);
  const dim3 color_grid((half + kTileX - 1) / kTileX,
                        (ny + kTileY - 1) / kTileY, nz > 1 ? nz - 2 : 1);
  for (int parity = 0; parity < 2; ++parity) {
    rbsor_color_kernel<<<color_grid, block, 0, stream>>>(
        x, rhs, st, nz, ny, nx, inv_dx2, inv_dy2, inv_dz2, inv_factor, omega,
        parity);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rbsor_mirror_residual_kernel<<<tile_grid(nz, ny, nx), block, 0, stream>>>(
      x, rhs, st, part, nz, ny, nx, inv_dx2, inv_dy2, inv_dz2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rbsor_finalize<<<1, kFoldThreads, 0, stream>>>(
      part, cfd_rbsor_partials(nz, ny, nx), st, ci, max_iter);
  return (int)cudaGetLastError();
}

// S2's grid: as many blocks as fit on the card at once for both forms (a
// cooperative launch needs every block resident), and no more than the
// points need.
long long cfd_stationary_solve_blocks(int nz, int ny, int nx) {
  static int resident = 0;
  if (resident == 0) {
    const int a = resident_blocks((const void*)stationary_solve_kernel<false>);
    const int b = resident_blocks((const void*)stationary_solve_kernel<true>);
    resident = a < b ? a : b;
  }
  const long long want =
      ((long long)nz * ny * nx + kThreads - 1) / kThreads;
  return want < resident ? want : resident;
}

int cfd_stationary_solve(const float* x0, const float* rhs, float* x,
                         float* xb, float* part, float* stats, int nz,
                         int ny, int nx, float inv_dx2, float inv_dy2,
                         float inv_dz2, float inv_factor, float omega,
                         float tolerance, float abs_tol, int max_iter,
                         int ci, int jacobi, cudaStream_t stream) {
  const long long nblk = cfd_stationary_solve_blocks(nz, ny, nx);
  if (nblk < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&x0,      &rhs,        &x,       &xb,       &part,
                  &stats,   &nz,         &ny,      &nx,       &inv_dx2,
                  &inv_dy2, &inv_dz2,    &inv_factor, &omega, &tolerance,
                  &abs_tol, &max_iter,   &ci};
  const void* kernel = jacobi ? (const void*)stationary_solve_kernel<true>
                              : (const void*)stationary_solve_kernel<false>;
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3((unsigned int)nblk), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
