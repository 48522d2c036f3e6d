// Shared pieces of the explicit integrators' CUDA kernels
// (euler_kernels.cu, rk_kernels.cu): the reference's clamp limits, clamps
// and min/max written as selects that keep NaN (jnp.clip, jnp.maximum and
// jnp.minimum propagate it; fminf/fmaxf would drop it), the launch
// geometry, the second pass of the four step maxima, and the energy
// equation with its thermal faces and the Boussinesq sources.
//
// On a stretched grid a spacing template parameter selects the derivative
// provider (the reference's stretch pins, ops/pallas/stretch.py, here
// per-axis weight rows, ops/kernels/stretch.py): kUniform the scalar
// coefficients, kParity per-point 1/(2h) and 1/h^2 from x rows [1/(2dx),
// 1/dx^2] and y rows (forward spacing, padded by its last entry), and
// kConsistent the exact 3-point nonuniform weights from rows [wm, wc, wp,
// lm, lc, lp] (euler_kernels.py:149-197 of the reference).  A warp's x
// weights are one coalesced load, its y weights one broadcast.
//
// Every kernel runs one thread per grid point in 32x8 blocks, one block row
// of planes per blockIdx.z, and writes per-block maxima of
// (|u|^2, p, |p|, T) into partials[4 * block + q]; reduce_max4_kernel folds
// them into out[0..3].

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Internal linkage: both kernel sources include this header.
namespace {

// Stability limits (solver_explicit_euler.c:24-55).
constexpr float kD1 = 100.0f;     // first derivatives
constexpr float kD2 = 1000.0f;    // second-derivative terms
constexpr float kVel = 100.0f;    // velocities
constexpr float kDiv = 10.0f;     // divergence
constexpr float kUpdate = 1.0f;   // Euler increments, pressure coupling
constexpr float kRhoMin = 1e-10f;

constexpr int kTileX = 32, kTileY = 8;     // 256 threads a block
constexpr int kReduceThreads = 1024;

__device__ __forceinline__ float clampv(float x, float lim) {
  return x < -lim ? -lim : (x > lim ? lim : x);
}

__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float min_keep_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// nu = min(mu / max(rho, 1e-10), 1)
__device__ __forceinline__ float viscosity(float mu, float rho) {
  return min_keep_nan(mu / max_keep_nan(rho, kRhoMin), 1.0f);
}

// Spacing providers (see the top of this file).
constexpr int kUniform = 0, kParity = 1, kConsistent = 2;

struct Stretch {
  const float* x;  // rows of nx
  const float* y;  // rows of ny
  int nx, ny;
};

// First derivative at index a of an axis from (f[a-1], f[a], f[a+1]):
// (fp - fm) * coef (coef the scalar, or row 0 when parity), or
// (fm wm + fc wc) + fp wp (rows 0-2) when consistent.
template <int kS>
__device__ __forceinline__ float d1_at(float fm, float fc, float fp,
                                       float coef, const float* w, int n,
                                       int a) {
  if (kS == kConsistent) return (fm * w[a] + fc * w[n + a]) + fp * w[2 * n + a];
  return (fp - fm) * (kS == kParity ? w[a] : coef);
}

// Second derivative: ((fp - 2 fc) + fm) * coef (row 1 when parity), or
// (fm lm + fc lc) + fp lp (rows 3-5) when consistent.
template <int kS>
__device__ __forceinline__ float d2_at(float fm, float fc, float fp,
                                       float coef, const float* w, int n,
                                       int a) {
  if (kS == kConsistent)
    return (fm * w[3 * n + a] + fc * w[4 * n + a]) + fp * w[5 * n + a];
  return ((fp - 2.0f * fc) + fm) * (kS == kParity ? w[n + a] : coef);
}

// The periodic wrap's source index on one axis: face 0 reads n - 2, face
// n - 1 reads 1, the interior itself (apply_periodic_scalar, x->y->z: the
// composition of the three face copies is this map on each axis).
__device__ __forceinline__ int wrap_src(int a, int n) {
  return a == 0 ? n - 2 : (a == n - 1 ? 1 : a);
}

// The energy equation and Boussinesq buoyancy (euler_kernels.py:286-351,
// rk_kernels.py:292-344 of the reference).  face[] holds the thermal BC
// of each face in the reference's order (left, right, bottom, top, back,
// front) as BCType values, val[] the Dirichlet values; coef[c] is
// (-beta) * g[c] rounded in float32 on the host.
constexpr int kNeumann = 1, kDirichlet = 2;  // BCType (PERIODIC = 0)

struct Thermal {
  int energy, buoy;
  float alpha, coef[3], tref;
  int face[6];
  float val[6];
};

// One axis of the map from an output point to the point its final T
// comes from: the low face (a == 0) copies n - 2 when periodic (the wrap)
// or 1 when Neumann, the high face 1 or n - 2; an interior index is its
// own source.  A Dirichlet face returns true with its value instead.
__device__ __forceinline__ bool thermal_axis(int a, int n, int lo, int hi,
                                             float vlo, float vhi, int& src,
                                             float& value) {
  if (a == 0) {
    if (lo == kDirichlet) {
      value = vlo;
      return true;
    }
    src = lo == kNeumann ? 1 : n - 2;
  } else if (a == n - 1) {
    if (hi == kDirichlet) {
      value = vhi;
      return true;
    }
    src = hi == kNeumann ? n - 2 : 1;
  } else {
    src = a;
  }
  return false;
}

// Where the final T of output point (k, j, i) comes from: the periodic
// wrap x -> y -> z of the updated T, then the thermal faces in the order
// left, right, bottom, top, back, front (energy_solver.c:246-331, the
// face applied last owning a corner) compose to one source per axis,
// taken z first, then y, then x: true with the value of the Dirichlet
// face that owns the point, else the interior point (kT, jT, iT) whose
// updated T it holds.  A Neumann face reads its neighbour's updated,
// wrapped value, so a face thread evaluates the update at that point.
// kZ / kY false leave that axis's faces out (jT = j): a decomposed
// shard's wrapper applies them (the sharded modes below).
template <bool kZ, bool kY = true>
__device__ __forceinline__ bool thermal_source(const Thermal& th, int k,
                                               int j, int i, int nz, int ny,
                                               int nx, int& kT, int& jT,
                                               int& iT, float& value) {
  kT = k;
  jT = j;
  if (kZ && thermal_axis(k, nz, th.face[4], th.face[5], th.val[4],
                         th.val[5], kT, value))
    return true;
  if (kY && thermal_axis(j, ny, th.face[2], th.face[3], th.val[2],
                         th.val[3], jT, value))
    return true;
  return thermal_axis(i, nx, th.face[0], th.face[1], th.val[0], th.val[1],
                      iT, value);
}

// T + cdt * (-(u T_x + v T_y + w T_z) + alpha lap T) at interior point c
// = (k, j, i) with the updated velocities (uo, vo, wo) there; unclamped,
// in the reference kernels' order (no z terms in 2D): central differences
// on a uniform grid, and on the consistent scheme T_x = (T[i-1] wm +
// T wc) + T[i+1] wp and lap T one chain of the six x/y terms
// (euler_kernels.py:319-326).  Parity on a stretched grid has no energy
// equation (the builder refuses it).
template <bool k3D, int kS>
__device__ __forceinline__ float energy_update(
    const float* __restrict__ T, long long c, long long sy, long long sz,
    int j, int i, float uo, float vo, float wo, float cdt, float alpha,
    float c2x, float c2y, float c2z, float cx2, float cy2, float cz2,
    const Stretch& st) {
  const float tc = T[c];
  const float xm = T[c - 1], xp = T[c + 1];
  const float ym = T[c - sy], yp = T[c + sy];
  const float t2 = 2.0f * tc;
  float lap, adv;
  if (kS == kConsistent) {
    const int nx = st.nx, ny = st.ny;
    const float* wx = st.x;
    const float* wy = st.y;
    const float tx = (xm * wx[i] + tc * wx[nx + i]) + xp * wx[2 * nx + i];
    const float ty = (ym * wy[j] + tc * wy[ny + j]) + yp * wy[2 * ny + j];
    lap = (((((xm * wx[3 * nx + i] + tc * wx[4 * nx + i]) +
              xp * wx[5 * nx + i]) +
             ym * wy[3 * ny + j]) +
            tc * wy[4 * ny + j]) +
           yp * wy[5 * ny + j]);
    adv = uo * tx + vo * ty;
  } else {
    lap = ((xp - t2) + xm) * cx2 + ((yp - t2) + ym) * cy2;
    adv = uo * ((xp - xm) * c2x) + vo * ((yp - ym) * c2y);
  }
  if (k3D) {
    const float zm = T[c - sz], zp = T[c + sz];
    lap = lap + ((zp - t2) + zm) * cz2;
    adv = adv + wo * ((zp - zm) * c2z);
  }
  return tc + cdt * (-adv + alpha * lap);
}

// The host arrays of an entry point: f = alpha, coef[3], T_ref, the six
// Dirichlet values; i = energy, buoyancy, the six face types.
inline Thermal thermal_from(const float* f, const int* i) {
  Thermal th;
  th.energy = i[0];
  th.buoy = i[1];
  th.alpha = f[0];
  for (int q = 0; q < 3; ++q) th.coef[q] = f[1 + q];
  th.tref = f[4];
  for (int q = 0; q < 6; ++q) {
    th.face[q] = i[2 + q];
    th.val[q] = f[5 + q];
  }
  return th;
}

// A decomposed shard's block, the sharded modes' geometry
// (parallel/fused_explicit.py): the input block holds hz planes and hy
// rows of halo a side around the owned (nzl, nyl) window, and the kernel
// runs one thread per owned point, its global plane z_base + k and row
// y_base + j of an nz_g-plane, ny_g-row grid (nz_g 1 in 2D).  The global
// faces the wrapper rewrites from other shards (the z-shell planes; the
// y-face rows in the global-row modes) are passed through, and the step
// maxima skip them: the wrapper folds them in after its fix.
struct Shard {
  int hz, hy;
  int z_base, nz_g;
  int y_base, ny_g;
};

inline dim3 grid_of(int nz, int ny, int nx) {
  return dim3((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY, nz);
}

inline long long blocks_of(int nz, int ny, int nx) {
  const dim3 g = grid_of(nz, ny, nx);
  return (long long)g.x * g.y * g.z;
}

// Block-wide fold of the four maxima; thread 0 writes the block's partials.
__device__ __forceinline__ void block_max4(float m[4],
                                           float* __restrict__ partials) {
  __shared__ float red[4][kTileX * kTileY];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int q = 0; q < 4; ++q) red[q][tid] = m[q];
  __syncthreads();
  for (int half = kTileX * kTileY / 2; half > 0; half >>= 1) {
    if (tid < half) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        red[q][tid] = max_keep_nan(red[q][tid], red[q][tid + half]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    const long long blk =
        ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
        blockIdx.x;
#pragma unroll
    for (int q = 0; q < 4; ++q) partials[4 * blk + q] = red[q][0];
  }
}

// Second pass: one block folds n per-block partials into out[0..3].
__global__ void __launch_bounds__(kReduceThreads) reduce_max4_kernel(
    const float* __restrict__ partials, long long n, float* __restrict__ out) {
  __shared__ float red[4][kReduceThreads];
  const int tid = threadIdx.x;
  float acc[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (long long b = tid; b < n; b += kReduceThreads) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      acc[q] = max_keep_nan(acc[q], partials[4 * b + q]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) red[q][tid] = acc[q];
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (tid < half) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        red[q][tid] = max_keep_nan(red[q][tid], red[q][tid + half]);
    }
    __syncthreads();
  }
  if (tid < 4) out[tid] = red[tid][0];
}

}  // namespace
