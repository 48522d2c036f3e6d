// Shared pieces of the explicit integrators' CUDA kernels
// (euler_kernels.cu, rk_kernels.cu): the reference's clamp limits, clamps
// and min/max written as selects that keep NaN (jnp.clip, jnp.maximum and
// jnp.minimum propagate it; fminf/fmaxf would drop it), the launch
// geometry, and the second pass of the four step maxima.
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

// The periodic wrap's source index on one axis: face 0 reads n - 2, face
// n - 1 reads 1, the interior itself (apply_periodic_scalar, x->y->z: the
// composition of the three face copies is this map on each axis).
__device__ __forceinline__ int wrap_src(int a, int n) {
  return a == 0 ? n - 2 : (a == n - 1 ? 1 : a);
}

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
