// Fixed-order sums inside a block, shared by the kernels that fold dots
// without float atomics (cg_kernels.cu, mg_solve.cu, bicgstab_kernels.cu,
// rbsor_kernels.cu): the same partials folded in the same order give the
// same sum on every run and in every block that folds them.  The NaN-
// keeping maxima fold the stationary solves' infinity-norm residuals.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0 holds the sum
}

// Sum of one value per thread over a block of kN threads, in a fixed
// order (a shuffle tree per warp, then one over the warp sums); every
// thread gets the result.
template <int kN>
__device__ float block_sum(float v, int tid) {
  __shared__ float warps[kN / 32];
  __shared__ float total;
  v = warp_sum(v);
  if ((tid & 31) == 0) warps[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    const float w = warp_sum(tid < kN / 32 ? warps[tid] : 0.0f);
    if (tid == 0) total = w;
  }
  __syncthreads();
  const float out = total;
  __syncthreads();  // the slots may be reused by the next call
  return out;
}

// Fixed-order sum of n partials by one block of kN threads.
template <int kN>
__device__ float fold(const float* part, long long n, int tid) {
  float acc = 0.0f;
  for (long long b = tid; b < n; b += kN) acc += part[b];
  return block_sum<kN>(acc, tid);
}

// The same sums in float64, for the BiCGSTAB dots (bicgstab_kernels.cu):
// each product of two floats is exact in a double, and the sum is rounded
// to float once.
__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int kN>
__device__ double block_sum_d(double v, int tid) {
  __shared__ double warps[kN / 32];
  __shared__ double total;
  v = warp_sum_d(v);
  if ((tid & 31) == 0) warps[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    const double w = warp_sum_d(tid < kN / 32 ? warps[tid] : 0.0);
    if (tid == 0) total = w;
  }
  __syncthreads();
  const double out = total;
  __syncthreads();
  return out;
}

template <int kN>
__device__ double fold_d(const double* part, long long n, int tid) {
  double acc = 0.0;
  for (long long b = tid; b < n; b += kN) acc += part[b];
  return block_sum_d<kN>(acc, tid);
}

// The larger of a and b, NaN if either is NaN (jnp.max and torch.amax
// propagate NaN; fmaxf drops it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_nan_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;  // lane 0 holds the maximum
}

// NaN-keeping maximum of one value per thread over a block of kN threads;
// every thread gets the result.  Max is exact, so the order only matters
// for which NaN comes out.
template <int kN>
__device__ float block_nan_max(float v, int tid) {
  __shared__ float warps[kN / 32];
  __shared__ float total;
  v = warp_nan_max(v);
  if ((tid & 31) == 0) warps[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    const float w = warp_nan_max(tid < kN / 32 ? warps[tid] : 0.0f);
    if (tid == 0) total = w;
  }
  __syncthreads();
  const float out = total;
  __syncthreads();
  return out;
}

// NaN-keeping maximum of n non-negative partials by one block of kN
// threads.
template <int kN>
__device__ float fold_nan_max(const float* part, long long n, int tid) {
  float acc = 0.0f;
  for (long long b = tid; b < n; b += kN) acc = nan_max(acc, part[b]);
  return block_nan_max<kN>(acc, tid);
}

}  // namespace
