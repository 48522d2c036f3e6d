// Fixed-order sums inside a block, shared by the kernels that fold dots
// without float atomics (cg_kernels.cu, mg_solve.cu): the same partials
// folded in the same order give the same sum on every run and in every
// block that folds them.
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

}  // namespace
