// The asynchronous copies of the hand-written GEMMs, shared by
// gemm_tf32.cu (the one-pass TF32 GEMM) and sgemm_fp32.cu (the IEEE fp32
// SGEMM): mbarriers in shared memory, TMA tile loads into a ring of
// stages, 4-byte cp.async copies with zero fill that arrive on an
// mbarrier, and the tensor maps of row-major float32 operands (batches x
// rows x cols, rows `ld` floats apart), encoded by cuTensorMapEncodeTiled
// without linking libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// ---- host side -------------------------------------------------------------

// whether a device pointer is 16-byte aligned (TMA's and LDG.128's
// operands)
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  });
  return fn;
}

// a (batches x rows x cols) row-major float32 operand, rows ld floats
// apart and batches sb apart (sb unused for one batch), in boxes of
// box_rows x box_cols; out of bounds reads zeros
int encode(CUtensorMap* map, const float* base, long long cols,
           long long rows, long long ld, int batches, long long sb,
           uint32_t box_cols, uint32_t box_rows, CUtensorMapSwizzle swz) {
  const EncodeTiled fn = encoder();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols < 1 ? 1 : cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batches)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(ld) * 4,
      static_cast<cuuint64_t>(batches > 1 ? sb : rows * ld) * 4};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<float*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
