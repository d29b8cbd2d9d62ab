// TMA copies and mbarriers, shared by the kernels fed by a producer warp:
// the dense split kernel (stiffness3d_dense_split.cu: the congruent 2D and
// 3D operators in the split-bf16 classes) and the congruent FP32 3D kernel
// (stiffness3d_uniform.cu).  One thread asks for a whole box of a field,
// described by a 2D tensor map, to be copied into shared memory; the copy
// reports its bytes to an mbarrier, on which the consumers wait.

#ifndef SWIRLFEM_TMA_CUH_
#define SWIRLFEM_TMA_CUH_

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// After the mbarriers' init, before any thread uses them.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      ::"r"(smem_addr(bar))
      : "memory");
}

// Arrives on `bar` and adds `bytes` to the transfers its phase waits for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
      ::"r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of `bar` of parity `parity` to complete; traps after
// about 2 seconds rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 32)) __trap();
  }
}

// One TMA copy of the box of `map` at (x, y) to shared memory (128-byte
// aligned), counted by `bar`.
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device to shared memory, counted by `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

constexpr int kMaxMaps = 4;

// The tensor maps of up to kMaxMaps fields, one per component, passed to a
// kernel as a __grid_constant__ argument.
struct FieldMaps {
  CUtensorMap m[kMaxMaps];
};

// cuTensorMapEncodeTiled, fetched once through the runtime's entry-point
// query (no link against the driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The maps of `num_c` (rows, num_e) fields `us` (element axis last, rows
// num_e values apart) of `type` (`elem_bytes` each), in boxes of box_e
// elements by box_rows rows; zero fill out of bounds.  Returns a CUDA
// error code or 0.
inline int field_maps(const void* const* us, int num_c, int rows, int num_e,
                      CUtensorMapDataType type, int elem_bytes, int box_e,
                      int box_rows, CUtensorMapSwizzle swizzle,
                      FieldMaps* maps) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return static_cast<int>(cudaErrorNotSupported);
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  if (num_c > kMaxMaps) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(num_e),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(num_e) *
                                 static_cast<cuuint64_t>(elem_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_e),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  for (int c = 0; c < num_c; ++c) {
    const CUresult res = encode(
        &maps->m[c], type, 2, const_cast<void*>(us[c]), dims, strides, box,
        unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// Whether TMA can copy boxes of box_e elements of these fields: every row
// 16-byte aligned and at least one box wide (else the caller copies them
// itself).
inline bool boxes_fit(const void* const* us, int num_c, int num_e,
                      int elem_bytes, int box_e) {
  bool ok = (static_cast<long long>(num_e) * elem_bytes) % 16 == 0 &&
            num_e >= box_e;
  for (int c = 0; c < num_c; ++c) {
    ok = ok && (reinterpret_cast<uintptr_t>(us[c]) & 15) == 0;
  }
  return ok;
}

}  // namespace tma

#endif  // SWIRLFEM_TMA_CUH_
