// Split-bf16 primitives on Hopper tensor cores, shared by the kernels of the
// 'bf16x3' and 'default' stiffness classes: the dense split kernel
// (stiffness3d_dense_split.cu), the affine 2D split kernel
// (stiffness2d_affine_split.cu) and the bf16x3 pair kernels
// (stiffness3d_pair_columns.cuh).
//
// The TPU kernels of these classes (swirlfem_tpu/ops/pallas_stiffness.py:
// _kernel_uniform_mm3, _kernel_affine_mm3, and _kernel_uniform_mm /
// _kernel_affine_mm at Precision.DEFAULT) compute y = A u for a static
// operator A (float64 on the host, rounded to float32) and a float32 field
// u of E columns, in bf16 passes with float32 accumulation:
//
//   host:   hi = bf16(A),  lo = bf16(A - f32(hi))
//   kernel: uhi = bf16(u), ulo = bf16(u - f32(uhi))       (both RNE)
//   'bf16x3' (3 passes): y = hi uhi + hi ulo + lo uhi
//   'default' (1 pass):  y = hi uhi
//
// A bf16 x bf16 product is exact in float32, so a kernel and a plain
// emulation differ only in the order of their float32 sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace split_bf16 {

constexpr int kMaxComponents = 4;

struct Pointers {
  const float* u[kMaxComponents];
  float* out[kMaxComponents];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// (hi, lo) of two neighbouring values as bf16 pairs, x in the low half:
// hi = bf16(x), lo = bf16(x - hi), round to nearest even.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Checks shared by the entry points; returns a CUDA error code or 0.
inline int check_args(int num_c, int rows, int depth, int rows_pad,
                      int depth_pad, int num_e) {
  if (num_c < 1 || num_c > kMaxComponents || rows < 1 || depth < 1 ||
      rows > rows_pad || depth > depth_pad || rows_pad % 16 != 0 ||
      depth_pad % 16 != 0 || num_e < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// Raises the kernel's dynamic shared memory limit where it needs more than
// the default 48 KB.
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace split_bf16
