// Congruent-element 2D stiffness: out_c = A @ u_c for every component c.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness.py:stiffness_el_pallas_uniform
// (_kernel_uniform_mm, precision 'highest').  On a box whose elements all
// share the same metric scalars, the element stiffness is one static dense
// (k^2, k^2) matrix A = c11 M11 + c12 M12 + c22 M22, built in float64 on the
// host and cast to the working dtype.  Each component field is (k^2, E),
// element axis last.
//
// Design (exact in float32, the 'highest' class: FP32 FFMA, no TF32).  A
// block owns a tile of kTileE = 32 element columns of ONE component
// (blockIdx.y).  It stages A transposed in shared memory (rows padded to a
// multiple of 4: 81 x 84 x 4 B = 27 KB at order 8) with the (k^2, 32) u tile
// beside it, both by cp.async so that all staging loads are in flight at
// once.  Each thread owns a 4 x 4 register tile of the output (4 rows,
// 4 element columns): per j it reads one 4-vector of A^T and one 4-vector
// of u from shared memory and issues 16 FFMAs, summing in order of j.  The
// block is 8 x ceil(k^2 / 4) threads (8 x 21 = 168 at order 8).  wgmma,
// 3xTF32 and TMA are for later work.
//
// Bound.  2 k^4 E C flops against 2 C k^2 E 4 bytes of HBM traffic: about
// 20 flop/B at k = 9, near the FP32 FFMA balance of the card (67 TFLOP/s
// over 3.35 TB/s).  At the datagen shape (C = 2, k^2 = 81, E = 4096) both
// bounds are under 2 microseconds, so the launch dominates.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileE = 32;       // element columns per block
constexpr int kColGroups = kTileE / 4;
constexpr int kMaxK2 = 128;      // k^2 <= 128 (order <= 10)
constexpr int kMaxComponents = 4;

struct Pointers {
  const void* u[kMaxComponents];
  void* out[kMaxComponents];
};

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

template <typename T>
__global__ void __launch_bounds__(kColGroups * kMaxK2 / 4)
stiffness_uniform_kernel(const T* __restrict__ amat, Pointers ptrs, int k2,
                         int num_e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k2p = (k2 + 3) & ~3;            // A^T row length, padded
  T* at_s = reinterpret_cast<T*>(smem_raw);  // (k2, k2p): at_s[j][i] = A[i][j]
  T* u_s = at_s + k2 * k2p;                  // (k2, kTileE)
  const T* __restrict__ u = static_cast<const T*>(ptrs.u[blockIdx.y]);
  T* __restrict__ out = static_cast<T*>(ptrs.out[blockIdx.y]);
  const int e0 = blockIdx.x * kTileE;
  const int cg = threadIdx.x;                // column group: 4 columns
  const int rg = threadIdx.y;                // row group: 4 rows
  const int tid = rg * kColGroups + cg;
  const int nthreads = kColGroups * blockDim.y;

  // Stage A^T and the u tile with asynchronous copies (cp.async): every
  // element load is in flight at once instead of one L2 round trip per
  // loop iteration.  A is read coalesced and scattered transposed.
  for (int idx = tid; idx < k2 * k2; idx += nthreads) {
    const int i = idx / k2;
    const int j = idx - i * k2;
    __pipeline_memcpy_async(at_s + j * k2p + i, amat + idx, sizeof(T));
  }
  for (int idx = tid; idx < k2 * (k2p - k2); idx += nthreads) {
    const int j = idx / (k2p - k2);
    at_s[j * k2p + k2 + idx % (k2p - k2)] = T(0);  // padded rows
  }
  for (int idx = tid; idx < k2 * kTileE; idx += nthreads) {
    const int j = idx / kTileE;
    const int col = e0 + idx % kTileE;
    if (col < num_e) {
      __pipeline_memcpy_async(u_s + idx,
                              u + static_cast<long long>(j) * num_e + col,
                              sizeof(T));
    } else {
      u_s[idx] = T(0);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  T acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = T(0);
  }
  for (int j = 0; j < k2; ++j) {
    T a[4], b[4];
    load4(at_s + j * k2p + 4 * rg, a);
    load4(u_s + j * kTileE + 4 * cg, b);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fma(a[r], b[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * rg + r;
    if (i >= k2) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = e0 + 4 * cg + c;
      if (col < num_e) out[static_cast<long long>(i) * num_e + col] = acc[r][c];
    }
  }
}

template <typename T>
int launch(const void* amat, const void* const* us, void* const* outs,
           int num_c, int k2, int num_e, void* stream) {
  if (num_c < 1 || num_c > kMaxComponents || k2 < 1 || k2 > kMaxK2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pointers ptrs = {};
  for (int c = 0; c < num_c; ++c) {
    ptrs.u[c] = us[c];
    ptrs.out[c] = outs[c];
  }
  const int k2p = (k2 + 3) & ~3;
  const size_t smem =
      (static_cast<size_t>(k2) * k2p + static_cast<size_t>(k2) * kTileE) *
      sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stiffness_uniform_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_e == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((num_e + kTileE - 1) / kTileE, num_c);
  const dim3 block(kColGroups, k2p / 4);
  stiffness_uniform_kernel<T><<<grid, block, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(amat), ptrs, k2, num_e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stiffness_uniform_f32(const void* amat, const void* const* us,
                                     void* const* outs, int num_c, int k2,
                                     int num_e, void* stream) {
  return launch<float>(amat, us, outs, num_c, k2, num_e, stream);
}

extern "C" int stiffness_uniform_f64(const void* amat, const void* const* us,
                                     void* const* outs, int num_c, int k2,
                                     int num_e, void* stream) {
  return launch<double>(amat, us, outs, num_c, k2, num_e, stream);
}
