// Affine-element 2D stiffness: out_c = c11 M11 u_c + c12 M12 u_c + c22 M22 u_c
// with per-element metric scalars c (3, E), for every component c.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness.py:stiffness_el_pallas_affine
// (_kernel_affine_mm, precision 'highest').  On affine elements
// G_ab(q, e) = w(q) c_ab(e), so the element operator is a per-element
// combination of three static (k^2, k^2) matrices, stacked as
// mstack = [M11; M12; M22] (3 k^2, k^2), built in float64 on the host and
// cast to the working dtype.  Each component field is (k^2, E), element axis
// last; c is (3, E).
//
// Design (exact in float32, the 'highest' class: FP32 FFMA, no TF32).  The
// TPU kernel writes y = mstack @ u (3 k^2 rows) and combines it afterwards;
// here the product and the combination are fused: each thread keeps THREE
// accumulators per output (M11 u, M12 u, M22 u) in registers and combines
// them with the element's c11, c12, c22 in the epilogue, so y never reaches
// memory.  A block owns kTileE = 32 element columns and loops over the
// components.  It stages mstack in shared memory once, row by row as it lies
// in device memory (coalesced, conflict-free), with an odd row stride so
// that the rows a warp reads fall on distinct banks, and the (k^2, 32) u
// tile of each component beside it, double-buffered: the next component's
// tile is in flight (cp.async) while the current one is multiplied.  Each
// thread owns a 2 x 4 register tile of the output (2 rows, 4 element
// columns) and per j reads six operator entries and one 4-vector of u from
// shared memory for 24 FFMAs.  The block is 8 x ceil(k^2 / 2) threads (328
// at order 8, 256 at order 7).  wgmma and TMA are later work.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32) at the datagen shape
// (E = 4096, order 8, C = 2, float32): 2 x 3 k^4 E C = 0.32 GFLOP, 4.8 us,
// against (2 C k^2 + 3) E 4 B = 2.7 MB, 0.8 us of bytes.  Operations set the
// bound.  On the lid-driven cavity (E = 256, order 7) both are under 0.2 us:
// the launch floor sets the time.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileE = 32;  // element columns per block
constexpr int kColGroups = kTileE / 4;
constexpr int kRowsPerThread = 2;
constexpr int kMaxK2 = 100;  // k^2 <= 100 (order <= 9)
constexpr int kMaxComponents = 4;
constexpr int kOps = 3;  // M11, M12, M22

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

// Row stride of the staged operators: odd, so the four row pairs a warp
// reads at one j lie on four distinct banks.
__host__ __device__ __forceinline__ int op_stride(int k2) { return k2 | 1; }

template <typename T>
size_t smem_bytes(int k2) {
  return (2 * static_cast<size_t>(k2) * kTileE +
          static_cast<size_t>(kOps) * k2 * op_stride(k2)) *
         sizeof(T);
}

// Issues the asynchronous copies of one component's (k2, kTileE) u tile.
template <typename T>
__device__ __forceinline__ void stage_u(T* u_s, const T* __restrict__ u,
                                        int k2, int e0, int num_e, int tid,
                                        int nthreads) {
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
}

template <typename T>
__global__ void __launch_bounds__(kColGroups * (kMaxK2 / kRowsPerThread))
stiffness2d_affine_kernel(const T* __restrict__ mstack,
                          const T* __restrict__ caff, Pointers ptrs,
                          int num_c, int k2, int num_e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = op_stride(k2);
  T* u_s = reinterpret_cast<T*>(smem_raw);  // 2 x (k2, kTileE)
  T* m_s = u_s + 2 * k2 * kTileE;           // (3 k2, stride): M_s[i][j]
  const int e0 = blockIdx.x * kTileE;
  const int cg = threadIdx.x;  // column group: 4 columns
  const int rg = threadIdx.y;  // row group: 2 rows
  const int tid = rg * kColGroups + cg;
  const int nthreads = kColGroups * blockDim.y;

  // Stage the three operators (read coalesced), once for all components,
  // in the same commit group as the first component's u tile.
  for (int idx = tid; idx < kOps * k2 * k2; idx += nthreads) {
    const int row = idx / k2;  // s * k2 + i
    const int j = idx - row * k2;
    __pipeline_memcpy_async(m_s + row * stride + j, mstack + idx, sizeof(T));
  }
  stage_u(u_s, static_cast<const T*>(ptrs.u[0]), k2, e0, num_e, tid,
          nthreads);
  __pipeline_commit();

  // Per-element metric scalars of this thread's four columns.
  T c11[4], c12[4], c22[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = e0 + 4 * cg + c;
    const bool live = col < num_e;
    c11[c] = live ? caff[col] : T(0);
    c12[c] = live ? caff[num_e + col] : T(0);
    c22[c] = live ? caff[2 * static_cast<long long>(num_e) + col] : T(0);
  }
  // Rows of this thread; a row past the end (odd k2) reads a valid row and
  // is not stored.
  const int row0 = kRowsPerThread * rg;
  const int row1 = row0 + 1 < k2 ? row0 + 1 : row0;

  for (int comp = 0; comp < num_c; ++comp) {
    const T* tile = u_s + (comp & 1) * k2 * kTileE;
    if (comp + 1 < num_c) {
      stage_u(u_s + ((comp + 1) & 1) * k2 * kTileE,
              static_cast<const T*>(ptrs.u[comp + 1]), k2, e0, num_e, tid,
              nthreads);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();

    T acc[kOps][kRowsPerThread][4];
#pragma unroll
    for (int s = 0; s < kOps; ++s) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[s][r][c] = T(0);
      }
    }
    // Unrolled so that the shared loads of later j issue ahead of the
    // FFMAs of earlier ones (two warps per scheduler hide little latency).
#pragma unroll 4
    for (int j = 0; j < k2; ++j) {
      T b[4];
      load4(tile + j * kTileE + 4 * cg, b);
#pragma unroll
      for (int s = 0; s < kOps; ++s) {
        const T a0 = m_s[(s * k2 + row0) * stride + j];
        const T a1 = m_s[(s * k2 + row1) * stride + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[s][0][c] = fma(a0, b[c], acc[s][0][c]);
          acc[s][1][c] = fma(a1, b[c], acc[s][1][c]);
        }
      }
    }
    T* __restrict__ out = static_cast<T*>(ptrs.out[comp]);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int i = row0 + r;
      if (i >= k2) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = e0 + 4 * cg + c;
        if (col < num_e) {
          out[static_cast<long long>(i) * num_e + col] =
              c11[c] * acc[0][r][c] + c12[c] * acc[1][r][c] +
              c22[c] * acc[2][r][c];
        }
      }
    }
    __syncthreads();  // the component after next overwrites this tile
  }
}

template <typename T>
int launch(const void* mstack, const void* caff, const void* const* us,
           void* const* outs, int num_c, int k2, int num_e, void* stream) {
  if (num_c < 1 || num_c > kMaxComponents || k2 < 1 || k2 > kMaxK2 ||
      num_e < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pointers ptrs = {};
  for (int c = 0; c < num_c; ++c) {
    ptrs.u[c] = us[c];
    ptrs.out[c] = outs[c];
  }
  const size_t smem = smem_bytes<T>(k2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stiffness2d_affine_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_e == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((num_e + kTileE - 1) / kTileE);
  const dim3 block(kColGroups, (k2 + kRowsPerThread - 1) / kRowsPerThread);
  stiffness2d_affine_kernel<T><<<grid, block, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(mstack), static_cast<const T*>(caff), ptrs, num_c,
      k2, num_e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stiffness2d_affine_f32(const void* mstack, const void* caff,
                                      const void* const* us, void* const* outs,
                                      int num_c, int k2, int num_e,
                                      void* stream) {
  return launch<float>(mstack, caff, us, outs, num_c, k2, num_e, stream);
}

extern "C" int stiffness2d_affine_f64(const void* mstack, const void* caff,
                                      const void* const* us, void* const* outs,
                                      int num_c, int k2, int num_e,
                                      void* stream) {
  return launch<double>(mstack, caff, us, outs, num_c, k2, num_e, stream);
}
