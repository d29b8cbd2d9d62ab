// The static-operator 2D stiffness in the 'highest' class (FP32 FFMA, or
// FP64 FFMA for float64 fields), one design for the congruent and the
// affine element operator.
//
// Replaces two bodies of swirlfem_tpu/ops/pallas_stiffness.py:
//   kNumOps = 1: _kernel_uniform_mm (stiffness_el_pallas_uniform),
//                out_c = A u_c;
//   kNumOps = 3: _kernel_affine_mm (stiffness_el_pallas_affine),
//                out_c = sum_s c_s(e) M_s u_c, s in {11, 12, 22}.
// Fields are (k^2, E), element axis last; c is (3, E).
//
// Operator layout.  The operators come transposed and padded, built once
// with the operator on the host side (`cuda_stiffness.operator_layout`):
// op_t[s][j][i] = M_s[i][j], shape (kNumOps, k^2, k2p) with k2p = k^2
// rounded up to a multiple of 4 and zeros in the padding.  A row panel of
// the output (rows r0 .. r0 + rows) is then, for every j, one contiguous run
// of `rows` values, staged by 16-byte cp.async.
//
// Work decomposition (computed on the host, `cuda_stiffness.work_plan`).
// The output is cut into row panels x components x 32-column element
// tiles.  blockIdx.y is the row panel; a block stages its panel of the
// operators once and then walks the (component, tile) pairs
// n = blockIdx.x, blockIdx.x + gridDim.x, ... (component-major), with the
// next u tile (and, affine, its c tile) in flight by cp.async while the
// current tile is multiplied.  Small problems (the lid-driven cavity,
// E = 256) get many thin panels, so that about one block lands on each SM;
// large ones (E = 4096) one panel, with a block per tile (congruent) or a
// grid of one block per SM walking about two tiles each (affine).
//
// Threads.  threadIdx.x is the column group (4 element columns), threadIdx.y
// the row group (4 rows of the panel), threadIdx.z the slice of the
// contraction index j (split-K: `splits` contiguous slices; their partial
// tiles meet in shared memory, and every thread sums and stores a share of
// the tile, in slice order).  Each thread holds a 4 x 4 register tile
// per operator and per j reads one 4-vector of each operator and one
// 4-vector of u from shared memory: (kNumOps + 1) 16-byte reads for
// 16 kNumOps FFMAs.  The affine combination is fused into the epilogue
// (y = mstack u never reaches memory), on the per-element c staged with
// the tile.
//
// Edges.  Any E and any pointer alignment: a 16-byte copy or store where
// the four (two, in FP64) values are in range and 16-byte aligned, else
// element by element (copies), zeros past E.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32), float32, C = 2:
// congruent, datagen shape (E = 4096, k^2 = 81): 2 k^4 E C = 0.107 GFLOP,
// 1.60 us, against 5.3 MB, 1.59 us; affine, lid-driven shape (E = 256,
// k^2 = 64): 6 k^4 E C = 12.6 MFLOP, 0.19 us.  At the small shapes the
// launch sets the time.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace stiffness2d_fp32 {

constexpr int kTileE = 32;             // element columns per tile
constexpr int kStages = 2;             // tiles in the ring
constexpr int kColGroups = kTileE / 4;  // threadIdx.x
constexpr int kMaxComponents = 4;
constexpr int kMaxSplits = 8;
constexpr int kSmemLimit = 232448;     // bytes a block may use (H100)

struct Pointers {
  const void* u[kMaxComponents];
  void* out[kMaxComponents];
};

// -- asynchronous copies ----------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

template <int kBytes>
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(kBytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Threads a block may have: 512, or 256 for the FP64 affine kernel, whose
// 48 accumulators take two registers each.
template <typename T, int kNumOps>
constexpr int max_threads() {
  return sizeof(T) == 8 && kNumOps == 3 ? 256 : 512;
}

// -- 4-vectors in shared memory and device memory ----------------------------

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

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// Stores 4 values of output row i from column col on: one 16-byte store
// where in range and aligned, else value by value; nothing past k2 or E.
template <typename T>
__device__ __forceinline__ void store_row4(T* __restrict__ dst, int i, int col,
                                           int k2, int num_e,
                                           const T (&v)[4]) {
  if (i >= k2) return;
  T* p = dst + static_cast<long long>(i) * num_e + col;
  if (col + 4 <= num_e && aligned16(p)) {
    store4(p, v);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (col + c < num_e) p[c] = v[c];
    }
  }
}

// Starts the copies of a (rows, kTileE) tile of a row-major (rows, ld)
// array from column e0 on: 16 bytes at a time where in range and aligned,
// else one value at a time; columns past num_e are zero.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src,
                                           int rows, long long ld, int e0,
                                           int num_e, int tid, int nthreads) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kTileE / kVec;
  for (int idx = tid; idx < rows * kChunks; idx += nthreads) {
    const int r = idx / kChunks;
    const int col = e0 + (idx - r * kChunks) * kVec;
    const T* g = src + r * ld + col;
    T* s = dst + r * kTileE + (col - e0);
    if (col + kVec <= num_e && aligned16(g)) {
      cp_async16(s, g);
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        if (col + v < num_e) {
          cp_async_small<sizeof(T)>(s + v, g + v);
        } else {
          s[v] = T(0);
        }
      }
    }
  }
}

// Shared memory of one block, in values of T (the launcher's count).
__host__ __device__ __forceinline__ long long smem_values(int num_ops,
                                                           int k2, int rows,
                                                           int splits) {
  return static_cast<long long>(num_ops) * k2 * rows +
         static_cast<long long>(kStages) * k2 * kTileE +
         (num_ops == 3 ? static_cast<long long>(kStages) * 3 * kTileE : 0) +
         (splits > 1 ? static_cast<long long>(splits) * rows * kTileE : 0);
}

template <typename T, int kNumOps>
__global__ void __launch_bounds__((max_threads<T, kNumOps>()))
stiffness2d_fp32_kernel(const T* __restrict__ op_t, const T* __restrict__ caff,
                        Pointers ptrs, int num_c, int k2, int num_e,
                        int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k2p = (k2 + 3) & ~3;
  const int splits = blockDim.z;
  const int tiles = (num_e + kTileE - 1) / kTileE;
  const int pairs = num_c * tiles;
  // Shared memory: the operator panel (kNumOps, k2, rows), the u ring
  // (kStages, k2, kTileE), the c ring (kStages, 3, kTileE; affine), the
  // split-K partials (splits, rows, kTileE; none for one slice).
  T* op_s = reinterpret_cast<T*>(smem_raw);
  T* u_s = op_s + kNumOps * k2 * rows;
  T* c_s = u_s + kStages * k2 * kTileE;
  T* red_s = c_s + (kNumOps == 3 ? kStages * 3 * kTileE : 0);

  const int cg = threadIdx.x;
  const int rg = threadIdx.y;
  const int kq = threadIdx.z;
  const int tid = (kq * blockDim.y + rg) * kColGroups + cg;
  const int nthreads = kColGroups * blockDim.y * splits;
  const int r0 = blockIdx.y * rows;  // first row of the panel

  // The panel of each operator: for every (s, j), `rows` contiguous values
  // from op_t[s][j][r0]; rows past k2p are zero.
  {
    const int chunks = rows / 4;
    for (int idx = tid; idx < kNumOps * k2 * chunks; idx += nthreads) {
      const int sj = idx / chunks;
      const int i = r0 + 4 * (idx - sj * chunks);
      T* s = op_s + sj * rows + (i - r0);
      if (i < k2p) {
        const T* g = op_t + static_cast<long long>(sj) * k2p + i;
        if constexpr (sizeof(T) == 4) {
          cp_async16(s, g);
        } else {
          cp_async16(s, g);
          cp_async16(s + 2, g + 2);
        }
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) s[v] = T(0);
      }
    }
  }

  auto stage = [&](int n, int slot) {
    const int comp = n / tiles;
    const int e0 = (n - comp * tiles) * kTileE;
    stage_tile(u_s + slot * k2 * kTileE, static_cast<const T*>(ptrs.u[comp]),
               k2, num_e, e0, num_e, tid, nthreads);
    if constexpr (kNumOps == 3) {
      stage_tile(c_s + slot * 3 * kTileE, caff, 3, num_e, e0, num_e, tid,
                 nthreads);
    }
  };

  // Prologue: the operator panel and the first tile; one commit group per
  // tile (empty past the last pair), so that the group of the tile of
  // iteration `it` is group `it`.
  if (blockIdx.x < pairs) stage(blockIdx.x, 0);
  cp_async_commit();

  const int jc = (k2 + splits - 1) / splits;
  const int j0 = kq * jc;
  const int j1 = min(k2, j0 + jc);
  int it = 0;
  for (int n = blockIdx.x; n < pairs; n += gridDim.x, ++it) {
    cp_async_wait<0>();  // this thread's copies of tile `it`
    __syncthreads();     // everyone's; tile it - 1 is done
    {
      const int ahead = n + gridDim.x;
      if (ahead < pairs) stage(ahead, (it + 1) % kStages);
      cp_async_commit();
    }
    const int slot = it % kStages;
    const T* tile = u_s + slot * k2 * kTileE;

    T acc[kNumOps][4][4];
#pragma unroll
    for (int s = 0; s < kNumOps; ++s) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[s][r][c] = T(0);
      }
    }
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      T b[4];
      load4(tile + j * kTileE + 4 * cg, b);
#pragma unroll
      for (int s = 0; s < kNumOps; ++s) {
        T a[4];
        load4(op_s + (s * k2 + j) * rows + 4 * rg, a);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[s][r][c] = fma(a[r], b[c], acc[s][r][c]);
        }
      }
    }

    // Epilogue: the affine combination, then the split-K sum.
    T out[4][4];
    if constexpr (kNumOps == 3) {
      T cc[3][4];
#pragma unroll
      for (int s = 0; s < 3; ++s) load4(c_s + (slot * 3 + s) * kTileE + 4 * cg, cc[s]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          out[r][c] = cc[0][c] * acc[0][r][c] + cc[1][c] * acc[1][r][c] +
                      cc[2][c] * acc[2][r][c];
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) out[r][c] = acc[0][r][c];
      }
    }
    const int comp = n / tiles;
    const int e0 = (n - comp * tiles) * kTileE;
    T* __restrict__ dst = static_cast<T*>(ptrs.out[comp]);
    if (splits == 1) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        store_row4(dst, r0 + 4 * rg + r, e0 + 4 * cg, k2, num_e, out[r]);
      }
    } else {
      // Every slice writes its partial tile; then each thread sums a share
      // of the tile's 4-vectors over the slices, in slice order, and
      // stores it.
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        store4(red_s + (kq * rows + 4 * rg + r) * kTileE + 4 * cg, out[r]);
      }
      __syncthreads();
      for (int q = tid; q < rows * kColGroups; q += nthreads) {
        const int r = q / kColGroups;
        const int c4 = 4 * (q - r * kColGroups);
        T sum[4];
        load4(red_s + r * kTileE + c4, sum);
        for (int kk = 1; kk < splits; ++kk) {
          T p[4];
          load4(red_s + (kk * rows + r) * kTileE + c4, p);
#pragma unroll
          for (int c = 0; c < 4; ++c) sum[c] += p[c];
        }
        store_row4(dst, r0 + r, e0 + c4, k2, num_e, sum);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// Checks the plan and launches.  The plan (`panels` row panels of `rows`
// rows, `splits` slices of j, `blocks` blocks per panel) comes from the
// host; any plan that covers the rows is valid.
template <typename T, int kNumOps>
int launch(const void* op_t, const void* caff, const void* const* us,
           void* const* outs, int num_c, int k2, int num_e, int panels,
           int rows, int splits, int blocks, void* stream) {
  const int k2p = (k2 + 3) & ~3;
  if (num_c < 1 || num_c > kMaxComponents || k2 < 1 || num_e < 0 ||
      rows < 4 || rows % 4 != 0 || panels < 1 ||
      static_cast<long long>(panels) * rows < k2p || splits < 1 ||
      splits > kMaxSplits || blocks < 1 ||
      kColGroups * (rows / 4) * splits > max_threads<T, kNumOps>() ||
      !aligned16(op_t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      static_cast<size_t>(smem_values(kNumOps, k2, rows, splits)) * sizeof(T);
  if (smem > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_e == 0) return static_cast<int>(cudaGetLastError());
  Pointers ptrs = {};
  for (int c = 0; c < num_c; ++c) {
    ptrs.u[c] = us[c];
    ptrs.out[c] = outs[c];
  }
  auto kernel = stiffness2d_fp32_kernel<T, kNumOps>;
  // Opened once per device to the whole of a block's shared memory, not at
  // every launch: the steps that launch these kernels are host-bound.
  constexpr int kMaxDevices = 64;
  static bool opened[kMaxDevices] = {};
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= kMaxDevices || !opened[device]) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemLimit);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (device < kMaxDevices) opened[device] = true;
    }
  }
  const dim3 grid(blocks, panels);
  const dim3 block(kColGroups, rows / 4, splits);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(op_t), static_cast<const T*>(caff), ptrs, num_c,
      k2, num_e, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stiffness2d_fp32
