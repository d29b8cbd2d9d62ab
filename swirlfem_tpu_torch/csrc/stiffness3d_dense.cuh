// The persistent tile walk and the wgmma primitives of the dense congruent
// stiffness kernels: the 3D 3xTF32 one ('highest', stiffness3d_dense.cu)
// and the split-bf16 one (stiffness3d_dense_split.cu: the 3D operator at
// 'bf16x3', the 2D one at 'bf16x3' and 'default').  Both compute
// out_c = A u_c for the static (k^d, k^d) operator A of a congruent box and
// C <= 4 component fields (k^d, E), E last, with the field as the register
// A operand of wgmma (M = 64 elements of a warpgroup) and the operator's
// split from shared memory as the B operand, in the order the host lays
// out.
//
// Work.  In 3D a tile is 128 elements (two warpgroups of 64) by one panel
// of 256 operator rows.  The (component, panel, 64-element unit) space is
// cut into one contiguous range per block, one block per SM, each walking
// its range in tiles of two units (warpgroup w takes unit w, the whole
// panel) or, at a range's or segment's end, one unit (both warpgroups take
// it, warpgroup w the panel's half w), so that a block's time goes with
// its units.  The 2D kernel has one warpgroup and walks tiles of one unit
// by its one panel (kMaxWidth 1).  Each tile's depth is walked in chunks
// through a ring of shared-memory stages.

#ifndef SWIRLFEM_STIFFNESS3D_DENSE_CUH_
#define SWIRLFEM_STIFFNESS3D_DENSE_CUH_

#include <cuda_runtime.h>

#include <cstdint>

namespace dense3d {

constexpr int kMaxComponents = 4;
constexpr int kMaxK3 = 1000;  // k <= 10
constexpr int kMaxDevices = 64;

constexpr int kThreads = 256;  // two warpgroups, 64 elements each
constexpr int kTileE = 128;    // elements of a tile (M: 2 x 64)
constexpr int kUnitE = 64;     // elements of a warpgroup (one wgmma M)
constexpr int kPanel = 256;    // operator rows of a tile (N: 2 x 128)
constexpr int kHalf = 128;     // operator rows of one wgmma (N)

struct Pointers {
  const void* u[kMaxComponents];
  void* out[kMaxComponents];
};

// A block's walk over its range of (component, panel, 64-element unit)
// space: the tile it is at (component c, panel p, first unit col, width 1
// or 2 units) and the depth chunk within it.
struct Walk {
  int pos;  // first unit after the current tile
  int end;
  int c, p, col, width, chunk;
  bool valid;
};

// In 32 bits: num_e is an int, so a launch has fewer than 2^31 units.
struct Shape {
  int k3, num_e, chunks, panels;
  int units;  // 64-element units of one (component, panel) segment
};

// Tiles are at most kMaxWidth (1 or 2) units wide.
template <int kMaxWidth = 2>
__device__ __forceinline__ void start_tile(Walk& w, const Shape& s) {
  if (w.pos >= w.end) {
    w.valid = false;
    return;
  }
  const int seg = w.pos / s.units;
  const int off = w.pos - seg * s.units;
  const int piece = min(w.end, (seg + 1) * s.units) - w.pos;
  w.width = kMaxWidth == 2 && piece >= 2 ? 2 : 1;
  w.c = seg / s.panels;
  w.p = seg - w.c * s.panels;
  w.col = off;
  w.chunk = 0;
  w.valid = true;
  w.pos += w.width;
}

template <int kMaxWidth = 2>
__device__ __forceinline__ void advance(Walk& w, const Shape& s) {
  if (++w.chunk == s.chunks) start_tile<kMaxWidth>(w, s);
}

// Block b's walk: the b-th of `grid` contiguous ranges of the units, of
// total / grid units and one more for the first total % grid blocks.
template <int kMaxWidth = 2>
__device__ __forceinline__ Walk first_tile(const Shape& s,
                                           long long total_units) {
  const int total = static_cast<int>(total_units);
  const int grid = static_cast<int>(gridDim.x);
  const int b = static_cast<int>(blockIdx.x);
  const int base = total / grid;
  const int rem = total - base * grid;
  Walk w = {b * base + min(b, rem), (b + 1) * base + min(b + 1, rem),
            0, 0, 0, 0, 0, false};
  start_tile<kMaxWidth>(w, s);
  return w;
}

// The wgmma descriptor of a K-major operand without swizzle: 8-row core
// matrices of 16 bytes a row, `lbo` bytes between the two 16-byte halves
// of the step's depth, `sbo` bytes between 8-row groups.
__device__ __forceinline__ uint64_t descriptor(const void* smem, int lbo,
                                               int sbo) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32);
}

// The wgmma descriptor of a K-major operand in the 32-byte swizzle
// (layout type 3): 8-row groups of 32-byte rows, 256 bytes apart.
__device__ __forceinline__ uint64_t descriptor_sw32(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) |
         (static_cast<uint64_t>(3) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes, so that the
// compiler neither reuses nor reads them before the wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The shape of one launch, and its units (operator rows in panels of
// `panel`).
inline Shape shape_of(int k3, int num_e, int depth_chunk, long long* total,
                      int num_c, int panel = kPanel) {
  Shape s;
  s.k3 = k3;
  s.num_e = num_e;
  s.chunks = (k3 + depth_chunk - 1) / depth_chunk;
  s.panels = (k3 + panel - 1) / panel;
  s.units = (num_e + kUnitE - 1) / kUnitE;
  *total = static_cast<long long>(num_c) * s.panels * s.units;
  return s;
}

// The SM count of the current device; the first call on a device also
// opens `kernel`'s dynamic shared memory to `bytes` (once per device, not
// at every launch).  `counts` is the caller's cache, one per kernel.
inline int sm_count(const void* kernel, int bytes,
                    int (&counts)[kMaxDevices], int* count) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < kMaxDevices && counts[device] > 0) {
    *count = counts[device];
    return 0;
  }
  err = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < kMaxDevices) counts[device] = *count;
  return 0;
}

// Checks shared by the entry points; fills `ptrs`.  Returns a CUDA error
// code, or -1 when there is nothing to launch.
inline int prepare(const void* const* us, void* const* outs, int num_c,
                   int k3, int num_e, Pointers* ptrs) {
  if (num_c < 1 || num_c > kMaxComponents || k3 < 1 || k3 > kMaxK3 ||
      num_e < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_e == 0) return -1;
  *ptrs = {};
  for (int c = 0; c < num_c; ++c) {
    ptrs->u[c] = us[c];
    ptrs->out[c] = outs[c];
  }
  return 0;
}

}  // namespace dense3d

#endif  // SWIRLFEM_STIFFNESS3D_DENSE_CUH_
