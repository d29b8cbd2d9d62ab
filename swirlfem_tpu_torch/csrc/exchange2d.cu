// Periodic 2D direct-stiffness summation (Q Q^T) in element-local form, for
// up to four fields of a batch of element grids in one launch.
//
// Replaces swirlfem_tpu/ops/pallas_exchange.py:exchange2d_pallas (_kernel),
// the TPU kernel that runs the two sequential axis passes in VMEM (and, under
// the JAX trainer's vmap, runs them for every sample).  Input and output are
// (k, k, nb, n0, n1), contiguous, element axes last: nb independent periodic
// grids (nb = 1 is one (k, k, n0, n1) grid), each exchanged on its own:
//
//   pass 1 (local axis 1 <-> element axis n1): s = w[a,p,e0,e1] + w[a,0,e0,e1+1]
//     is written to face p of element e1 and face 0 of element e1+1;
//   pass 2 (local axis 0 <-> element axis n0), on pass 1's output, the same
//     along e0 — so corners receive all four contributions.
//
// Every output entry is computed in GATHER form, adding its node's copies in
// exactly the order of the two-pass reference:
//   face node:   w[a,p,.,e1] + w[a,0,.,e1+1]
//   corner node: (w[p,p] + w[p,0]+) + (w[0,p]+ + w[0,0]++)
// so every copy of a node comes out bitwise identical to the plain
// torch.roll version (sem2d.exchange_el's plain path), which the chip test
// checks with exact equality.  There are no multiplies, so no FMA
// contraction can change the rounding.
//
// Bound.  Memory: one read and one write per entry; at the datagen shape
// (9, 9, 64, 64) in float32 that is 2.65 MB, 0.79 us at 3.35 TB/s.
//
// Design.  A block owns one plane (a, b) (blockIdx.y = a, blockIdx.z = b) of
// one grid of the batch, a band of blockDim.y element rows of it (blockIdx.x
// = grid * bands + band) and, along threadIdx.z, one field each: a block
// never reads another grid's rows, so no periodic wrap crosses from one
// sample into the next.  The batch adds one division a thread.  A thread moves V values along the
// contiguous axis e1 at once, 16 bytes where n1 and the pointers allow it
// (V = 4 in float32, 2 in float64), else one; it strides over its row by
// blockDim.x chunks.  The plane decides the work for the whole block:
// interior planes (0 < a, b < p) are a straight copy; a face along e1
// (b = 0 or p) adds the other face's copy, whose e1 +- 1 neighbour at the
// chunk's edge comes from the next or previous chunk of the row: by a warp
// shuffle where a row is one aligned group of lanes (blockDim.x = n1 / V a
// power of two <= 32), else by a load of that one value; a face along e0
// (a = 0 or p) forms pass 1 at its own row and the adjacent one.  The field
// pointers are picked from the kernel's parameters by selects: indexed by
// threadIdx.z they went through a 64-byte stack frame, whose launches took
// 1.4 us more at the datagen shape (an empty block: 2.24 us against 0.86,
// profiler durations on an NVIDIA H100 80GB HBM3 at 700 W,
// tests/torch_port_exchange_general2d_variants.py).  Two and four rows a
// thread, all loaded before any is stored, were slower.
//
// A first version (one thread per entry, five 64-bit divisions each, scalar
// loads, a grid-stride loop) took 4.65 us at the datagen shape on an NVIDIA
// H100 80GB HBM3 at 700 W, one launch per field; this one 3.13 us (2.11 by
// the profiler), 3.63 for both velocity components in one launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxFields = 4;
constexpr int kMaxThreads = 1024;

struct Fields {
  const void* in[kMaxFields];
  void* out[kMaxFields];
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* __restrict__ p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

// The value at element `elem` of chunk c + d (d = +1 or -1, periodic in the
// row of `chunks` chunks) of the row at `row`; `mine` is this thread's own
// value at that element of chunk c.
template <typename T, int V, bool kShfl>
__device__ __forceinline__ T neighbour(T mine, const T* __restrict__ row,
                                       int c, int d, int chunks, int elem) {
  if constexpr (kShfl) {
    int src = static_cast<int>(threadIdx.x) + d;
    src = src < 0 ? chunks - 1 : (src == chunks ? 0 : src);
    return __shfl_sync(0xffffffffu, mine, src, chunks);
  } else {
    int cn = c + d;
    cn = cn < 0 ? chunks - 1 : (cn == chunks ? 0 : cn);
    return row[cn * V + elem];
  }
}

// Pass 1 at plane (a2, b), row e0, chunk c.  `plane(i, j)` is the start of
// plane (i, j) of this field.
template <typename T, int V, bool kShfl, typename Plane>
__device__ __forceinline__ Pack<T, V> pass1(const Plane& plane, int a2, int b,
                                            int p, long long row, int c,
                                            int chunks) {
  if (b != 0 && b != p) return load<T, V>(plane(a2, b) + row + c * V);
  const T* __restrict__ wp = plane(a2, p) + row;
  const T* __restrict__ w0 = plane(a2, 0) + row;
  const Pack<T, V> vp = load<T, V>(wp + c * V);
  const Pack<T, V> v0 = load<T, V>(w0 + c * V);
  Pack<T, V> s;
  if (b == p) {  // w[a,p,e1] + w[a,0,e1+1]
    const T next = neighbour<T, V, kShfl>(v0.v[0], w0, c, 1, chunks, 0);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s.v[i] = vp.v[i] + (i + 1 < V ? v0.v[i + 1] : next);
    }
  } else {  // w[a,p,e1-1] + w[a,0,e1]
    const T prev = neighbour<T, V, kShfl>(vp.v[V - 1], wp, c, -1, chunks,
                                          V - 1);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s.v[i] = (i > 0 ? vp.v[i - 1] : prev) + v0.v[i];
    }
  }
  return s;
}

// a[i] of a kernel parameter array, without copying it to local memory.
template <typename P>
__device__ __forceinline__ P pick(P const (&a)[kMaxFields], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

template <typename T, int V, bool kShfl>
__global__ void exchange2d_kernel(Fields f, int k, int nb, int n0, int n1,
                                  int bands) {
  const int a = blockIdx.y;
  const int b = blockIdx.z;
  const int p = k - 1;
  const int grid = blockIdx.x / bands;
  const int band = blockIdx.x - grid * bands;
  const T* __restrict__ w = static_cast<const T*>(pick(f.in, threadIdx.z));
  T* __restrict__ out = static_cast<T*>(pick(f.out, threadIdx.z));
  const long long plane_size = static_cast<long long>(n0) * n1;
  // Plane (i, j) of this block's grid.
  auto at = [&](int i, int j) {
    return (static_cast<long long>(i * k + j) * nb + grid) * plane_size;
  };
  auto plane = [&](int i, int j) { return w + at(i, j); };
  const int chunks = n1 / V;
  // With shuffles every thread of a row takes part, so a row past n0 is
  // computed on the last row and not stored.
  const int e0_raw = band * blockDim.y + threadIdx.y;
  const bool live = e0_raw < n0;
  const int e0 = live ? e0_raw : n0 - 1;
  const long long row = static_cast<long long>(e0) * n1;
  T* __restrict__ dst = out + at(a, b) + row;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    Pack<T, V> v;
    if (a == p || a == 0) {
      // (w1[p] at e0 + w1[0] at e0 + 1) or (w1[p] at e0 - 1 + w1[0] at e0).
      const int up = e0 + 1 == n0 ? 0 : e0 + 1;
      const int down = e0 == 0 ? n0 - 1 : e0 - 1;
      const long long rp = static_cast<long long>(a == p ? e0 : down) * n1;
      const long long r0 = static_cast<long long>(a == p ? up : e0) * n1;
      const Pack<T, V> sp = pass1<T, V, kShfl>(plane, p, b, p, rp, c, chunks);
      const Pack<T, V> s0 = pass1<T, V, kShfl>(plane, 0, b, p, r0, c, chunks);
#pragma unroll
      for (int i = 0; i < V; ++i) v.v[i] = sp.v[i] + s0.v[i];
    } else {
      v = pass1<T, V, kShfl>(plane, a, b, p, row, c, chunks);
    }
    if (live) *reinterpret_cast<Pack<T, V>*>(dst + c * V) = v;
  }
}

template <typename T, int V, bool kShfl>
int launch_v(const Fields& f, int num_fields, int k, int nb, int n0, int n1,
             int tx, int ty, cudaStream_t stream) {
  const int bands = (n0 + ty - 1) / ty;
  const dim3 block(tx, ty, num_fields);
  const dim3 grid(static_cast<unsigned>(bands) * nb, k, k);
  exchange2d_kernel<T, V, kShfl><<<grid, block, 0, stream>>>(f, k, nb, n0, n1,
                                                             bands);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry is the host's (cuda_exchange.launch_geometry); this
// checks that it covers the fields as the kernel reads them.
template <typename T>
int launch(const void* const* ins, void* const* outs, int num_fields, int k,
           int nb, int n0, int n1, int vec, int tx, int ty, int shfl,
           void* stream) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  const int v = vec ? kV : 1;
  const bool pow2 = tx > 0 && (tx & (tx - 1)) == 0;
  if (num_fields < 1 || num_fields > kMaxFields || k < 2 || k > 65535 ||
      nb < 1 || n0 < 1 || n1 < 1 || n1 % v != 0 || tx < 1 || ty < 1 ||
      static_cast<long long>((n0 + ty - 1) / ty) * nb > 0x7fffffffLL ||
      tx * ty * num_fields > kMaxThreads ||
      (shfl && (tx != n1 / v || !pow2 || tx > 32 ||
                tx * ty * num_fields % 32 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Fields f = {};
  for (int i = 0; i < num_fields; ++i) {
    f.in[i] = ins[i];
    f.out[i] = outs[i];
    if (vec && (reinterpret_cast<uintptr_t>(ins[i]) % 16 != 0 ||
                reinterpret_cast<uintptr_t>(outs[i]) % 16 != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    return shfl
        ? launch_v<T, kV, true>(f, num_fields, k, nb, n0, n1, tx, ty, s)
        : launch_v<T, kV, false>(f, num_fields, k, nb, n0, n1, tx, ty, s);
  }
  return shfl ? launch_v<T, 1, true>(f, num_fields, k, nb, n0, n1, tx, ty, s)
              : launch_v<T, 1, false>(f, num_fields, k, nb, n0, n1, tx, ty, s);
}

}  // namespace

// ins, outs: num_fields (<= 4) distinct (k, k, nb, n0, n1) fields of one
// shape (nb periodic grids each); vec: 16-byte chunks (n1 a multiple of
// 16 / sizeof(T), pointers aligned); tx, ty: the block's threads along e1
// and e0 (threadIdx.z: the field); shfl: the e1 neighbours by warp shuffle
// (tx = the row's chunks, a power of two <= 32, whole warps).
extern "C" int exchange2d_f32(const void* const* ins, void* const* outs,
                              int num_fields, int k, int nb, int n0, int n1,
                              int vec, int tx, int ty, int shfl,
                              void* stream) {
  return launch<float>(ins, outs, num_fields, k, nb, n0, n1, vec, tx, ty,
                       shfl, stream);
}

extern "C" int exchange2d_f64(const void* const* ins, void* const* outs,
                              int num_fields, int k, int nb, int n0, int n1,
                              int vec, int tx, int ty, int shfl,
                              void* stream) {
  return launch<double>(ins, outs, num_fields, k, nb, n0, n1, vec, tx, ty,
                        shfl, stream);
}
