// Congruent-element 3D stiffness in pair-axis form, class bf16x3, for
// C <= 4 components.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness3d.py:stiffness3d_el_pallas_pair
// (_kernel_3d_pair, always bf16x3).  With the (eta, zeta) pair merged into
// one axis of M = k^2 entries, a field is k xi-slabs u[a] of shape (M, E),
// and on an axis-aligned box of identical elements
//
//   out[a] = w_a mm3(A2, u[a]) + sum_b (c11 At)[a, b] mm3(W2, u[b]),
//   A2 = c22 At (x) W + c33 W (x) At   (M x M),   W2 = diag(w (x) w),
//
// with At = D^T W D, W = diag(w), and mm3 the class bf16x3: the host split
// of the float64 operator (hi, lo) times the split of the field (bf16(u),
// bf16(u - hi)), hi uhi + hi ulo + lo uhi in float32.  A2 is split on the
// host and multiplied on the tensor cores.  W2 is diagonal: its mm3 is
// three exact products a point, (W2hi uhi + W2hi ulo) + W2lo uhi, on FFMA,
// as its class defines it; the xi chain over b stays FP32 FFMA.  The table
// (float32, built in float64 on the host) is [c11 At (k^2, row-major),
// w (k), W2hi (M), W2lo (M)].  Fields are (k, k, k, E), element axis last.
//
// Design: the columns layout of the general pair kernels
// (stiffness3d_pair_columns.cuh: CongruentLayout, pair_congruent_kernel).
// All k slabs of a block's tile of 8 G elements are the columns of one
// product, so each A2 fragment a warp loads feeds its k n8 fragments, and a
// thread holds every slab at its points, where it forms the W2 products
// and the chain from the field it loaded there (straight from device
// memory, evict-first, as its stores are) with no exchange.  Persistent
// blocks (cuda_stiffness3d.pair_columns_grid) load the next unit's field
// while A2 multiplies the current one; a ring of two field operands leaves
// one barrier per unit.  Shared memory: the table, A2's split (2 Mp (Mp +
// 8) bf16) and the ring (4 Mp ldB bf16): 87 KB at k = 8, 131 KB at k = 10,
// one block of 8 (k = 10: 7) warps per SM.  (The slab-tile version this
// replaces, 32 elements a block split whole before its first product and
// one fragment product per slab, took 73.4 us at 16^3 elements, order 7,
// C = 3 on an H100 at 700 W; its first version with scalar field loads
// 103.8 us.)
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s dense bf16) at 16^3
// elements, order 7, C = 3, float32: 2 C k^3 E 4 B = 50.3 MB, 15.02 us;
// tensor-core operations 6 k^5 E C = 2.4 GFLOP, 2.4 us.  Memory sets the
// bound.  (The FP32 FFMA version that preceded this class took 71.7 us.)

#include "stiffness3d_pair_columns.cuh"

namespace {

using pair_columns::CongruentLayout;
using pair_columns::pair_congruent_kernel;
using pair_columns::Pointers;

template <int K>
int launch_k(const __nv_bfloat16* a2, const float* table,
             const Pointers& ptrs, int num_c, int num_e, bool vec, int grid,
             cudaStream_t stream) {
  using L = CongruentLayout<K>;
  static const int attr =
      split_bf16::allow_smem(pair_congruent_kernel<K>, L::kSmem);
  if (attr != 0) return attr;
  pair_congruent_kernel<K><<<grid, L::kThreads, L::kSmem, stream>>>(
      a2, table, ptrs, num_c, num_e, vec);
  return static_cast<int>(cudaGetLastError());
}

// out = [tile_e, threads, shared bytes, resident blocks per SM].
template <int K>
int layout_k(int* out) {
  using L = CongruentLayout<K>;
  const int attr = split_bf16::allow_smem(pair_congruent_kernel<K>, L::kSmem);
  if (attr != 0) return attr;
  out[0] = L::kTE;
  out[1] = L::kThreads;
  out[2] = L::kSmem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], pair_congruent_kernel<K>, L::kThreads, L::kSmem));
}

template <int K = pair_columns::kMinK>
int dispatch(int k, const __nv_bfloat16* a2, const float* table,
             const Pointers* ptrs, int num_c, int num_e, bool vec, int grid,
             cudaStream_t stream, int* layout_out) {
  if constexpr (K > pair_columns::kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k == K) {
      if (layout_out != nullptr) return layout_k<K>(layout_out);
      return launch_k<K>(a2, table, *ptrs, num_c, num_e, vec, grid, stream);
    }
    return dispatch<K + 1>(k, a2, table, ptrs, num_c, num_e, vec, grid,
                           stream, layout_out);
  }
}

}  // namespace

// a2: (2, Mp, Mp) bf16 [hi, lo]; table: float32 (3 k^2 + k); us, outs:
// (k, k, k, num_e) float32; k = order + 1 in [2, 10]; `grid` persistent
// blocks walk the tiles (cuda_stiffness3d.pair_columns_grid).
extern "C" int stiffness3d_pair_f32(const void* a2, const void* table,
                                    const void* const* us, void* const* outs,
                                    int num_c, int k, int num_e, int grid,
                                    void* stream) {
  if (num_c < 1 || num_c > pair_columns::kMaxComponents ||
      k < pair_columns::kMinK || k > pair_columns::kMaxK || num_e < 0 ||
      grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_e == 0) return static_cast<int>(cudaGetLastError());
  Pointers ptrs = {};
  // 8-byte loads and stores where every row of every field is aligned.
  bool vec = num_e % 2 == 0;
  for (int c = 0; c < num_c; ++c) {
    ptrs.u[c] = static_cast<const float*>(us[c]);
    ptrs.out[c] = static_cast<float*>(outs[c]);
    vec = vec && reinterpret_cast<uintptr_t>(us[c]) % 8 == 0 &&
          reinterpret_cast<uintptr_t>(outs[c]) % 8 == 0;
  }
  return dispatch(k, static_cast<const __nv_bfloat16*>(a2),
                  static_cast<const float*>(table), &ptrs, num_c, num_e, vec,
                  grid, static_cast<cudaStream_t>(stream), nullptr);
}

// The congruent kernel's geometry at k: out = [tile_e, threads, shared
// bytes, resident blocks per SM on the current device].
extern "C" int stiffness3d_pair_layout(int k, int* out) {
  return dispatch(k, nullptr, nullptr, nullptr, 0, 0, false, 0, nullptr, out);
}
