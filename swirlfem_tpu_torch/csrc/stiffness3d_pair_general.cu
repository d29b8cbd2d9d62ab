// General 3D stiffness on six factor fields in pair-axis form, class
// bf16x3, C <= 4 components.
//
// Replaces three functions of swirlfem_tpu/ops/pallas_stiffness3d.py, all
// always bf16x3:
//   stiffness3d_el_pallas_pair_general (_kernel_3d_pair_general): xi-slabs
//     of the (eta, zeta) pair;
//   stiffness3d_el_pallas_pairs_general (_kernel_3d_pairs_general): the
//     same products with S = 2 or 4 slabs stacked into block-diagonal
//     operators for the TPU's matrix unit; the off-diagonal blocks add
//     exact zeros and the field split is elementwise, so it computes
//     pair_general's products bit for bit and runs this kernel;
//   stiffness3d_el_pallas_pairz_general (_kernel_3d_pairz_general):
//     zeta-slabs of the (xi, eta) pair, the zeta derivative and its
//     transpose as FP32 chains.
// The pipeline, its design and its counts are described in
// stiffness3d_pair_columns.cuh (every slab of an element as columns of one
// product; k = order + 1 in [2, 10]); the metric is the six symmetric
// factor fields G_ab = w |J| (J^-1 J^-T)_ab, each (k, k, k, E) float32, and
// the table is the (k, k) differentiation matrix D in float32.  Both
// layouts take the same split operator DP = [D (x) I; I (x) D]; the
// transposed stage reads its two transposes from it.  The superslab
// kernels' k % S == 0 is the caller's to hold (ops/sem3d.py), as the JAX
// package asserts it.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s dense bf16) at 16^3
// elements, order 7, C = 3, float32: (2 C + 6) k^3 E 4 B = 100.7 MB,
// 30.05 us; tensor-core operations 24 k^5 E C = 9.66 GFLOP (three passes
// of the (2k^2, k^2) and two (k^2, k^2) products), 9.8 us.  Memory sets
// the bound.

#include "stiffness3d_pair_columns.cuh"

// dp: (2, 2 Mp, Mp) bf16; dmat: (k, k) float32; us, gs (6), outs:
// (k, k, k, num_e) float32; grid: persistent blocks.
extern "C" int stiffness3d_pair_general_f32(const void* dp, const void* dmat,
                                            const void* const* us,
                                            const void* const* gs,
                                            void* const* outs, int num_c,
                                            int k, int num_e, int grid,
                                            void* stream) {
  return pair_columns::launch<pair_columns::kXi>(
      dp, nullptr, dmat, us, gs, outs, num_c, k, num_e, grid, stream);
}

extern "C" int stiffness3d_pairz_general_f32(const void* dp,
                                             const void* dmat,
                                             const void* const* us,
                                             const void* const* gs,
                                             void* const* outs, int num_c,
                                             int k, int num_e, int grid,
                                             void* stream) {
  return pair_columns::launch<pair_columns::kZetaSlabs>(
      dp, nullptr, dmat, us, gs, outs, num_c, k, num_e, grid, stream);
}

// The kernels' geometry at k (zeta: the pairz kernel): out = [tile_e,
// threads, shared bytes, resident blocks per SM on the current device].
extern "C" int stiffness3d_pair_columns_layout(int k, int zeta, int* out) {
  return zeta ? pair_columns::layout<pair_columns::kZetaSlabs>(k, out)
              : pair_columns::layout<pair_columns::kXi>(k, out);
}
