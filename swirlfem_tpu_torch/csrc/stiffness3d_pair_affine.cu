// Affine-element 3D stiffness in pair-axis form, class bf16x3, C <= 4
// components.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness3d.py:
// stiffness3d_el_pallas_pair_affine (_kernel_3d_pair_affine, always
// bf16x3).  On elements that are (graded, sheared) parallelepipeds the
// Jacobian is constant per element and the six factor fields collapse to
//
//   G_ab(q, e) = w(q) C_ab(e),   w(q) = w_a w2[p],  w2 = w (x) w,
//
// so the kernel reads six scalars per ELEMENT, a (6, E) array with rows
// (c11, c12, c13, c22, c23, c33), in place of six (k, k, k, E) fields.  The
// quadrature weight is folded in as the JAX kernel folds it:
//
//   fa = c11 r + c12 s + c13 t                  (weight-free)
//   fb = w_a (c12 r + c22 s + c23 t),  fc likewise
//   pair = mm3(De^T diag(w2), fb) + mm3(Dz^T diag(w2), fc)
//   out[m] = pair[m] + w2 sum_a (D[a][m] w_a) fa[a],
//
// the products' transposes folded with diag(w2) in float64 on the host
// before their split, and table = [D (k^2), Dw (k^2) with Dw[a][m] =
// D[a][m] w_a, w (k), w2 (k^2)] in float32.  The pipeline is that of the
// general pair kernels on xi-slabs (stiffness3d_pair_columns.cuh: every
// slab of an element as columns of one product, persistent blocks,
// k = order + 1 in [2, 10]), with the affine flux, and the transposed
// product's A fragments read from device memory in mma.sync fragment order
// (the header says why).  A first version on a slab pipeline (one product
// per slab, two barriers a slab; k <= 8) took 149.98 us at 16^3 elements,
// order 7, C = 3 on an H100 at 700 W.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s dense bf16) at 16^3
// elements, order 7, C = 3, float32: (2 C k^3 E + 6 E) 4 B = 50.4 MB,
// 15.05 us; tensor-core operations 24 k^5 E C = 9.66 GFLOP, 9.8 us.
// Memory sets the bound.

#include "stiffness3d_pair_columns.cuh"

// dp: (2, 2 Mp, Mp) bf16; at_frags: the split of T = [(D (x) I)^T W2,
// (I (x) D)^T W2] (2, Mp, 2 Mp) as mma.sync A fragments, (Mp / 16,
// 2 Mp / 16, 2, 32, 4) int32; table: float32 (3 k^2 + k); c_affine:
// (6, num_e) float32; us, outs: (k, k, k, num_e) float32; grid: persistent
// blocks.
extern "C" int stiffness3d_pair_affine_f32(const void* dp,
                                           const void* at_frags,
                                           const void* table,
                                           const void* c_affine,
                                           const void* const* us,
                                           void* const* outs, int num_c, int k,
                                           int num_e, int grid, void* stream) {
  const void* gs[1] = {c_affine};
  return pair_columns::launch<pair_columns::kAffine>(
      dp, at_frags, table, us, gs, outs, num_c, k, num_e, grid, stream);
}

// The kernel's geometry at k: out = [tile_e, threads, shared bytes, resident
// blocks per SM on the current device].
extern "C" int stiffness3d_pair_affine_layout(int k, int* out) {
  return pair_columns::layout<pair_columns::kAffine>(k, out);
}
