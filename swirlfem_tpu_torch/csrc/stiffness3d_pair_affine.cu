// Affine-element 3D stiffness in pair-axis form, C <= 4 components.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness3d.py:
// stiffness3d_el_pallas_pair_affine (_kernel_3d_pair_affine).  On elements
// that are (graded, sheared) parallelepipeds the Jacobian is constant per
// element and the six factor fields collapse to
//
//   G_ab(q, e) = w(q) C_ab(e),   w(q) = w_a w2[pq],  w2 = w (x) w,
//
// so the kernel reads six scalars per ELEMENT, a (6, E) array with rows
// (c11, c12, c13, c22, c23, c33), in place of six (k, k, k, E) fields.  The
// slab pipeline is that of stiffness3d_pair_slab.cuh; the quadrature weight
// is folded in statically, from a table built in float64 on the host:
//
//   fa = c11 r + c12 s + c13 t                  (weight-free)
//   fb = w_a w2 (c12 r + c22 s + c23 t),  fc likewise
//   out[m] = pair[m] + w2 sum_a (D[a][m] w_a) fa[a],
//
// table = [D (k^2), Dw (k^2) with Dw[a][m] = D[a][m] w_a, w (k), w2 (k^2)].
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32) at 16^3 elements,
// order 7, C = 3, float32: (2 C k^3 E + 6 E) 4 B = 50.4 MB, 15.1 us; the
// sum-factorized count (12 k + 20) flops per point and component, 0.730
// GFLOP, 10.9 us.  Memory sets the bound.

#include "stiffness3d_pair_slab.cuh"

extern "C" int stiffness3d_pair_affine_f32(const void* table,
                                           const void* c_affine,
                                           const void* const* us,
                                           void* const* outs, int num_c, int k,
                                           int num_e, void* stream) {
  const void* gs[1] = {c_affine};
  return pair_slab::launch<float, true>(table, us, gs, outs, num_c, k, num_e,
                                        stream);
}

extern "C" int stiffness3d_pair_affine_f64(const void* table,
                                           const void* c_affine,
                                           const void* const* us,
                                           void* const* outs, int num_c, int k,
                                           int num_e, void* stream) {
  const void* gs[1] = {c_affine};
  return pair_slab::launch<double, true>(table, us, gs, outs, num_c, k, num_e,
                                         stream);
}
