// Affine-element 2D stiffness: out_c = c11 M11 u_c + c12 M12 u_c + c22 M22 u_c
// with per-element metric scalars c (3, E), for every component c.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness.py:stiffness_el_pallas_affine
// (_kernel_affine_mm, precision 'highest').  On affine elements
// G_ab(q, e) = w(q) c_ab(e), so the element operator is a per-element
// combination of three static (k^2, k^2) matrices, stacked as
// mstack = [M11; M12; M22] (3 k^2, k^2), built in float64 on the host, cast
// to the working dtype and passed here as its transposed, padded layout
// (`cuda_stiffness.operator_layout`).  The TPU kernel writes y = mstack @ u
// and combines it afterwards; here the combination is fused into the
// epilogue of the static-operator design of stiffness2d_fp32.cuh (three
// operators), so y never reaches memory.  Its note gives the work
// decomposition and the bound.

#include "stiffness2d_fp32.cuh"

extern "C" int stiffness2d_affine_f32(const void* mstack_t, const void* caff,
                                      const void* const* us, void* const* outs,
                                      int num_c, int k2, int num_e, int panels,
                                      int rows, int splits, int blocks,
                                      void* stream) {
  return stiffness2d_fp32::launch<float, 3>(mstack_t, caff, us, outs, num_c,
                                            k2, num_e, panels, rows, splits,
                                            blocks, stream);
}

extern "C" int stiffness2d_affine_f64(const void* mstack_t, const void* caff,
                                      const void* const* us, void* const* outs,
                                      int num_c, int k2, int num_e, int panels,
                                      int rows, int splits, int blocks,
                                      void* stream) {
  return stiffness2d_fp32::launch<double, 3>(mstack_t, caff, us, outs, num_c,
                                             k2, num_e, panels, rows, splits,
                                             blocks, stream);
}
