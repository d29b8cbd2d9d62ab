// Congruent-element 2D stiffness: out_c = A @ u_c for every component c.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness.py:stiffness_el_pallas_uniform
// (_kernel_uniform_mm, precision 'highest').  On a box whose elements all
// share the same metric scalars, the element stiffness is one static dense
// (k^2, k^2) matrix A = c11 M11 + c12 M12 + c22 M22, built in float64 on the
// host and cast to the working dtype, and passed here as its transposed,
// padded layout (`cuda_stiffness.operator_layout`).  The kernel is the
// static-operator design of stiffness2d_fp32.cuh with one operator; its
// note gives the work decomposition and the bound.

#include "stiffness2d_fp32.cuh"

extern "C" int stiffness_uniform_f32(const void* amat_t, const void* const* us,
                                     void* const* outs, int num_c, int k2,
                                     int num_e, int panels, int rows,
                                     int splits, int blocks, void* stream) {
  return stiffness2d_fp32::launch<float, 1>(amat_t, nullptr, us, outs, num_c,
                                            k2, num_e, panels, rows, splits,
                                            blocks, stream);
}

extern "C" int stiffness_uniform_f64(const void* amat_t, const void* const* us,
                                     void* const* outs, int num_c, int k2,
                                     int num_e, int panels, int rows,
                                     int splits, int blocks, void* stream) {
  return stiffness2d_fp32::launch<double, 1>(amat_t, nullptr, us, outs, num_c,
                                             k2, num_e, panels, rows, splits,
                                             blocks, stream);
}
