// General 3D stiffness on six factor fields in pair-axis form, C <= 4
// components.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness3d.py:
// stiffness3d_el_pallas_pair_general (_kernel_3d_pair_general): the operator
// sum_ab D_a^T (G_ab D_b u) of stiffness3d_general.cu, organised by xi-slabs
// with the (eta, zeta) pair merged into one axis.  The slab pipeline, its
// design and its barriers are described in stiffness3d_pair_slab.cuh; here
// the metric is six symmetric factor fields G_ab = w |J| (J^-1 J^-T)_ab,
// each (k, k, k, E), read from device memory ONCE for all components, and the
// static table is the (k, k) differentiation matrix D.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32) at 16^3 elements,
// order 7, C = 3, float32: (2 C + 6) k^3 E 4 B = 100.7 MB, 30.0 us; the
// sum-factorized count (12 k + 17) flops per point and component, 0.711
// GFLOP, 10.6 us.  Memory sets the bound.

#include "stiffness3d_pair_slab.cuh"

extern "C" int stiffness3d_pair_general_f32(const void* dmat,
                                            const void* const* us,
                                            const void* const* gs,
                                            void* const* outs, int num_c,
                                            int k, int num_e, void* stream) {
  return pair_slab::launch<float, false>(dmat, us, gs, outs, num_c, k, num_e,
                                         stream);
}

extern "C" int stiffness3d_pair_general_f64(const void* dmat,
                                            const void* const* us,
                                            const void* const* gs,
                                            void* const* outs, int num_c,
                                            int k, int num_e, void* stream) {
  return pair_slab::launch<double, false>(dmat, us, gs, outs, num_c, k, num_e,
                                          stream);
}
