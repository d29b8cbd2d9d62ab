// Affine-element 2D stiffness in the split-bf16 classes, on the tensor
// cores: out_c = c11 M11 u_c + c12 M12 u_c + c22 M22 u_c with per-element
// metric scalars c (3, E), for every component c.
//
// Replaces the 'bf16x3' and 'default' classes of swirlfem_tpu/ops/
// pallas_stiffness.py:stiffness_el_pallas_affine (_kernel_affine_mm3, and
// _kernel_affine_mm at Precision.DEFAULT).  The stacked static operator
// [M11; M12; M22] (3 k^2, k^2) is split on the host into bf16 hi / lo, each
// of its three blocks padded to rows_pad rows (split_bf16_mma.cuh has the
// arithmetic and the layout); each component field is (k^2, E) float32,
// element axis last, and c is (3, E) float32.
//
// Design.  The TPU kernel writes y = mstack u (3 k^2 rows) into VMEM and
// combines it afterwards.  Here a block holds every operator row of the
// three blocks (BM = 128 >= k^2) for 32 element columns: 4 warps of 32 rows,
// each with THREE accumulator sets (M11 u, M12 u, M22 u) that share every B
// fragment of the split field.  The epilogue combines them in registers with
// the column's c11, c12, c22, (c11 y1 + c12 y2) + c22 y3 as the TPU kernel
// does, before one store, so y never reaches device memory.  The depth is
// walked in chunks of 16, so that the two stages of the three blocks'
// slices take 79 KB.  Components go to blockIdx.z.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at the datagen
// shape (E = 4096, order 8, C = 2), 3 passes: 3 x 2 x 3 x 81^2 x 4096 x 2 =
// 0.97 GFLOP, 0.98 us, against (2 C k^2 + 3) E 4 B + 2 x 288 x 96 x 2 B =
// 5.5 MB, 1.63 us: bytes bound it.  On the lid-driven cavity (E = 256,
// order 7) both are under 0.1 us and the launch sets the time.

#include "split_bf16_mma.cuh"

namespace {

using split_bf16::Operator;
using split_bf16::Pointers;

template <class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, Cfg::MIN_BLOCKS)
stiffness2d_affine_split_kernel(Operator op, const float* __restrict__ c_aff,
                                Pointers ptrs, int rows, int num_e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = blockIdx.x * Cfg::BN;
  split_bf16::Accumulators<Cfg> acc;
  split_bf16::block_product<Cfg>(op, ptrs.u[blockIdx.z], rows, num_e, 0, n0,
                                 reinterpret_cast<__nv_bfloat16*>(smem_raw),
                                 acc);
  float* __restrict__ out = ptrs.out[blockIdx.z];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < Cfg::NI; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + ni * 8 + 2 * t + j;
      if (col >= num_e) continue;
      const float c11 = c_aff[col];
      const float c12 = c_aff[num_e + col];
      const float c22 = c_aff[2 * num_e + col];
#pragma unroll
      for (int mi = 0; mi < Cfg::MI; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = warp * Cfg::WM + mi * 16 + g + 8 * half;
          if (row >= rows) continue;
          const int q = 2 * half + j;
          out[static_cast<long long>(row) * num_e + col] =
              __fadd_rn(__fadd_rn(__fmul_rn(c11, acc[0][mi][ni][q]),
                                  __fmul_rn(c12, acc[1][mi][ni][q])),
                        __fmul_rn(c22, acc[2][mi][ni][q]));
        }
      }
    }
  }
}

// BM (every row), BN, BK, warps (M x N), passes, operator blocks: chunks
// of 16 keep the three blocks' two stages at 79 KB.
template <int PASSES>
using Config = split_bf16::Config<128, 32, 16, 4, 1, PASSES, 3>;

template <int PASSES>
int launch(const Operator& op, const float* c_aff, const Pointers& ptrs,
           int num_c, int rows, int num_e, cudaStream_t stream) {
  using Cfg = Config<PASSES>;
  static_assert(Cfg::WARPS_N == 1, "the epilogue maps warps to rows");
  const int err = split_bf16::allow_smem(
      stiffness2d_affine_split_kernel<Cfg>, Cfg::kSmemBytes);
  if (err != 0) return err;
  const dim3 grid((num_e + Cfg::BN - 1) / Cfg::BN, 1, num_c);
  stiffness2d_affine_split_kernel<Cfg>
      <<<grid, Cfg::kThreads, Cfg::kSmemBytes, stream>>>(op, c_aff, ptrs,
                                                         rows, num_e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hi, lo: (3 rows_pad, depth_pad) bf16, rows_pad <= 128; c_aff: (3, num_e)
// float32; us, outs: num_c (rows, num_e) float32 fields (rows = k^2, the
// depth of the operator before padding).
extern "C" int stiffness2d_affine_split_f32(const void* hi, const void* lo,
                                            const void* c_aff,
                                            const void* const* us,
                                            void* const* outs, int num_c,
                                            int rows, int rows_pad,
                                            int depth_pad, int num_e,
                                            int passes, void* stream) {
  const int err = split_bf16::check_args(num_c, rows, rows, rows_pad,
                                         depth_pad, num_e);
  if (err != 0) return err;
  if ((passes != 1 && passes != 3) || rows_pad > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_e == 0) return static_cast<int>(cudaGetLastError());
  const Operator op = {static_cast<const __nv_bfloat16*>(hi),
                       static_cast<const __nv_bfloat16*>(lo), rows_pad,
                       depth_pad};
  Pointers ptrs = {};
  for (int c = 0; c < num_c; ++c) {
    ptrs.u[c] = static_cast<const float*>(us[c]);
    ptrs.out[c] = static_cast<float*>(outs[c]);
  }
  const float* c = static_cast<const float*>(c_aff);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return passes == 3 ? launch<3>(op, c, ptrs, num_c, rows, num_e, s)
                     : launch<1>(op, c, ptrs, num_c, rows, num_e, s);
}
