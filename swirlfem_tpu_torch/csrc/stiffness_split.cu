// Congruent-element 2D stiffness in the split-bf16 classes: out_c = A u_c
// for every component c, on the tensor cores.
//
// Replaces the 'bf16x3' and 'default' classes of swirlfem_tpu/ops/
// pallas_stiffness.py:stiffness_el_pallas_uniform (_kernel_uniform_mm3, and
// _kernel_uniform_mm at Precision.DEFAULT).  A is the static (k^2, k^2)
// operator of a congruent 2D box, split on the host into bf16 hi / lo
// (split_bf16_mma.cuh has the arithmetic); each component field is (k^2, E)
// float32, element axis last.  (The 3D dense operator's 'bf16x3' class is
// stiffness3d_dense_split.cu's.)
//
// Design (split_bf16_mma.cuh has the block product): a block holds every
// operator row (BM = 128, so k^2 <= 128) and 32 element columns, 4 warps of
// 32 rows each; the depth (96 at order 8) is walked in chunks of 32.  At the
// datagen shape (E = 4096, C = 2) that is 256 blocks for the 132 SMs.
// Components go to blockIdx.z: one launch for all of them.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at the datagen
// shape, 3 passes: 3 x 2 x 81^2 x 4096 x 2 = 0.32 GFLOP, 0.33 us, against
// (2 C k^2 E 4 + 2 x 96^2 x 2) B = 5.3 MB, 1.60 us: bytes bound it, and the
// launch sets the time.  The design keeps the field split in registers and
// shared memory (hi / lo never reach device memory) and reuses every B
// fragment for all passes.

#include "split_bf16_mma.cuh"

namespace {

using split_bf16::Operator;
using split_bf16::Pointers;

template <class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, Cfg::MIN_BLOCKS)
stiffness_split_kernel(Operator op, Pointers ptrs, int rows, int depth,
                       int num_e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * Cfg::BM;
  const int n0 = blockIdx.x * Cfg::BN;
  split_bf16::Accumulators<Cfg> acc;
  split_bf16::block_product<Cfg>(op, ptrs.u[blockIdx.z], depth, num_e, m0,
                                 n0,
                                 reinterpret_cast<__nv_bfloat16*>(smem_raw),
                                 acc);
  float* __restrict__ out = ptrs.out[blockIdx.z];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < Cfg::MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row =
          m0 + (warp / Cfg::WARPS_N) * Cfg::WM + mi * 16 + g + 8 * half;
      if (row >= rows) continue;
#pragma unroll
      for (int ni = 0; ni < Cfg::NI; ++ni) {
        const int col =
            n0 + (warp % Cfg::WARPS_N) * Cfg::WN + ni * 8 + 2 * t;
        float* dst = out + static_cast<long long>(row) * num_e + col;
        if (col < num_e) dst[0] = acc[0][mi][ni][2 * half];
        if (col + 1 < num_e) dst[1] = acc[0][mi][ni][2 * half + 1];
      }
    }
  }
}

template <class Cfg>
int launch(const Operator& op, const Pointers& ptrs, int num_c, int rows,
           int depth, int num_e, cudaStream_t stream) {
  const int err = split_bf16::allow_smem(stiffness_split_kernel<Cfg>,
                                         Cfg::kSmemBytes);
  if (err != 0) return err;
  const dim3 grid((num_e + Cfg::BN - 1) / Cfg::BN,
                  (op.rows_pad + Cfg::BM - 1) / Cfg::BM, num_c);
  stiffness_split_kernel<Cfg><<<grid, Cfg::kThreads, Cfg::kSmemBytes,
                                stream>>>(op, ptrs, rows, depth, num_e);
  return static_cast<int>(cudaGetLastError());
}

// BM, BN, BK, warps (M x N), passes, operator blocks.
template <int PASSES>
using Config2D = split_bf16::Config<128, 32, 32, 4, 1, PASSES, 1>;

}  // namespace

// hi, lo: (rows_pad, depth_pad) bf16, rows_pad <= 128; us, outs: num_c
// (rows, num_e) float32 fields (rows == depth: the operator is square before
// padding).
extern "C" int stiffness_uniform_split_f32(const void* hi, const void* lo,
                                           const void* const* us,
                                           void* const* outs, int num_c,
                                           int rows, int rows_pad,
                                           int depth_pad, int num_e,
                                           int passes, void* stream) {
  const int err = split_bf16::check_args(num_c, rows, rows, rows_pad,
                                         depth_pad, num_e);
  if (err != 0) return err;
  if ((passes != 1 && passes != 3) || rows_pad > Config2D<1>::BM) {
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return passes == 3
             ? launch<Config2D<3>>(op, ptrs, num_c, rows, rows, num_e, s)
             : launch<Config2D<1>>(op, ptrs, num_c, rows, rows, num_e, s);
}
