// Congruent-element 3D stiffness, sum-factorized, for C <= 4 components.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness3d.py:stiffness3d_el_pallas_uniform
// (_kernel_3d_uniform).  On an axis-aligned box of identical elements the
// element operator is
//
//   A = c11 (At x W x W) + c22 (W x At x W) + c33 (W x W x At),
//   At = D^T W D,  W = diag(w),
//
// so no geometric factor field is read.  Per element, with u = u[m, q, r]:
//
//   out[m,q,r] = w_r (c11 w_q sum_a At[m,a] u[a,q,r]
//                     + c22 w_m sum_b At[q,b] u[m,b,r])
//                + c33 w_m w_q sum_c At[r,c] u[m,q,c].
//
// The coefficients (At, w, c11 w, c22 w, c33 w w^T) come as one small table
// computed in float64 on the host and cast to the working dtype.  Fields are
// (k, k, k, E), element axis last.
//
// Design (simple and exact in the working precision: FFMA, no TF32).  A block
// owns a tile of TE consecutive elements (8 in float32, 4 in float64) of one
// component (blockIdx.y) and has one thread per (m, q) node line and element:
// k^2 TE threads, 512 at order 7.  Each thread loads its own line
// u[m, q, 0..k-1] from device memory (for a fixed r, a warp reads 4 rows of
// 32 consecutive bytes: full sectors), stores it into the shared tile, and
// after one barrier computes its k outputs from the three k-term
// contractions.  Lines are padded by TE entries in shared memory so that the
// 4 lines a warp reads fall on distinct banks.  At 16^3 elements there are
// 4096 elements but 786,432 (line, element, component) threads, so all SMs
// are busy.  wgmma, TMA and a persistent grid are later work.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32) at 16^3 elements,
// order 7, C = 3, float32: 2 C k^3 E 4 B = 50.3 MB in and out, 15.0 us;
// 0.654 GFLOP (the count of bench.py:_stiffness_counts), 9.8 us.  Memory
// sets the bound.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxComponents = 4;
constexpr int kMinK = 2;
constexpr int kMaxK = 10;

struct Pointers {
  const void* u[kMaxComponents];
  void* out[kMaxComponents];
};

template <typename T>
struct TileE;
template <>
struct TileE<float> {
  static constexpr int value = 8;
};
template <>
struct TileE<double> {
  static constexpr int value = 4;
};

template <typename T, int K>
struct Layout {
  static constexpr int kTE = TileE<T>::value;
  static constexpr int kThreads = K * K * kTE;
  static constexpr int kLine = K * kTE + kTE;  // padded (m, q) line stride
  static constexpr int kTable = 2 * K * K + 3 * K;
  static constexpr int kTablePadded = (kTable + 3) & ~3;
  static constexpr size_t kSmem =
      (static_cast<size_t>(kTablePadded) + K * K * kLine) * sizeof(T);
};

template <typename T, int K>
__global__ void __launch_bounds__(Layout<T, K>::kThreads)
stiffness3d_uniform_kernel(const T* __restrict__ table, Pointers ptrs,
                           int num_e) {
  using L = Layout<T, K>;
  constexpr int TE = L::kTE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);
  T* tile = tab + L::kTablePadded;
  const T* __restrict__ u = static_cast<const T*>(ptrs.u[blockIdx.y]);
  T* __restrict__ out = static_cast<T*>(ptrs.out[blockIdx.y]);

  const int tid = threadIdx.x;
  const int el = tid % TE;
  const int line = tid / TE;  // m * K + q
  const int m = line / K;
  const int q = line - m * K;
  const long long e = static_cast<long long>(blockIdx.x) * TE + el;
  const bool live = e < num_e;

  for (int i = tid; i < L::kTable; i += L::kThreads) tab[i] = table[i];
  T ul[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    ul[r] = live ? u[static_cast<long long>(line * K + r) * num_e + e] : T(0);
    tile[line * L::kLine + r * TE + el] = ul[r];
  }
  __syncthreads();

  const T* at = tab;
  const T* w = tab + K * K;
  const T* cw1 = w + K;
  const T* cw2 = cw1 + K;
  const T* cw3 = cw2 + K;
  T acc1[K], acc2[K], acc3[K];
#pragma unroll
  for (int r = 0; r < K; ++r) acc1[r] = acc2[r] = acc3[r] = T(0);
#pragma unroll
  for (int a = 0; a < K; ++a) {
    const T am = at[m * K + a];
    const T aq = at[q * K + a];
    const T* ua = tile + (a * K + q) * L::kLine + el;  // line (a, q)
    const T* ub = tile + (m * K + a) * L::kLine + el;  // line (m, a)
#pragma unroll
    for (int r = 0; r < K; ++r) {
      acc1[r] = fma(am, ua[r * TE], acc1[r]);
      acc2[r] = fma(aq, ub[r * TE], acc2[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < K; ++r) {
#pragma unroll
    for (int c = 0; c < K; ++c) acc3[r] = fma(at[r * K + c], ul[c], acc3[r]);
  }
  if (!live) return;
  const T c1 = cw1[q];
  const T c2 = cw2[m];
  const T c3 = cw3[m * K + q];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    out[static_cast<long long>(line * K + r) * num_e + e] =
        w[r] * (c1 * acc1[r] + c2 * acc2[r]) + c3 * acc3[r];
  }
}

template <typename T, int K>
int launch_k(const T* table, const Pointers& ptrs, int num_c, int num_e,
             cudaStream_t stream) {
  using L = Layout<T, K>;
  if (L::kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stiffness3d_uniform_kernel<T, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((num_e + L::kTE - 1) / L::kTE, num_c);
  stiffness3d_uniform_kernel<T, K>
      <<<grid, L::kThreads, L::kSmem, stream>>>(table, ptrs, num_e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K = kMinK>
int dispatch(int k, const T* table, const Pointers& ptrs, int num_c, int num_e,
             cudaStream_t stream) {
  if constexpr (K > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k == K) return launch_k<T, K>(table, ptrs, num_c, num_e, stream);
    return dispatch<T, K + 1>(k, table, ptrs, num_c, num_e, stream);
  }
}

template <typename T>
int launch(const void* table, const void* const* us, void* const* outs,
           int num_c, int k, int num_e, void* stream) {
  if (num_c < 1 || num_c > kMaxComponents || k < kMinK || k > kMaxK ||
      num_e < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_e == 0) return static_cast<int>(cudaGetLastError());
  Pointers ptrs = {};
  for (int c = 0; c < num_c; ++c) {
    ptrs.u[c] = us[c];
    ptrs.out[c] = outs[c];
  }
  return dispatch<T>(k, static_cast<const T*>(table), ptrs, num_c, num_e,
                     static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int stiffness3d_uniform_f32(const void* table, const void* const* us,
                                       void* const* outs, int num_c, int k,
                                       int num_e, void* stream) {
  return launch<float>(table, us, outs, num_c, k, num_e, stream);
}

extern "C" int stiffness3d_uniform_f64(const void* table, const void* const* us,
                                       void* const* outs, int num_c, int k,
                                       int num_e, void* stream) {
  return launch<double>(table, us, outs, num_c, k, num_e, stream);
}
