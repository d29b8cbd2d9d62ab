// Congruent-element 3D stiffness in pair-axis form, for C <= 4 components.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness3d.py:stiffness3d_el_pallas_pair
// (_kernel_3d_pair).  With the (eta, zeta) pair merged into one axis of
// k^2 entries, a field is k xi-slabs u[a] of shape (k^2, E), and on an
// axis-aligned box of identical elements
//
//   out[a] = w_a (A2 u[a]) + c11 sum_b At[a, b] (W2 u[b]),
//   A2 = c22 At (x) W + c33 W (x) At   (k^2, k^2),   W2 = diag(w (x) w),
//
// with At = D^T W D and W = diag(w).  A2 is applied as the dense matrix it
// is; W2 is diagonal and At is (k, k), and they are applied as such.  The
// static coefficients come as one table built in float64 on the host and cast
// to the working dtype: [A2^T (k^4, row-major), c11 At (k^2), w (k),
// w (x) w (k^2)].  Fields are (k, k, k, E), element axis last.
//
// Design (exact in the working precision: FFMA, no TF32).  A block owns a
// tile of TE consecutive elements (32 in float32, 16 in float64) of one
// component (blockIdx.y) and stages the table (16.6 KB at order 7) and the
// (k^3, TE) u tile (64 KB) in shared memory.  A thread owns ONE element and
// kRows = 4 pair rows for ALL k slabs: 4 k accumulators.  The element is the
// fastest thread index, so a warp shares its pair rows: per contraction
// index j it reads 4 entries of A2^T (one address for the whole warp: a
// broadcast) and k entries of u (32 consecutive words: no bank conflict) and
// issues 4 k FMAs, 12 shared-memory wavefronts for 32 FMA instructions.  The
// xi chain then runs on the thread's own columns of the tile, one row at a
// time.  The block is ceil(k^2 / 4) TE threads (512 at order 7), held to 64
// registers up to order 7 so that two blocks share an SM and one's loads
// and stores overlap the other's arithmetic.  (A first version gave a
// thread one row and a 16-byte vector of elements, 8 vector loads per 32
// FMAs: 93.6 us against this version's 71.7 us at 16^3 elements, order 7,
// C = 3, float32, on an H100 at 700 W.)  Tensor-core products of the
// (k^2, k^2) matrix are later work.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32) at 16^3 elements,
// order 7, C = 3, float32: 2 C k^3 E 4 B = 50.3 MB, 15.0 us; (2 k^2 + 2 k + 3)
// flops per point, 0.925 GFLOP, 13.8 us.  Memory sets the bound.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxComponents = 4;
constexpr int kMinK = 2;
constexpr int kMaxK = 10;
constexpr int kRows = 4;  // pair rows per thread

struct Pointers {
  const void* u[kMaxComponents];
  void* out[kMaxComponents];
};

template <typename T, int K>
struct Layout {
  static constexpr int kTE = 128 / sizeof(T);  // elements per block
  static constexpr int kK2 = K * K;
  static constexpr int kRowGroups = (kK2 + kRows - 1) / kRows;
  static constexpr int kThreads = kRowGroups * kTE;
  static constexpr int kTable = kK2 * kK2 + kK2 + K + kK2;
  static constexpr int kTablePadded = (kTable + 3) & ~3;
  static constexpr size_t kSmem =
      (static_cast<size_t>(kTablePadded) + K * kK2 * kTE) * sizeof(T);
  static constexpr int kTablePasses = (kTable + kThreads - 1) / kThreads;
  static constexpr int kTilePasses = (K * kK2 * kTE + kThreads - 1) / kThreads;
  // Two blocks per SM where threads and shared memory allow it (order <= 7):
  // one block's loads and stores then overlap the other's arithmetic.
  static constexpr int kMinBlocks =
      (kThreads <= 512 && 2 * kSmem <= 220 * 1024) ? 2 : 1;
};

template <typename T, int K>
__global__ void
__launch_bounds__(Layout<T, K>::kThreads, Layout<T, K>::kMinBlocks)
stiffness3d_pair_kernel(const T* __restrict__ table, Pointers ptrs,
                        int num_e) {
  using L = Layout<T, K>;
  constexpr int TE = L::kTE;
  constexpr int K2 = L::kK2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);
  T* tile = tab + L::kTablePadded;  // tile[(a * K2 + pq) * TE + el]
  const T* a2t = tab;               // a2t[j * K2 + pq] = A2[pq][j]
  const T* cat = a2t + K2 * K2;     // cat[a * K + b] = c11 At[a][b]
  const T* w = cat + K2;
  const T* w2 = w + K;
  const T* __restrict__ u = static_cast<const T*>(ptrs.u[blockIdx.y]);
  T* __restrict__ out = static_cast<T*>(ptrs.out[blockIdx.y]);

  const int tid = threadIdx.x;
  const int el = tid % TE;
  const int pq0 = (tid / TE) * kRows;  // first pair row of this thread
  const long long e0 = static_cast<long long>(blockIdx.x) * TE;
  const bool live = e0 + el < num_e;

  // Staging loops of known length, unrolled: all of a thread's loads are in
  // flight at once instead of one round trip to device memory per pass.
#pragma unroll
  for (int it = 0; it < L::kTablePasses; ++it) {
    const int i = tid + it * L::kThreads;
    if (i < L::kTable) tab[i] = table[i];
  }
#pragma unroll
  for (int it = 0; it < L::kTilePasses; ++it) {
    const int idx = tid + it * L::kThreads;
    const int row = idx / TE;
    const long long e = e0 + idx % TE;
    if (idx < K * K2 * TE) {
      tile[idx] =
          e < num_e ? u[static_cast<long long>(row) * num_e + e] : T(0);
    }
  }
  __syncthreads();

  // Rows past k^2 (k^2 not a multiple of kRows) repeat the last one and are
  // not stored.
  int rows[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) rows[i] = min(pq0 + i, K2 - 1);

  // The pair product: acc[a][i] = (A2 u[a])[rows[i]] for every slab a.
  T acc[K][kRows];
#pragma unroll
  for (int a = 0; a < K; ++a) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[a][i] = T(0);
  }
#pragma unroll 2
  for (int j = 0; j < K2; ++j) {
    T coef[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) coef[i] = a2t[j * K2 + rows[i]];
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const T uv = tile[(a * K2 + j) * TE + el];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[a][i] = fma(coef[i], uv, acc[a][i]);
    }
  }

  // The xi chain on the thread's own columns, then the combination, one
  // pair row at a time (few live registers beside the accumulators).
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    T ub[K];
#pragma unroll
    for (int b = 0; b < K; ++b) ub[b] = tile[(b * K2 + rows[i]) * TE + el];
    const T w2r = w2[rows[i]];
#pragma unroll
    for (int a = 0; a < K; ++a) {
      T res = T(0);
#pragma unroll
      for (int b = 0; b < K; ++b) res = fma(cat[a * K + b], ub[b], res);
      if (live && pq0 + i < K2) {
        out[static_cast<long long>(a * K2 + pq0 + i) * num_e + e0 + el] =
            w[a] * acc[a][i] + w2r * res;
      }
    }
  }
}

template <typename T, int K>
int launch_k(const T* table, const Pointers& ptrs, int num_c, int num_e,
             cudaStream_t stream) {
  using L = Layout<T, K>;
  if (L::kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stiffness3d_pair_kernel<T, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((num_e + L::kTE - 1) / L::kTE, num_c);
  stiffness3d_pair_kernel<T, K>
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

extern "C" int stiffness3d_pair_f32(const void* table, const void* const* us,
                                    void* const* outs, int num_c, int k,
                                    int num_e, void* stream) {
  return launch<float>(table, us, outs, num_c, k, num_e, stream);
}

extern "C" int stiffness3d_pair_f64(const void* table, const void* const* us,
                                    void* const* outs, int num_c, int k,
                                    int num_e, void* stream) {
  return launch<double>(table, us, outs, num_c, k, num_e, stream);
}
