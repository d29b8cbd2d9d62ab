// General 2D sum-factorized stiffness on three factor fields, C <= 4
// components.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness.py:stiffness_el_pallas_batched
// (and stiffness_el_pallas, its C = 1 case; _kernel_rows_batched).  Per
// element and component, with u = u[a, b] and the symmetric geometric factor
// fields G_ab = w |J| (J^-1 J^-T)_ab:
//
//   ur = D_xi u,  us = D_eta u
//   fa = G11 ur + G12 us,  fb = G12 ur + G22 us
//   out = D_xi^T fa + D_eta^T fb.
//
// Fields are (k, k, E), element axis last.  The three factor fields are read
// from device memory ONCE for all C components, as the TPU kernel does.
//
// Design (simple and exact in the working precision: FFMA, no TF32).  A block
// owns TE consecutive elements (8 in float32, 4 in float64, so that the TE
// values of one node are one 32-byte sector) and has one thread per (a, b)
// node and element: k^2 TE threads, 512 at order 7.  Each thread keeps the
// three factor values of its node in registers for all components.  Per
// component, in two phases:
//   1. the thread stores u[a, b] into the shared tile; after a barrier it
//      forms ur and us from the tile (k-term contractions along the two
//      axes) and the two fluxes;
//   2. after a barrier the fluxes go to two shared tiles (the first reuses
//      the u tile), and after another out[a, b] = sum_q D[q,a] fa[q, b]
//      + sum_q D[q,b] fb[a, q] is written to memory.
// Rows of the tiles (one per a) are padded by TE entries so that the lines a
// warp reads across a row boundary fall on distinct banks.  wgmma, TMA and
// several elements per thread are later work.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32) at the datagen shape
// (E = 4096, order 8, C = 2, float32): (2C + 3) k^2 E 4 B = 9.3 MB, 2.8 us;
// C (8 k^3 + 6 k^2) E = 0.052 GFLOP, 0.8 us.  Memory sets the bound.  On the
// heated cavity (E = 144, order 7) both are under 0.1 us: the launch floor
// sets the time.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxComponents = 4;
constexpr int kFactors = 3;
constexpr int kMinK = 2;
constexpr int kMaxK = 10;

struct Pointers {
  const void* u[kMaxComponents];
  const void* g[kFactors];  // g11, g12, g22
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
  static constexpr int kRow = K * kTE + kTE;  // padded stride of one a-row
  static constexpr int kTile = K * kRow;
  static constexpr int kDPadded = (K * K + 3) & ~3;
  static constexpr size_t kSmem =
      (static_cast<size_t>(kDPadded) + 2 * kTile) * sizeof(T);
};

template <typename T, int K>
__global__ void __launch_bounds__(Layout<T, K>::kThreads)
stiffness2d_general_kernel(const T* __restrict__ dmat, Pointers ptrs,
                           int num_c, int num_e) {
  using L = Layout<T, K>;
  constexpr int TE = L::kTE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* d_s = reinterpret_cast<T*>(smem_raw);  // d_s[i * K + j] = D[i][j]
  T* fa = d_s + L::kDPadded;                // u tile, then the fa fluxes
  T* fb = fa + L::kTile;

  const int tid = threadIdx.x;
  const int el = tid % TE;
  const int node = tid / TE;  // a * K + b
  const int a = node / K;
  const int b = node - a * K;
  const long long e = static_cast<long long>(blockIdx.x) * TE + el;
  const bool live = e < num_e;
  const long long gidx = static_cast<long long>(node) * num_e + e;
  const int own = a * L::kRow + b * TE + el;

  for (int i = tid; i < K * K; i += L::kThreads) d_s[i] = dmat[i];
  T g[kFactors];
#pragma unroll
  for (int s = 0; s < kFactors; ++s) {
    g[s] = live ? static_cast<const T*>(ptrs.g[s])[gidx] : T(0);
  }

  for (int c = 0; c < num_c; ++c) {
    const T* __restrict__ u = static_cast<const T*>(ptrs.u[c]);
    fa[own] = live ? u[gidx] : T(0);
    __syncthreads();

    // Phase 1: reference derivatives and fluxes at the own node.
    T ur = T(0), us = T(0);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      ur = fma(d_s[a * K + q], fa[q * L::kRow + b * TE + el], ur);
      us = fma(d_s[b * K + q], fa[a * L::kRow + q * TE + el], us);
    }
    const T flux_a = g[0] * ur + g[1] * us;
    const T flux_b = g[1] * ur + g[2] * us;
    __syncthreads();  // every read of the u tile is done
    fa[own] = flux_a;
    fb[own] = flux_b;
    __syncthreads();

    // Phase 2: transposed derivatives.
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      acc = fma(d_s[q * K + a], fa[q * L::kRow + b * TE + el], acc);
      acc = fma(d_s[q * K + b], fb[a * L::kRow + q * TE + el], acc);
    }
    if (live) static_cast<T*>(ptrs.out[c])[gidx] = acc;
    __syncthreads();  // the next component overwrites the tiles
  }
}

template <typename T, int K>
int launch_k(const T* dmat, const Pointers& ptrs, int num_c, int num_e,
             cudaStream_t stream) {
  using L = Layout<T, K>;
  const int blocks = (num_e + L::kTE - 1) / L::kTE;
  stiffness2d_general_kernel<T, K>
      <<<blocks, L::kThreads, L::kSmem, stream>>>(dmat, ptrs, num_c, num_e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K = kMinK>
int dispatch(int k, const T* dmat, const Pointers& ptrs, int num_c, int num_e,
             cudaStream_t stream) {
  if constexpr (K > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k == K) return launch_k<T, K>(dmat, ptrs, num_c, num_e, stream);
    return dispatch<T, K + 1>(k, dmat, ptrs, num_c, num_e, stream);
  }
}

template <typename T>
int launch(const void* dmat, const void* const* us, const void* const* gs,
           void* const* outs, int num_c, int k, int num_e, void* stream) {
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
  for (int s = 0; s < kFactors; ++s) ptrs.g[s] = gs[s];
  return dispatch<T>(k, static_cast<const T*>(dmat), ptrs, num_c, num_e,
                     static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int stiffness2d_general_f32(const void* dmat, const void* const* us,
                                       const void* const* gs, void* const* outs,
                                       int num_c, int k, int num_e,
                                       void* stream) {
  return launch<float>(dmat, us, gs, outs, num_c, k, num_e, stream);
}

extern "C" int stiffness2d_general_f64(const void* dmat, const void* const* us,
                                       const void* const* gs, void* const* outs,
                                       int num_c, int k, int num_e,
                                       void* stream) {
  return launch<double>(dmat, us, gs, outs, num_c, k, num_e, stream);
}
