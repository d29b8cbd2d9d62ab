// The slab pipeline shared by the pair-axis general and affine 3D stiffness
// kernels (stiffness3d_pair_general.cu, stiffness3d_pair_affine.cu).
//
// With the (eta, zeta) pair merged into one axis pq = q k + r, a field is k
// xi-slabs u[a] of shape (k^2, E).  Per slab a and component:
//
//   [s; t] = DP u[a],   DP = [D (x) I; I (x) D]     (eta and zeta derivatives)
//   r      = sum_m D[a, m] u[m]                      (xi chain)
//   (fa, fb, fc) = G(a) (r, s, t)                    (pointwise flux)
//   pair[a] = (D (x) I)^T fb + (I (x) D)^T fc        (transposed pair stage)
//   out[m]  = pair[m] + sum_a D[a, m] fa[a]          (transposed xi chain)
//
// DP and its transposes are Kronecker products with the identity: every row
// has k non-zeros, and they are applied as such.
//
// Design (exact in the working precision: FFMA, no TF32).  A block owns TE
// consecutive elements (8 in float32, 4 in float64) and has one thread per
// pair row pq and element: k^2 TE threads, 512 at order 7.  A thread keeps
// its own xi column of u (k values), the fluxes fa (k values) and the pair
// results (k values) in registers; the metric of its k points stays in
// registers for all components (general: 6 k factor values, read from device
// memory once per call; affine: six scalars of its element and k weights).
// Per component the block stores the (k^3, TE) u tile in shared memory, then
// walks the slabs: each thread forms s and t from the tile (two k-term
// contractions along q and r), r from its registers, the fluxes; fb and fc
// go to one of two shared slab buffers, and after ONE barrier the transposed
// pair stage reads them back (the other buffer takes the next slab
// meanwhile).  The element index is the fastest thread index, so tile rows
// are read without bank conflicts and no padding is needed.
//
// Why one barrier per slab is enough: slab a writes buffer a & 1 after the
// barrier of slab a - 1, which every reader of that buffer (slab a - 2) had
// to pass first; a component's tile is overwritten only after the last
// slab's barrier, which follows every thread's last tile read.

#ifndef SWIRLFEM_STIFFNESS3D_PAIR_SLAB_CUH_
#define SWIRLFEM_STIFFNESS3D_PAIR_SLAB_CUH_

#include <cuda_runtime.h>

namespace pair_slab {

constexpr int kMaxComponents = 4;
constexpr int kFactors = 6;
constexpr int kMinK = 2;
constexpr int kMaxK = 10;

struct Pointers {
  const void* u[kMaxComponents];
  // General: the six factor fields g11, g12, g13, g22, g23, g33, each
  // (k, k, k, E).  Affine: g[0] is the (6, E) coefficient array.
  const void* g[kFactors];
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

// The static table.  General: [D (k^2)].  Affine: [D (k^2), Dw (k^2) with
// Dw[a][m] = D[a][m] w_a, w (k), w (x) w (k^2)].
template <typename T, int K, bool kAffine>
struct Layout {
  static constexpr int kTE = TileE<T>::value;
  static constexpr int kK2 = K * K;
  static constexpr int kThreads = kK2 * kTE;
  static constexpr int kTable = kAffine ? 3 * kK2 + K : kK2;
  static constexpr int kTablePadded = (kTable + 3) & ~3;
  static constexpr int kSlab = kK2 * kTE;
  static constexpr size_t kSmem =
      (static_cast<size_t>(kTablePadded) + (K + 4) * kSlab) * sizeof(T);
};

template <typename T, int K, bool kAffine>
__global__ void __launch_bounds__(Layout<T, K, kAffine>::kThreads)
pair_slab_kernel(const T* __restrict__ table, Pointers ptrs, int num_c,
                 int num_e) {
  using L = Layout<T, K, kAffine>;
  constexpr int TE = L::kTE;
  constexpr int K2 = L::kK2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);
  T* tile = tab + L::kTablePadded;  // tile[(a * K2 + pq) * TE + el]
  T* fb_s = tile + K * L::kSlab;    // two slab buffers of fb, then two of fc
  T* fc_s = fb_s + 2 * L::kSlab;
  const T* d_s = tab;               // d_s[i * K + j] = D[i][j]
  // Coefficients of the transposed xi chain: D, or Dw on affine elements.
  const T* xt_s = kAffine ? tab + K2 : tab;

  const int tid = threadIdx.x;
  const int el = tid % TE;
  const int pq = tid / TE;
  const int q = pq / K;
  const int r = pq - q * K;
  const long long e = static_cast<long long>(blockIdx.x) * TE + el;
  const bool live = e < num_e;
  const int own = pq * TE + el;

  for (int i = tid; i < L::kTable; i += L::kThreads) tab[i] = table[i];

  // The metric of this thread's k points.  General: g[s][a] = G_s(a, pq, e).
  // Affine: G_s(a, pq, e) = w_a w2[pq] c[s](e); the weights are applied to
  // the fluxes below.
  constexpr int kMetricDepth = kAffine ? 1 : K;
  T g[kFactors][kMetricDepth];
#pragma unroll
  for (int s = 0; s < kFactors; ++s) {
    if constexpr (kAffine) {
      const T* __restrict__ c = static_cast<const T*>(ptrs.g[0]);
      g[s][0] = live ? c[static_cast<long long>(s) * num_e + e] : T(0);
    } else {
      const T* __restrict__ gs = static_cast<const T*>(ptrs.g[s]);
#pragma unroll
      for (int a = 0; a < K; ++a) {
        g[s][a] =
            live ? gs[static_cast<long long>(a * K2 + pq) * num_e + e] : T(0);
      }
    }
  }
  __syncthreads();  // the table is staged
  T w2pq = T(1);
  if constexpr (kAffine) w2pq = tab[2 * K2 + K + pq];

  for (int c = 0; c < num_c; ++c) {
    const T* __restrict__ u = static_cast<const T*>(ptrs.u[c]);
    T ucol[K];
#pragma unroll
    for (int a = 0; a < K; ++a) {
      ucol[a] =
          live ? u[static_cast<long long>(a * K2 + pq) * num_e + e] : T(0);
      tile[a * L::kSlab + own] = ucol[a];
    }
    __syncthreads();

    T fa[K], pair[K];
#pragma unroll
    for (int a = 0; a < K; ++a) {
      // Eta and zeta derivatives from the tile, the xi chain from registers.
      T s = T(0), t = T(0), rr = T(0);
      const T* slab = tile + a * L::kSlab + el;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        s = fma(d_s[q * K + j], slab[(j * K + r) * TE], s);
        t = fma(d_s[r * K + j], slab[(q * K + j) * TE], t);
        rr = fma(d_s[a * K + j], ucol[j], rr);
      }
      T fbv, fcv;
      if constexpr (kAffine) {
        const T wq = tab[2 * K2 + a] * w2pq;  // w_a w2[pq]
        fa[a] = g[0][0] * rr + g[1][0] * s + g[2][0] * t;
        fbv = wq * (g[1][0] * rr + g[3][0] * s + g[4][0] * t);
        fcv = wq * (g[2][0] * rr + g[4][0] * s + g[5][0] * t);
      } else {
        fa[a] = g[0][a] * rr + g[1][a] * s + g[2][a] * t;
        fbv = g[1][a] * rr + g[3][a] * s + g[4][a] * t;
        fcv = g[2][a] * rr + g[4][a] * s + g[5][a] * t;
      }
      T* fb = fb_s + (a & 1) * L::kSlab;
      T* fc = fc_s + (a & 1) * L::kSlab;
      fb[own] = fbv;
      fc[own] = fcv;
      __syncthreads();
      // The transposed pair stage of this slab.
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        acc = fma(d_s[j * K + q], fb[(j * K + r) * TE + el], acc);
        acc = fma(d_s[j * K + r], fc[(q * K + j) * TE + el], acc);
      }
      pair[a] = acc;
    }

    // The transposed xi chain and the store.
    T* __restrict__ out = static_cast<T*>(ptrs.out[c]);
#pragma unroll
    for (int m = 0; m < K; ++m) {
      T x = T(0);
#pragma unroll
      for (int a = 0; a < K; ++a) x = fma(xt_s[a * K + m], fa[a], x);
      if (live) {
        out[static_cast<long long>(m * K2 + pq) * num_e + e] =
            kAffine ? pair[m] + w2pq * x : pair[m] + x;
      }
    }
  }
}

template <typename T, int K, bool kAffine>
int launch_k(const T* table, const Pointers& ptrs, int num_c, int num_e,
             cudaStream_t stream) {
  using L = Layout<T, K, kAffine>;
  if (L::kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pair_slab_kernel<T, K, kAffine>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (num_e + L::kTE - 1) / L::kTE;
  pair_slab_kernel<T, K, kAffine>
      <<<blocks, L::kThreads, L::kSmem, stream>>>(table, ptrs, num_c, num_e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kAffine, int K = kMinK>
int dispatch(int k, const T* table, const Pointers& ptrs, int num_c, int num_e,
             cudaStream_t stream) {
  if constexpr (K > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k == K) {
      return launch_k<T, K, kAffine>(table, ptrs, num_c, num_e, stream);
    }
    return dispatch<T, kAffine, K + 1>(k, table, ptrs, num_c, num_e, stream);
  }
}

// `gs` holds kFactors field pointers (general) or one pointer to the (6, E)
// coefficients (affine).
template <typename T, bool kAffine>
int launch(const void* table, const void* const* us, const void* const* gs,
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
  for (int s = 0; s < (kAffine ? 1 : kFactors); ++s) ptrs.g[s] = gs[s];
  return dispatch<T, kAffine>(k, static_cast<const T*>(table), ptrs, num_c,
                              num_e, static_cast<cudaStream_t>(stream));
}

}  // namespace pair_slab

#endif  // SWIRLFEM_STIFFNESS3D_PAIR_SLAB_CUH_
