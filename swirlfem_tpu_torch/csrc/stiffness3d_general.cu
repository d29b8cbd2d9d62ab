// General 3D sum-factorized stiffness on six factor fields, C <= 4 components.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness3d.py:stiffness3d_el_pallas
// (_kernel_3d).  Per element and component, with u = u[m, q, r] and the
// symmetric geometric factor fields G_ab = w |J| (J^-1 J^-T)_ab:
//
//   (ur, us, ut) = (D_xi u, D_eta u, D_zeta u)
//   fa = G11 ur + G12 us + G13 ut,  fb = G12 ur + G22 us + G23 ut,
//   fc = G13 ur + G23 us + G33 ut
//   out = D_xi^T fa + D_eta^T fb + D_zeta^T fc.
//
// Fields are (k, k, k, E), element axis last.  The six factor fields are read
// from device memory ONCE for all C components, as the TPU kernel does.
//
// Design (simple and exact in the working precision: FFMA, no TF32).  A block
// owns TE consecutive elements (8 in float32, 4 in float64) and has one
// thread per (m, q) node line and element: k^2 TE threads, 512 at order 7.
// Each thread keeps the six factor values of its own line in registers
// (6 k of them) for all components.  Per component, in two phases:
//   1. the thread loads its line of u into registers and into the shared
//      tile; after a barrier it forms ur and us from the tile (k-term
//      contractions across lines) and ut from its registers, then the three
//      fluxes; fc stays in registers, fa and fb go to two shared tiles;
//   2. after a barrier, out[m, q, :] = sum_a D[a,m] fa[a,q,:]
//      + sum_b D[b,q] fb[m,b,:] + sum_c D[c,:] fc[c], written to memory.
// The u tile and the fa tile share storage.  Lines are padded by TE entries
// in shared memory so the 4 lines a warp reads fall on distinct banks.
// wgmma, TMA and double-buffered components are later work.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32) at 16^3 elements,
// order 7, C = 3, float32: (2C + 6) k^3 E 4 B = 100.7 MB, 30.0 us; 0.711
// GFLOP (the count of bench.py:_stiffness_counts), 10.6 us.  Memory sets
// the bound.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxComponents = 4;
constexpr int kFactors = 6;
constexpr int kMinK = 2;
constexpr int kMaxK = 10;

struct Pointers {
  const void* u[kMaxComponents];
  const void* g[kFactors];  // g11, g12, g13, g22, g23, g33
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
  static constexpr int kTile = K * K * kLine;
  static constexpr int kDPadded = (K * K + 3) & ~3;
  static constexpr size_t kSmem =
      (static_cast<size_t>(kDPadded) + 2 * kTile) * sizeof(T);
};

template <typename T, int K>
__global__ void __launch_bounds__(Layout<T, K>::kThreads)
stiffness3d_general_kernel(const T* __restrict__ dmat, Pointers ptrs,
                           int num_c, int num_e) {
  using L = Layout<T, K>;
  constexpr int TE = L::kTE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* d_s = reinterpret_cast<T*>(smem_raw);  // d_s[i * K + j] = D[i][j]
  T* fa = d_s + L::kDPadded;                // u tile, then the fa fluxes
  T* fb = fa + L::kTile;

  const int tid = threadIdx.x;
  const int el = tid % TE;
  const int line = tid / TE;  // m * K + q
  const int m = line / K;
  const int q = line - m * K;
  const long long e = static_cast<long long>(blockIdx.x) * TE + el;
  const bool live = e < num_e;
  const int own = line * L::kLine + el;

  for (int i = tid; i < K * K; i += L::kThreads) d_s[i] = dmat[i];
  T g[kFactors][K];
#pragma unroll
  for (int s = 0; s < kFactors; ++s) {
    const T* __restrict__ gs = static_cast<const T*>(ptrs.g[s]);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      g[s][r] =
          live ? gs[static_cast<long long>(line * K + r) * num_e + e] : T(0);
    }
  }

  for (int c = 0; c < num_c; ++c) {
    const T* __restrict__ u = static_cast<const T*>(ptrs.u[c]);
    T ul[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      ul[r] = live ? u[static_cast<long long>(line * K + r) * num_e + e] : T(0);
      fa[own + r * TE] = ul[r];
    }
    __syncthreads();

    // Phase 1: reference derivatives and fluxes.
    T ur[K], us[K];
#pragma unroll
    for (int r = 0; r < K; ++r) ur[r] = us[r] = T(0);
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const T dm = d_s[m * K + a];
      const T dq = d_s[q * K + a];
      const T* ua = fa + (a * K + q) * L::kLine + el;  // line (a, q)
      const T* ub = fa + (m * K + a) * L::kLine + el;  // line (m, a)
#pragma unroll
      for (int r = 0; r < K; ++r) {
        ur[r] = fma(dm, ua[r * TE], ur[r]);
        us[r] = fma(dq, ub[r * TE], us[r]);
      }
    }
    T fc[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      T ut = T(0);
#pragma unroll
      for (int j = 0; j < K; ++j) ut = fma(d_s[r * K + j], ul[j], ut);
      const T vr = ur[r], vs = us[r];
      ur[r] = g[0][r] * vr + g[1][r] * vs + g[2][r] * ut;  // fa
      us[r] = g[1][r] * vr + g[3][r] * vs + g[4][r] * ut;  // fb
      fc[r] = g[2][r] * vr + g[4][r] * vs + g[5][r] * ut;
    }
    __syncthreads();  // every read of the u tile is done
#pragma unroll
    for (int r = 0; r < K; ++r) {
      fa[own + r * TE] = ur[r];
      fb[own + r * TE] = us[r];
    }
    __syncthreads();

    // Phase 2: transposed derivatives.
    T acc[K];
#pragma unroll
    for (int r = 0; r < K; ++r) acc[r] = T(0);
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const T dm = d_s[a * K + m];
      const T dq = d_s[a * K + q];
      const T* pa = fa + (a * K + q) * L::kLine + el;  // line (a, q)
      const T* pb = fb + (m * K + a) * L::kLine + el;  // line (m, a)
#pragma unroll
      for (int r = 0; r < K; ++r) {
        acc[r] = fma(dm, pa[r * TE], acc[r]);
        acc[r] = fma(dq, pb[r * TE], acc[r]);
      }
    }
    T* __restrict__ out = static_cast<T*>(ptrs.out[c]);
#pragma unroll
    for (int r = 0; r < K; ++r) {
#pragma unroll
      for (int j = 0; j < K; ++j) acc[r] = fma(d_s[j * K + r], fc[j], acc[r]);
      if (live) out[static_cast<long long>(line * K + r) * num_e + e] = acc[r];
    }
    __syncthreads();  // the next component overwrites the tiles
  }
}

template <typename T, int K>
int launch_k(const T* dmat, const Pointers& ptrs, int num_c, int num_e,
             cudaStream_t stream) {
  using L = Layout<T, K>;
  if (L::kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stiffness3d_general_kernel<T, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (num_e + L::kTE - 1) / L::kTE;
  stiffness3d_general_kernel<T, K>
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

extern "C" int stiffness3d_general_f32(const void* dmat, const void* const* us,
                                       const void* const* gs, void* const* outs,
                                       int num_c, int k, int num_e,
                                       void* stream) {
  return launch<float>(dmat, us, gs, outs, num_c, k, num_e, stream);
}

extern "C" int stiffness3d_general_f64(const void* dmat, const void* const* us,
                                       const void* const* gs, void* const* outs,
                                       int num_c, int k, int num_e,
                                       void* stream) {
  return launch<double>(dmat, us, gs, outs, num_c, k, num_e, stream);
}
