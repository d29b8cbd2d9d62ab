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
// Fields are (k, k, k, E), element axis last.  The class is that of the TPU
// kernel at HIGHEST: FP32 (or FP64) FFMA, no TF32.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32) at 16^3 elements,
// order 7, C = 3, float32: (2C + 6) k^3 E 4 B = 100.7 MB, 30.0 us; 0.711
// GFLOP (the count of bench.py:_stiffness_counts), 10.6 us.  Memory sets
// the bound.
//
// Design.  A block owns a tile of TE = 8 elements, one row per point, and
// walks its components; the blocks are persistent on a host grid
// (cuda_stiffness3d.general3d_grid), tiles b, b + grid, ..., each through
// its components.  Every contraction is pencil-owned: a thread holds a line
// of k points of one element along the contracted axis in registers, reads
// each input once from shared memory and forms the line's k outputs by k
// FFMAs per input, D read as 16-byte broadcasts (two lines at once in the
// xi and eta stages), so shared memory sees one access per point and
// stage, not one per FFMA.  The lanes of a warp are 8 elements by 4 lines.
// Per component, with U, R, S tiles in shared memory:
//
//   A. xi lines R = D_xi U, eta lines S = D_eta U;
//   B. zeta lines: ut = D_zeta U in registers, the fluxes from R, S, ut and
//      the factor fields, fa and fb back into R and S in place (each point
//      of a zeta line is this thread's alone in this stage), and the
//      line's D_zeta^T fc kept in registers;
//   C. xi lines R = D_xi^T R, eta lines S = D_eta^T S, in place;
//   D. zeta lines: out = (R + S) + D_zeta^T fc, to device memory.
//
// Four barriers a component.  The factor fields are the most bytes: where
// their six tiles fit beside U, R and S (float32, k <= 9: 162.5 KB at
// k = 8), they are copied into shared memory once per tile and serve all
// its components, so each factor value crosses the L2 once (read at every
// component from device memory, they held a first version with 16-element
// rows at 85 us, 49.5 without them; tests/torch_port_general3d_variants.py);
// elsewhere (k = 10, float64) stage B reads them at its own points, a line
// ahead.  U is free after B, so the next component's field (and, at a new
// tile, the factor fields) is copied by cp.async during C and D (16 bytes
// a thread where E and the bases allow, else element-wise with zero fill);
// the field is waited for before A, the factor fields before B.  The
// outputs go out with evict-first stores: the device memory sees
// (2 C + 6) k^3 E words, the bound's bytes.  Bank conflicts: a warp reads
// four neighbouring lines at once, whose rows are distinct mod 4 (32-byte
// rows, a quarter of the banks each) along zeta lines at every k and along
// every axis at k = 4, 5, 8, 9; where k is even a zeta line's rows are k
// apart, so one spare row follows every k rows (row(P) = P + P / k).  One
// block of 8 warps per SM at k = 8, each thread two lines an axis (16
// warps, one line each, took 6 % longer).
//
// A first version (one thread per (m, q) line and element, 8 elements a
// block, one shared read per FFMA, three barriers a component, one block
// per 8 elements) took 132.81 us at 16^3 elements, order 7, C = 3 on an
// H100 at 700 W.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxComponents = 4;
constexpr int kFactors = 6;
constexpr int kMinK = 2;
constexpr int kMaxK = 10;
constexpr int kTileElements = 8;  // a tile's elements: one row per point
constexpr int kSmemLimit = 232448;

struct Pointers {
  const void* u[kMaxComponents];
  const void* g[kFactors];  // g11, g12, g13, g22, g23, g33
  void* out[kMaxComponents];
};

// Mirrored by cuda_stiffness3d.general3d_layout (tested on the CPU).
template <typename T, int K>
struct Layout {
  static constexpr int kTE = kTileElements;
  static constexpr int kSlots = 32 / kTE;  // lines a warp holds at once
  static constexpr int kLines = K * K;     // lines along each axis
  // Lines per thread, and warps so that a block has at most 8.
  static constexpr int kRounds = (kLines + 8 * kSlots - 1) / (8 * kSlots);
  static constexpr int kWarps =
      (kLines + kSlots * kRounds - 1) / (kSlots * kRounds);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kNS = kWarps * kSlots;  // line slots of a block
  // One spare row after every k rows where k is even (see row()).
  static constexpr int kPad = K % 2 == 0 ? 1 : 0;
  static constexpr int kRows = K * K * K + kPad * K * K;
  static constexpr int kTile = kRows * kTE;  // T per tile
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLdD = (K + kVec - 1) / kVec * kVec;
  static constexpr int kTable = 2 * K * kLdD;  // D and D^T, rows padded
  // The tile's six factor fields stay in shared memory for all components
  // where they fit beside U, R and S (float32, k <= 9); else each
  // component's stage B reads them from device memory.
  static constexpr bool kFactorTiles =
      (static_cast<size_t>(kTable) + 9 * static_cast<size_t>(kTile)) *
          sizeof(T) <=
      kSmemLimit;
  static constexpr int kTiles = kFactorTiles ? 9 : 3;
  static constexpr size_t kSmem =
      (static_cast<size_t>(kTable) + kTiles * static_cast<size_t>(kTile)) *
      sizeof(T);
  // Row strides of a line: xi (k^2 points apart), eta (k apart), zeta (1).
  static constexpr int kXiStride = K * K + kPad * K;
  static constexpr int kEtaStride = K + kPad;
  static constexpr int kZetaLine = K + kPad;
  static_assert(kSmem <= kSmemLimit, "shared memory");
  static_assert(kNS % 4 == 0, "a warp's lines in fours");
};

// The shared-memory row of point P = (m K + q) K + r.
template <typename T, int K>
__device__ __forceinline__ int row(int p) {
  return p + Layout<T, K>::kPad * (p / K);
}

// 16 bytes of T from shared memory (a broadcast when the warp agrees).
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load_vec(const double* p, double (&v)[2]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  v[0] = x.x;
  v[1] = x.y;
}

// acc[i] += M[j][i] x for one row j of a table (`mrow`: M[j][0..K), padded
// to kLdD), and a second line's acc2 with y where given.
template <typename T, int K, bool kTwo>
__device__ __forceinline__ void axpy_row(const T* mrow, T x, T (&acc)[K], T y,
                                         T (&acc2)[K]) {
  constexpr int V = Layout<T, K>::kVec;
#pragma unroll
  for (int i0 = 0; i0 < K; i0 += V) {
    T v[V];
    load_vec(mrow + i0, v);
#pragma unroll
    for (int t = 0; t < V; ++t) {
      if (i0 + t < K) {
        acc[i0 + t] = fma(v[t], x, acc[i0 + t]);
        if (kTwo) acc2[i0 + t] = fma(v[t], y, acc2[i0 + t]);
      }
    }
  }
}

// cp.async of N bytes (4, 8 or 16) with zero fill where `in` is false; the
// 16-byte copies bypass the L1 (the fields are read once).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = in ? N : 0;
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(N), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits for all but the newest `N` groups of this thread's copies.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int K>
__global__ void __launch_bounds__(Layout<T, K>::kThreads, 1)
stiffness3d_general_kernel(const T* __restrict__ dmat, Pointers ptrs,
                           int num_c, int num_e, bool vec) {
  using L = Layout<T, K>;
  constexpr int TE = L::kTE;
  constexpr int kLdD = L::kLdD;
  constexpr int R = L::kRounds;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* d_s = reinterpret_cast<T*>(smem_raw);  // D[i][j] at i kLdD + j
  T* dt_s = d_s + K * kLdD;                 // D[j][i] at i kLdD + j
  T* u_s = dt_s + K * kLdD;                 // [row][TE]: U, R, S
  T* r_s = u_s + L::kTile;
  T* s_s = r_s + L::kTile;
  T* g_s = s_s + L::kTile;  // kFactorTiles: factor field f at f kTile

  const int tid = threadIdx.x;
  for (int i = tid; i < K * kLdD; i += L::kThreads) {
    const int a = i / kLdD;
    const int b = i - a * kLdD;
    d_s[i] = b < K ? dmat[a * K + b] : T(0);
    dt_s[i] = b < K ? dmat[b * K + a] : T(0);
  }

  // This thread: element `el` of the tile, line slot `slot`; its lines are
  // slot + NS j, j < R (the last round ragged where NS R > k^2).
  const int lane = tid & 31;
  const int el = lane % TE;
  const int slot = (tid >> 5) * L::kSlots + lane / TE;
  const int num_tiles = (num_e + TE - 1) / TE;

  // A (k, k, k, E) field's tile into a shared tile, by cp.async.
  auto stage = [&](const T* __restrict__ src, T* dst, int tile) {
    const long long e0 = static_cast<long long>(tile) * TE;
    constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
    if (vec && e0 + TE <= num_e) {
      for (int v = tid; v < K * K * K * (TE / kChunk); v += L::kThreads) {
        const int p = v / (TE / kChunk);
        const int c = (v - p * (TE / kChunk)) * kChunk;
        cp_async<16>(dst + row<T, K>(p) * TE + c,
                     src + static_cast<long long>(p) * num_e + e0 + c, true);
      }
    } else {
      for (int v = tid; v < K * K * K * TE; v += L::kThreads) {
        const int p = v / TE;
        const int c = v - p * TE;
        const bool in = e0 + c < num_e;
        cp_async<sizeof(T)>(
            dst + row<T, K>(p) * TE + c,
            in ? src + static_cast<long long>(p) * num_e + e0 + c : src, in);
      }
    }
  };
  // Two groups of copies per unit: the field into U, then the factor fields
  // where a new tile starts (else an empty group).
  auto stage_unit = [&](int tile, int comp) {
    stage(static_cast<const T*>(ptrs.u[comp]), u_s, tile);
    cp_async_commit();
    if (L::kFactorTiles && comp == 0) {
#pragma unroll 1
      for (int f = 0; f < kFactors; ++f) {
        stage(static_cast<const T*>(ptrs.g[f]), g_s + f * L::kTile, tile);
      }
    }
    cp_async_commit();
  };

  int tile = blockIdx.x;
  int comp = 0;
  if (tile < num_tiles) stage_unit(tile, 0);
  while (tile < num_tiles) {
    const long long e = static_cast<long long>(tile) * TE + el;
    const bool elive = e < num_e;
    cp_async_wait<1>();
    __syncthreads();  // U staged; every thread is done with R and S

    // The factor fields along a zeta line at this thread's element,
    // loaded a line ahead of the flux (the first during stage A).
    T g[kFactors][K];
    auto load_factors = [&](int line) {
      if constexpr (L::kFactorTiles) return;
      const bool live = elive && line < K * K;
#pragma unroll
      for (int f = 0; f < kFactors; ++f) {
        const T* __restrict__ gf = static_cast<const T*>(ptrs.g[f]);
#pragma unroll
        for (int c = 0; c < K; ++c) {
          g[f][c] = live ? __ldg(gf + static_cast<long long>(line * K + c) *
                                          num_e + e)
                         : T(0);
        }
      }
    };
    load_factors(slot);

    // A. R = D_xi U on xi lines (q, r), S = D_eta U on eta lines (m, r).
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int line = slot + L::kNS * j;
      if (line >= K * K) continue;
      const int xi0 = row<T, K>(line);                            // (0, q, r)
      const int eta0 = (line / K) * L::kXiStride + line % K;      // (m, 0, r)
      T ax[K], ae[K];
#pragma unroll
      for (int i = 0; i < K; ++i) ax[i] = ae[i] = T(0);
#pragma unroll
      for (int a = 0; a < K; ++a) {
        const T x = u_s[(xi0 + a * L::kXiStride) * TE + el];
        const T y = u_s[(eta0 + a * L::kEtaStride) * TE + el];
        axpy_row<T, K, true>(dt_s + a * kLdD, x, ax, y, ae);
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
        r_s[(xi0 + i * L::kXiStride) * TE + el] = ax[i];
        s_s[(eta0 + i * L::kEtaStride) * TE + el] = ae[i];
      }
    }
    cp_async_wait<0>();  // the factor tiles
    __syncthreads();

    // B. Zeta lines (m, q): ut, the fluxes, fa and fb into R and S, and
    // oz = D_zeta^T fc.
    T oz[R][K];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int line = slot + L::kNS * j;
#pragma unroll
      for (int i = 0; i < K; ++i) oz[j][i] = T(0);
      if (line >= K * K) continue;
      const int z0 = line * L::kZetaLine;
      T ut[K], fc[K];
#pragma unroll
      for (int i = 0; i < K; ++i) ut[i] = T(0);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        axpy_row<T, K, false>(dt_s + c * kLdD, u_s[(z0 + c) * TE + el], ut,
                              T(0), ut);
      }
      if constexpr (L::kFactorTiles) {
#pragma unroll
        for (int f = 0; f < kFactors; ++f) {
#pragma unroll
          for (int c = 0; c < K; ++c) {
            g[f][c] = g_s[f * L::kTile + (z0 + c) * TE + el];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const int i = (z0 + c) * TE + el;
        const T vr = r_s[i], vs = s_s[i], vt = ut[c];
        r_s[i] = g[0][c] * vr + g[1][c] * vs + g[2][c] * vt;  // fa
        s_s[i] = g[1][c] * vr + g[3][c] * vs + g[4][c] * vt;  // fb
        fc[c] = g[2][c] * vr + g[4][c] * vs + g[5][c] * vt;
      }
      if (j + 1 < R) load_factors(line + L::kNS);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        axpy_row<T, K, false>(d_s + c * kLdD, fc[c], oz[j], T(0), oz[j]);
      }
    }
    __syncthreads();  // every read of U and of the factor tiles is done

    // The next unit's field (and factor fields), in flight during C and D.
    int next_tile = tile;
    int next_comp = comp + 1;
    if (next_comp == num_c) {
      next_comp = 0;
      next_tile += gridDim.x;
    }
    if (next_tile < num_tiles) stage_unit(next_tile, next_comp);

    // C. R = D_xi^T R, S = D_eta^T S, each line in place.
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int line = slot + L::kNS * j;
      if (line >= K * K) continue;
      const int xi0 = row<T, K>(line);
      const int eta0 = (line / K) * L::kXiStride + line % K;
      T ax[K], ae[K];
#pragma unroll
      for (int i = 0; i < K; ++i) ax[i] = ae[i] = T(0);
#pragma unroll
      for (int a = 0; a < K; ++a) {
        const T x = r_s[(xi0 + a * L::kXiStride) * TE + el];
        const T y = s_s[(eta0 + a * L::kEtaStride) * TE + el];
        axpy_row<T, K, true>(d_s + a * kLdD, x, ax, y, ae);
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
        r_s[(xi0 + i * L::kXiStride) * TE + el] = ax[i];
        s_s[(eta0 + i * L::kEtaStride) * TE + el] = ae[i];
      }
    }
    __syncthreads();

    // D. out = (R + S) + oz along the zeta lines.
    T* __restrict__ out = static_cast<T*>(ptrs.out[comp]);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int line = slot + L::kNS * j;
      if (line >= K * K || !elive) continue;
      const int z0 = line * L::kZetaLine;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const int i = (z0 + c) * TE + el;
        __stcs(out + static_cast<long long>(line * K + c) * num_e + e,
               (r_s[i] + s_s[i]) + oz[j][c]);
      }
    }
    tile = next_tile;
    comp = next_comp;
  }
}

template <typename T, int K>
int launch_k(const T* dmat, const Pointers& ptrs, int num_c, int num_e,
             bool vec, int grid, cudaStream_t stream) {
  using L = Layout<T, K>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      stiffness3d_general_kernel<T, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  stiffness3d_general_kernel<T, K><<<grid, L::kThreads, L::kSmem, stream>>>(
      dmat, ptrs, num_c, num_e, vec);
  return static_cast<int>(cudaGetLastError());
}

// out = [tile_e, threads, shared bytes, resident blocks per SM].
template <typename T, int K>
int layout_k(int* out) {
  using L = Layout<T, K>;
  const cudaError_t err = cudaFuncSetAttribute(
      stiffness3d_general_kernel<T, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = L::kTE;
  out[1] = L::kThreads;
  out[2] = static_cast<int>(L::kSmem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], stiffness3d_general_kernel<T, K>, L::kThreads, L::kSmem));
}

template <typename T, int K = kMinK>
int dispatch(int k, const T* dmat, const Pointers* ptrs, int num_c,
             int num_e, bool vec, int grid, cudaStream_t stream,
             int* layout_out) {
  if constexpr (K > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k == K) {
      if (layout_out != nullptr) return layout_k<T, K>(layout_out);
      return launch_k<T, K>(dmat, *ptrs, num_c, num_e, vec, grid, stream);
    }
    return dispatch<T, K + 1>(k, dmat, ptrs, num_c, num_e, vec, grid, stream,
                              layout_out);
  }
}

template <typename T>
int launch(const void* dmat, const void* const* us, const void* const* gs,
           void* const* outs, int num_c, int k, int num_e, int grid,
           void* stream) {
  if (num_c < 1 || num_c > kMaxComponents || k < kMinK || k > kMaxK ||
      num_e < 0 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_e == 0) return static_cast<int>(cudaGetLastError());
  Pointers ptrs = {};
  // 16-byte copies where every row of every field is aligned.
  bool vec = num_e % (16 / static_cast<int>(sizeof(T))) == 0;
  for (int c = 0; c < num_c; ++c) {
    ptrs.u[c] = us[c];
    ptrs.out[c] = outs[c];
    vec = vec && reinterpret_cast<uintptr_t>(us[c]) % 16 == 0;
  }
  for (int s = 0; s < kFactors; ++s) {
    ptrs.g[s] = gs[s];
    vec = vec && reinterpret_cast<uintptr_t>(gs[s]) % 16 == 0;
  }
  return dispatch<T>(k, static_cast<const T*>(dmat), &ptrs, num_c, num_e, vec,
                     grid, static_cast<cudaStream_t>(stream), nullptr);
}

}  // namespace

// dmat: (k, k); us, gs (6), outs: (k, k, k, num_e), all float32 (or all
// float64); grid: persistent blocks (cuda_stiffness3d.general3d_grid).
extern "C" int stiffness3d_general_f32(const void* dmat, const void* const* us,
                                       const void* const* gs, void* const* outs,
                                       int num_c, int k, int num_e, int grid,
                                       void* stream) {
  return launch<float>(dmat, us, gs, outs, num_c, k, num_e, grid, stream);
}

extern "C" int stiffness3d_general_f64(const void* dmat, const void* const* us,
                                       const void* const* gs, void* const* outs,
                                       int num_c, int k, int num_e, int grid,
                                       void* stream) {
  return launch<double>(dmat, us, gs, outs, num_c, k, num_e, grid, stream);
}

// The kernel's geometry at k (f64: the float64 instance): out = [tile_e,
// threads, shared bytes, resident blocks per SM on the current device].
extern "C" int stiffness3d_general_layout(int k, int f64, int* out) {
  return f64 ? dispatch<double>(k, nullptr, nullptr, 0, 0, false, 1, nullptr,
                                out)
             : dispatch<float>(k, nullptr, nullptr, 0, 0, false, 1, nullptr,
                               out);
}
