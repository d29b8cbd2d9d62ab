// General 2D sum-factorized stiffness on three factor fields, C <= 4
// components.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness.py:stiffness_el_pallas_batched
// (and stiffness_el_pallas, its C = 1 case; _kernel_rows_batched), and
// serves stiffness_el_pallas_kron (the same operator) at C = 1.  Per element
// and component, with u = u[a, b] and the symmetric geometric factor fields
// G_ab = w |J| (J^-1 J^-T)_ab:
//
//   ur = D_xi u,  us = D_eta u
//   fa = G11 ur + G12 us,  fb = G12 ur + G22 us
//   out = D_xi^T fa + D_eta^T fb.
//
// Fields are (k, k, E), element axis last.  The class is that of the TPU
// kernel at HIGHEST: FP32 (or FP64) FFMA, no TF32.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32) at the datagen shape
// (E = 4096, order 8, C = 2, float32): (2C + 3) k^2 E 4 B = 9.3 MB, 2.77 us;
// C (8 k^3 + 6 k^2) E = 0.052 GFLOP, 0.8 us.  Memory sets the bound.  On the
// heated cavity (E = 144, order 7) both are under 0.1 us: latency (launch,
// first load, the dependent stages) sets the time.
//
// Design.  A unit is a tile of TE elements of one component; persistent
// blocks walk contiguous ranges of the units, tile-major (a tile's
// components follow one another; whole tiles where a block takes more than
// one unit, so that each tile's factor fields are read by one block), on a
// host plan (cuda_stiffness2d.general2d_plan): TE = 32 (128-byte rows)
// where the units reach half the SMs, else TE = 8 (32-byte rows, four times
// the units), so that the heated cavity's E = 144 spreads over 36 SMs
// rather than 5.  A thread owns line i of one element (lanes over
// elements, so that every lane of a warp uses the same D entry at once) in
// two roles, the row a = i and the column b = i of the element's k x k
// tile:
//
//   1. column b: ur[:, b] = D u[:, b] into the shared tile R; row a:
//      us[a, :] = D u[a, :] kept in registers;
//   2. row a: ur[a, :] from R, the fluxes with the factor values of the row,
//      fa back into R's row a in place, and D_eta^T fb of the row into the
//      row of the (now free) U tile;
//   3. column b: D_xi^T fa[:, b] from R, plus U's column, to device memory.
//
// Each contraction reads its k inputs once from shared memory and forms
// the line's k outputs by k FFMAs each, D from registers in float32 (168
// registers at k = 9: one block of 9 warps an SM; D in shared memory as
// 16-byte broadcasts, two blocks an SM, was slower: 7.01 us against 6.70
// at 64^2, order 8, C = 2; two components a thread, sharing D's
// registers, took the same time: a unit issues ~700 instructions a thread,
// 342 of them FFMA, and the issue rate, not latency, holds it).  Three
// barriers a unit.  The next unit's field
// (and, at a new tile, its three factor tiles) is copied by cp.async into
// the other of two buffers while the current unit is computed (16 bytes a
// thread where E and the bases allow, else element-wise with zero fill); a
// tile's factor values serve all its components in the block.  Bank
// conflicts: at TE = 8 a warp holds four lines, whose rows start on
// distinct 8-bank groups (a line's stride is padded to 8 mod 32 words
// where k is even).
//
// A first version (k^2 TE threads, one per (a, b) node and element, TE = 8,
// one block per tile, two shared reads per FFMA, three barriers a
// component) took 4.77 us at E = 144, order 7, C = 2 and 14.00 us at 64^2,
// order 8, C = 1 on an NVIDIA H100 80GB HBM3 at 700 W; this one 3.38 and
// 4.86 us, and 6.23 at 64^2, C = 2 (19.90 before).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxComponents = 4;
constexpr int kFactors = 3;
constexpr int kMinK = 2;
constexpr int kMaxK = 10;
constexpr int kSmemLimit = 232448;

struct Pointers {
  const void* u[kMaxComponents];
  const void* g[kFactors];  // g11, g12, g22
  void* out[kMaxComponents];
};

// D for the contractions acc[i] += M[o][i] x, M = D or D^T: in registers
// (indices known at compile time), or in two shared tables (D and D^T,
// rows padded to 16 bytes, read as 16-byte broadcasts).
template <typename T, int K, bool kRegs>
struct DMat;

template <typename T, int K>
struct DMat<T, K, true> {
  T d[K][K];
  __device__ __forceinline__ void load(const T* __restrict__ dmat, T*, int,
                                       int) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int j = 0; j < K; ++j) d[i][j] = __ldg(dmat + i * K + j);
    }
  }
  // acc[i] += M[o][i] x (and acc2[i] += M[o][i] y where given).
  template <bool kTrans, bool kTwo = false>
  __device__ __forceinline__ void axpy(int o, T x, T (&acc)[K], T y = T(0),
                                       T* acc2 = nullptr) const {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const T m = kTrans ? d[i][o] : d[o][i];
      acc[i] = fma(m, x, acc[i]);
      if (kTwo) acc2[i] = fma(m, y, acc2[i]);
    }
  }
};

template <typename T, int K>
struct DMat<T, K, false> {
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLd = (K + kV - 1) / kV * kV;
  const T* s;  // D[i][j] at i kLd + j, then D^T
  __device__ __forceinline__ void load(const T* __restrict__ dmat, T* table,
                                       int tid, int threads) {
    for (int i = tid; i < K * kLd; i += threads) {
      const int a = i / kLd;
      const int b = i - a * kLd;
      table[i] = b < K ? dmat[a * K + b] : T(0);
      table[K * kLd + i] = b < K ? dmat[b * K + a] : T(0);
    }
    s = table;
  }
  template <bool kTrans, bool kTwo = false>
  __device__ __forceinline__ void axpy(int o, T x, T (&acc)[K], T y = T(0),
                                       T* acc2 = nullptr) const {
    const T* row = s + (kTrans ? K * kLd : 0) + o * kLd;
#pragma unroll
    for (int i0 = 0; i0 < K; i0 += kV) {
      T v[kV];
      if constexpr (kV == 4) {
        const float4 f = *reinterpret_cast<const float4*>(row + i0);
        v[0] = f.x;
        v[1] = f.y;
        v[2] = f.z;
        v[3] = f.w;
      } else {
        const double2 f = *reinterpret_cast<const double2*>(row + i0);
        v[0] = f.x;
        v[1] = f.y;
      }
#pragma unroll
      for (int t = 0; t < kV; ++t) {
        if (i0 + t < K) {
          acc[i0 + t] = fma(v[t], x, acc[i0 + t]);
          if (kTwo) acc2[i0 + t] = fma(v[t], y, acc2[i0 + t]);
        }
      }
    }
  }
};

// Mirrored by cuda_stiffness2d.general2d_layout (tested on the CPU).
template <typename T, int K, int TE>
struct Layout {
  static constexpr int kThreads = (K * TE + 31) / 32 * 32;
  // A line's stride in a tile: K rows of TE values, padded by TE where
  // TE < 32 and K is even, so that the 32 / TE lines of a warp start on
  // distinct groups of TE banks.
  static constexpr int kPad = TE < 32 && K % 2 == 0 ? TE : 0;
  static constexpr int kLine = K * TE + kPad;
  static constexpr int kTile = K * kLine;
  // D in each thread's registers in float32; in float64 (twice the
  // registers) the shared tables D and D^T, rows padded to 16 bytes.
  static constexpr bool kDRegs = sizeof(T) == 4;
  static constexpr int kTable = kDRegs ? 0 : 2 * K * DMat<T, K, false>::kLd;
  // Two U tiles, R, two sets of the three factor tiles.
  static constexpr int kTiles = 3 + 2 * kFactors;
  static constexpr size_t kSmem =
      (static_cast<size_t>(kTable) + kTiles * static_cast<size_t>(kTile)) *
      sizeof(T);
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

// a[i] of a kernel parameter array, without copying it to local memory.
template <typename P>
__device__ __forceinline__ P pick(const P (&a)[kMaxComponents], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int K, int TE>
__global__ void __launch_bounds__(Layout<T, K, TE>::kThreads)
stiffness2d_general_kernel(const T* __restrict__ dmat, Pointers ptrs,
                           int num_c, int num_e, int num_units, int span,
                           bool vec) {
  using L = Layout<T, K, TE>;
  constexpr int kLine = L::kLine;
  constexpr int kTile = L::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* d_s = reinterpret_cast<T*>(smem_raw);  // float64: the D tables
  T* u_s = d_s + L::kTable;                 // two U tiles
  T* r_s = u_s + 2 * kTile;
  T* g_s = r_s + kTile;  // two sets of the three factor tiles

  // This block's units: the contiguous range [b N / grid, (b + 1) N / grid)
  // of the N = U / span runs of `span` units (1, or a whole tile's
  // components).
  const long long runs = num_units / span;
  const int first = static_cast<int>(blockIdx.x * runs / gridDim.x) * span;
  const int last =
      static_cast<int>((blockIdx.x + 1) * runs / gridDim.x) * span;
  if (first >= last) return;

  const int tid = threadIdx.x;
  const int el = tid % TE;
  const int line = tid / TE;  // this thread's row a and column b
  const bool owner = line < K;

  // A (k, k, E) field's tile into a shared tile: node (a, b) at a kLine +
  // b TE.  Offsets in 32 bits (the entry point takes k^2 E < 2^31); the
  // 16-byte copies in a loop of fixed trip count, so that a thread's chunk
  // offsets are the same few instructions for every field and tile.
  auto stage = [&](const T* __restrict__ src, T* dst, int tile) {
    const int e0 = tile * TE;
    constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
    constexpr int kPer = TE / kChunk;
    constexpr int kChunks = K * K * kPer;
    if (vec && e0 + TE <= num_e) {
      src += e0;
#pragma unroll
      for (int j = 0; j < (kChunks + L::kThreads - 1) / L::kThreads; ++j) {
        const int v = tid + j * L::kThreads;
        if (kChunks % L::kThreads == 0 || v < kChunks) {
          const int n = v / kPer;
          const int c = (v - n * kPer) * kChunk;
          const int a = n / K;
          cp_async<16>(dst + a * kLine + (n - a * K) * TE + c,
                       src + n * num_e + c, true);
        }
      }
    } else {
#pragma unroll 1
      for (int v = tid; v < K * K * TE; v += L::kThreads) {
        const int n = v / TE;
        const int c = v - n * TE;
        const int a = n / K;
        const bool in = e0 + c < num_e;
        cp_async<sizeof(T)>(dst + a * kLine + (n - a * K) * TE + c,
                            in ? src + n * num_e + e0 + c : src, in);
      }
    }
  };
  // (Unrolled: a factor pointer indexed at run time would copy the
  // parameters to a stack frame, which costs every launch.)
  auto stage_factors = [&](T* dst, int tile) {
#pragma unroll
    for (int f = 0; f < kFactors; ++f) {
      stage(static_cast<const T*>(ptrs.g[f]), dst + f * kTile, tile);
    }
  };

  int tile = first / num_c;
  int comp = first - tile * num_c;
  int ub = 0;  // U buffer of this unit
  int gb = 0;  // factor set of this unit's tile
  stage(static_cast<const T*>(pick(ptrs.u, comp)), u_s, tile);
  stage_factors(g_s, tile);
  cp_async_commit();
  // D while the first unit's copies are in flight.
  DMat<T, K, L::kDRegs> dm;
  dm.load(dmat, d_s, tid, L::kThreads);

  for (int unit = first; unit < last; ++unit) {
    cp_async_wait_all();
    __syncthreads();  // this unit staged; the last unit's reads are done

    // The next unit's copies, in flight during this one.
    int next_tile = tile;
    int next_comp = comp + 1;
    if (next_comp == num_c) {
      next_comp = 0;
      ++next_tile;
    }
    const bool new_tile = next_tile != tile;
    if (unit + 1 < last) {
      stage(static_cast<const T*>(pick(ptrs.u, next_comp)),
            u_s + (ub ^ 1) * kTile, next_tile);
      if (new_tile) stage_factors(g_s + (gb ^ 1) * kFactors * kTile, next_tile);
      cp_async_commit();
    }

    T* u_t = u_s + ub * kTile;
    const T* g_t = g_s + gb * kFactors * kTile;
    const int col = line * TE + el;     // node (., b = line) less a kLine
    const int row = line * kLine + el;  // node (a = line, .) less b TE

    // 1. Column b: R[:, b] = D u[:, b].  Row a: us = D u[a, :].
    T us[K];
    if (owner) {
      T x[K], y[K], acc[K];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        x[q] = u_t[q * kLine + col];
        y[q] = u_t[row + q * TE];
      }
#pragma unroll
      for (int i = 0; i < K; ++i) acc[i] = us[i] = T(0);
#pragma unroll
      for (int q = 0; q < K; ++q) {
        dm.template axpy<true, true>(q, x[q], acc, y[q], us);  // D[i][q]
      }
#pragma unroll
      for (int i = 0; i < K; ++i) r_s[i * kLine + col] = acc[i];
    }
    __syncthreads();

    // 2. Row a: the fluxes; fa into R's row, D_eta^T fb into U's row.
    if (owner) {
      T fb[K], ob[K];
#pragma unroll
      for (int b = 0; b < K; ++b) {
        const int i = row + b * TE;
        const T ur = r_s[i];
        const T g11 = g_t[i], g12 = g_t[kTile + i], g22 = g_t[2 * kTile + i];
        r_s[i] = g11 * ur + g12 * us[b];
        fb[b] = g12 * ur + g22 * us[b];
        ob[b] = T(0);
      }
#pragma unroll
      for (int b = 0; b < K; ++b) dm.template axpy<false>(b, fb[b], ob);
#pragma unroll
      for (int c = 0; c < K; ++c) u_t[row + c * TE] = ob[c];
    }
    __syncthreads();

    // 3. Column b: out[:, b] = D_xi^T fa[:, b] + U[:, b].
    const int e = tile * TE + el;
    if (owner && e < num_e) {
      T fa[K], oa[K];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        fa[q] = r_s[q * kLine + col];
        oa[q] = T(0);
      }
#pragma unroll
      for (int q = 0; q < K; ++q) dm.template axpy<false>(q, fa[q], oa);
      T* __restrict__ out =
          static_cast<T*>(pick(ptrs.out, comp)) + line * num_e + e;
#pragma unroll
      for (int a = 0; a < K; ++a) {
        out[a * K * num_e] = oa[a] + u_t[a * kLine + col];
      }
    }
    tile = next_tile;
    comp = next_comp;
    ub ^= 1;
    if (new_tile) gb ^= 1;
  }
}

template <typename T, int K, int TE>
int launch_k(const T* dmat, const Pointers& ptrs, int num_c, int num_e,
             bool vec, int grid, int span, cudaStream_t stream) {
  using L = Layout<T, K, TE>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      stiffness2d_general_kernel<T, K, TE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int units = num_c * ((num_e + TE - 1) / TE);
  stiffness2d_general_kernel<T, K, TE><<<grid, L::kThreads, L::kSmem, stream>>>(
      dmat, ptrs, num_c, num_e, units, span, vec);
  return static_cast<int>(cudaGetLastError());
}

// out = [tile_e, threads, shared bytes, resident blocks per SM].
template <typename T, int K, int TE>
int layout_k(int* out) {
  using L = Layout<T, K, TE>;
  const cudaError_t err = cudaFuncSetAttribute(
      stiffness2d_general_kernel<T, K, TE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = TE;
  out[1] = L::kThreads;
  out[2] = static_cast<int>(L::kSmem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], stiffness2d_general_kernel<T, K, TE>, L::kThreads, L::kSmem));
}

template <typename T, int TE, int K = kMinK>
int dispatch(int k, const T* dmat, const Pointers* ptrs, int num_c,
             int num_e, bool vec, int grid, int span, cudaStream_t stream,
             int* layout_out) {
  if constexpr (K > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k == K) {
      if (layout_out != nullptr) return layout_k<T, K, TE>(layout_out);
      return launch_k<T, K, TE>(dmat, *ptrs, num_c, num_e, vec, grid, span,
                                stream);
    }
    return dispatch<T, TE, K + 1>(k, dmat, ptrs, num_c, num_e, vec, grid,
                                  span, stream, layout_out);
  }
}

// The tiles each dtype is built for: float32 8 and 32, float64 8.
template <typename T>
int by_tile(int tile_e, int k, const T* dmat, const Pointers* ptrs,
            int num_c, int num_e, bool vec, int grid, int span,
            cudaStream_t stream, int* layout_out) {
  if (tile_e == 8) {
    return dispatch<T, 8>(k, dmat, ptrs, num_c, num_e, vec, grid, span,
                          stream, layout_out);
  }
  if constexpr (sizeof(T) == 4) {
    if (tile_e == 32) {
      return dispatch<T, 32>(k, dmat, ptrs, num_c, num_e, vec, grid, span,
                             stream, layout_out);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* dmat, const void* const* us, const void* const* gs,
           void* const* outs, int num_c, int k, int num_e, int tile_e,
           int grid, int span, void* stream) {
  if (num_c < 1 || num_c > kMaxComponents || k < kMinK || k > kMaxK ||
      num_e < 0 || static_cast<long long>(k) * k * num_e >= (1LL << 31) ||
      grid < 1 || (span != 1 && span != num_c)) {
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
  return by_tile<T>(tile_e, k, static_cast<const T*>(dmat), &ptrs, num_c,
                    num_e, vec, grid, span, static_cast<cudaStream_t>(stream),
                    nullptr);
}

}  // namespace

// dmat: (k, k); us, gs (3), outs: (k, k, num_e), all float32 (or all
// float64), k^2 num_e < 2^31; tile_e, grid and span: the host's plan
// (cuda_stiffness2d.general2d_plan): 8 or 32 elements a tile (float64: 8),
// persistent blocks, each over runs of `span` units (1, or num_c: whole
// tiles).
extern "C" int stiffness2d_general_f32(const void* dmat, const void* const* us,
                                       const void* const* gs, void* const* outs,
                                       int num_c, int k, int num_e,
                                       int tile_e, int grid, int span,
                                       void* stream) {
  return launch<float>(dmat, us, gs, outs, num_c, k, num_e, tile_e, grid,
                       span, stream);
}

extern "C" int stiffness2d_general_f64(const void* dmat, const void* const* us,
                                       const void* const* gs, void* const* outs,
                                       int num_c, int k, int num_e,
                                       int tile_e, int grid, int span,
                                       void* stream) {
  return launch<double>(dmat, us, gs, outs, num_c, k, num_e, tile_e, grid,
                        span, stream);
}

// The kernel's geometry at (k, tile_e) (f64: the float64 instance): out =
// [tile_e, threads, shared bytes, resident blocks per SM on the current
// device].
extern "C" int stiffness2d_general_layout(int k, int f64, int tile_e,
                                          int* out) {
  return f64 ? by_tile<double>(tile_e, k, nullptr, nullptr, 0, 0, false, 1,
                               1, nullptr, out)
             : by_tile<float>(tile_e, k, nullptr, nullptr, 0, 0, false, 1, 1,
                              nullptr, out);
}
