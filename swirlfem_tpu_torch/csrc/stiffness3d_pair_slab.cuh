// The bf16x3 slab pipeline of the pair-layout affine 3D stiffness kernel
// (stiffness3d_pair_affine.cu).  The general kernels that it also served
// run on stiffness3d_pair_columns.cuh, which the affine flux is to join;
// the general (kAffine = false) paths below are no longer instantiated.
//
// A field (k, k, k, E) is viewed as k slabs along a chain axis, the other
// two axes merged into one pair axis of M = k^2 entries p: xi-slabs of the
// (eta, zeta) pair (the JAX package's `pair`, `pairs` and affine kernels) or
// zeta-slabs of the (xi, eta) pair (`pairz`).  Per slab a and component, as
// the TPU kernel bodies compute it (swirlfem_tpu/ops/pallas_stiffness3d.py:
// _kernel_3d_pair_general, _kernel_3d_pairz_general, _kernel_3d_pair_affine):
//
//   [P1; P2] = mm3(DP, u[a]),  DP = [D (x) I; I (x) D]     (2M x M)
//   C        = sum_m D[a, m] u[m]                  (FP32 chain, FFMA)
//   (Q1, Q2, Qc) = flux of (P1, P2, C)             (pointwise)
//   pair[a]  = mm3(T1, Q1) + mm3(T2, Q2)           (T = [T1, T2], M x 2M)
//   out[m]   = pair[m] + (w2 *) sum_a Ct[a, m] Qc[a]   (FP32, FFMA)
//
// where mm3 is the class bf16x3: the host split of the float64 operator
// (hi, lo) times the split of the float32 operand (bf16(x), bf16(x - hi)),
// hi xhi + hi xlo + lo xhi, in float32.  On xi-slabs (r, s, t) = (C, P1, P2)
// and (Q1, Q2, Qc) = (fb, fc, fa); on zeta-slabs (r, s, t) = (P1, P2, C)
// and (Q1, Q2, Qc) = (fa, fb, fc); T1, T2 are the transposes of DP's blocks
// (affine: times diag(w (x) w), folded in before the split), Ct is D
// (affine: Dw[a][m] = D[a][m] w_a, and the w2 = w (x) w factor).  The
// general flux is (fa, fb, fc) = G (r, s, t) on the six factor fields; the
// affine one fa = c11 r + c12 s + c13 t, fb = w_a (c12 r + c22 s + c23 t),
// fc = w_a (c13 r + c23 s + c33 t) on six scalars per element.
//
// Design.  A block owns TE = 16 consecutive elements and walks the
// components, each through all k slabs; 8 warps.  Shared memory holds the
// split DP and T (hi, lo; M padded with zeros to Mp, a multiple of 16), the
// component's float32 (k M, TE) tile, and per slab the split u[a] and the
// split (Q1; Q2).  Both products are mma.sync m16n8k16 bf16 fragments
// (split_bf16_mma.cuh: fragment_product): each warp owns the same m16n8
// fragments of the (Mp, TE) output in both products and in both of DP's
// blocks, so a thread holds P1, P2 and, after the second product, pair at
// the same points (p, e), where it also forms C from the tile and keeps the
// k outputs out[m] of its points in registers until the last slab.  The
// metric at its points is loaded from device memory one slab ahead, so that
// the loads are in flight during the products.  Two barriers per slab: after the split of u[a], and after
// the split of (Q1; Q2).  On general elements T is DP's transpose (the split
// is elementwise), so the second product reads DP's split with transposed
// fragment loads (ldmatrix.trans) and T takes no shared memory.
//
// Shared memory at order 7 (M = Mp = 64): tile 48 KB, DP 36 KB, u[a] 6 KB,
// (Q1; Q2) 12 KB: 102 KB, two blocks of 256 threads per SM (256 blocks at
// 16^3 elements); affine elements add T, 34 KB, and take one block per SM.
// The operators stay in shared memory, so k <= 8.
// The factor fields (general) are read once per component (the L2 serves
// the re-reads).  The bound is the bytes (stiffness3d_pair_general.cu,
// stiffness3d_pair_affine.cu).  A first version (32 elements a block, the
// metric loaded point by point after the first product) took 273.9 us on
// the general and 203.5 us on the affine box at 16^3 elements, order 7,
// C = 3 (H100 at 700 W); wgmma, TMA and more blocks per SM are later work.

#ifndef SWIRLFEM_STIFFNESS3D_PAIR_SLAB_CUH_
#define SWIRLFEM_STIFFNESS3D_PAIR_SLAB_CUH_

#include "split_bf16_mma.cuh"

namespace pair_slab {

constexpr int kMaxComponents = 4;
constexpr int kFactors = 6;
constexpr int kMinK = 2;
constexpr int kMaxK = 8;
constexpr int kTE = 16;        // elements per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

struct Pointers {
  const float* u[kMaxComponents];
  // General: the six factor fields g11, g12, g13, g22, g23, g33, each
  // (k, k, k, E).  Affine: g[0] is the (6, E) coefficient array.
  const float* g[kFactors];
  float* out[kMaxComponents];
};

// The split operators as the host passes them: dp (2, 2 Mp, Mp) and, for
// affine elements, t (2, Mp, 2 Mp), [hi, lo] each.
struct Operators {
  const __nv_bfloat16* dp;
  const __nv_bfloat16* t;
};

template <int K, bool kZeta, bool kAffine>
struct Layout {
  static constexpr int M = K * K;
  static constexpr int Mp = (M + 15) / 16 * 16;
  static constexpr int kLdT = kTE + 8;       // float32 tile row
  static constexpr int kLdB = kTE + 8;       // bf16 rows of u[a] and Q
  static constexpr int kLdDP = Mp + 8;       // bf16 rows of DP
  static constexpr int kLdTT = 2 * Mp + 8;   // bf16 rows of T
  // The float32 table: D (K^2), Ct (K^2), w (K), w2 (M); general: D only.
  static constexpr int kTable = kAffine ? 3 * K * K + K : K * K;
  static constexpr int kTablePadded = (kTable + 3) & ~3;
  static constexpr int kTileFloats = K * M * kLdT;
  static constexpr int kDP = 2 * Mp * kLdDP;  // bf16 per part
  // The affine T (folded with the weights) has a split of its own; the
  // general T is DP's transpose, read from DP's split.
  static constexpr int kTT = kAffine ? Mp * kLdTT : 0;
  static constexpr int kU = Mp * kLdB;
  static constexpr int kQ = 2 * Mp * kLdB;
  static constexpr size_t kSmem =
      (static_cast<size_t>(kTablePadded) + kTileFloats) * 4 +
      static_cast<size_t>(2 * (kDP + kTT + kU + kQ)) * 2;
  // m16n8 fragments of one (Mp, TE) output, and per warp.
  static constexpr int kFrags = (Mp / 16) * (kTE / 8);
  static constexpr int NF = (kFrags + kWarps - 1) / kWarps;
  // Two blocks per SM where shared memory allows it (the general kernels).
  static constexpr int kMinBlocks = 2 * (kSmem + 1024) <= 233472 ? 2 : 1;
  static_assert(kSmem <= 232448, "shared memory");
};

// Offset of (slab, pair p) in a (k, k, k, E) field, in units of E.
template <int K, bool kZeta>
__device__ __forceinline__ long long row_of(int slab, int p) {
  return kZeta ? static_cast<long long>(p) * K + slab
               : static_cast<long long>(slab) * K * K + p;
}

template <int K, bool kZeta, bool kAffine>
__global__ void __launch_bounds__(kThreads,
                                  (Layout<K, kZeta, kAffine>::kMinBlocks))
pair_slab_kernel(Operators ops, const float* __restrict__ table,
                 Pointers ptrs, int num_c, int num_e, bool vec) {
  using L = Layout<K, kZeta, kAffine>;
  constexpr int M = L::M;
  constexpr int Mp = L::Mp;
  constexpr int NF = L::NF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tab = reinterpret_cast<float*>(smem_raw);
  float* tile = tab + L::kTablePadded;  // tile[(slab M + p) kLdT + col]
  __nv_bfloat16* dp_s = reinterpret_cast<__nv_bfloat16*>(tile + L::kTileFloats);
  __nv_bfloat16* t_s = dp_s + 2 * L::kDP;
  __nv_bfloat16* u_s = t_s + 2 * L::kTT;
  __nv_bfloat16* q_s = u_s + 2 * L::kU;
  const float* d_s = tab;                          // D[a][m] at a K + m
  const float* ct_s = kAffine ? tab + K * K : tab;  // Ct[a][m]
  const float* w_s = tab + 2 * K * K;              // affine: w, then w2
  const float* w2_s = w_s + K;

  const int tid = threadIdx.x;
  const long long e0 = static_cast<long long>(blockIdx.x) * kTE;

  // Stage the table and the split operators (16-byte vectors).
  for (int i = tid; i < L::kTable; i += kThreads) tab[i] = table[i];
  for (int v = tid; v < 2 * 2 * Mp * (Mp / 8); v += kThreads) {
    const int row = v / (Mp / 8);  // part * 2 Mp + r
    const int c = (v - row * (Mp / 8)) * 8;
    *reinterpret_cast<uint4*>(dp_s + row * L::kLdDP + c) =
        *reinterpret_cast<const uint4*>(ops.dp + row * Mp + c);
  }
  for (int v = tid; kAffine && v < 2 * Mp * (2 * Mp / 8); v += kThreads) {
    const int row = v / (2 * Mp / 8);  // part * Mp + r
    const int c = (v - row * (2 * Mp / 8)) * 8;
    *reinterpret_cast<uint4*>(t_s + row * L::kLdTT + c) =
        *reinterpret_cast<const uint4*>(ops.t + row * 2 * Mp + c);
  }

  // This warp's fragments: f = warp + 8 j of the (Mp / 16) x (TE / 8) grid.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  int frow[NF], fcol[NF];
  bool fvalid[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = warp + kWarps * j;
    fvalid[j] = f < L::kFrags;
    frow[j] = (f / (kTE / 8)) * 16;
    fcol[j] = (f % (kTE / 8)) * 8;
  }

  // The metric at this thread's points of slab a (all slabs alike on affine
  // elements), into gv; loaded one slab ahead of its use, so that the loads
  // are in flight during the products.
  float gv[kFactors][NF][4];
  auto load_metric = [&](int a) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = frow[j] + g + 8 * (q >> 1);
        const long long e = e0 + fcol[j] + 2 * t + (q & 1);
        const bool live = fvalid[j] && p < M && e < num_e;
#pragma unroll
        for (int f = 0; f < kFactors; ++f) {
          gv[f][j][q] = !live ? 0.0f
                        : kAffine
                            ? ptrs.g[0][static_cast<long long>(f) * num_e + e]
                            : ptrs.g[f][row_of<K, kZeta>(a, p) * num_e + e];
        }
      }
    }
  };
  load_metric(0);

  for (int comp = 0; comp < num_c; ++comp) {
    // The component's float32 tile (coalesced along E, zero past num_e).
    // The previous component's last reads of the tile preceded the last
    // slab's second barrier.
    const float* __restrict__ u = ptrs.u[comp];
#pragma unroll 4
    for (int v = tid; v < K * M * (kTE / 4); v += kThreads) {
      const int row = v / (kTE / 4);
      const int col = (v - row * (kTE / 4)) * 4;
      const int slab = row / M;
      const long long e = e0 + col;
      const float* src = u + row_of<K, kZeta>(slab, row - slab * M) * num_e + e;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (vec && e + 4 <= num_e) {
        x = *reinterpret_cast<const float4*>(src);
      } else {
        x.x = e < num_e ? src[0] : 0.0f;
        x.y = e + 1 < num_e ? src[1] : 0.0f;
        x.z = e + 2 < num_e ? src[2] : 0.0f;
        x.w = e + 3 < num_e ? src[3] : 0.0f;
      }
      *reinterpret_cast<float4*>(tile + row * L::kLdT + col) = x;
    }
    __syncthreads();

    float out_acc[K][NF][4];
#pragma unroll
    for (int m = 0; m < K; ++m) {
#pragma unroll
      for (int j = 0; j < NF; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) out_acc[m][j][q] = 0.0f;
      }
    }

    for (int a = 0; a < K; ++a) {
      // The split of u[a], zero past the pair axis.
      for (int idx = tid; idx < Mp * kTE; idx += kThreads) {
        const int p = idx / kTE;
        const int col = idx - p * kTE;
        const float v = p < M ? tile[(a * M + p) * L::kLdT + col] : 0.0f;
        split_bf16::store_split(v, u_s, u_s + L::kU, p * L::kLdB + col);
      }
      __syncthreads();

      // [P1; P2] = mm3(DP, u[a]).
      float acc1[2][NF][4];
#pragma unroll
      for (int o = 0; o < 2; ++o) {
#pragma unroll
        for (int j = 0; j < NF; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc1[o][j][q] = 0.0f;
        }
      }
      split_bf16::fragment_product<3, 2, NF>(
          dp_s, dp_s + L::kDP, L::kLdDP, Mp * L::kLdDP, u_s, u_s + L::kU,
          L::kLdB, Mp, frow, fcol, fvalid, acc1);

      // The chain at this thread's points (independent chains, the tile
      // row outermost).
      float chain[NF][4];
#pragma unroll
      for (int j = 0; j < NF; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) chain[j][q] = 0.0f;
      }
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const float dam = d_s[a * K + m];
#pragma unroll
        for (int j = 0; j < NF; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = min(frow[j] + g + 8 * (q >> 1), M - 1);
            const int col = fcol[j] + 2 * t + (q & 1);
            chain[j][q] =
                fmaf(dam, tile[(m * M + p) * L::kLdT + col], chain[j][q]);
          }
        }
      }

      // The flux, the chain's transpose into out_acc, and the split of
      // (Q1; Q2) at this thread's points.
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        if (!fvalid[j]) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = frow[j] + g + 8 * (q >> 1);
          const int col = fcol[j] + 2 * t + (q & 1);
          float q1 = 0.0f, q2 = 0.0f;
          if (p < M) {
            const float p1 = acc1[0][j][q];
            const float p2 = acc1[1][j][q];
            const float r = kZeta ? p1 : chain[j][q];
            const float s = kZeta ? p2 : p1;
            const float tt = kZeta ? chain[j][q] : p2;
            float fa = gv[0][j][q] * r + gv[1][j][q] * s + gv[2][j][q] * tt;
            float fb = gv[1][j][q] * r + gv[3][j][q] * s + gv[4][j][q] * tt;
            float fc = gv[2][j][q] * r + gv[4][j][q] * s + gv[5][j][q] * tt;
            if (kAffine) {
              fb *= w_s[a];
              fc *= w_s[a];
            }
            // (Q1, Q2, Qc): xi-slabs (fb, fc, fa), zeta-slabs (fa, fb, fc).
            q1 = kZeta ? fa : fb;
            q2 = kZeta ? fb : fc;
            float qc = kZeta ? fc : fa;
            if (kAffine) qc *= w2_s[p];
#pragma unroll
            for (int m = 0; m < K; ++m) {
              out_acc[m][j][q] = fmaf(ct_s[a * K + m], qc, out_acc[m][j][q]);
            }
          }
          split_bf16::store_split(q1, q_s, q_s + L::kQ, p * L::kLdB + col);
          split_bf16::store_split(q2, q_s, q_s + L::kQ,
                                  (Mp + p) * L::kLdB + col);
        }
      }
      // The next slab's metric (the next component starts at slab 0 again).
      if (!kAffine) load_metric(a + 1 < K ? a + 1 : 0);
      __syncthreads();

      // pair[a] = mm3(T1, Q1) + mm3(T2, Q2), one product of depth 2 Mp.
      float acc2[1][NF][4];
#pragma unroll
      for (int j = 0; j < NF; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc2[0][j][q] = 0.0f;
      }
      if constexpr (kAffine) {
        split_bf16::fragment_product<3, 1, NF>(
            t_s, t_s + L::kTT, L::kLdTT, 0, q_s, q_s + L::kQ, L::kLdB,
            2 * Mp, frow, fcol, fvalid, acc2);
      } else {
        // T = DP^T: the transposed fragments of DP's split.
        split_bf16::fragment_product<3, 1, NF, true>(
            dp_s, dp_s + L::kDP, L::kLdDP, 0, q_s, q_s + L::kQ, L::kLdB,
            2 * Mp, frow, fcol, fvalid, acc2);
      }
#pragma unroll
      for (int m = 0; m < K; ++m) {
        if (m != a) continue;  // a static index into out_acc
#pragma unroll
        for (int j = 0; j < NF; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) out_acc[m][j][q] += acc2[0][j][q];
        }
      }
    }

    // The k output slabs of this thread's points.
    float* __restrict__ out = ptrs.out[comp];
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      if (!fvalid[j]) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = frow[j] + g + 8 * (q >> 1);
        const long long e = e0 + fcol[j] + 2 * t + (q & 1);
        if (p >= M || e >= num_e) continue;
#pragma unroll
        for (int m = 0; m < K; ++m) {
          out[row_of<K, kZeta>(m, p) * num_e + e] = out_acc[m][j][q];
        }
      }
    }
  }
}

template <int K, bool kZeta, bool kAffine>
int launch_k(const Operators& ops, const float* table, const Pointers& ptrs,
             int num_c, int num_e, bool vec, cudaStream_t stream) {
  using L = Layout<K, kZeta, kAffine>;
  const int err = split_bf16::allow_smem(pair_slab_kernel<K, kZeta, kAffine>,
                                         static_cast<int>(L::kSmem));
  if (err != 0) return err;
  const int blocks = (num_e + kTE - 1) / kTE;
  pair_slab_kernel<K, kZeta, kAffine>
      <<<blocks, kThreads, L::kSmem, stream>>>(ops, table, ptrs, num_c,
                                               num_e, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kZeta, bool kAffine, int K = kMinK>
int dispatch(int k, const Operators& ops, const float* table,
             const Pointers& ptrs, int num_c, int num_e, bool vec,
             cudaStream_t stream) {
  if constexpr (K > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k == K) {
      return launch_k<K, kZeta, kAffine>(ops, table, ptrs, num_c, num_e, vec,
                                         stream);
    }
    return dispatch<kZeta, kAffine, K + 1>(k, ops, table, ptrs, num_c, num_e,
                                           vec, stream);
  }
}

// `gs` holds kFactors field pointers (general) or one pointer to the (6, E)
// coefficients (affine); `table` is D (general) or the affine table.
template <bool kZeta, bool kAffine>
int launch(const void* dp, const void* t, const void* table,
           const void* const* us, const void* const* gs, void* const* outs,
           int num_c, int k, int num_e, void* stream) {
  if (num_c < 1 || num_c > kMaxComponents || k < kMinK || k > kMaxK ||
      num_e < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_e == 0) return static_cast<int>(cudaGetLastError());
  Pointers ptrs = {};
  // 16-byte field loads where every row of every component is aligned.
  bool vec = num_e % 4 == 0;
  for (int c = 0; c < num_c; ++c) {
    ptrs.u[c] = static_cast<const float*>(us[c]);
    ptrs.out[c] = static_cast<float*>(outs[c]);
    vec = vec && reinterpret_cast<uintptr_t>(us[c]) % 16 == 0;
  }
  for (int s = 0; s < (kAffine ? 1 : kFactors); ++s) {
    ptrs.g[s] = static_cast<const float*>(gs[s]);
  }
  const Operators ops = {static_cast<const __nv_bfloat16*>(dp),
                         static_cast<const __nv_bfloat16*>(t)};
  return dispatch<kZeta, kAffine>(k, ops, static_cast<const float*>(table),
                                  ptrs, num_c, num_e, vec,
                                  static_cast<cudaStream_t>(stream));
}

}  // namespace pair_slab

#endif  // SWIRLFEM_STIFFNESS3D_PAIR_SLAB_CUH_
