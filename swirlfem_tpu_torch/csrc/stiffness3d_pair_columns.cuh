// The bf16x3 pipeline of the 3D stiffness in pair-axis form, with every
// slab of an element as columns of one product: the general kernels
// (stiffness3d_pair_general.cu: the xi-slab kernel that pair, pairs2 and
// pairs4 run, and the zeta-slab kernel of pairz) and the affine one
// (stiffness3d_pair_affine.cu); and the congruent kernel
// (stiffness3d_pair.cu), whose one product needs neither the flux nor the
// transposed stage (`pair_congruent_kernel`, at its definition).
//
// A field (k, k, k, E) is viewed as k slabs along a chain axis, the other
// two axes merged into one pair axis of M = k^2 entries p: xi-slabs of the
// (eta, zeta) pair, or zeta-slabs of the (xi, eta) pair.  Per slab a, as
// the TPU kernel bodies compute it (swirlfem_tpu/ops/pallas_stiffness3d.py:
// _kernel_3d_pair_general, _kernel_3d_pairz_general, _kernel_3d_pair_affine):
//
//   [P1; P2] = mm3(DP, u[a]),  DP = [D (x) I; I (x) D]     (2M x M)
//   C        = sum_m D[a, m] u[m]                  (FP32 chain, FFMA)
//   (Q1, Q2, Qc) = flux of (P1, P2, C)             (pointwise)
//   pair[a]  = mm3(T, [Q1; Q2])                    (T = [T1, T2], M x 2M)
//   out[m]   = pair[m] + (w2 *) sum_a Ct[a, m] Qc[a]   (FP32, FFMA)
//
// where mm3 is the class bf16x3: the host split of the float64 operator
// (hi, lo) times the in-kernel split of the float32 operand (bf16(x),
// bf16(x - hi), both RNE), hi xhi + hi xlo + lo xhi with float32 sums.  On
// xi-slabs (r, s, t) = (C, P1, P2) and (Q1, Q2, Qc) = (fb, fc, fa); on
// zeta-slabs (r, s, t) = (P1, P2, C) and (Q1, Q2, Qc) = (fa, fb, fc).  The
// general flux is (fa, fb, fc) = G (r, s, t) on the six symmetric factor
// fields, T is DP's transpose and Ct is D.  The affine flux (xi-slabs) reads
// six coefficients per element, fa = c11 r + c12 s + c13 t weight-free,
// fb = w_a (c12 r + c22 s + c23 t), fc = w_a (c13 r + c23 s + c33 t); its T
// is [(D (x) I)^T W2, (I (x) D)^T W2] with W2 = diag(w (x) w) folded in
// float64 before its own split (not DP's split times W2: another rounding),
// Ct is Dw[a][m] = D[a][m] w_a, and the chain term takes the factor w2[p].
//
// Design.  The products of all k slabs of an element are one product, the
// slabs side by side as columns (the JAX pairz kernel's "lane width
// k tile_e"): a block owns TE = 8 G elements (G column groups of 8) and
// walks its tile's components one after the other; warp (i, grp) owns the
// 16 pair rows p of tile i and the k n8 column fragments (slab a, group
// grp).  So every A fragment of DP a warp loads from shared memory feeds
// k fragments (3 k mma.sync m16n8k16 per P1 tile), and a thread holds, at
// each of its four points (p, e), every slab: P1, P2, the chain, the flux
// and the transposed chain stay in its registers, and out[m] = pair[m] +
// R[m] needs no sum across threads or slabs.  A thread loads the field at
// its own points for all k slabs straight from device memory, writes their
// split into the block's operand B1 (Mp x k TE, hi and lo) and forms the
// chain from the same registers; the fluxes' split goes to B2 (2 Mp rows).
// Two barriers per component (B1 written; B2 written), none per slab.  The
// blocks of the I (x) D half that hold only zeros (the 16 x 16 tiles off its
// block diagonal, 12 of 16 at k = 8) are skipped: they add exact zeros.
// Shared rows are padded to an odd number of 16-byte units: the eight rows
// an ldmatrix phase reads and the eight rows a split store writes fall on
// distinct banks.  The blocks are persistent (the host passes the grid,
// cuda_stiffness3d.pair_columns_grid) and load the next component's field
// during the transposed product.
//
// The affine T.  DP's split and the field's and fluxes' operands take 226
// KB of shared memory at k = 10 (163 KB at k = 9), and T's split would add
// 104 KB (77 KB): it does not fit beside them.  So the affine kernel reads
// T's A fragments from device memory in mma.sync fragment order
// (cuda_split.mma_a_fragments: per 16 x 16 tile and part, 16 contiguous
// bytes a lane, one 512-byte request a warp), the way the 2D affine split
// kernel holds its operator (stiffness2d_affine_split.cu).  T is at most
// 104 KB and every block reads it once per component, so the L1 and the L2
// serve it; each warp reads only the tiles its products use (the live ones
// of the I (x) D half), one tile ahead of its products, and the first before
// the barrier that ends the flux.  At every k the affine kernel has the
// general kernels' layout and grid.
//
// Device memory: the factor fields are read once per component of a tile;
// the other resident blocks read ~26 MB between a block's reads of them
// (132 tiles of 16 elements, order 7), so the L1 and the 50 MB L2 serve the
// re-reads, and the fields and outputs stream past them with evict-first
// loads and stores (__ldcs, __stcs): the device memory sees (2 C + 6) k^3 E
// floats, the bound's bytes (the affine kernel: 2 C k^3 E + 6 E).  What
// holds the general kernels (H100, order 7, C = 3;
// tests/torch_port_pair_columns_variants.py): the loads at each thread's
// own points, 32 bytes of each of 8 rows a warp request; without the
// factor-field loads it takes half the time, while the same loads served
// from a small footprint in cache take as long, and a smaller L1 costs.  A
// ring of factor-field slabs in shared memory (cp.async, or TMA with
// mbarriers) was slower: it takes the L1 the re-reads use.  Shared memory
// (bytes): the table (D; affine: D, Dw, w, w2, float32), DP's split
// 4 (2 Mp)(Mp + 8), B1 4 Mp ldB, B2 8 Mp ldB: 138 KB at k = 8, one block of
// 8 warps per SM (246 registers); 221 KB at k = 10 (7 warps, TE = 8).

#ifndef SWIRLFEM_STIFFNESS3D_PAIR_COLUMNS_CUH_
#define SWIRLFEM_STIFFNESS3D_PAIR_COLUMNS_CUH_

#include "split_bf16_mma.cuh"

namespace pair_columns {

constexpr int kMaxComponents = 4;
constexpr int kFactors = 6;
constexpr int kMinK = 2;
constexpr int kMaxK = 10;
constexpr int kGroup = 8;  // elements of one column group: an n8 fragment
constexpr int kSmemLimit = 232448;

struct Pointers {
  const float* u[kMaxComponents];
  // General: g11, g12, g13, g22, g23, g33.  Affine: g[0] is the (6, E)
  // coefficient array, rows c11, c12, c13, c22, c23, c33.
  const float* g[kFactors];
  float* out[kMaxComponents];
};

// The three kernels: xi-slabs and zeta-slabs on six factor fields, and
// xi-slabs on affine elements.
enum Variant : int { kXi = 0, kZetaSlabs = 1, kAffine = 2 };

// Mirrored by cuda_stiffness3d.pair_columns_layout (tested on the CPU).
template <int K, int V>
struct Layout {
  static constexpr int M = K * K;
  static constexpr int Mp = (M + 15) / 16 * 16;
  static constexpr int kTiles = Mp / 16;  // m16 tiles of the pair axis
  static constexpr int kGroups = kTiles >= 8 ? 1 : 8 / kTiles;
  static constexpr int kTE = kGroup * kGroups;  // elements per block tile
  static constexpr int kWarps = kTiles * kGroups;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kCols = K * kTE;  // operand columns: (group, slab, e)
  static constexpr int kLdB = (kCols / 8) % 2 == 1 ? kCols : kCols + 8;
  static constexpr int kLdDP = Mp + 8;
  // General: D; affine: D, Dw, w, w2 (float32).
  static constexpr int kTableUsed = V == kAffine ? 3 * K * K + K : K * K;
  static constexpr int kTable = (kTableUsed + 3) / 4 * 4;
  static constexpr int kDPPart = 2 * Mp * kLdDP;      // bf16, hi or lo
  static constexpr int kB1Part = Mp * kLdB;
  static constexpr int kB2Part = 2 * Mp * kLdB;
  static constexpr int kSmem = kTable * 4 + 4 * (kDPPart + kB1Part + kB2Part);
  static_assert(kSmem <= kSmemLimit, "shared memory");
  static_assert(((kLdB / 8) & 1) == 1 && ((kLdDP / 8) & 1) == 1,
                "rows of an odd number of 16-byte units");
};

// d += a b on one m16n8k16 fragment (bf16 in, float32 sums).  Not volatile:
// the compiler may interleave independent products.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_split2(float x, float y,
                                             __nv_bfloat16* hi_p,
                                             __nv_bfloat16* lo_p, int i) {
  uint32_t hi, lo;
  split_bf16::split2(x, y, hi, lo);
  *reinterpret_cast<uint32_t*>(hi_p + i) = hi;
  *reinterpret_cast<uint32_t*>(lo_p + i) = lo;
}

// Two neighbouring entries (e, e + 1) of a field row, zero where dead or
// past num_e; `vec`: 8-byte loads (num_e even, rows aligned).  `kStream`:
// evict-first (the fields, read once); else the read-only path (the factor
// fields, read again for the next component).
template <bool kStream>
__device__ __forceinline__ void load2(const float* p, bool live, long long e,
                                      int num_e, bool vec, float (&v)[2]) {
  if (vec) {
    float2 x = make_float2(0.0f, 0.0f);
    if (live && e < num_e) {
      const float2* q = reinterpret_cast<const float2*>(p);
      x = kStream ? __ldcs(q) : __ldg(q);
    }
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = live && e < num_e ? (kStream ? __ldcs(p) : __ldg(p)) : 0.0f;
    v[1] = live && e + 1 < num_e ? (kStream ? __ldcs(p + 1) : __ldg(p + 1))
                                 : 0.0f;
  }
}

__device__ __forceinline__ void store2(float* p, long long e, int num_e,
                                       bool vec, float x, float y) {
  if (vec) {
    if (e < num_e) __stcs(reinterpret_cast<float2*>(p), make_float2(x, y));
  } else {
    if (e < num_e) __stcs(p, x);
    if (e + 1 < num_e) __stcs(p + 1, y);
  }
}

// Whether the 16 x 16 tile (ri, ci) of I (x) D (k x k blocks of D on the
// diagonal) holds a nonzero: the row and column tiles share a block.  The
// D (x) I tiles always do (16 consecutive indices cover every residue
// mod k <= 10, and a short last tile of rows meets the same residues among
// the columns).
template <int K>
__device__ __forceinline__ bool eye_tile_live(int ri, int ci) {
  constexpr int M = K * K;
  const int r0 = 16 * ri / K, r1 = (min(16 * ri + 16, M) - 1) / K;
  const int c0 = 16 * ci / K, c1 = (min(16 * ci + 16, M) - 1) / K;
  return max(r0, c0) <= min(r1, c1);
}

// The general flux at one point: (Q1, Q2, Qc) from (P1, P2, C) and the six
// factor values.
template <bool kZeta>
__device__ __forceinline__ void flux_general(const float (&gm)[kFactors],
                                             float p1, float p2, float chain,
                                             float& q1, float& q2,
                                             float& qc) {
  const float r = kZeta ? p1 : chain;
  const float s = kZeta ? p2 : p1;
  const float t = kZeta ? chain : p2;
  const float fa = gm[0] * r + gm[1] * s + gm[2] * t;
  const float fb = gm[1] * r + gm[3] * s + gm[4] * t;
  const float fc = gm[2] * r + gm[4] * s + gm[5] * t;
  q1 = kZeta ? fa : fb;
  q2 = kZeta ? fb : fc;
  qc = kZeta ? fc : fa;
}

// The affine flux at one point (xi-slabs): (Q1, Q2, Qc) = (fb, fc, fa)
// from (P1, P2, C), the element's six coefficients and the slab's weight.
__device__ __forceinline__ void flux_affine(const float (&cm)[kFactors],
                                            float wa, float p1, float p2,
                                            float chain, float& q1, float& q2,
                                            float& qc) {
  const float r = chain, s = p1, t = p2;
  qc = cm[0] * r + cm[1] * s + cm[2] * t;
  q1 = wa * (cm[1] * r + cm[3] * s + cm[4] * t);
  q2 = wa * (cm[2] * r + cm[4] * s + cm[5] * t);
}

// `atf`: the affine T's A fragments (cuda_split.mma_a_fragments), 16 bytes
// of lane l at [(row tile Mp / 16 + column tile) 2 + part] 32 + l; null for
// the general kernels.
template <int K, int V>
__global__ void __launch_bounds__(Layout<K, V>::kThreads, 1)
pair_columns_kernel(const __nv_bfloat16* __restrict__ dp,
                    const uint4* __restrict__ atf,
                    const float* __restrict__ table, Pointers ptrs, int num_c,
                    int num_e, bool vec) {
  constexpr bool kZeta = V == kZetaSlabs;
  using L = Layout<K, V>;
  constexpr int M = L::M;
  constexpr int Mp = L::Mp;
  constexpr int kLdB = L::kLdB;
  constexpr int kLdDP = L::kLdDP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* d_s = reinterpret_cast<float*>(smem_raw);  // D[a][m] at a K + m
  // The transposed chain's table Ct, and the affine weights w, w2.
  const float* ct_s = V == kAffine ? d_s + K * K : d_s;
  const float* w_s = d_s + 2 * K * K;
  const float* w2_s = w_s + K;
  __nv_bfloat16* dp_hi = reinterpret_cast<__nv_bfloat16*>(d_s + L::kTable);
  __nv_bfloat16* dp_lo = dp_hi + L::kDPPart;
  __nv_bfloat16* b1_hi = dp_lo + L::kDPPart;  // [p][(group K + a) 8 + e]
  __nv_bfloat16* b1_lo = b1_hi + L::kB1Part;
  __nv_bfloat16* b2_hi = b1_lo + L::kB1Part;  // rows Q1 (p), Q2 (Mp + p)
  __nv_bfloat16* b2_lo = b2_hi + L::kB2Part;

  const int tid = threadIdx.x;
  // Stage the table and the split DP (16-byte vectors; dp is (2, 2 Mp,
  // Mp)).
  for (int i = tid; i < L::kTableUsed; i += L::kThreads) d_s[i] = table[i];
  for (int v = tid; v < 2 * 2 * Mp * (Mp / 8); v += L::kThreads) {
    const int row = v / (Mp / 8);  // part 2 Mp + r
    const int c = (v - row * (Mp / 8)) * 8;
    *reinterpret_cast<uint4*>(dp_hi + row * kLdDP + c) =
        *reinterpret_cast<const uint4*>(dp + static_cast<long long>(row) * Mp +
                                        c);
  }
  __syncthreads();

  // Warp (ti, grp): pair rows 16 ti + g (+ 8), column group grp; the thread's
  // points are those rows at elements 2t, 2t + 1 of the group.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ti = warp % L::kTiles;
  const int grp = warp / L::kTiles;
  const int prow[2] = {16 * ti + g, 16 * ti + g + 8};
  const bool plive[2] = {prow[0] < M, prow[1] < M};
  // Offsets of (slab 0, p) in a field, and from one slab to the next.
  const long long roff[2] = {
      static_cast<long long>(kZeta ? prow[0] * K : prow[0]) * num_e,
      static_cast<long long>(kZeta ? prow[1] * K : prow[1]) * num_e};
  const long long slab_step = static_cast<long long>(kZeta ? 1 : M) * num_e;
  const int col0 = grp * K * 8 + 2 * t;  // this thread's column at slab 0
  // ldmatrix row addresses: A tiles (rows lane % 16, column half lane / 16);
  // transposed A (DP's stored tile read as its transpose); B (rows lane % 16
  // of the hi part for lanes 0-15, of the lo part for lanes 16-31).
  const int a_row = lane & 15;
  const int a_col = (lane >> 4) * 8;
  const int at_row = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int at_col = ((lane >> 3) & 1) * 8;
  const int b_off = (lane & 15) * kLdB + grp * K * 8;
  const __nv_bfloat16* b1 = (lane >> 4) ? b1_lo : b1_hi;
  const __nv_bfloat16* b2 = (lane >> 4) ? b2_lo : b2_hi;
  // The affine T: this warp's row tile of fragments; the weight w2 at its
  // points; and its live column tiles, all Mp / 16 of the first half and
  // the contiguous run [eye0, eye1] of the (I (x) D)^T half that meets
  // this row tile's diagonal blocks (it holds tile ti).
  const uint4* at_frag =
      V == kAffine ? atf + ti * (2 * Mp / 16) * 2 * 32 + lane : nullptr;
  float w2v[2] = {0.0f, 0.0f};
  int eye0 = ti, eye1 = ti;
  if constexpr (V == kAffine) {
    w2v[0] = plive[0] ? w2_s[prow[0]] : 0.0f;
    w2v[1] = plive[1] ? w2_s[prow[1]] : 0.0f;
    while (eye0 > 0 && eye_tile_live<K>(eye0 - 1, ti)) --eye0;
    while (eye1 + 1 < Mp / 16 && eye_tile_live<K>(eye1 + 1, ti)) ++eye1;
  }

  const int num_tiles = (num_e + L::kTE - 1) / L::kTE;
  float uv[K][2][2];  // the field at this thread's points, every slab
  auto load_field = [&](int tile, int comp) {
    const long long e = static_cast<long long>(tile) * L::kTE + grp * 8 +
                        2 * t;
    const float* u = ptrs.u[comp];
#pragma unroll
    for (int m = 0; m < K; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        load2<true>(u + roff[r] + m * slab_step + e, plive[r], e, num_e, vec,
                    uv[m][r]);
      }
    }
  };

  int tile = blockIdx.x;
  int comp = 0;
  if (tile < num_tiles) load_field(tile, 0);
  while (tile < num_tiles) {
    const long long e = static_cast<long long>(tile) * L::kTE + grp * 8 +
                        2 * t;

    // The split of the field into B1, and the chain, from the same values.
#pragma unroll
    for (int a = 0; a < K; ++a) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        store_split2(uv[a][r][0], uv[a][r][1], b1_hi, b1_lo,
                     prow[r] * kLdB + col0 + a * 8);
      }
    }
    float ch[K][2][2];
#pragma unroll
    for (int a = 0; a < K; ++a) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float s = 0.0f;
#pragma unroll
          for (int m = 0; m < K; ++m) s = fmaf(d_s[a * K + m], uv[m][r][j], s);
          ch[a][r][j] = s;
        }
      }
    }
    __syncthreads();  // B1 complete

    // The factor fields at this thread's points, one slab ahead of the
    // flux; slab 0's loads are in flight during the first product.  The
    // affine kernel reads its elements' six coefficients once.
    float gv[2][kFactors][2][2];
    float cv[kFactors][2];
    auto load_metric = [&](int a, float (&gm)[kFactors][2][2]) {
#pragma unroll
      for (int f = 0; f < kFactors; ++f) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          load2<false>(ptrs.g[f] + roff[r] + a * slab_step + e, plive[r], e,
                       num_e, vec, gm[f][r]);
        }
      }
    };
    if constexpr (V == kAffine) {
#pragma unroll
      for (int f = 0; f < kFactors; ++f) {
        load2<false>(ptrs.g[0] + static_cast<long long>(f) * num_e + e, true,
                     e, num_e, vec, cv[f]);
      }
    } else {
      load_metric(0, gv[0]);
    }

    // [P1; P2] = mm3(DP, U) over every slab's columns: the A tiles of this
    // warp's rows once per 16-deep chunk, each feeding the k slabs.
    float acc[2][K][4];
#pragma unroll
    for (int o = 0; o < 2; ++o) {
#pragma unroll
      for (int a = 0; a < K; ++a) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[o][a][q] = 0.0f;
      }
    }
#pragma unroll
    for (int kc = 0; kc < Mp / 16; ++kc) {
      uint32_t a1h[4], a1l[4], a2h[4], a2l[4];
      const int off1 = (16 * ti + a_row) * kLdDP + 16 * kc + a_col;
      split_bf16::ldmatrix_x4(a1h, dp_hi + off1);
      split_bf16::ldmatrix_x4(a1l, dp_lo + off1);
      const bool live2 = eye_tile_live<K>(ti, kc);  // warp-uniform
      if (live2) {
        split_bf16::ldmatrix_x4(a2h, dp_hi + off1 + Mp * kLdDP);
        split_bf16::ldmatrix_x4(a2l, dp_lo + off1 + Mp * kLdDP);
      }
#pragma unroll
      for (int a = 0; a < K; ++a) {
        uint32_t b[4];  // uhi (b0, b1), ulo (b2, b3)
        split_bf16::ldmatrix_x4_trans(b, b1 + 16 * kc * kLdB + b_off + a * 8);
        mma(acc[0][a], a1h, b[0], b[1]);
        mma(acc[0][a], a1h, b[2], b[3]);
        mma(acc[0][a], a1l, b[0], b[1]);
        if (live2) {
          mma(acc[1][a], a2h, b[0], b[1]);
          mma(acc[1][a], a2h, b[2], b[3]);
          mma(acc[1][a], a2l, b[0], b[1]);
        }
      }
    }

    // The flux per slab: the split of (Q1; Q2) into B2, Qc in place of the
    // chain.  Fragment entry q = 2 r + j is the point (row r, element j).
#pragma unroll
    for (int a = 0; a < K; ++a) {
      if (V != kAffine && a + 1 < K) load_metric(a + 1, gv[(a + 1) & 1]);
      const float wa = V == kAffine ? w_s[a] : 0.0f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float q1[2], q2[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float gm[kFactors];
#pragma unroll
          for (int f = 0; f < kFactors; ++f) {
            gm[f] = V == kAffine ? cv[f][j] : gv[a & 1][f][r][j];
          }
          if constexpr (V == kAffine) {
            flux_affine(gm, wa, acc[0][a][2 * r + j], acc[1][a][2 * r + j],
                        ch[a][r][j], q1[j], q2[j], ch[a][r][j]);
          } else {
            flux_general<kZeta>(gm, acc[0][a][2 * r + j],
                                acc[1][a][2 * r + j], ch[a][r][j], q1[j],
                                q2[j], ch[a][r][j]);
          }
        }
        const int i = prow[r] * kLdB + col0 + a * 8;
        store_split2(q1[0], q1[1], b2_hi, b2_lo, i);
        store_split2(q2[0], q2[1], b2_hi, b2_lo, i + Mp * kLdB);
      }
    }
    // The transposed chain R[m] = sum_a Ct[a, m] Qc[a].
    float rr[K][2][2];
#pragma unroll
    for (int m = 0; m < K; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float s = 0.0f;
#pragma unroll
          for (int a = 0; a < K; ++a) {
            s = fmaf(ct_s[a * K + m], ch[a][r][j], s);
          }
          rr[m][r][j] = s;
        }
      }
    }
    // The affine T's first fragments (column tile 0), in flight across the
    // barrier.
    uint4 at_hi = make_uint4(0, 0, 0, 0), at_lo = at_hi;
    if constexpr (V == kAffine) {
      at_hi = __ldg(at_frag);
      at_lo = __ldg(at_frag + 32);
    }
    __syncthreads();  // B2 complete; every warp is done with B1

    // The next unit's field, in flight during the transposed product.
    int next_tile = tile;
    int next_comp = comp + 1;
    if (next_comp == num_c) {
      next_comp = 0;
      next_tile += gridDim.x;
    }
    if (next_tile < num_tiles) load_field(next_tile, next_comp);

    // pair = mm3(T, [Q1; Q2]).  General: DP's stored tiles read transposed;
    // the tiles of (I (x) D)^T that hold only zeros are skipped.  Affine:
    // T's fragments from device memory, over this warp's live column tiles,
    // the next tile's loads in flight during a tile's products.
    float y[K][4];
#pragma unroll
    for (int a = 0; a < K; ++a) {
#pragma unroll
      for (int q = 0; q < 4; ++q) y[a][q] = 0.0f;
    }
    if constexpr (V == kAffine) {
      const int num_live = Mp / 16 + eye1 - eye0 + 1;
      for (int i = 0; i < num_live; ++i) {
        // Column tile i, or tile eye0 + (i - Mp / 16) of the second half.
        const int kc = i < Mp / 16 ? i : eye0 + i;
        const uint32_t ah[4] = {at_hi.x, at_hi.y, at_hi.z, at_hi.w};
        const uint32_t al[4] = {at_lo.x, at_lo.y, at_lo.z, at_lo.w};
        if (i + 1 < num_live) {
          const int next = i + 1 < Mp / 16 ? i + 1 : eye0 + i + 1;
          at_hi = __ldg(at_frag + next * 64);
          at_lo = __ldg(at_frag + next * 64 + 32);
        }
#pragma unroll
        for (int a = 0; a < K; ++a) {
          uint32_t b[4];
          split_bf16::ldmatrix_x4_trans(b,
                                        b2 + 16 * kc * kLdB + b_off + a * 8);
          mma(y[a], ah, b[0], b[1]);
          mma(y[a], ah, b[2], b[3]);
          mma(y[a], al, b[0], b[1]);
        }
      }
    } else {
#pragma unroll
      for (int kc = 0; kc < 2 * Mp / 16; ++kc) {
        if (kc >= Mp / 16 && !eye_tile_live<K>(kc - Mp / 16, ti)) continue;
        uint32_t ah[4], al[4];
        const int off = (16 * kc + at_row) * kLdDP + 16 * ti + at_col;
        split_bf16::ldmatrix_x4_trans(ah, dp_hi + off);
        split_bf16::ldmatrix_x4_trans(al, dp_lo + off);
#pragma unroll
        for (int a = 0; a < K; ++a) {
          uint32_t b[4];
          split_bf16::ldmatrix_x4_trans(b,
                                        b2 + 16 * kc * kLdB + b_off + a * 8);
          mma(y[a], ah, b[0], b[1]);
          mma(y[a], ah, b[2], b[3]);
          mma(y[a], al, b[0], b[1]);
        }
      }
    }

    // out[m] = pair[m] + (w2[p] *) R[m] at this thread's points.
    float* __restrict__ out = ptrs.out[comp];
#pragma unroll
    for (int m = 0; m < K; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!plive[r]) continue;
        if constexpr (V == kAffine) {
          store2(out + roff[r] + m * slab_step + e, e, num_e, vec,
                 fmaf(w2v[r], rr[m][r][0], y[m][2 * r]),
                 fmaf(w2v[r], rr[m][r][1], y[m][2 * r + 1]));
        } else {
          store2(out + roff[r] + m * slab_step + e, e, num_e, vec,
                 y[m][2 * r] + rr[m][r][0], y[m][2 * r + 1] + rr[m][r][1]);
        }
      }
    }
    tile = next_tile;
    comp = next_comp;
  }
}

// The congruent kernel (stiffness3d_pair.cu): the columns tiling of
// Layout, with the split A2 (Mp x Mp) in place of DP, a ring of two field
// operands B1 and no flux operand.  Mirrored by
// cuda_stiffness3d.pair_congruent_layout (tested on the CPU).
template <int K>
struct CongruentLayout {
  using Tiling = Layout<K, kXi>;
  static constexpr int M = Tiling::M;
  static constexpr int Mp = Tiling::Mp;
  static constexpr int kTiles = Tiling::kTiles;
  static constexpr int kTE = Tiling::kTE;
  static constexpr int kThreads = Tiling::kThreads;
  static constexpr int kLdB = Tiling::kLdB;
  static constexpr int kLdA = Mp + 8;
  // c11 At (k^2), w (k), W2hi and W2lo (k^2 each), float32.
  static constexpr int kTableUsed = 3 * K * K + K;
  static constexpr int kTable = (kTableUsed + 3) / 4 * 4;
  static constexpr int kAPart = Mp * kLdA;  // bf16, hi or lo
  static constexpr int kBPart = Mp * kLdB;
  static constexpr int kSmem = kTable * 4 + 4 * kAPart + 8 * kBPart;
  static_assert(kSmem <= kSmemLimit, "shared memory");
  static_assert(((kLdA / 8) & 1) == 1,
                "rows of an odd number of 16-byte units");
};

// The congruent operator in pair-axis form on xi-slabs,
//
//   out[a] = w_a mm3(A2, u[a]) + sum_b (c11 At)[a, b] mm3(W2, u[b]),
//
// A2 = c22 At (x) W + c33 W (x) At split on the host, W2 = diag(w (x) w):
// its mm3 is three exact products a point, (W2hi uhi + W2hi ulo) + W2lo uhi,
// and the xi chain is FP32 FFMA.  Per unit (tile, component): each thread
// splits the field it holds at its points into the operand B1 of the unit
// (a ring of two, so that one barrier a unit suffices: a warp writes the
// next unit's operand only after every warp passed the barrier that follows
// the products of the unit before it) and forms the W2 products and the
// chain from the same registers; after the barrier the next unit's field is
// in flight while A2 multiplies every slab's columns, each A fragment a
// warp loads feeding its k n8 fragments, and the thread adds w_a A2 u[a]
// and the chain at its points and stores them.
template <int K>
__global__ void __launch_bounds__(CongruentLayout<K>::kThreads, 1)
pair_congruent_kernel(const __nv_bfloat16* __restrict__ a2,
                      const float* __restrict__ table, Pointers ptrs,
                      int num_c, int num_e, bool vec) {
  using L = CongruentLayout<K>;
  constexpr int M = L::M;
  constexpr int Mp = L::Mp;
  constexpr int kLdA = L::kLdA;
  constexpr int kLdB = L::kLdB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tab = reinterpret_cast<float*>(smem_raw);
  const float* cat = tab;  // c11 At[a][b] at a K + b
  const float* w_s = cat + K * K;
  const float* w2hi_s = w_s + K;
  const float* w2lo_s = w2hi_s + M;
  __nv_bfloat16* a_hi = reinterpret_cast<__nv_bfloat16*>(tab + L::kTable);
  __nv_bfloat16* a_lo = a_hi + L::kAPart;
  // B1 of ring slot q, part pt at b_s + (2 q + pt) kBPart:
  // [p][(group K + a) 8 + e].
  __nv_bfloat16* b_s = a_lo + L::kAPart;

  const int tid = threadIdx.x;
  for (int i = tid; i < L::kTableUsed; i += L::kThreads) tab[i] = table[i];
  for (int v = tid; v < 2 * Mp * (Mp / 8); v += L::kThreads) {
    const int row = v / (Mp / 8);  // part Mp + r
    const int c = (v - row * (Mp / 8)) * 8;
    *reinterpret_cast<uint4*>(a_hi + row * kLdA + c) =
        *reinterpret_cast<const uint4*>(a2 + row * Mp + c);
  }
  __syncthreads();

  // Warp (ti, grp): pair rows 16 ti + g (+ 8), column group grp; the thread's
  // points are those rows at elements 2t, 2t + 1 of the group.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ti = warp % L::kTiles;
  const int grp = warp / L::kTiles;
  const int prow[2] = {16 * ti + g, 16 * ti + g + 8};
  const bool plive[2] = {prow[0] < M, prow[1] < M};
  const long long roff[2] = {static_cast<long long>(prow[0]) * num_e,
                             static_cast<long long>(prow[1]) * num_e};
  const long long slab_step = static_cast<long long>(M) * num_e;
  const int col0 = grp * K * 8 + 2 * t;
  const float w2h[2] = {plive[0] ? w2hi_s[prow[0]] : 0.0f,
                        plive[1] ? w2hi_s[prow[1]] : 0.0f};
  const float w2l[2] = {plive[0] ? w2lo_s[prow[0]] : 0.0f,
                        plive[1] ? w2lo_s[prow[1]] : 0.0f};
  // ldmatrix row addresses: A2 tiles (rows lane % 16, column half lane /
  // 16); B1 (rows lane % 16 of the hi part for lanes 0-15, of the lo part
  // for lanes 16-31).
  const int a_off = (16 * ti + (lane & 15)) * kLdA + (lane >> 4) * 8;
  const int b_off = ((lane >> 4) * L::kBPart + (lane & 15) * kLdB +
                     grp * K * 8);

  const int num_tiles = (num_e + L::kTE - 1) / L::kTE;
  float uv[K][2][2];  // the field at this thread's points, every slab
  auto load_field = [&](int tile, int comp) {
    const long long e = static_cast<long long>(tile) * L::kTE + grp * 8 +
                        2 * t;
    const float* u = ptrs.u[comp];
#pragma unroll
    for (int m = 0; m < K; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        load2<true>(u + roff[r] + m * slab_step + e, plive[r], e, num_e, vec,
                    uv[m][r]);
      }
    }
  };

  int tile = blockIdx.x;
  int comp = 0;
  int slot = 0;
  if (tile < num_tiles) load_field(tile, 0);
  while (tile < num_tiles) {
    const long long e = static_cast<long long>(tile) * L::kTE + grp * 8 +
                        2 * t;
    __nv_bfloat16* b1_hi = b_s + 2 * slot * L::kBPart;

    // The split of the field into B1, the W2 products and the chain, from
    // the same values.
    float ch[K][2][2];
    {
      float w2u[K][2][2];
#pragma unroll
      for (int b = 0; b < K; ++b) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          store_split2(uv[b][r][0], uv[b][r][1], b1_hi, b1_hi + L::kBPart,
                       prow[r] * kLdB + col0 + b * 8);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float x = uv[b][r][j];
            const float uhi = __bfloat162float(__float2bfloat16_rn(x));
            const float ulo = __bfloat162float(__float2bfloat16_rn(x - uhi));
            float v = w2h[r] * uhi;
            v += w2h[r] * ulo;
            v += w2l[r] * uhi;
            w2u[b][r][j] = v;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < K; ++a) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float s = 0.0f;
#pragma unroll
            for (int b = 0; b < K; ++b) {
              s = fmaf(cat[a * K + b], w2u[b][r][j], s);
            }
            ch[a][r][j] = s;
          }
        }
      }
    }
    __syncthreads();  // B1 complete; every warp is done with the other slot

    // The next unit's field, in flight during the products.
    int next_tile = tile;
    int next_comp = comp + 1;
    if (next_comp == num_c) {
      next_comp = 0;
      next_tile += gridDim.x;
    }
    if (next_tile < num_tiles) load_field(next_tile, next_comp);

    // mm3(A2, U) over every slab's columns: the A tiles of this warp's rows
    // once per 16-deep chunk, each feeding the k slabs.
    float acc[K][4];
#pragma unroll
    for (int a = 0; a < K; ++a) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = 0.0f;
    }
#pragma unroll
    for (int kc = 0; kc < Mp / 16; ++kc) {
      uint32_t ah[4], al[4];
      split_bf16::ldmatrix_x4(ah, a_hi + a_off + 16 * kc);
      split_bf16::ldmatrix_x4(al, a_lo + a_off + 16 * kc);
#pragma unroll
      for (int a = 0; a < K; ++a) {
        uint32_t b[4];  // uhi (b0, b1), ulo (b2, b3)
        split_bf16::ldmatrix_x4_trans(b,
                                      b1_hi + 16 * kc * kLdB + b_off + a * 8);
        mma(acc[a], ah, b[0], b[1]);
        mma(acc[a], ah, b[2], b[3]);
        mma(acc[a], al, b[0], b[1]);
      }
    }

    // out[a] = w_a A2 u[a] + chain at this thread's points; fragment entry
    // q = 2 r + j is the point (row r, element j).
    float* __restrict__ out = ptrs.out[comp];
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const float wa = w_s[a];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!plive[r]) continue;
        store2(out + roff[r] + a * slab_step + e, e, num_e, vec,
               fmaf(wa, acc[a][2 * r], ch[a][r][0]),
               fmaf(wa, acc[a][2 * r + 1], ch[a][r][1]));
      }
    }
    tile = next_tile;
    comp = next_comp;
    slot ^= 1;
  }
}

template <int K, int V>
int launch_k(const __nv_bfloat16* dp, const uint4* atf, const float* table,
             const Pointers& ptrs, int num_c, int num_e, bool vec, int grid,
             cudaStream_t stream) {
  using L = Layout<K, V>;
  static const int attr =
      split_bf16::allow_smem(pair_columns_kernel<K, V>, L::kSmem);
  if (attr != 0) return attr;
  pair_columns_kernel<K, V><<<grid, L::kThreads, L::kSmem, stream>>>(
      dp, atf, table, ptrs, num_c, num_e, vec);
  return static_cast<int>(cudaGetLastError());
}

// out = [tile_e, threads, shared bytes, resident blocks per SM].
template <int K, int V>
int layout_k(int* out) {
  using L = Layout<K, V>;
  const int attr = split_bf16::allow_smem(pair_columns_kernel<K, V>, L::kSmem);
  if (attr != 0) return attr;
  out[0] = L::kTE;
  out[1] = L::kThreads;
  out[2] = L::kSmem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], pair_columns_kernel<K, V>, L::kThreads, L::kSmem));
}

template <int V, int K = kMinK>
int dispatch(int k, const __nv_bfloat16* dp, const uint4* atf,
             const float* table, const Pointers* ptrs, int num_c, int num_e,
             bool vec, int grid, cudaStream_t stream, int* layout_out) {
  if constexpr (K > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k == K) {
      if (layout_out != nullptr) return layout_k<K, V>(layout_out);
      return launch_k<K, V>(dp, atf, table, *ptrs, num_c, num_e, vec, grid,
                            stream);
    }
    return dispatch<V, K + 1>(k, dp, atf, table, ptrs, num_c, num_e, vec,
                              grid, stream, layout_out);
  }
}

// Variant V's geometry at k: out = [tile_e, threads, shared bytes, resident
// blocks per SM on the current device].
template <int V>
int layout(int k, int* out) {
  return dispatch<V>(k, nullptr, nullptr, nullptr, nullptr, 0, 0, false, 0,
                     nullptr, out);
}

// `gs` holds the kFactors field pointers (affine: one, the (6, E)
// coefficients); `table` is D (affine: D, Dw, w, w2); `atf` the affine T's
// fragments (else null); `grid` persistent blocks walk the tiles of kTE
// elements (cuda_stiffness3d.pair_columns_grid).
template <int V>
int launch(const void* dp, const void* atf, const void* table,
           const void* const* us, const void* const* gs, void* const* outs,
           int num_c, int k, int num_e, int grid, void* stream) {
  if (num_c < 1 || num_c > kMaxComponents || k < kMinK || k > kMaxK ||
      num_e < 0 || grid < 1 || (V == kAffine && atf == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_e == 0) return static_cast<int>(cudaGetLastError());
  Pointers ptrs = {};
  // 8-byte loads and stores where every row of every field is aligned.
  bool vec = num_e % 2 == 0;
  for (int c = 0; c < num_c; ++c) {
    ptrs.u[c] = static_cast<const float*>(us[c]);
    ptrs.out[c] = static_cast<float*>(outs[c]);
    vec = vec && reinterpret_cast<uintptr_t>(us[c]) % 8 == 0 &&
          reinterpret_cast<uintptr_t>(outs[c]) % 8 == 0;
  }
  for (int f = 0; f < (V == kAffine ? 1 : kFactors); ++f) {
    ptrs.g[f] = static_cast<const float*>(gs[f]);
    vec = vec && reinterpret_cast<uintptr_t>(gs[f]) % 8 == 0;
  }
  return dispatch<V>(k, static_cast<const __nv_bfloat16*>(dp),
                     static_cast<const uint4*>(atf),
                     static_cast<const float*>(table), &ptrs, num_c, num_e,
                     vec, grid, static_cast<cudaStream_t>(stream), nullptr);
}

}  // namespace pair_columns

#endif  // SWIRLFEM_STIFFNESS3D_PAIR_COLUMNS_CUH_
