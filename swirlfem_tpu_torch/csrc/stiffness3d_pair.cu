// Congruent-element 3D stiffness in pair-axis form, class bf16x3, for
// C <= 4 components.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness3d.py:stiffness3d_el_pallas_pair
// (_kernel_3d_pair, always bf16x3).  With the (eta, zeta) pair merged into
// one axis of M = k^2 entries, a field is k xi-slabs u[a] of shape (M, E),
// and on an axis-aligned box of identical elements
//
//   out[a] = w_a mm3(A2, u[a]) + sum_b (c11 At)[a, b] mm3(W2, u[b]),
//   A2 = c22 At (x) W + c33 W (x) At   (M x M),   W2 = diag(w (x) w),
//
// with At = D^T W D, W = diag(w), and mm3 the class bf16x3: the host split
// of the float64 operator (hi, lo) times the split of the field (bf16(u),
// bf16(u - hi)), hi uhi + hi ulo + lo uhi in float32.  A2 is split on the
// host and multiplied on the tensor cores.  W2 is diagonal: its mm3 is
// three exact products a point, (W2hi uhi + W2hi ulo) + W2lo uhi, on FFMA,
// as its class defines it; the xi chain over b stays FP32 FFMA.  The table
// (float32, built in float64 on the host) is [c11 At (k^2, row-major),
// w (k), W2hi (M), W2lo (M)].  Fields are (k, k, k, E), element axis last.
//
// Design.  A block owns TE = 32 consecutive elements of one component
// (blockIdx.y); 8 warps.  It splits the component's (k M, TE) tile once into
// bf16 hi / lo in shared memory (80 KB at order 7), beside the split A2
// (18 KB; M padded with zeros to Mp, a multiple of 16): 99 KB, two blocks
// per SM.  At k = 10 a 32-element tile needs 234,208 B, past the 232,448 a
// block may use, so the tile is 16 elements wherever 32 does not fit
// (`Layout::kTE`, chosen per k: 162 KB at k = 10, one block per SM).  Per
// slab the (Mp, TE) product A2 u[a] runs as mma.sync m16n8k16
// fragments (split_bf16_mma.cuh: fragment_product), each warp owning the
// same fragments in every slab, so a thread holds A2 u[a] for all k slabs
// at its points (p, e); there it forms W2 u[b] from the split tile and the
// xi chain, and stores the k outputs.  One barrier, after the split.  (A
// first version with scalar field loads took 103.8 us at 16^3 elements,
// order 7, C = 3 on an H100 at 700 W.)
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s dense bf16) at 16^3
// elements, order 7, C = 3, float32: 2 C k^3 E 4 B = 50.3 MB, 15.02 us;
// tensor-core operations 6 k^5 E C = 2.4 GFLOP, 2.4 us.  Memory sets the
// bound.  (The FP32 FFMA version that preceded this class took 71.7 us.)

#include "split_bf16_mma.cuh"

namespace {

constexpr int kMaxComponents = 4;
constexpr int kMinK = 2;
constexpr int kMaxK = 10;
constexpr int kWarps = 8;
constexpr int kSmemLimit = 232448;
constexpr int kThreads = 32 * kWarps;

struct Pointers {
  const float* u[kMaxComponents];
  float* out[kMaxComponents];
};

// Written out in tests/test_torch_kernel_host.py (_pair_smem).
template <int K, int TE>
struct TileLayout {
  static constexpr int M = K * K;
  static constexpr int Mp = (M + 15) / 16 * 16;
  static constexpr int kTE = TE;        // elements per block
  static constexpr int kLdA = Mp + 8;   // bf16 rows of A2
  static constexpr int kLdB = kTE + 8;  // bf16 rows of the split tile
  static constexpr int kTable = K * K + K + 2 * M;
  static constexpr int kTablePadded = (kTable + 3) & ~3;
  static constexpr int kA = Mp * kLdA;      // bf16 per part
  static constexpr int kU = K * Mp * kLdB;  // bf16 per part
  static constexpr size_t kSmem =
      static_cast<size_t>(kTablePadded) * 4 +
      static_cast<size_t>(2 * (kA + kU)) * 2;
  static constexpr int kFrags = (Mp / 16) * (kTE / 8);
  static constexpr int NF = (kFrags + kWarps - 1) / kWarps;
  // Two blocks per SM where shared memory allows it (k <= 8); else the
  // compiler may give a thread all 255 registers.
  static constexpr int kMinBlocks = 2 * (kSmem + 1024) <= 233472 ? 2 : 1;
};

// 32 elements a block where that fits, else 16.
template <int K>
struct Layout : TileLayout<K, (TileLayout<K, 32>::kSmem <= kSmemLimit ? 32
                                                                       : 16)> {
};

template <int K>
__global__ void __launch_bounds__(kThreads, Layout<K>::kMinBlocks)
stiffness3d_pair_kernel(const __nv_bfloat16* __restrict__ a2,
                        const float* __restrict__ table, Pointers ptrs,
                        int num_e, bool vec) {
  using L = Layout<K>;
  constexpr int M = L::M;
  constexpr int Mp = L::Mp;
  constexpr int NF = L::NF;
  constexpr int kTE = L::kTE;
  static_assert(L::kSmem <= kSmemLimit, "shared memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tab = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(tab + L::kTablePadded);
  __nv_bfloat16* u_s = a_s + 2 * L::kA;  // u_s[(a Mp + p) kLdB + col]
  const float* cat = tab;                // c11 At[a][b] at a K + b
  const float* w = cat + K * K;
  const float* w2hi = w + K;
  const float* w2lo = w2hi + M;
  const float* __restrict__ u = ptrs.u[blockIdx.y];
  float* __restrict__ out = ptrs.out[blockIdx.y];

  const int tid = threadIdx.x;
  const long long e0 = static_cast<long long>(blockIdx.x) * kTE;

  for (int i = tid; i < L::kTable; i += kThreads) tab[i] = table[i];
  for (int v = tid; v < 2 * Mp * (Mp / 8); v += kThreads) {
    const int row = v / (Mp / 8);  // part * Mp + r
    const int c = (v - row * (Mp / 8)) * 8;
    *reinterpret_cast<uint4*>(a_s + row * L::kLdA + c) =
        *reinterpret_cast<const uint4*>(a2 + row * Mp + c);
  }
  // The split tile, zero past the pair axis and the ragged E edge
  // (16-byte loads where the rows are aligned).
#pragma unroll 4
  for (int v = tid; v < K * Mp * (kTE / 4); v += kThreads) {
    const int row = v / (kTE / 4);  // a Mp + p
    const int col = (v - row * (kTE / 4)) * 4;
    const int a = row / Mp;
    const int p = row - a * Mp;
    const long long e = e0 + col;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (p < M) {
      const float* src = u + (static_cast<long long>(a) * M + p) * num_e + e;
      if (vec && e + 4 <= num_e) {
        const float4 y = *reinterpret_cast<const float4*>(src);
        x[0] = y.x;
        x[1] = y.y;
        x[2] = y.z;
        x[3] = y.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = e + i < num_e ? src[i] : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split_bf16::store_split(x[i], u_s, u_s + L::kU,
                              row * L::kLdB + col + i);
    }
  }
  __syncthreads();

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

  // acc[a][0][j] = mm3(A2, u[a]) at this thread's points.
  float acc[K][1][NF][4];
#pragma unroll
  for (int a = 0; a < K; ++a) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][0][j][q] = 0.0f;
    }
    split_bf16::fragment_product<3, 1, NF>(
        a_s, a_s + L::kA, L::kLdA, 0, u_s + a * Mp * L::kLdB,
        u_s + L::kU + a * Mp * L::kLdB, L::kLdB, Mp, frow, fcol, fvalid,
        acc[a]);
  }

#pragma unroll
  for (int j = 0; j < NF; ++j) {
    if (!fvalid[j]) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = frow[j] + g + 8 * (q >> 1);
      const int col = fcol[j] + 2 * t + (q & 1);
      const long long e = e0 + col;
      if (p >= M || e >= num_e) continue;
      // mm3(W2, u[b]) at (p, e): three exact products, summed in order.
      float w2u[K];
#pragma unroll
      for (int b = 0; b < K; ++b) {
        const int i = (b * Mp + p) * L::kLdB + col;
        const float uhi = __bfloat162float(u_s[i]);
        const float ulo = __bfloat162float(u_s[L::kU + i]);
        float v = w2hi[p] * uhi;
        v += w2hi[p] * ulo;
        v += w2lo[p] * uhi;
        w2u[b] = v;
      }
#pragma unroll
      for (int a = 0; a < K; ++a) {
        float chain = 0.0f;
#pragma unroll
        for (int b = 0; b < K; ++b) chain = fmaf(cat[a * K + b], w2u[b], chain);
        out[(static_cast<long long>(a) * M + p) * num_e + e] =
            fmaf(w[a], acc[a][0][j][q], chain);
      }
    }
  }
}

template <int K>
int launch_k(const __nv_bfloat16* a2, const float* table,
             const Pointers& ptrs, int num_c, int num_e, bool vec,
             cudaStream_t stream) {
  using L = Layout<K>;
  const int err = split_bf16::allow_smem(stiffness3d_pair_kernel<K>,
                                         static_cast<int>(L::kSmem));
  if (err != 0) return err;
  const dim3 grid((num_e + L::kTE - 1) / L::kTE, num_c);
  stiffness3d_pair_kernel<K>
      <<<grid, kThreads, L::kSmem, stream>>>(a2, table, ptrs, num_e, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int K = kMinK>
int dispatch(int k, const __nv_bfloat16* a2, const float* table,
             const Pointers& ptrs, int num_c, int num_e, bool vec,
             cudaStream_t stream) {
  if constexpr (K > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k == K) return launch_k<K>(a2, table, ptrs, num_c, num_e, vec, stream);
    return dispatch<K + 1>(k, a2, table, ptrs, num_c, num_e, vec, stream);
  }
}

}  // namespace

// a2: (2, Mp, Mp) bf16 [hi, lo]; table: float32 (3 k^2 + k); us, outs:
// (k, k, k, num_e) float32; k = order + 1 in [2, 10].
extern "C" int stiffness3d_pair_f32(const void* a2, const void* table,
                                    const void* const* us, void* const* outs,
                                    int num_c, int k, int num_e,
                                    void* stream) {
  if (num_c < 1 || num_c > kMaxComponents || k < kMinK || k > kMaxK ||
      num_e < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_e == 0) return static_cast<int>(cudaGetLastError());
  Pointers ptrs = {};
  bool vec = num_e % 4 == 0;
  for (int c = 0; c < num_c; ++c) {
    ptrs.u[c] = static_cast<const float*>(us[c]);
    ptrs.out[c] = static_cast<float*>(outs[c]);
    vec = vec && reinterpret_cast<uintptr_t>(us[c]) % 16 == 0;
  }
  return dispatch(k, static_cast<const __nv_bfloat16*>(a2),
                  static_cast<const float*>(table), ptrs, num_c, num_e, vec,
                  static_cast<cudaStream_t>(stream));
}
