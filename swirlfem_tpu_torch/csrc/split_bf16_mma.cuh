// Split-bf16 products on Hopper tensor cores, shared by the kernels of the
// 'bf16x3' and 'default' stiffness classes: the block-tile product of
// stiffness_split.cu, the fragment-level product (`fragment_product`, at its
// definition) of the bf16x3 pair kernels, and the fragment primitives of
// stiffness2d_affine_split.cu.
//
// The TPU kernels of these classes (swirlfem_tpu/ops/pallas_stiffness.py:
// _kernel_uniform_mm3, _kernel_affine_mm3, and _kernel_uniform_mm /
// _kernel_affine_mm at Precision.DEFAULT) compute y = A u for a static
// operator A (float64 on the host, rounded to float32) and a float32 field
// u of E columns, in bf16 passes with float32 accumulation:
//
//   host:   hi = bf16(A),  lo = bf16(A - f32(hi))
//   kernel: uhi = bf16(u), ulo = bf16(u - f32(uhi))       (both RNE)
//   'bf16x3' (3 passes): y = hi uhi + hi ulo + lo uhi
//   'default' (1 pass):  y = hi uhi
//
// A bf16 x bf16 product is exact in float32, so this code and a plain
// emulation differ only in the order of their float32 sums.
//
// Layouts.  The host passes hi and lo row-major, NOPS blocks of rows_pad
// rows each (block o's row r at o * rows_pad + r), every row depth_pad long;
// rows_pad and depth_pad are multiples of 16 and the padding is zero.  The
// field is (depth, E) float32, E contiguous, read as it lies and split here.
//
// Block tile.  A block owns a BM x BN tile of Y (BM operator rows, BN
// element columns) for each of the NOPS operator blocks and walks the depth
// in chunks of BK through two shared-memory stages.  Per chunk it copies the
// operator slices (hi, and lo with three passes) with 16-byte cp.async, loads
// the field slice (BK x BN, coalesced along E, zero beyond the depth and the
// ragged E edge) into registers, splits it and stores uhi (and ulo) beside
// them; the next chunk's copies and loads are in flight while the current
// one is multiplied, with one barrier per chunk.  Every shared row is
// padded by 8 bf16 so that its stride is an odd number of 16-byte units: the
// eight rows one ldmatrix phase reads fall on distinct banks.  The warps,
// WARPS_M x WARPS_N, each own a (BM / WARPS_M) x (BN / WARPS_N) sub-tile of
// m16n8k16 fragments: A through ldmatrix.x4, B (stored k-major, as the field
// lies) through ldmatrix.x4.trans, and mma.sync.m16n8k16.row.col.f32.bf16
// into float32 registers.  The accumulators of the NOPS operator blocks
// share every B fragment.  A warp skips fragment rows at or beyond rows_pad.
// wgmma, TMA and a deeper pipeline are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace split_bf16 {

constexpr int kMaxComponents = 4;
constexpr int kRowPad = 8;  // bf16 of padding at the end of each shared row

struct Pointers {
  const float* u[kMaxComponents];
  float* out[kMaxComponents];
};

// The host's split operator: hi and lo, NOPS blocks of rows_pad rows.
struct Operator {
  const __nv_bfloat16* hi;
  const __nv_bfloat16* lo;  // read only with three passes
  int rows_pad;
  int depth_pad;
};

template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_, int PASSES_,
          int NOPS_, int MIN_BLOCKS_ = 1>
struct Config {
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;  // per SM, for the compiler
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int BK = BK_;
  static constexpr int WARPS_M = WARPS_M_;
  static constexpr int WARPS_N = WARPS_N_;
  static constexpr int PASSES = PASSES_;
  static constexpr int NOPS = NOPS_;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int kParts = PASSES == 3 ? 2 : 1;  // hi, and lo
  static constexpr int WM = BM / WARPS_M;              // warp tile rows
  static constexpr int WN = BN / WARPS_N;              // warp tile columns
  static constexpr int MI = WM / 16;                   // m16 fragments
  static constexpr int NI = WN / 8;                    // n8 fragments
  static constexpr int kLdA = BK + kRowPad;
  static constexpr int kLdB = BN + kRowPad;
  static constexpr int kATile = BM * kLdA;  // bf16 of one (block, part) slice
  static constexpr int kBTile = BK * kLdB;  // bf16 of one field part
  static constexpr int kAStage = NOPS * kParts * kATile;
  static constexpr int kStage = kAStage + kParts * kBTile;  // bf16 per stage
  static constexpr int kSmemBytes = 2 * kStage * 2;  // two stages
  static constexpr int kFieldPerThread = BK * BN / kThreads;

  static_assert(PASSES == 1 || PASSES == 3, "one or three bf16 passes");
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "tile shape");
  static_assert((kLdA * 2 / 16) % 2 == 1 && (kLdA * 2) % 16 == 0,
                "operator rows: an odd number of 16-byte units");
  static_assert((kLdB * 2 / 16) % 2 == 1 && (kLdB * 2) % 16 == 0,
                "field rows: an odd number of 16-byte units");
  static_assert((BK * BN) % kThreads == 0, "field slice per thread");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The two 8x8 bf16 matrices of an m16n8k16 B fragment from a k-major tile;
// lanes 0-15 give the row addresses (k 0-7, then k 8-15).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a b on one m16n8k16 fragment, bf16 inputs, float32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The accumulators of one block tile: per operator block, per fragment.
// Fragment (mi, ni) holds rows g and g + 8, columns 2t and 2t + 1 of its
// 16 x 8 tile (g = lane / 4, t = lane % 4) in d[0..1] and d[2..3].
template <class Cfg>
using Accumulators = float[Cfg::NOPS][Cfg::MI][Cfg::NI][4];

// Starts the 16-byte copies of the operator slices of the depth chunk at k0
// into `a_s` ([NOPS][kParts][BM][kLdA]); zero past rows_pad and depth_pad.
template <class Cfg>
__device__ __forceinline__ void copy_operator_chunk(const Operator& op,
                                                    int m0, int k0,
                                                    __nv_bfloat16* a_s) {
  constexpr int BK = Cfg::BK;
  constexpr int kVecs = Cfg::BM * (BK / 8);  // per (block, part) slice
  for (int idx = threadIdx.x; idx < Cfg::NOPS * Cfg::kParts * kVecs;
       idx += Cfg::kThreads) {
    const int slice = idx / kVecs;  // o * kParts + part
    const int v = idx - slice * kVecs;
    const int r = v / (BK / 8);
    const int c = (v - r * (BK / 8)) * 8;
    const int o = slice / Cfg::kParts;
    const int part = slice - o * Cfg::kParts;
    __nv_bfloat16* dst = a_s + slice * Cfg::kATile + r * Cfg::kLdA + c;
    if (m0 + r < op.rows_pad && k0 + c < op.depth_pad) {
      const __nv_bfloat16* src =
          (part == 0 ? op.hi : op.lo) +
          static_cast<long long>(o * op.rows_pad + m0 + r) * op.depth_pad +
          k0 + c;
      __pipeline_memcpy_async(dst, src, 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __pipeline_commit();
}

// Loads this thread's entries of the field's depth chunk at k0 (coalesced
// along E; zero past the depth and the ragged E edge).
template <class Cfg>
__device__ __forceinline__ void load_field_chunk(
    const float* __restrict__ u, int depth, int num_e, int k0, int n0,
    float (&vals)[Cfg::kFieldPerThread]) {
#pragma unroll
  for (int s = 0; s < Cfg::kFieldPerThread; ++s) {
    const int idx = threadIdx.x + s * Cfg::kThreads;
    const int r = idx / Cfg::BN;
    const int c = idx - r * Cfg::BN;
    vals[s] = (k0 + r < depth && n0 + c < num_e)
                  ? u[static_cast<long long>(k0 + r) * num_e + n0 + c]
                  : 0.0f;
  }
}

// Splits the loaded entries into uhi (and ulo) in `b_s` ([kParts][BK][kLdB]).
template <class Cfg>
__device__ __forceinline__ void store_field_split(
    const float (&vals)[Cfg::kFieldPerThread], __nv_bfloat16* b_s) {
#pragma unroll
  for (int s = 0; s < Cfg::kFieldPerThread; ++s) {
    const int idx = threadIdx.x + s * Cfg::kThreads;
    const int r = idx / Cfg::BN;
    const int c = idx - r * Cfg::BN;
    const __nv_bfloat16 hi = __float2bfloat16_rn(vals[s]);
    b_s[r * Cfg::kLdB + c] = hi;
    if (Cfg::kParts == 2) {
      b_s[Cfg::kBTile + r * Cfg::kLdB + c] =
          __float2bfloat16_rn(vals[s] - __bfloat162float(hi));
    }
  }
}

// The products of one depth chunk held in shared memory, into `acc`.
template <class Cfg>
__device__ __forceinline__ void multiply_chunk(const __nv_bfloat16* a_s,
                                               const __nv_bfloat16* b_s,
                                               int m0, int rows_pad,
                                               Accumulators<Cfg>& acc) {
  constexpr int kParts = Cfg::kParts;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / Cfg::WARPS_N;
  const int wn = warp % Cfg::WARPS_N;
#pragma unroll
  for (int ks = 0; ks < Cfg::BK; ks += 16) {
    // B fragments of the warp's columns: x4.trans gives (k 0-7, k 8-15) of
    // two neighbouring n8 fragments.
    uint32_t bf[kParts][Cfg::NI][2];
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
#pragma unroll
      for (int nj = 0; nj < Cfg::NI / 2; ++nj) {
        const int k = ks + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = wn * Cfg::WN + nj * 16 + (lane >> 4) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, b_s + part * Cfg::kBTile + k * Cfg::kLdB + n);
        bf[part][2 * nj][0] = r[0];
        bf[part][2 * nj][1] = r[1];
        bf[part][2 * nj + 1][0] = r[2];
        bf[part][2 * nj + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int mi = 0; mi < Cfg::MI; ++mi) {
      const int row = wm * Cfg::WM + mi * 16;
      if (m0 + row >= rows_pad) continue;  // warp-uniform
#pragma unroll
      for (int o = 0; o < Cfg::NOPS; ++o) {
        uint32_t af[kParts][4];
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
          ldmatrix_x4(af[part], a_s + (o * kParts + part) * Cfg::kATile +
                                    (row + (lane & 15)) * Cfg::kLdA + ks +
                                    (lane >> 4) * 8);
        }
#pragma unroll
        for (int ni = 0; ni < Cfg::NI; ++ni) {
          mma_bf16(acc[o][mi][ni], af[0], bf[0][ni]);
          if (Cfg::PASSES == 3) {
            mma_bf16(acc[o][mi][ni], af[0], bf[kParts - 1][ni]);
            mma_bf16(acc[o][mi][ni], af[kParts - 1], bf[0][ni]);
          }
        }
      }
    }
  }
}

// Y[m0:m0+BM, n0:n0+BN] of each operator block into `acc` (zeroed here).
// `u` is the (depth, num_e) field; `smem` holds Cfg::kSmemBytes: two stages
// of operator and field slices.  While one depth chunk is multiplied, the
// next one's operator slices are in flight (cp.async) and its field entries
// in registers; one barrier per chunk.
template <class Cfg>
__device__ __forceinline__ void block_product(const Operator& op,
                                              const float* __restrict__ u,
                                              int depth, int num_e, int m0,
                                              int n0, __nv_bfloat16* smem,
                                              Accumulators<Cfg>& acc) {
#pragma unroll
  for (int o = 0; o < Cfg::NOPS; ++o) {
#pragma unroll
    for (int mi = 0; mi < Cfg::MI; ++mi) {
#pragma unroll
      for (int ni = 0; ni < Cfg::NI; ++ni) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[o][mi][ni][q] = 0.0f;
      }
    }
  }
  // Stage s: operator slices at smem + s * kStage, field parts after them.
  auto a_stage = [&](int s) { return smem + s * Cfg::kStage; };
  auto b_stage = [&](int s) { return smem + s * Cfg::kStage + Cfg::kAStage; };
  const int num_chunks = (op.depth_pad + Cfg::BK - 1) / Cfg::BK;
  float vals[Cfg::kFieldPerThread];
  copy_operator_chunk<Cfg>(op, m0, 0, a_stage(0));
  load_field_chunk<Cfg>(u, depth, num_e, 0, n0, vals);
  store_field_split<Cfg>(vals, b_stage(0));
  for (int chunk = 0; chunk < num_chunks; ++chunk) {
    const int cur = chunk & 1;
    // This chunk's stage is complete, and every warp is done with the other.
    __pipeline_wait_prior(0);
    __syncthreads();
    const bool more = chunk + 1 < num_chunks;
    if (more) {
      const int k0 = (chunk + 1) * Cfg::BK;
      copy_operator_chunk<Cfg>(op, m0, k0, a_stage(cur ^ 1));
      load_field_chunk<Cfg>(u, depth, num_e, k0, n0, vals);
    }
    multiply_chunk<Cfg>(a_stage(cur), b_stage(cur), m0, op.rows_pad, acc);
    if (more) store_field_split<Cfg>(vals, b_stage(cur ^ 1));
  }
}

// The fragment-level split product, for kernels that keep both operands in
// shared memory (the congruent bf16x3 pair kernel, stiffness3d_pair.cu):
//
//   acc[o][j] += A_o[row[j] : row[j] + 16, 0 : depth] B[0 : depth,
//                col[j] : col[j] + 8]
//
// for the NF m16n8 fragments j of the calling warp with valid[j] (warp
// uniform), over the NOPS operator blocks A_o = a + o * a_stride.  Both
// operands are split: A as hi / lo (row-major, `lda` bf16 a row), B as its
// hi / lo parts (k-major, `ldb` a row); 'bf16x3' (PASSES = 3) adds
// hi uhi + hi ulo + lo uhi, 'default' hi uhi.  `depth` is a multiple of 16;
// rows are 16-byte aligned.  The fragment layout of acc[o][j] is that of
// `Accumulators`: rows g and g + 8, columns 2t and 2t + 1.  The three passes
// accumulate apart and are added at the end, (hh + hl) + lh, as the JAX
// kernels add their three products; the three independent mma chains also
// overlap each other's latency.  With TRANS_A the operator is read as the
// transpose of what lies in shared memory: A_o[r][c] = a[c lda + r]
// (ldmatrix.trans of the stored 16 x 16 tiles), so that one stored split
// serves a product and its transpose.
template <int PASSES, int NOPS, int NF, bool TRANS_A = false>
__device__ __forceinline__ void fragment_product(
    const __nv_bfloat16* a_hi, const __nv_bfloat16* a_lo, int lda,
    int a_stride, const __nv_bfloat16* b_hi, const __nv_bfloat16* b_lo,
    int ldb, int depth, const int (&row)[NF], const int (&col)[NF],
    const bool (&valid)[NF], float (&acc)[NOPS][NF][4]) {
  static_assert(PASSES == 1 || PASSES == 3, "one or three bf16 passes");
  const int lane = threadIdx.x & 31;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  // Lane l gives the address of row l % 8 of 8 x 8 matrix l / 8 of the
  // 16 x 16 A tile (a0-a3: rows 0-7 / 8-15 of columns 0-7, then 8-15).  A
  // transposed tile stores those matrices transposed: matrix 1 (rows 8-15
  // of A) lies at stored columns 8-15, matrix 2 (columns 8-15 of A) at
  // stored rows 8-15.
  const int a_row = TRANS_A ? (lane & 7) + ((lane >> 4) & 1) * 8 : lane & 15;
  const int a_col = TRANS_A ? ((lane >> 3) & 1) * 8 : (lane >> 4) * 8;
  float hl[NOPS][NF][4], lh[NOPS][NF][4];
#pragma unroll
  for (int o = 0; o < NOPS; ++o) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) hl[o][j][q] = lh[o][j][q] = 0.0f;
    }
  }
  for (int ks = 0; ks < depth; ks += 16) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      if (!valid[j]) continue;  // warp-uniform
      uint32_t bh[2], bl[2];
      const int b_off = (ks + b_row) * ldb + col[j];
      ldmatrix_x2_trans(bh, b_hi + b_off);
      if (PASSES == 3) ldmatrix_x2_trans(bl, b_lo + b_off);
#pragma unroll
      for (int o = 0; o < NOPS; ++o) {
        const int a_off =
            TRANS_A ? o * a_stride + (ks + a_row) * lda + row[j] + a_col
                    : o * a_stride + (row[j] + a_row) * lda + ks + a_col;
        uint32_t ah[4], al[4];
        if (TRANS_A) {
          ldmatrix_x4_trans(ah, a_hi + a_off);
        } else {
          ldmatrix_x4(ah, a_hi + a_off);
        }
        mma_bf16(acc[o][j], ah, bh);
        if (PASSES == 3) {
          if (TRANS_A) {
            ldmatrix_x4_trans(al, a_lo + a_off);
          } else {
            ldmatrix_x4(al, a_lo + a_off);
          }
          mma_bf16(hl[o][j], ah, bl);
          mma_bf16(lh[o][j], al, bh);
        }
      }
    }
  }
  if (PASSES == 3) {
#pragma unroll
    for (int o = 0; o < NOPS; ++o) {
#pragma unroll
      for (int j = 0; j < NF; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[o][j][q] = (acc[o][j][q] + hl[o][j][q]) + lh[o][j][q];
        }
      }
    }
  }
}

// (hi, lo) of two neighbouring values as bf16 pairs, x in the low half:
// hi = bf16(x), lo = bf16(x - hi), round to nearest even.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Splits v into hi = bf16(v) and lo = bf16(v - hi), round to nearest even
// (the JAX kernels' field split), and stores them at hi_p[i], lo_p[i].
__device__ __forceinline__ void store_split(float v, __nv_bfloat16* hi_p,
                                            __nv_bfloat16* lo_p, int i) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  hi_p[i] = hi;
  lo_p[i] = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// Checks shared by the entry points; returns a CUDA error code or 0.
inline int check_args(int num_c, int rows, int depth, int rows_pad,
                      int depth_pad, int num_e) {
  if (num_c < 1 || num_c > kMaxComponents || rows < 1 || depth < 1 ||
      rows > rows_pad || depth > depth_pad || rows_pad % 16 != 0 ||
      depth_pad % 16 != 0 || num_e < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// Raises the kernel's dynamic shared memory limit where it needs more than
// the default 48 KB.
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace split_bf16
