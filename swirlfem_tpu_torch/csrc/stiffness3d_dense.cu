// Congruent-element 3D stiffness as ONE dense (k^3, k^3) operator:
// out_c = A @ u_c for every component c, for C <= 4 components.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness3d.py:stiffness3d_el_pallas_dense
// (_kernel_uniform_mm, precision 'highest').  On an axis-aligned box of
// identical elements the element operator
//
//   A = c11 (At x W x W) + c22 (W x At x W) + c33 (W x W x At),  At = D^T W D,
//
// is one static matrix, built in float64 on the host; the apply is the
// product of A with the (k^3, E) field of each component (element axis last).
//
// float32: 3xTF32 on the tensor cores.  The TPU runs 'highest' as a
// multi-pass bf16 emulation of float32; the Hopper counterpart is a TF32
// split.  The host rounds A to float32 and splits it, hi = rna_tf32(A) and
// lo = rna_tf32(A - hi) (`cuda_stiffness3d.dense_tf32_layout_np`); the kernel
// splits each field value it loads the same way (cvt.rna.tf32.f32: the
// tensor cores would otherwise drop the low 13 bits, and the split would be
// wrong) and adds u_lo hi + u_hi lo + u_hi hi of each 16-deep chunk into
// one float32 sum per output.  Against the float64 operator that reads
// ~3e-7 of the largest output, the FP32 class; one TF32 pass would read
// ~5e-4.
//
// Operator layout.  The host stores hi and lo as float32 bit patterns in
// the order wgmma reads its K-major B operand without swizzle: for each
// panel of 256 operator rows and 16-deep depth chunk, part (hi, lo), 8-deep
// step, 4-deep half of the step and 8-row group, one 8 x 4 core matrix of
// 128 bytes; rows padded to a multiple of 256 and the depth to one of 16
// with zeros.  A (panel, chunk) of the operator is then one contiguous 32 KB
// run, staged by 16-byte cp.async as it lies.
//
// Products.  wgmma.m64n128k8 TF32 with the field as the A operand from
// registers (M = 64 elements of a warpgroup, K = 8 depths: each thread
// loads its four values from the staged field tile as it lies and splits
// them) and the operator from shared memory (N = 128 operator rows): the
// accumulator holds out^T, and each thread stores its values straight to
// out[row][element] (8 consecutive elements per row and instruction).
// TF32 wgmma takes shared-memory operands K-major only, and the field is
// element-major; as the register operand it needs no transpose.
//
// Work (stiffness3d_dense.cuh, shared with the bf16x3 kernel).  Tiles of
// 128 elements by 256 operator rows, walked by one persistent block per
// SM over its range of (component, panel, 64-element unit) space.  At
// 16^3 elements, order 7, C = 3 that is 3 x 2 x 64 = 384 units, 2.91 a
// block on 132 SMs: the busiest block has 3, so the last "wave" is 97 %
// busy (whole 128 x 256 tiles would be 192, 1.45 waves).  The depth is
// walked in chunks of 16 through a ring of five shared-memory stages (the
// operator chunk and the field slice as it lies, rows padded by 8 floats
// so that the A fragment reads fall on distinct banks), filled by 16-byte
// cp.async four chunks ahead, across tile boundaries; one barrier per
// chunk.  Each chunk's six products of a half (two steps x three passes)
// go into a fresh accumulator, added to the tile's sums in float32.
//
// float64: FFMA (exact in the working precision).  A block of 256 threads
// owns a 64 x 64 output tile of one component; the contraction is streamed
// in panels of 8 through shared memory, each thread holding a 4 x 4 register
// tile.  The caller passes A TRANSPOSED for this body, at[j * k^3 + i] =
// A[i][j].
//
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s dense TF32) at 16^3
// elements, order 7, C = 3, float32: three TF32 passes of 2 k^6 E C =
// 6.44 GFLOP, 19.3 GFLOP, 39.0 us; (2 C k^3 E + k^6) 4 B = 51.4 MB, 15.3 us.
// The tensor cores bound it (at the FP32 FFMA rate, 67 TFLOP/s, the same
// work takes 96.2 us).  Every block reads the operator panel of each of its
// tiles from L2, 1 MB of hi / lo per 128-element tile: ~240 MB of L2
// traffic in all.  What holds it (an H100 at 700 W, built with its loads or
// its products taken out): the loads alone take 52 us, the products alone
// 78 us (two waits per chunk and warpgroup, with one accumulator free for
// the chunk sums), both 120 us: they overlap poorly.

#include "stiffness3d_dense.cuh"

namespace {

using dense3d::kHalf;
using dense3d::kMaxComponents;
using dense3d::kPanel;
using dense3d::kThreads;
using dense3d::kTileE;
using dense3d::kUnitE;
using dense3d::Pointers;
using dense3d::Shape;
using dense3d::Walk;

// -- float32: 3xTF32 ----------------------------------------------------------

namespace tf32 {

constexpr int kBK = 16;         // depth of a stage (two k8 steps)
constexpr int kStages = 5;
constexpr int kLdU = kTileE + 8;  // floats of a shared field row
// One stage: the operator chunk (2 parts x 2 k8 steps x 2 halves of 4 x
// 32 row groups x 8 rows x 4 floats: the wgmma K-major core matrices, as the
// host lays them out) and the field chunk (kBK rows of kTileE elements).
constexpr int kOpStage = 2 * kBK * kPanel;  // 8192 floats, 32 KB
constexpr int kStageFloats = kOpStage + kBK * kLdU;
constexpr int kSmemBytes = kStages * kStageFloats * 4;  // 207,360

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Starts the copies of chunk w.chunk of tile w into `stage`: the operator
// chunk of the panel (one contiguous run of kOpStage floats), then the
// field slice (kBK rows of the tile's elements, kLdU floats apart;
// zeros past the depth and the ragged E edge).
__device__ __forceinline__ void load_stage(const float* __restrict__ op,
                                           const Pointers& ptrs,
                                           const Walk& w, const Shape& s,
                                           float* stage) {
  const float* src = op + (static_cast<long long>(w.p) * s.chunks + w.chunk) *
                              kOpStage;
  for (int v = threadIdx.x; v < kOpStage / 4; v += kThreads) {
    cp_async16(stage + 4 * v, src + 4 * v);
  }
  float* u_s = stage + kOpStage;
  const float* __restrict__ u = static_cast<const float*>(ptrs.u[w.c]);
  const int e0 = w.col * kUnitE;
  const int vecs = w.width * kUnitE / 4;
  for (int idx = threadIdx.x; idx < kBK * vecs; idx += kThreads) {
    const int r = idx / vecs;
    const int v = idx - r * vecs;
    const int k = w.chunk * kBK + r;
    const int e = e0 + 4 * v;
    float* dst = u_s + r * kLdU + 4 * v;
    const float* g = u + static_cast<long long>(k) * s.num_e + e;
    if (k < s.k3 && e + 4 <= s.num_e &&
        (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      cp_async16(dst, g);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (k < s.k3 && e + q < s.num_e) {
          cp_async4(dst + q, g + q);
        } else {
          dst[q] = 0.0f;
        }
      }
    }
  }
}

// Stores a finished 64 x 128 accumulator half h of the tile (wgmma's
// m64n128 layout: entry 4 n + q of thread (g, t) of warp wrow is element
// 16 wrow + g + 8 (q >> 1), operator row 8 n + 2 t + (q & 1)) to
// out[row][element], 8 consecutive elements a row and instruction.
__device__ __forceinline__ void store_half(float* __restrict__ out,
                                           const float (&acc)[64],
                                           const Shape& s, int p, int h,
                                           int e) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = p * kPanel + kHalf * h + 8 * n + 2 * t + (q & 1);
      const int col = e + 8 * (q >> 1);
      if (row < s.k3 && col < s.num_e) {
        out[static_cast<long long>(row) * s.num_e + col] = acc[4 * n + q];
      }
    }
  }
}

// hi = rna_tf32(x), lo = rna_tf32(x - hi), as TF32 bit patterns (the low
// 13 bits cleared).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  hi &= 0xffffe000u;
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
  lo &= 0xffffe000u;
}

// d (+)= a b for one m64n128k8 TF32 product of the warpgroup: a (64 x 8,
// the elements' field values) from registers, b (8 x 128 operator rows)
// from shared memory; `accumulate` 0 starts d from zero.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__global__ void __launch_bounds__(kThreads, 1)
stiffness3d_dense_tf32_kernel(const float* __restrict__ op, Pointers ptrs,
                              Shape s, long long total_units) {
  extern __shared__ __align__(128) float smem[];
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg = threadIdx.x >> 7;          // the warpgroup: elements 64 wg..
  const int wrow = (threadIdx.x >> 5) & 3;  // its warp: 16 of them

  Walk load = dense3d::first_tile(s, total_units);
  Walk comp = load;

  float acc[2][64];  // the two 128-row halves of the tile
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[h][q] = 0.0f;
  }

  // Prologue: the first kStages - 1 chunks, one commit group each (empty
  // past the end), so that the group of step i is group i.
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (load.valid) {
      load_stage(op, ptrs, load, s,
                                               smem + st * kStageFloats);
      dense3d::advance(load, s);
    }
    cp_async_commit();
  }

  for (int step = 0; comp.valid; ++step) {
    cp_async_wait<kStages - 2>();  // this thread's copies of this step
    __syncthreads();                        // everyone's; step - 1 is done
    if (load.valid) {
      load_stage(
          op, ptrs, load, s,
          smem + ((step + kStages - 1) % kStages) * kStageFloats);
      dense3d::advance(load, s);
    }
    cp_async_commit();

    // A tile of two units: warpgroup wg takes unit wg, both halves.  A tile
    // of one unit: both take it, warpgroup wg half wg.
    const int unit = comp.width == 2 ? wg : 0;
    const int h_lo = comp.width == 2 ? 0 : wg;
    const int h_hi = comp.width == 2 ? 2 : wg + 1;
    {
      const float* op_s = smem + (step % kStages) * kStageFloats;
      const float* u_s = op_s + kOpStage;
      // A fragments of the two k8 steps: rows (elements) 16 wrow + g (+8),
      // columns (depth) t (+4), split.
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = kUnitE * unit + 16 * wrow + g + 8 * (q & 1);
          const int col = kk * 8 + t + 4 * (q >> 1);
          split_tf32(u_s[col * kLdU + row], ahi[kk][q], alo[kk][q]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h < h_lo || h >= h_hi) continue;  // warpgroup-uniform
        // The chunk's three products of each step, small ones first, from
        // zero; then one float32 add (round to nearest) into the sum.  The
        // tensor cores truncate as they accumulate: a chain over the whole
        // depth would lose the small products' low bits against the
        // running sum (~1e-6 of the output at k^3 = 512, against ~3e-7).
        float part[64];
        dense3d::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          // Operator part pt, step kk, half h: core matrices at
          // ((pt * 2 + kk) * 2 + kc) * 32 + ng, 128 bytes each.
          const float* hi_b = op_s + ((0 * 2 + kk) * 2 * 32 + 16 * h) * 32;
          const float* lo_b = op_s + ((1 * 2 + kk) * 2 * 32 + 16 * h) * 32;
          wgmma_tf32(part, alo[kk], dense3d::descriptor(hi_b, 32 * 128, 128), kk);
          wgmma_tf32(part, ahi[kk], dense3d::descriptor(lo_b, 32 * 128, 128), 1);
          wgmma_tf32(part, ahi[kk], dense3d::descriptor(hi_b, 32 * 128, 128), 1);
        }
        dense3d::wgmma_commit();
        dense3d::wgmma_wait<0>();
        dense3d::pin(part);
        dense3d::pin(ahi[0]);
        dense3d::pin(ahi[1]);
        dense3d::pin(alo[0]);
        dense3d::pin(alo[1]);
#pragma unroll
        for (int q = 0; q < 64; ++q) acc[h][q] += part[q];
      }
    }

    if (comp.chunk == s.chunks - 1) {  // the tile is complete: store it
      float* __restrict__ out = static_cast<float*>(ptrs.out[comp.c]);
      const int e = (comp.col + unit) * kUnitE + 16 * wrow + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h < h_lo || h >= h_hi) continue;
        store_half(out, acc[h], s, comp.p, h, e);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < 64; ++q) acc[h][q] = 0.0f;
      }
    }
    dense3d::advance(comp, s);
  }
  cp_async_wait<0>();  // no copy outlives the block
}

int launch(const float* op, const Pointers& ptrs, int num_c, int k3,
           int num_e, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(op) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int counts[dense3d::kMaxDevices] = {};
  int sms = 0;
  const int err =
      dense3d::sm_count(reinterpret_cast<const void*>(
                            stiffness3d_dense_tf32_kernel),
                        kSmemBytes, counts, &sms);
  if (err != 0) return err;
  long long total = 0;
  const Shape s = dense3d::shape_of(k3, num_e, kBK, &total, num_c);
  const int blocks = static_cast<int>(total < sms ? total : sms);
  stiffness3d_dense_tf32_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(
      op, ptrs, s, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32

// -- float64: FFMA ------------------------------------------------------------

namespace fp64 {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBK = 8;         // contraction panel depth
constexpr int TM = 4;          // register tile edge: two halves of 2
constexpr int H = TM / 2;
constexpr int BM = 16 * TM;    // rows and columns of the block tile

__device__ __forceinline__ void load_half(const double* p, double (&v)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x;
  v[1] = t.y;
}

__global__ void __launch_bounds__(kThreads)
stiffness3d_dense_f64_kernel(const double* __restrict__ at, Pointers ptrs,
                             int k3, int num_e) {
  constexpr int LD = kBK * BM / kThreads;  // panel entries per thread
  __shared__ __align__(16) double a_s[kBK * BM];  // a_s[kk][i] = A[i0+i][j0+kk]
  __shared__ __align__(16) double b_s[kBK * BM];  // b_s[kk][n] = u[j0+kk][e0+n]

  const double* __restrict__ u = static_cast<const double*>(ptrs.u[blockIdx.z]);
  double* __restrict__ out = static_cast<double*>(ptrs.out[blockIdx.z]);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = blockIdx.y * BM;
  const int e0 = blockIdx.x * BM;

  double acc[TM][TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int c = 0; c < TM; ++c) acc[r][c] = 0.0;
  }

  // Panel entry s of this thread: row kk = idx / BM, column idx % BM.
  double ra[LD], rb[LD];
#pragma unroll
  for (int s = 0; s < LD; ++s) {
    const int idx = tid + s * kThreads;
    const int j = idx / BM;
    const int n = idx % BM;
    ra[s] = (j < k3 && i0 + n < k3)
                ? at[static_cast<long long>(j) * k3 + i0 + n] : 0.0;
    rb[s] = (j < k3 && e0 + n < num_e)
                ? u[static_cast<long long>(j) * num_e + e0 + n] : 0.0;
  }

  for (int j0 = 0; j0 < k3; j0 += kBK) {
#pragma unroll
    for (int s = 0; s < LD; ++s) {
      a_s[tid + s * kThreads] = ra[s];
      b_s[tid + s * kThreads] = rb[s];
    }
    __syncthreads();
    if (j0 + kBK < k3) {
#pragma unroll
      for (int s = 0; s < LD; ++s) {
        const int idx = tid + s * kThreads;
        const int j = j0 + kBK + idx / BM;
        const int n = idx % BM;
        ra[s] = (j < k3 && i0 + n < k3)
                    ? at[static_cast<long long>(j) * k3 + i0 + n] : 0.0;
        rb[s] = (j < k3 && e0 + n < num_e)
                    ? u[static_cast<long long>(j) * num_e + e0 + n] : 0.0;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      double a_lo[H], a_hi[H], b_lo[H], b_hi[H];
      load_half(a_s + kk * BM + ty * H, a_lo);
      load_half(a_s + kk * BM + BM / 2 + ty * H, a_hi);
      load_half(b_s + kk * BM + tx * H, b_lo);
      load_half(b_s + kk * BM + BM / 2 + tx * H, b_hi);
#pragma unroll
      for (int r = 0; r < H; ++r) {
#pragma unroll
        for (int c = 0; c < H; ++c) {
          acc[r][c] = fma(a_lo[r], b_lo[c], acc[r][c]);
          acc[r][H + c] = fma(a_lo[r], b_hi[c], acc[r][H + c]);
          acc[H + r][c] = fma(a_hi[r], b_lo[c], acc[H + r][c]);
          acc[H + r][H + c] = fma(a_hi[r], b_hi[c], acc[H + r][H + c]);
        }
      }
    }
    __syncthreads();  // the next panel overwrites a_s and b_s
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int i = i0 + (r / H) * (BM / 2) + ty * H + r % H;
    if (i >= k3) continue;
#pragma unroll
    for (int c = 0; c < TM; ++c) {
      const int e = e0 + (c / H) * (BM / 2) + tx * H + c % H;
      if (e < num_e) out[static_cast<long long>(i) * num_e + e] = acc[r][c];
    }
  }
}

int launch(const double* at, const Pointers& ptrs, int num_c, int k3,
           int num_e, cudaStream_t stream) {
  const dim3 grid((num_e + BM - 1) / BM, (k3 + BM - 1) / BM, num_c);
  stiffness3d_dense_f64_kernel<<<grid, kThreads, 0, stream>>>(at, ptrs, k3,
                                                              num_e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp64

}  // namespace

// float32: `op` is the TF32 split in its fragment layout,
// (ceil(k3 / 16), ceil(k3 / 32) * 4, 2, 32, 4) float32.
extern "C" int stiffness3d_dense_f32(const void* op, const void* const* us,
                                     void* const* outs, int num_c, int k3,
                                     int num_e, void* stream) {
  Pointers ptrs;
  const int err = dense3d::prepare(us, outs, num_c, k3, num_e, &ptrs);
  if (err == -1) return static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return tf32::launch(static_cast<const float*>(op), ptrs, num_c, k3, num_e,
                      static_cast<cudaStream_t>(stream));
}

// float64: `op` is the transposed operator, (k3, k3).
extern "C" int stiffness3d_dense_f64(const void* op, const void* const* us,
                                     void* const* outs, int num_c, int k3,
                                     int num_e, void* stream) {
  Pointers ptrs;
  const int err = dense3d::prepare(us, outs, num_c, k3, num_e, &ptrs);
  if (err == -1) return static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return fp64::launch(static_cast<const double*>(op), ptrs, num_c, k3, num_e,
                      static_cast<cudaStream_t>(stream));
}
