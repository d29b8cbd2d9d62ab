// Congruent-element 3D stiffness as ONE dense (k^3, k^3) operator in the
// split-bf16 class 'bf16x3': out_c = A u_c for every component c, for C <= 4
// components, on the tensor cores by wgmma.
//
// Replaces the 'bf16x3' class of swirlfem_tpu/ops/pallas_stiffness3d.py:
// stiffness3d_el_pallas_dense (which runs _kernel_uniform_mm3 of
// swirlfem_tpu/ops/pallas_stiffness.py).  The class, as the JAX package
// defines it: the float64 operator is rounded to float32 and split on the
// host into hi = bf16(A) and lo = bf16(A - hi) (cuda_split.split_operator_np;
// here in the layout of cuda_split.dense_bf16_layout_np); the field is split
// in the kernel into uhi = bf16(u) and ulo = bf16(u - uhi) (both RNE); the
// output is hi uhi + hi ulo + lo uhi with float32 sums.  A bf16 product is
// exact in float32, so this kernel and its plain version differ only in the
// order of their sums.
//
// Operator layout.  For each panel of 256 operator rows and 16-deep depth
// chunk: part (hi, lo), then the rows, 32 bytes each (the chunk's 16 bf16),
// as wgmma reads a K-major B operand in the 32-byte swizzle: the two 16-byte
// units of a row swapped where bit 2 of its row index is set; rows padded
// to a multiple of 256 and the depth to one of 32 with zeros.  A (panel,
// chunk) of the operator is one contiguous 16 KB run, and two chunks one
// 32 KB run.
//
// Products.  wgmma bf16 with the field as the A operand from registers
// (M = 64 elements of a warpgroup, K = 16 depths: each thread loads its
// eight values of a step from the staged field and splits them into hi and
// lo fragments) and the operator's hi and lo from shared memory: ulo hi,
// uhi lo and uhi hi of each step into float32 accumulators over the whole
// depth, as one m64n256k16 product of the panel's 256 rows, or, where a
// tile has one unit, as m64n128k16 products of the warpgroup's half.  The
// tensor cores truncate as they accumulate: the chain reads ~1e-6 of the
// output against the class's ~1e-5, where the 3xTF32 kernel must add
// per-chunk sums to stay in its FP32 class.  So nothing waits for a chunk's
// products: its fragments are double-buffered in registers and each chunk
// waits only for the products of the one before it (wgmma.wait_group 1),
// and for all of them at the end of a tile, whose accumulators it then
// stores straight to out[row][element] (8 consecutive elements a row and
// instruction).  No branch around a wgmma depends on the warpgroup (ptxas
// serializes every wgmma otherwise: C7520).
//
// Work (stiffness3d_dense.cuh, the 3xTF32 kernel's walk).  Tiles of 128
// elements by 256 operator rows, walked by one persistent block per SM
// over its range of (component, panel, 64-element unit) space: at 16^3
// elements, order 7, C = 3, 384 units, at most 3 a block.  The depth is
// walked in chunks of 32 (two k16 steps) through a ring of four stages in
// shared memory, each the 32 KB operator chunk and the field chunk.  A
// producer warp fills the ring with TMA copies: one for the operator chunk
// and one 2D box of 32 rows by 32 elements per 128-byte segment of the
// field's rows (a tensor map per component; zeros past the depth and past
// num_e), in the 128-byte swizzle, so that a warp's fragment reads, 8
// elements by depths 2t of its four lanes t, fall on distinct banks.  Each
// stage's arrival is counted by an mbarrier, and the producer waits for a
// stage to be released before it refills it; the two warpgroups only wait
// for full stages, multiply, and release a stage once their products of it
// are done.  What held earlier builds (tests/
// torch_port_congruent_bf16x3_variants.py, H100 at 700 W, 16^3 elements,
// order 7, C = 3): with every thread issuing 16-byte cp.async copies
// behind one barrier a chunk, the copies' issue and the barrier (75 us);
// with one TMA copy per field row, the copies (71 us); with chunks of one
// step, the per-chunk waits and fences (61 us against 57 with two steps).
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s dense bf16) at 16^3
// elements, order 7, C = 3: three bf16 passes of 2 k^6 E C = 6.44 GFLOP,
// 19.3 GFLOP, 19.5 us; (2 C k^3 E) 4 B + k^6 2 x 2 B = 51.4 MB, 15.3 us:
// the tensor cores bound it.  Every tile reads its operator panel from the
// L2 (512 KB of hi and lo), 96 MB in all, and its field chunk twice (once
// per panel), 50 MB.

#include <cuda.h>

#include <type_traits>

#include "split_bf16_mma.cuh"
#include "stiffness3d_dense.cuh"

namespace {

using dense3d::kPanel;
using dense3d::kThreads;
using dense3d::kTileE;
using dense3d::kUnitE;
using dense3d::Pointers;
using dense3d::Shape;
using dense3d::Walk;
using split_bf16::smem_addr;

constexpr int kWarps = kThreads / 32;      // the two warpgroups' warps
constexpr int kAllThreads = kThreads + 32;  // and the producer warp
constexpr int kSteps = 2;          // k16 steps of a stage
constexpr int kBK = 16 * kSteps;    // depth of a stage
constexpr int kStages = 4;
constexpr int kSeg = 32;  // elements of a field segment: one 128-byte row
// One stage: the operator chunk (kSteps steps of 2 parts x 256 rows x 16
// bf16) and the field chunk (kTileE / kSeg segments of kBK rows of kSeg
// elements, `field_at`).
constexpr int kStepBytes = 2 * kPanel * 16 * 2;  // 16 KB
constexpr int kPartBytes = kStepBytes / 2;       // hi, then lo
constexpr int kOpBytes = kSteps * kStepBytes;
constexpr int kSegBytes = kBK * kSeg * 4;  // 4 KB: one TMA box
constexpr int kStageFloats = kOpBytes / 4 + kBK * kTileE;
// The ring (1024-byte aligned: the field's swizzle repeats every 1024
// bytes), then its full and empty mbarriers.
constexpr int kSmemBytes = 1024 + kStages * kStageFloats * 4 + 2 * kStages * 8;

// The field's tensor maps, one per component: 2D (num_e, k3) float32
// boxes of kSeg x kBK, 128-byte swizzle, zero fill out of bounds.
struct FieldMaps {
  CUtensorMap m[dense3d::kMaxComponents];
};

// Where element e of row r of a field chunk lies in its stage: segment
// e / 32 of 16 rows of 128 bytes, the 16-byte unit of e within its row
// swizzled by the row (TMA's 128-byte swizzle: unit ^ r % 8), so that a
// warp's fragment reads, 8 elements by rows 2t of its lanes t, fall on
// distinct banks.
__device__ __forceinline__ int field_at(int r, int e) {
  const int x = e & (kSeg - 1);
  return (e / kSeg) * (kBK * kSeg) + r * kSeg +
         ((((x >> 2) ^ (r & 7)) << 2) | (x & 3));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      ::"r"(smem_addr(bar))
      : "memory");
}

// Arrives on `bar` and adds `bytes` to the transfers its phase waits for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
      ::"r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of `bar` of parity `parity` to complete; traps after
// about 2 seconds rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 32)) __trap();
  }
}

// One TMA copy of the box of `map` at (x, y) to shared memory, counted by
// `bar`.
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device to shared memory, counted by `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// st.global of an accumulator entry.  The store reads the register inside
// an asm statement, after the wgmma.wait_group that completes it: a plain
// read would need the register pinned after the wait, and a pin counts as a
// new definition, which makes the compiler insert a warpgroup arrive before
// the next wgmma and serialize the wgmma (ptxas C7520).
__device__ __forceinline__ void st_global(float* p, float v) {
  asm volatile("st.global.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}

// d (+)= a b for one m64n128k16 bf16 product of the warpgroup: a (64 x 16,
// the elements' field values) from registers, b (16 x 128 operator rows,
// K-major) from shared memory; `accumulate` 0 starts d from zero.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

// The same for one m64n256k16 product of a whole panel: d0 holds its rows
// 0-127, d1 its rows 128-255, each in the layout of the 128-row product.
__device__ __forceinline__ void wgmma_bf16_n256(float (&d0)[64],
                                                float (&d1)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]), "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d0[32]), "+f"(d0[33]), "+f"(d0[34]), "+f"(d0[35]), "+f"(d0[36]), "+f"(d0[37]), "+f"(d0[38]), "+f"(d0[39]),
        "+f"(d0[40]), "+f"(d0[41]), "+f"(d0[42]), "+f"(d0[43]), "+f"(d0[44]), "+f"(d0[45]), "+f"(d0[46]), "+f"(d0[47]),
        "+f"(d0[48]), "+f"(d0[49]), "+f"(d0[50]), "+f"(d0[51]), "+f"(d0[52]), "+f"(d0[53]), "+f"(d0[54]), "+f"(d0[55]),
        "+f"(d0[56]), "+f"(d0[57]), "+f"(d0[58]), "+f"(d0[59]), "+f"(d0[60]), "+f"(d0[61]), "+f"(d0[62]), "+f"(d0[63]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]), "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31]),
        "+f"(d1[32]), "+f"(d1[33]), "+f"(d1[34]), "+f"(d1[35]), "+f"(d1[36]), "+f"(d1[37]), "+f"(d1[38]), "+f"(d1[39]),
        "+f"(d1[40]), "+f"(d1[41]), "+f"(d1[42]), "+f"(d1[43]), "+f"(d1[44]), "+f"(d1[45]), "+f"(d1[46]), "+f"(d1[47]),
        "+f"(d1[48]), "+f"(d1[49]), "+f"(d1[50]), "+f"(d1[51]), "+f"(d1[52]), "+f"(d1[53]), "+f"(d1[54]), "+f"(d1[55]),
        "+f"(d1[56]), "+f"(d1[57]), "+f"(d1[58]), "+f"(d1[59]), "+f"(d1[60]), "+f"(d1[61]), "+f"(d1[62]), "+f"(d1[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The producer warp: fills the ring, chunk by chunk along the block's walk.
// `vec`: every field row is 16-byte aligned (num_e % 4 == 0 and aligned
// fields), so that TMA copies the field in boxes of 16 rows by 32 elements
// (rows past the depth and elements past num_e filled with zeros);
// otherwise the warp copies the field itself.
__device__ void produce(const char* __restrict__ op, const Pointers& ptrs,
                        const FieldMaps& maps, const Shape& s, Walk w,
                        bool vec, float* ring, uint64_t* full,
                        uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  for (int i = 0; w.valid; ++i) {
    const int slot = i % kStages;
    float* stage = ring + slot * kStageFloats;
    float* u_s = stage + kOpBytes / 4;
    mbar_wait(empty + slot, ((i / kStages) & 1) ^ 1);
    const int k0 = w.chunk * kBK;
    const int e0 = w.col * kUnitE;
    const int segs = w.width * kUnitE / kSeg;
    if (!vec) {
      const int rows = min(kBK, s.k3 - k0);
      const int ne = min(w.width * kUnitE, s.num_e - e0);
      const float* __restrict__ u = static_cast<const float*>(ptrs.u[w.c]);
      for (int idx = lane; idx < kBK * segs * kSeg; idx += 32) {
        const int r = idx / (segs * kSeg);
        const int e = idx - r * (segs * kSeg);
        u_s[field_at(r, e)] =
            r < rows && e < ne
                ? u[static_cast<long long>(k0 + r) * s.num_e + e0 + e]
                : 0.0f;
      }
      // Before the async proxy writes the stage again.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncwarp();
    if (lane == 0) {
      mbar_expect(full + slot, kOpBytes + (vec ? segs * kSegBytes : 0));
      bulk_copy(stage,
                op + (static_cast<long long>(w.p) * s.chunks + w.chunk) *
                         kOpBytes,
                kOpBytes, full + slot);  // the layout's chunks of 16, paired
    }
    __syncwarp();
    if (vec && 1 <= lane && lane <= segs) {
      tensor_copy(u_s + (lane - 1) * (kBK * kSeg), &maps.m[w.c],
                  e0 + (lane - 1) * kSeg, k0, full + slot);
    }
    dense3d::advance(w, s);
  }
}

__global__ void __launch_bounds__(kAllThreads, 1)
stiffness3d_dense_split_kernel(const char* __restrict__ op, Pointers ptrs,
                               const __grid_constant__ FieldMaps maps,
                               Shape s, long long total_units, bool vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageFloats);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Walk comp = dense3d::first_tile(s, total_units);
  if (threadIdx.x >= kThreads) {
    produce(op, ptrs, maps, s, comp, vec, smem, full, empty);
    return;
  }

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg = threadIdx.x >> 7;          // the warpgroup: elements 64 wg..
  const int wrow = (threadIdx.x >> 5) & 3;  // its warp: 16 of them
  float acc[2][64];               // the two 128-row halves of the tile
  uint32_t ahi[2][kSteps][4], alo[2][kSteps][4];  // two chunks' fragments
  bool first = true;              // the chunk starts a tile
  int i = 0;
  // One chunk; `parity` picks its fragment buffer (a compile-time index:
  // the loop below takes two chunks a turn).
  auto chunk = [&](auto parity) {
    constexpr int B = decltype(parity)::value;
    const int slot = i % kStages;
    mbar_wait(full + slot, (i / kStages) & 1);
    // A tile of two units: warpgroup wg takes unit wg, both halves (acc[0]
    // half 0, acc[1] half 1).  A tile of one unit: both take it, warpgroup
    // wg half wg in acc[0].  Every branch around a wgmma depends on the
    // walk alone, never on the warpgroup.
    const bool two = comp.width == 2;
    const int unit = two ? wg : 0;
    const int h0 = two ? 0 : wg;
    const float* op_s = smem + slot * kStageFloats;
    const float* u_s = op_s + kOpBytes / 4;
    // The A fragments of step kk: rows (elements) 16 wrow + g (+8), columns
    // (depths) 16 kk + 2t, 2t + 1 (+8), split.
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = kUnitE * unit + 16 * wrow + g + 8 * (q & 1);
        const int col = 16 * kk + 2 * t + 8 * (q >> 1);
        split_bf16::split2(u_s[field_at(col, row)],
                           u_s[field_at(col + 1, row)], ahi[B][kk][q],
                           alo[B][kk][q]);
      }
    }
    const int scale = first ? 0 : 1;
    dense3d::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      // Step kk, part pt, half h: 128 rows of 32 bytes at kk 16 KB + pt
      // 8 KB + h 4 KB.
      const char* op_b = reinterpret_cast<const char*>(op_s) + kk * kStepBytes;
      const uint64_t dhi = dense3d::descriptor_sw32(op_b + 4096 * h0);
      const uint64_t dlo =
          dense3d::descriptor_sw32(op_b + kPartBytes + 4096 * h0);
      const int sc = kk == 0 ? scale : 1;
      if (two) {  // the whole panel: 256 rows a product
        wgmma_bf16_n256(acc[0], acc[1], alo[B][kk], dhi, sc);
        wgmma_bf16_n256(acc[0], acc[1], ahi[B][kk], dlo, 1);
        wgmma_bf16_n256(acc[0], acc[1], ahi[B][kk], dhi, 1);
      } else {
        wgmma_bf16(acc[0], alo[B][kk], dhi, sc);
        wgmma_bf16(acc[0], ahi[B][kk], dlo, 1);
        wgmma_bf16(acc[0], ahi[B][kk], dhi, 1);
      }
    }
    dense3d::wgmma_commit();
    dense3d::wgmma_wait<1>();  // the products of the chunk before
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      dense3d::pin(ahi[B ^ 1][kk]);
      dense3d::pin(alo[B ^ 1][kk]);
    }
    if (i > 0 && lane == 0) mbar_arrive(empty + (i - 1) % kStages);

    first = comp.chunk == s.chunks - 1;
    if (first) {  // the tile is complete: store it
      dense3d::wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        dense3d::pin(ahi[B][kk]);
        dense3d::pin(alo[B][kk]);
      }
      // Entry 4 n + q of thread (g, t) of warp wrow is element 16 wrow +
      // g + 8 (q >> 1), row 8 n + 2 t + (q & 1) of its half.
      float* __restrict__ out = static_cast<float*>(ptrs.out[comp.c]);
      const int e = (comp.col + unit) * kUnitE + 16 * wrow + g;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (hh == 1 && !two) break;
        const int row0 = comp.p * kPanel + 128 * (hh == 0 ? h0 : 1) + 2 * t;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = row0 + 8 * n + (q & 1);
            const int col = e + 8 * (q >> 1);
            if (row < s.k3 && col < s.num_e) {
              st_global(out + static_cast<long long>(row) * s.num_e + col,
                        acc[hh][4 * n + q]);
            }
          }
        }
      }
    }
    dense3d::advance(comp, s);
    ++i;
  };
  while (comp.valid) {
    chunk(std::integral_constant<int, 0>());
    if (!comp.valid) break;
    chunk(std::integral_constant<int, 1>());

  }
  dense3d::wgmma_wait<0>();
}

// cuTensorMapEncodeTiled, fetched once through the runtime's entry-point
// query.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

int field_maps(const Pointers& ptrs, int num_c, int k3, int num_e,
               FieldMaps* maps) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return static_cast<int>(cudaErrorNotSupported);
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(num_e),
                              static_cast<cuuint64_t>(k3)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(num_e) * 4};
  const cuuint32_t box[2] = {kSeg, kBK};
  const cuuint32_t unit[2] = {1, 1};
  for (int c = 0; c < num_c; ++c) {
    const CUresult res = encode(
        &maps->m[c], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
        const_cast<void*>(ptrs.u[c]), dims, strides, box, unit,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

int launch(const char* op, const Pointers& ptrs, int num_c, int k3,
           int num_e, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(op) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // TMA boxes of the field where every row is 16-byte aligned.
  bool vec = num_e % 4 == 0;
  for (int c = 0; c < num_c; ++c) {
    vec = vec && (reinterpret_cast<uintptr_t>(ptrs.u[c]) & 15) == 0;
  }
  FieldMaps maps = {};
  if (vec) {
    const int err = field_maps(ptrs, num_c, k3, num_e, &maps);
    if (err != 0) return err;
  }
  static int counts[dense3d::kMaxDevices] = {};
  int sms = 0;
  const int err = dense3d::sm_count(
      reinterpret_cast<const void*>(stiffness3d_dense_split_kernel),
      kSmemBytes, counts, &sms);
  if (err != 0) return err;
  long long total = 0;
  const Shape s = dense3d::shape_of(k3, num_e, kBK, &total, num_c);
  const int blocks = static_cast<int>(total < sms ? total : sms);
  stiffness3d_dense_split_kernel<<<blocks, kAllThreads, kSmemBytes, stream>>>(
      op, ptrs, maps, s, total, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `op` is the bf16 split in its wgmma layout (cuda_split.dense_bf16_layout_np:
// (ceil(k3 / 256), ceil(k3 / 16), 2, 32, 8, 2, 8) bf16); us, outs: num_c
// (k3, num_e) float32 fields.
extern "C" int stiffness3d_dense_split_f32(const void* op,
                                           const void* const* us,
                                           void* const* outs, int num_c,
                                           int k3, int num_e, void* stream) {
  Pointers ptrs;
  const int err = dense3d::prepare(us, outs, num_c, k3, num_e, &ptrs);
  if (err == -1) return static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch(static_cast<const char*>(op), ptrs, num_c, k3, num_e,
                static_cast<cudaStream_t>(stream));
}
