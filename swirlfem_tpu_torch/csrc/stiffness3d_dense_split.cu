// Congruent-element stiffness as ONE dense static operator in the split-bf16
// classes, on the tensor cores by wgmma: out_c = A u_c for every component
// c of C <= 4, for the 3D (k^3, k^3) operator at 'bf16x3' and the 2D
// (k^2, k^2) one at 'bf16x3' and 'default'.
//
// Replaces the split classes of two Pallas kernels of the JAX package, which
// run the same body (_kernel_uniform_mm3 of swirlfem_tpu/ops/
// pallas_stiffness.py, or _kernel_uniform_mm at Precision.DEFAULT):
// swirlfem_tpu/ops/pallas_stiffness3d.py:stiffness3d_el_pallas_dense
// ('bf16x3') and swirlfem_tpu/ops/pallas_stiffness.py:
// stiffness_el_pallas_uniform ('bf16x3' and 'default').  The class, as the
// JAX package defines it: the float64 operator is rounded to float32 and
// split on the host into hi = bf16(A) and lo = bf16(A - hi)
// (cuda_split.split_operator_np; here in the layout of
// cuda_split.dense_bf16_layout_np); the field is split in the kernel into
// uhi = bf16(u) and ulo = bf16(u - uhi) (both RNE); 'bf16x3' sums
// hi uhi + hi ulo + lo uhi, 'default' takes hi uhi alone (no lo is read,
// no ulo made), with float32 sums.  A bf16 product is exact in float32, so
// this kernel and its plain version differ only in the order of their sums.
//
// Operator layout.  For each panel of P operator rows (P = 256 in 3D; in 2D
// a multiple of 16 up to 128, cuda_split.uniform_split_panel: k^2 rounded
// up to 16, or 16 where a launch has few units) and 16-deep depth chunk: the
// parts (hi, and lo at 'bf16x3'), then the rows, 32 bytes each (the chunk's
// 16 bf16), as wgmma reads a K-major B operand in the 32-byte swizzle: the
// two 16-byte units of a row swapped where bit 2 of its row index is set;
// rows padded to a multiple of P and the depth to one of 32 with zeros.
// Two chunks of a panel are one contiguous run (32 KB in 3D).
//
// Products.  wgmma bf16 with the field as the A operand from registers
// (M = 64 elements of a warpgroup, K = 16 depths: each thread loads its
// eight values of a step from the staged field and splits them into hi and
// lo fragments) and the operator's parts from shared memory: ulo hi, uhi lo
// and uhi hi of each step ('default': uhi hi) into float32 accumulators
// over the whole depth.  In 3D, one m64n256k16 product of the panel's 256
// rows, or, where a tile has one unit, m64n128k16 products of the
// warpgroup's half; in 2D one m64nPk16 product of the whole panel.  The
// tensor cores truncate as they accumulate: the chain reads ~1e-6 of the
// output against the class's ~1e-5, where the 3xTF32 kernel must add
// per-chunk sums to stay in its FP32 class.  So nothing waits for a chunk's
// products: its fragments are double-buffered in registers and each chunk
// waits only for the products of the one before it (wgmma.wait_group 1),
// and for all of them at the end of a tile, whose accumulators it then
// stores: in 3D straight to out[row][element] (8 consecutive elements a
// row and instruction), in 2D through a staging tile in shared memory, from
// which each warp stores whole rows of the unit's 64 elements with 16-byte
// stores (~40 % fewer store cycles at the datagen shape, where the tile's
// stores follow all its loads).  No branch around a wgmma depends on the
// warpgroup (ptxas serializes every wgmma otherwise: C7520).
//
// Work (stiffness3d_dense.cuh, the 3xTF32 kernel's walk).  3D: tiles of
// 128 elements by 256 operator rows, two warpgroups, one persistent block
// per SM over its range of (component, panel, 64-element unit) space: at
// 16^3 elements, order 7, C = 3, 384 units, at most 3 a block.  2D: one
// warpgroup, tiles of one unit by one panel, up to two blocks an SM: at the
// datagen shape (64^2 elements, order 8, C = 2) 128 units of one 96-row
// panel, one a block, one wave; on the lid-driven box (16^2, order 7,
// C = 2) 8 units, each in four 16-row panels, so 32 blocks.  The walk's
// arithmetic is 32-bit (a 64-bit division took ~400 of the ~1100 cycles
// of a 2D block's setup).  The
// depth is walked in chunks of 32 (two k16 steps) through a ring of stages
// in shared memory, each the operator chunk and the field chunk: four
// stages in 3D; three in 2D, where the depth is 64 or 96 (order 7, 8), so
// that a unit's every chunk is in flight at once.  A producer warp fills
// the ring with TMA copies (tma.cuh): one for the operator chunk and one 2D
// box of 32 rows by 32 elements per 128-byte segment of the field's rows (a
// tensor map per component; zeros past the depth and past num_e), in the
// 128-byte swizzle, so that a warp's fragment reads, 8 elements by depths
// 2t of its four lanes t, fall on distinct banks.  Each stage's arrival is
// counted by an mbarrier, and the producer waits for a stage to be released
// before it refills it; the warpgroups only wait for full stages, multiply,
// and release a stage once their products of it are done.  What held
// earlier 3D builds (tests/torch_port_congruent_bf16x3_variants.py, H100 at
// 700 W, 16^3 elements, order 7, C = 3): with every thread issuing 16-byte
// cp.async copies behind one barrier a chunk, the copies' issue and the
// barrier (75 us); with one TMA copy per field row, the copies (71 us);
// with chunks of one step, the per-chunk waits and fences (61 us against 57
// with two steps).  The 2D operator's earlier kernel (mma.sync, one block
// per 32-element tile and component, 128 operator rows a block, two
// cp.async stages) took 9.8 / 7.2 us at the datagen shape ('bf16x3' /
// 'default') and 5.3 / 4.1 us on the lid-driven box.  What holds the 2D
// kernel at the datagen shape (tests/torch_port_split2d_uniform3d_variants.py,
// SM clocks of block 0, 'bf16x3'): ~0.4 us of setup, ~0.9 us until the
// first chunk lands, its other chunks at ~15 bytes a clock into the SM
// (~0.75 us each), ~0.55 us for the last chunk's products and ~0.85 us of
// stores, which all 128 SMs issue at once (~3 TB/s): the unit's phases
// follow one another on each SM, with the launch's ~1.2 us besides.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s dense bf16).  3D at 16^3
// elements, order 7, C = 3: three bf16 passes of 2 k^6 E C = 6.44 GFLOP,
// 19.3 GFLOP, 19.5 us; (2 C k^3 E) 4 B + k^6 2 x 2 B = 51.4 MB, 15.3 us:
// the tensor cores bound it.  Every tile reads its operator panel from the
// L2 (512 KB of hi and lo), 96 MB in all, and its field chunk twice (once
// per panel), 50 MB.  2D at the datagen shape, 'bf16x3': 0.32 GFLOP,
// 0.33 us, against (2 C k^2 E 4 + 2 x 96^2 x 2) B = 5.3 MB, 1.60 us: bytes
// bound it (each unit reads the 36 KB operator from the L2, 4.7 MB in all);
// on the lid-driven box 0.28 MB, 0.08 us: the launch sets the time.

#include <cuda.h>

#include <type_traits>

#include "split_bf16_mma.cuh"
#include "stiffness3d_dense.cuh"
#include "tma.cuh"

namespace {

using dense3d::kUnitE;
using dense3d::Pointers;
using dense3d::Shape;
using dense3d::Walk;
using tma::FieldMaps;
using tma::smem_addr;

constexpr int kSteps = 2;        // k16 steps of a stage
constexpr int kBK = 16 * kSteps;  // depth of a stage
constexpr int kSeg = 32;  // elements of a field segment: one 128-byte row
constexpr int kSegBytes = kBK * kSeg * 4;  // 4 KB: one TMA box

// One kernel instance: a panel of kPanel operator rows, kPasses bf16
// passes (3: 'bf16x3'; 1: 'default'), kGroups warpgroups (2: tiles of up
// to two units; 1: one) and a ring of kStages stages.
template <int kPanel_, int kPasses_, int kGroups_, int kStages_>
struct Config {
  static constexpr int kPanel = kPanel_;
  static constexpr int kPasses = kPasses_;
  static constexpr int kParts = kPasses == 3 ? 2 : 1;  // hi, and lo
  static constexpr int kGroups = kGroups_;
  static constexpr int kStages = kStages_;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kAllThreads = kThreads + 32;  // and the producer warp
  static constexpr int kTileE = kUnitE * kGroups;
  // One stage: the operator chunk (kSteps steps of kParts parts x kPanel
  // rows x 16 bf16) and the field chunk (kTileE / kSeg segments of kBK rows
  // of kSeg elements, `field_at`).
  static constexpr int kPartBytes = kPanel * 32;
  static constexpr int kStepBytes = kParts * kPartBytes;
  static constexpr int kOpBytes = kSteps * kStepBytes;
  static constexpr int kStageFloats = kOpBytes / 4 + kBK * kTileE;
  // 2D: a tile's outputs go out through a staging tile of kPanel rows of
  // its 64 elements (rows kOutLd floats apart: a warp's writes of an
  // accumulator register, 8 elements by 4 rows two apart, fall on distinct
  // banks), so that each warp stores whole rows with 16-byte stores.
  static constexpr bool kStaged = kGroups == 1;
  static constexpr int kOutLd = kUnitE + 4;
  static constexpr int kOutFloats = kStaged ? kPanel * kOutLd : 0;
  // The ring (1024-byte aligned: the field's swizzle repeats every 1024
  // bytes), the staging tile, then the ring's full and empty mbarriers.
  static constexpr int kSmemBytes =
      1024 + (kStages * kStageFloats + kOutFloats) * 4 + 2 * kStages * 8;
  // Accumulators: two 128-row halves of the 256-row panel (kGroups 2), or
  // the panel (kGroups 1).
  static constexpr int kAccs = kGroups == 2 ? 2 : 1;
  static constexpr int kAccRegs = kGroups == 2 ? 64 : kPanel / 2;
  static constexpr int kBlocksPerSm = kGroups == 2 ? 1 : 2;

  static_assert(kPasses == 1 || kPasses == 3, "one or three bf16 passes");
  static_assert(kGroups == 2 ? kPanel == 256
                             : kPanel % 16 == 0 && kPanel <= 128,
                "panel");
  static_assert(kOpBytes % 1024 == 0, "the field chunk stays 1024-aligned");
};

using Config3D = Config<256, 3, 2, 4>;
template <int kPanel, int kPasses>
using Config2D = Config<kPanel, kPasses, 1, 3>;

// Where element e of row r of a field chunk lies in its stage: segment
// e / 32 of kBK rows of 128 bytes, the 16-byte unit of e within its row
// swizzled by the row (TMA's 128-byte swizzle: unit ^ r % 8), so that a
// warp's fragment reads, 8 elements by rows 2t of its lanes t, fall on
// distinct banks.
__device__ __forceinline__ int field_at(int r, int e) {
  const int x = e & (kSeg - 1);
  return (e / kSeg) * (kBK * kSeg) + r * kSeg +
         ((((x >> 2) ^ (r & 7)) << 2) | (x & 3));
}

// The hi bf16 pair of two neighbouring values, x in the low half (RNE).
__device__ __forceinline__ uint32_t hi2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// st.global (st.shared) of an accumulator entry.  The store reads the
// register inside an asm statement, after the wgmma.wait_group that
// completes it: a plain read would need the register pinned after the wait,
// and a pin counts as a new definition, which makes the compiler insert a
// warpgroup arrive before the next wgmma and serialize the wgmma (ptxas
// C7520).
__device__ __forceinline__ void st_global(float* p, float v) {
  asm volatile("st.global.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}

__device__ __forceinline__ void st_shared(float* p, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(smem_addr(p)), "f"(v)
               : "memory");
}

// The warpgroup's barrier (named barrier 1: the producer warp is not in
// it).
__device__ __forceinline__ void warpgroup_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// The accumulator operands of a wgmma, eight at a time.
#define WG_D8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= a b for one m64nNk16 bf16 product of the warpgroup: a (64 x 16,
// the elements' field values) from registers, b (16 x N operator rows,
// K-major) from shared memory; `accumulate` 0 starts d from zero.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : WG_D8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : WG_D8(d, 0), WG_D8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<48> {
  __device__ static __forceinline__ void mma(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : WG_D8(d, 0), WG_D8(d, 8), WG_D8(d, 16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : WG_D8(d, 0), WG_D8(d, 8), WG_D8(d, 16),
          WG_D8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<80> {
  __device__ static __forceinline__ void mma(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
        : WG_D8(d, 0), WG_D8(d, 8), WG_D8(d, 16),
          WG_D8(d, 24), WG_D8(d, 32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<96> {
  __device__ static __forceinline__ void mma(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : WG_D8(d, 0), WG_D8(d, 8), WG_D8(d, 16),
          WG_D8(d, 24), WG_D8(d, 32), WG_D8(d, 40)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<112> {
  __device__ static __forceinline__ void mma(float (&d)[56],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
        : WG_D8(d, 0), WG_D8(d, 8), WG_D8(d, 16),
          WG_D8(d, 24), WG_D8(d, 32), WG_D8(d, 40),
          WG_D8(d, 48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : WG_D8(d, 0), WG_D8(d, 8), WG_D8(d, 16),
          WG_D8(d, 24), WG_D8(d, 32), WG_D8(d, 40),
          WG_D8(d, 48), WG_D8(d, 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

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
// `vec`: TMA copies the field in boxes of kBK rows by 32 elements (rows
// past the depth and elements past num_e filled with zeros); otherwise the
// warp copies the field itself.
template <class Cfg>
__device__ void produce(const char* __restrict__ op, const Pointers& ptrs,
                        const FieldMaps& maps, const Shape& s, Walk w,
                        bool vec, float* ring, uint64_t* full,
                        uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  for (int i = 0; w.valid; ++i) {
    const int slot = i % Cfg::kStages;
    float* stage = ring + slot * Cfg::kStageFloats;
    float* u_s = stage + Cfg::kOpBytes / 4;
    tma::mbar_wait(empty + slot, ((i / Cfg::kStages) & 1) ^ 1);
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
      tma::mbar_expect(full + slot,
                       Cfg::kOpBytes + (vec ? segs * kSegBytes : 0));
      tma::bulk_copy(stage,
                     op + (static_cast<long long>(w.p) * s.chunks + w.chunk) *
                              Cfg::kOpBytes,
                     Cfg::kOpBytes, full + slot);  // the layout's chunks, paired
    }
    __syncwarp();
    if (vec && 1 <= lane && lane <= segs) {
      tma::tensor_copy(u_s + (lane - 1) * (kBK * kSeg), &maps.m[w.c],
                       e0 + (lane - 1) * kSeg, k0, full + slot);
    }
    dense3d::advance<Cfg::kGroups>(w, s);
  }
}

template <class Cfg>
__global__ void __launch_bounds__(Cfg::kAllThreads, Cfg::kBlocksPerSm)
stiffness3d_dense_split_kernel(const char* __restrict__ op, Pointers ptrs,
                               const __grid_constant__ FieldMaps maps,
                               Shape s, long long total_units, bool vec,
                               bool vec_out) {
  constexpr int kPanel = Cfg::kPanel;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  float* o_s = smem + Cfg::kStages * Cfg::kStageFloats;  // the staging tile
  uint64_t* full = reinterpret_cast<uint64_t*>(o_s + Cfg::kOutFloats);
  uint64_t* empty = full + Cfg::kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < Cfg::kStages; ++i) {
      tma::mbar_init(full + i, 1);
      tma::mbar_init(empty + i, Cfg::kWarps);
    }
    tma::fence_mbar_init();
  }
  __syncthreads();
  Walk comp = dense3d::first_tile<Cfg::kGroups>(s, total_units);
  if (threadIdx.x >= Cfg::kThreads) {
    produce<Cfg>(op, ptrs, maps, s, comp, vec, smem, full, empty);
    return;
  }

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg = threadIdx.x >> 7;          // the warpgroup: elements 64 wg..
  const int wrow = (threadIdx.x >> 5) & 3;  // its warp: 16 of them
  float acc[Cfg::kAccs][Cfg::kAccRegs];
  uint32_t ahi[2][kSteps][4], alo[2][kSteps][4];  // two chunks' fragments
  bool first = true;              // the chunk starts a tile
  int i = 0;
  // One chunk; `parity` picks its fragment buffer (a compile-time index:
  // the loop below takes two chunks a turn).
  auto chunk = [&](auto parity) {
    constexpr int B = decltype(parity)::value;
    const int slot = i % Cfg::kStages;
    tma::mbar_wait(full + slot, (i / Cfg::kStages) & 1);
    // 3D, a tile of two units: warpgroup wg takes unit wg, both halves
    // (acc[0] half 0, acc[1] half 1).  3D, a tile of one unit: both take
    // it, warpgroup wg half wg in acc[0].  2D: the warpgroup takes the
    // tile's unit, the whole panel in acc[0].  Every branch around a wgmma
    // depends on the walk alone, never on the warpgroup.
    const bool two = Cfg::kGroups == 2 && comp.width == 2;
    const int unit = two ? wg : 0;
    const int h0 = two ? 0 : wg;
    const float* op_s = smem + slot * Cfg::kStageFloats;
    const float* u_s = op_s + Cfg::kOpBytes / 4;
    // The A fragments of step kk: rows (elements) 16 wrow + g (+8), columns
    // (depths) 16 kk + 2t, 2t + 1 (+8), split (hi alone at 'default').
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = kUnitE * unit + 16 * wrow + g + 8 * (q & 1);
        const int col = 16 * kk + 2 * t + 8 * (q >> 1);
        const float x = u_s[field_at(col, row)];
        const float y = u_s[field_at(col + 1, row)];
        if constexpr (Cfg::kPasses == 3) {
          split_bf16::split2(x, y, ahi[B][kk][q], alo[B][kk][q]);
        } else {
          ahi[B][kk][q] = hi2(x, y);
        }
      }
    }
    const int scale = first ? 0 : 1;
    dense3d::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      // Step kk, part pt: the panel's rows of 32 bytes at kk kStepBytes +
      // pt kPartBytes (in 3D half h at h 4 KB).
      const char* op_b =
          reinterpret_cast<const char*>(op_s) + kk * Cfg::kStepBytes;
      const uint64_t dhi = dense3d::descriptor_sw32(op_b + 4096 * h0);
      const uint64_t dlo =
          dense3d::descriptor_sw32(op_b + Cfg::kPartBytes + 4096 * h0);
      const int sc = kk == 0 ? scale : 1;
      if constexpr (Cfg::kGroups == 2) {
        if (two) {  // the whole panel: 256 rows a product
          wgmma_bf16_n256(acc[0], acc[1], alo[B][kk], dhi, sc);
          wgmma_bf16_n256(acc[0], acc[1], ahi[B][kk], dlo, 1);
          wgmma_bf16_n256(acc[0], acc[1], ahi[B][kk], dhi, 1);
        } else {
          Wgmma<128>::mma(acc[0], alo[B][kk], dhi, sc);
          Wgmma<128>::mma(acc[0], ahi[B][kk], dlo, 1);
          Wgmma<128>::mma(acc[0], ahi[B][kk], dhi, 1);
        }
      } else if constexpr (Cfg::kPasses == 3) {
        Wgmma<kPanel>::mma(acc[0], alo[B][kk], dhi, sc);
        Wgmma<kPanel>::mma(acc[0], ahi[B][kk], dlo, 1);
        Wgmma<kPanel>::mma(acc[0], ahi[B][kk], dhi, 1);
      } else {
        Wgmma<kPanel>::mma(acc[0], ahi[B][kk], dhi, sc);
      }
    }
    dense3d::wgmma_commit();
    dense3d::wgmma_wait<1>();  // the products of the chunk before
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      dense3d::pin(ahi[B ^ 1][kk]);
      if constexpr (Cfg::kPasses == 3) dense3d::pin(alo[B ^ 1][kk]);
    }
    if (i > 0 && lane == 0) tma::mbar_arrive(empty + (i - 1) % Cfg::kStages);

    first = comp.chunk == s.chunks - 1;
    if (first) {  // the tile is complete: store it
      dense3d::wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        dense3d::pin(ahi[B][kk]);
        if constexpr (Cfg::kPasses == 3) dense3d::pin(alo[B][kk]);
      }
      // Entry 4 n + q of thread (g, t) of warp wrow is element 16 wrow +
      // g + 8 (q >> 1), row 8 n + 2 t + (q & 1) of its half (3D) or of the
      // panel (2D).
      float* __restrict__ out = static_cast<float*>(ptrs.out[comp.c]);
      if constexpr (Cfg::kStaged) {
        warpgroup_sync();  // the last tile's rows are read
#pragma unroll
        for (int n = 0; n < Cfg::kAccRegs / 4; ++n) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            st_shared(o_s + (8 * n + 2 * t + (q & 1)) * Cfg::kOutLd +
                          16 * wrow + g + 8 * (q >> 1),
                      acc[0][4 * n + q]);
          }
        }
        warpgroup_sync();
        // Row r of the panel: its 64 elements as 16 float4, a warp two
        // rows (512 bytes) a store.
        const int rows = min(kPanel, s.k3 - comp.p * kPanel);
        const int e0 = comp.col * kUnitE;
        for (int idx = threadIdx.x; idx < rows * (kUnitE / 4); idx += 128) {
          const int r = idx / (kUnitE / 4);
          const int c = 4 * (idx - r * (kUnitE / 4));
          const float4 v =
              *reinterpret_cast<const float4*>(o_s + r * Cfg::kOutLd + c);
          float* dst = out +
                       static_cast<long long>(comp.p * kPanel + r) * s.num_e +
                       e0 + c;
          if (vec_out && e0 + c < s.num_e) {
            __stcs(reinterpret_cast<float4*>(dst), v);
          } else {
            const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              if (e0 + c + x < s.num_e) __stcs(dst + x, vs[x]);
            }
          }
        }
      } else {
        const int e = (comp.col + unit) * kUnitE + 16 * wrow + g;
#pragma unroll
        for (int hh = 0; hh < Cfg::kAccs; ++hh) {
          if (hh == 1 && !two) break;
          const int row0 =
              comp.p * kPanel + 128 * (hh == 0 ? h0 : 1) + 2 * t;
#pragma unroll
          for (int n = 0; n < Cfg::kAccRegs / 4; ++n) {
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
    }
    dense3d::advance<Cfg::kGroups>(comp, s);
    ++i;
  };
  while (comp.valid) {
    chunk(std::integral_constant<int, 0>());
    if (!comp.valid) break;
    chunk(std::integral_constant<int, 1>());
  }
  dense3d::wgmma_wait<0>();
}

template <class Cfg>
int launch(const char* op, const Pointers& ptrs, int num_c, int k3,
           int num_e, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(op) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // TMA boxes of the field where every row is 16-byte aligned, and
  // 16-byte stores of the outputs where theirs are.
  const bool vec = tma::boxes_fit(ptrs.u, num_c, num_e, 4, kSeg);
  const bool vec_out =
      tma::boxes_fit(ptrs.out, num_c, num_e, 4, 4);
  FieldMaps maps = {};
  if (vec) {
    const int err = tma::field_maps(ptrs.u, num_c, k3, num_e,
                                    CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kSeg,
                                    kBK, CU_TENSOR_MAP_SWIZZLE_128B, &maps);
    if (err != 0) return err;
  }
  static int counts[dense3d::kMaxDevices] = {};
  int sms = 0;
  const int err = dense3d::sm_count(
      reinterpret_cast<const void*>(stiffness3d_dense_split_kernel<Cfg>),
      Cfg::kSmemBytes, counts, &sms);
  if (err != 0) return err;
  long long total = 0;
  const Shape s =
      dense3d::shape_of(k3, num_e, kBK, &total, num_c, Cfg::kPanel);
  const long long slots = static_cast<long long>(sms) * Cfg::kBlocksPerSm;
  const int blocks = static_cast<int>(total < slots ? total : slots);
  stiffness3d_dense_split_kernel<Cfg>
      <<<blocks, Cfg::kAllThreads, Cfg::kSmemBytes, stream>>>(
          op, ptrs, maps, s, total, vec, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// The 2D kernel of panel kPanel at `passes`.
template <int kPanel>
int launch_2d(int passes, const char* op, const Pointers& ptrs, int num_c,
              int rows, int num_e, cudaStream_t stream) {
  return passes == 3
             ? launch<Config2D<kPanel, 3>>(op, ptrs, num_c, rows, num_e,
                                           stream)
             : launch<Config2D<kPanel, 1>>(op, ptrs, num_c, rows, num_e,
                                           stream);
}

}  // namespace

// `op` is the bf16 split in its wgmma layout (cuda_split.dense_bf16_layout_np:
// (ceil(k3 / 256), ceil(k3 / 32) * 2, 2, 32, 8, 2, 8) bf16); us, outs: num_c
// (k3, num_e) float32 fields.
extern "C" int stiffness3d_dense_split_f32(const void* op,
                                           const void* const* us,
                                           void* const* outs, int num_c,
                                           int k3, int num_e, void* stream) {
  Pointers ptrs;
  const int err = dense3d::prepare(us, outs, num_c, k3, num_e, &ptrs);
  if (err == -1) return static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch<Config3D>(static_cast<const char*>(op), ptrs, num_c, k3,
                          num_e, static_cast<cudaStream_t>(stream));
}

// The 2D congruent operator: `op` is its split in the layout of
// cuda_split.dense_bf16_layout at a panel P (a multiple of 16, at most 128)
// with `passes` == 3 ('bf16x3': hi and lo) or 1 ('default': hi):
// (ceil(rows / P), ceil(rows / 32) * 2, passes == 3 ? 2 : 1, P / 8, 8, 2,
// 8) bf16; us, outs: num_c (rows, num_e) float32 fields.
extern "C" int stiffness_uniform_split_f32(const void* op,
                                           const void* const* us,
                                           void* const* outs, int num_c,
                                           int rows, int num_e, int passes,
                                           int panel, void* stream) {
  if ((passes != 1 && passes != 3) || panel % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pointers ptrs;
  const int err = dense3d::prepare(us, outs, num_c, rows, num_e, &ptrs);
  if (err == -1) return static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const char* o = static_cast<const char*>(op);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (panel) {
    case 16: return launch_2d<16>(passes, o, ptrs, num_c, rows, num_e, st);
    case 32: return launch_2d<32>(passes, o, ptrs, num_c, rows, num_e, st);
    case 48: return launch_2d<48>(passes, o, ptrs, num_c, rows, num_e, st);
    case 64: return launch_2d<64>(passes, o, ptrs, num_c, rows, num_e, st);
    case 80: return launch_2d<80>(passes, o, ptrs, num_c, rows, num_e, st);
    case 96: return launch_2d<96>(passes, o, ptrs, num_c, rows, num_e, st);
    case 112: return launch_2d<112>(passes, o, ptrs, num_c, rows, num_e, st);
    case 128: return launch_2d<128>(passes, o, ptrs, num_c, rows, num_e, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
