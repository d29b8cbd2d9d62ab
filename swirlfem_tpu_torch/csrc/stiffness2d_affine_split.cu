// Affine-element 2D stiffness in the split-bf16 classes, on the tensor
// cores: out_c = c11 M11 u_c + c12 M12 u_c + c22 M22 u_c with per-element
// metric scalars c (3, E), for every component c.
//
// Replaces the 'bf16x3' and 'default' classes of swirlfem_tpu/ops/
// pallas_stiffness.py:stiffness_el_pallas_affine (_kernel_affine_mm3, and
// _kernel_affine_mm at Precision.DEFAULT).  The stacked static operator
// [M11; M12; M22] (3 k^2, k^2) is split on the host into bf16 hi / lo, each
// of its three blocks padded to rows_pad rows (split_bf16_mma.cuh has the
// arithmetic and the layout); each component field is (k^2, E) float32,
// element axis last, and c is (3, E) float32.
//
// Operator fragments.  The host lays the split stack out in the order of
// the mma.m16n8k16 A fragments (`cuda_split.affine_fragments`): for each
// 16-row tile, 16-deep step, block and part, the 32 lanes' four registers,
// 512 contiguous bytes.  A warp loads the fragments of its row tile and
// depth steps once, into registers (16-byte loads, coalesced), and keeps
// them over every tile it multiplies: the operator needs no shared memory,
// no ldmatrix and no barrier.
//
// Work plan (host: `cuda_split.affine_work_plan`).  The output is cut into
// row panels (blockIdx.y, `panel_rows` rows, a multiple of 16) x
// (component, column tile) pairs, tiles of TN = 16 or 32 elements.  The
// blocks of a panel walk its pairs n = blockIdx.x, blockIdx.x + gridDim.x,
// ... with the next three u tiles (and their c tiles) in flight by cp.async
// while the current one is multiplied: at a large E the tile loads, not the
// products, set the time, and one tile ahead left them exposed.  A block has (panel_rows / 16) x `splits`
// warps: warp (m, s) owns the 16 rows 16 m .. 16 m + 15 of the panel over
// the depth steps s, s + splits, ...  The plan takes the widest tile and
// the fewest panels whose (panel, pair) items reach one block per SM, with
// up to 8 warps a block and up to two blocks an SM; where none does, 16-row
// panels of 16-column tiles.  The lid-driven cavity (E = 256, k^2 = 64,
// C = 2): 4 panels x 32 pairs = 128 blocks of 4 warps, one depth step
// each.  The datagen box (E = 4096, k^2 = 81, C = 2): 2 panels of 48 rows x
// 132 blocks of 6 warps (3 depth steps each, 167 registers a thread in
// 'bf16x3': two blocks fit an SM), each walking about two of the 256 pairs
// of 32 columns.
//
// Products.  Per depth step a warp reads its B fragments from the float32 u
// tile (as it lies, rows padded by 4 floats so that the reads fall on
// distinct banks) and splits them in registers into uhi (and ulo); three
// accumulator sets (M11 u, M12 u, M22 u) share every B fragment, and the
// products are issued pass by pass over the tile's fragments, so that no
// product waits on the one before it.  Slices s > 0 leave their sums in
// shared memory; slice 0 adds them in slice order and combines the three
// sets in registers with the column's c11, c12, c22 as
// (c11 y1 + c12 y2) + c22 y3, the TPU kernel's order, before one store, so
// y never reaches device memory.

// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at the datagen
// shape (E = 4096, order 8, C = 2), 3 passes: 3 x 2 x 3 x 81^2 x 4096 x 2 =
// 0.97 GFLOP, 0.98 us, against (2 C k^2 + 3) E 4 B + 2 x 288 x 96 x 2 B =
// 5.5 MB, 1.63 us: bytes bound it.  On the lid-driven cavity (E = 256,
// order 7) both are under 0.1 us and the launch sets the time.

#include "split_bf16_mma.cuh"

namespace {

using split_bf16::Pointers;

constexpr int kSmemLimit = 232448;  // bytes a block may use (H100)
constexpr int kMaxDevices = 64;
constexpr int kMaxPanelRows = 128;  // also the most padded rows
constexpr int kStages = 4;          // u tiles in the ring: three ahead

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   split_bf16::smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   split_bf16::smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Shared memory of one block: the ring of kStages u tiles (depth_pad x
// (TN + 4) float32) and c tiles (3 x TN float32), and the partial sums of
// the depth slices past the first ((splits - 1) x 3 x panel_rows x TN
// float32).
__host__ __device__ inline long long smem_bytes(int panel_rows, int depth_pad,
                                                int tn, int splits) {
  return kStages * (depth_pad * (tn + 4) + 3LL * tn) * 4 +
         (splits - 1) * 3LL * panel_rows * tn * 4;
}

// d += a b on one m16n8k16 fragment, bf16 inputs, float32 sums.  Not
// volatile: the compiler interleaves independent fragments' products.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Starts the copies of columns e0 .. e0 + TN - 1 of `nrows` rows of the
// (nrows, num_e) array `src` into `dst` (row stride `ld`): 16 bytes where in
// range and aligned, else one value at a time; zeros past num_e.
template <int TN>
__device__ __forceinline__ void stage_columns(float* dst, int ld,
                                              const float* __restrict__ src,
                                              int nrows, int e0, int num_e) {
  constexpr int kVecs = TN / 4;
  for (int idx = threadIdx.x; idx < nrows * kVecs; idx += blockDim.x) {
    const int r = idx / kVecs;
    const int col = e0 + 4 * (idx - r * kVecs);
    const float* g = src + static_cast<long long>(r) * num_e + col;
    float* s = dst + r * ld + (col - e0);
    if (col + 4 <= num_e && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      cp_async16(s, g);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (col + q < num_e) {
          cp_async4(s + q, g + q);
        } else {
          s[q] = 0.0f;
        }
      }
    }
  }
}

// Two consecutive depth values of one column as a bf16 pair (the lower
// depth in the low half), split: hi = bf16(x), lo = bf16(x - hi), RNE.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// STEPS: the most depth steps of one warp.
template <int PASSES, int TN, int STEPS>
__global__ void __launch_bounds__(256)
stiffness2d_affine_split_kernel(const uint4* __restrict__ frags,
                                const float* __restrict__ c_aff,
                                Pointers ptrs, int num_c, int rows,
                                int num_e, int mt_total, int ksteps,
                                int mwarps) {
  constexpr int kParts = PASSES == 3 ? 2 : 1;
  constexpr int NI = TN / 8;
  constexpr int kLdu = TN + 4;
  constexpr int kSums = 3 * NI * 4;  // a warp's sums, per lane
  extern __shared__ __align__(16) float smem[];
  const int depth_pad = 16 * ksteps;
  const int splits = blockDim.x / (32 * mwarps);
  float* u_s = smem;                          // [kStages][depth_pad][kLdu]
  float* c_s = u_s + kStages * depth_pad * kLdu;  // [kStages][3][TN]
  float* red_s = c_s + kStages * 3 * TN;      // [slice - 1][m][kSums][32]
  const int tiles = (num_e + TN - 1) / TN;
  const int pairs = num_c * tiles;

  // The u rows past the depth are never copied: zero them in every slot.
  for (int idx = threadIdx.x; idx < kStages * (depth_pad - rows) * TN;
       idx += blockDim.x) {
    const int slot = idx / ((depth_pad - rows) * TN);
    const int rem = idx - slot * (depth_pad - rows) * TN;
    const int r = rows + rem / TN;
    u_s[(slot * depth_pad + r) * kLdu + rem % TN] = 0.0f;
  }

  auto stage = [&](int n, int slot) {
    const int comp = n / tiles;
    const int e0 = (n - comp * tiles) * TN;
    stage_columns<TN>(u_s + slot * depth_pad * kLdu, kLdu, ptrs.u[comp], rows,
                      e0, num_e);
    stage_columns<TN>(c_s + slot * 3 * TN, TN, c_aff, 3, e0, num_e);
  };
  // Prologue: the first kStages - 1 tiles, one commit group each (empty
  // past the last pair), so that the group of tile `it` is group `it`.
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    const int n = blockIdx.x + st * gridDim.x;
    if (n < pairs) stage(n, st);
    cp_async_commit();
  }

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int m = warp % mwarps;      // the warp's 16 rows of the panel
  const int slice = warp / mwarps;  // its depth steps
  const int mt = blockIdx.y * mwarps + m;
  const bool active = mt < mt_total;  // warp-uniform

  // The warp's operator fragments, over all its tiles.
  uint32_t afr[STEPS][3][kParts][4];
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const int ks = slice + i * splits;
    if (!active || ks >= ksteps) continue;
#pragma unroll
    for (int o = 0; o < 3; ++o) {
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        const uint4 v =
            frags[((static_cast<long long>(mt) * ksteps + ks) * 3 + o) * 64 +
                  part * 32 + lane];
        afr[i][o][part][0] = v.x;
        afr[i][o][part][1] = v.y;
        afr[i][o][part][2] = v.z;
        afr[i][o][part][3] = v.w;
      }
    }
  }

  int it = 0;
  for (int n = blockIdx.x; n < pairs; n += gridDim.x, ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile `it`
    __syncthreads();               // everyone's; tile it - 1 is done
    {
      const int ahead = n + (kStages - 1) * gridDim.x;
      if (ahead < pairs) stage(ahead, (it + kStages - 1) % kStages);
      cp_async_commit();
    }
    const float* u = u_s + (it % kStages) * depth_pad * kLdu;
    const float* cc = c_s + (it % kStages) * 3 * TN;

    float acc[3][NI][4];
#pragma unroll
    for (int o = 0; o < 3; ++o) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[o][ni][q] = 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      const int ks = slice + i * splits;
      if (!active || ks >= ksteps) continue;  // warp-uniform
      // B fragment of column ni * 8 + g: depths 2t, 2t + 1 (b0) and
      // 2t + 8, 2t + 9 (b1) of the step.
      uint32_t bh[NI][2], bl[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const float* col = u + (16 * ks + 2 * t) * kLdu + ni * 8 + g;
        split_pair(col[0], col[kLdu], bh[ni][0], bl[ni][0]);
        split_pair(col[8 * kLdu], col[9 * kLdu], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int o = 0; o < 3; ++o) {
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          mma_bf16(acc[o][ni], afr[i][o][0], bh[ni]);
        }
        if (PASSES == 3) {
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            mma_bf16(acc[o][ni], afr[i][o][0], bl[ni]);
          }
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            mma_bf16(acc[o][ni], afr[i][o][kParts - 1], bh[ni]);
          }
        }
      }
    }
    if (splits > 1) {  // block-uniform
      if (slice > 0) {
        float* mine = red_s + ((slice - 1) * mwarps + m) * kSums * 32 + lane;
#pragma unroll
        for (int o = 0; o < 3; ++o) {
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              mine[((o * NI + ni) * 4 + q) * 32] = acc[o][ni][q];
            }
          }
        }
      }
      __syncthreads();
      if (slice == 0) {
        for (int sl = 1; sl < splits; ++sl) {
          const float* part =
              red_s + ((sl - 1) * mwarps + m) * kSums * 32 + lane;
#pragma unroll
          for (int o = 0; o < 3; ++o) {
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                acc[o][ni][q] += part[((o * NI + ni) * 4 + q) * 32];
              }
            }
          }
        }
      }
    }
    if (slice != 0 || !active) continue;

    const int comp = n / tiles;
    const int e0 = (n - comp * tiles) * TN;
    float* __restrict__ out = ptrs.out[comp];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cl = ni * 8 + 2 * t + j;
        if (e0 + cl >= num_e) continue;
        const float c11 = cc[cl];
        const float c12 = cc[TN + cl];
        const float c22 = cc[2 * TN + cl];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * mt + g + 8 * half;
          if (row >= rows) continue;
          const int q = 2 * half + j;
          out[static_cast<long long>(row) * num_e + e0 + cl] =
              __fadd_rn(__fadd_rn(__fmul_rn(c11, acc[0][ni][q]),
                                  __fmul_rn(c12, acc[1][ni][q])),
                        __fmul_rn(c22, acc[2][ni][q]));
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <int PASSES, int TN, int STEPS>
int launch(const uint4* frags, const float* c_aff, const Pointers& ptrs,
           int num_c, int rows, int num_e, int mt_total, int ksteps,
           int panels, int mwarps, int splits, int blocks,
           cudaStream_t stream) {
  auto kernel = stiffness2d_affine_split_kernel<PASSES, TN, STEPS>;
  const long long smem = smem_bytes(16 * mwarps, 16 * ksteps, TN, splits);
  // Opened once per device to the whole of a block's shared memory, not at
  // every launch.
  static bool opened[kMaxDevices] = {};
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= kMaxDevices || !opened[device]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (device < kMaxDevices) opened[device] = true;
    }
  }
  kernel<<<dim3(blocks, panels), 32 * mwarps * splits,
           static_cast<size_t>(smem), stream>>>(frags, c_aff, ptrs, num_c,
                                                rows, num_e, mt_total, ksteps,
                                                mwarps);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for (passes, tile, steps per warp): the body holds
// exactly as many steps' fragments as the plan gives a warp (2, 3 or 4), so
// that no register is spent on steps it does not take.
template <int PASSES>
int launch_plan(const uint4* frags, const float* c_aff, const Pointers& ptrs,
                int num_c, int rows, int num_e, int mt_total, int ksteps,
                int panels, int mwarps, int tile, int splits, int blocks,
                cudaStream_t stream) {
  const int steps = (ksteps + splits - 1) / splits;
#define SPLIT_LAUNCH(TN, STEPS)                                             \
  launch<PASSES, TN, STEPS>(frags, c_aff, ptrs, num_c, rows, num_e,         \
                            mt_total, ksteps, panels, mwarps, splits, blocks, \
                            stream)
  if (tile == 16) {
    return steps <= 2   ? SPLIT_LAUNCH(16, 2)
           : steps == 3 ? SPLIT_LAUNCH(16, 3)
                        : SPLIT_LAUNCH(16, 4);
  }
  return steps <= 2   ? SPLIT_LAUNCH(32, 2)
         : steps == 3 ? SPLIT_LAUNCH(32, 3)
                      : SPLIT_LAUNCH(32, 4);
#undef SPLIT_LAUNCH
}

}  // namespace

// frags: `cuda_split.affine_fragments` of the (3 rows_pad, depth_pad) bf16
// split, rows_pad <= 128; c_aff: (3, num_e) float32; us, outs: num_c
// (rows, num_e) float32 fields (rows = k^2, the depth of the operator
// before padding).  The plan (`panels` row panels of `panel_rows` rows,
// column tiles of `tile` elements, the depth in `splits` slices, `blocks`
// blocks per panel) comes from the host; any plan that covers the rows and
// fits a block is valid.
extern "C" int stiffness2d_affine_split_f32(
    const void* frags, const void* c_aff, const void* const* us,
    void* const* outs, int num_c, int rows, int rows_pad, int depth_pad,
    int num_e, int passes, int panels, int panel_rows, int tile, int splits,
    int blocks, void* stream) {
  const int err = split_bf16::check_args(num_c, rows, rows, rows_pad,
                                         depth_pad, num_e);
  if (err != 0) return err;
  const int ksteps = depth_pad / 16;
  const int mwarps = panel_rows / 16;
  if ((passes != 1 && passes != 3) || rows_pad > kMaxPanelRows ||
      panel_rows < 16 || panel_rows % 16 != 0 || panels < 1 ||
      static_cast<long long>(panels) * panel_rows < rows_pad ||
      (tile != 16 && tile != 32) || splits < 1 || splits > ksteps ||
      mwarps * splits > 8 || (ksteps + splits - 1) / splits > 4 ||
      blocks < 1 ||
      (reinterpret_cast<uintptr_t>(frags) & 15) != 0 ||
      smem_bytes(panel_rows, depth_pad, tile, splits) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_e == 0) return static_cast<int>(cudaGetLastError());
  Pointers ptrs = {};
  for (int c = 0; c < num_c; ++c) {
    ptrs.u[c] = static_cast<const float*>(us[c]);
    ptrs.out[c] = static_cast<float*>(outs[c]);
  }
  const uint4* f = static_cast<const uint4*>(frags);
  const float* c = static_cast<const float*>(c_aff);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mt_total = rows_pad / 16;
  return passes == 3
             ? launch_plan<3>(f, c, ptrs, num_c, rows, num_e, mt_total, ksteps,
                              panels, mwarps, tile, splits, blocks, s)
             : launch_plan<1>(f, c, ptrs, num_c, rows, num_e, mt_total, ksteps,
                              panels, mwarps, tile, splits, blocks, s);
}
