// Congruent-element 3D stiffness, sum-factorized, for C <= 4 components.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness3d.py:stiffness3d_el_pallas_uniform
// (_kernel_3d_uniform).  On an axis-aligned box of identical elements the
// element operator is
//
//   A = c11 (At x W x W) + c22 (W x At x W) + c33 (W x W x At),
//   At = D^T W D,  W = diag(w),
//
// so no geometric factor field is read.  Per element, with u = u[m, q, r]:
//
//   out[m,q,r] = w_r (c11 w_q sum_a At[m,a] u[a,q,r]
//                     + c22 w_m sum_b At[q,b] u[m,b,r])
//                + c33 w_m w_q sum_c At[r,c] u[m,q,c].
//
// The coefficients (At, w, c11 w, c22 w, c33 w w^T) come as one small table
// computed in float64 on the host and cast to the working dtype.  Fields are
// (k, k, k, E), element axis last.  The class is that of the TPU kernel at
// HIGHEST: FP32 (or FP64) FFMA, no TF32.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32) at 16^3 elements,
// order 7, C = 3, float32: 2 C k^3 E 4 B = 50.3 MB in and out, 15.0 us;
// 0.654 GFLOP (the count of bench.py:_stiffness_counts), 9.8 us.  Memory
// sets the bound.
//
// Design.  Persistent blocks walk (component, tile) units, block b the
// contiguous range [b U / grid, (b + 1) U / grid) of the U = C ceil(E / TE)
// units (cuda_stiffness3d.uniform3d_grid).  A tile is TE elements by the
// k^3 points, one row of TE values a point: TE = 32 in float32 (16 in
// float64), so that a row is 128 bytes, where two stages and the output
// tile fit in shared memory (k <= 8), else half that (Plan; mirrored by
// cuda_stiffness3d.uniform3d_plan).  A producer warp fills a ring of two to
// four stages with TMA copies (tma.cuh): the field's tile as up to four 2D
// tensor-map boxes of TE elements by up to 256 rows, zero fill past num_e
// (where a row is not 16-byte aligned, the warp copies it element by
// element), each stage's arrival counted by an mbarrier, so that the next
// units land while this one is computed.  The consumers (a warp per 32 / TE
// planes) contract pencil-owned lines: a thread holds a line of k points of
// one element in registers, reads each input once from shared memory and
// forms the line's k outputs by k FFMAs per input, At^T read as 16-byte
// shared-memory broadcasts.  Per unit:
//
//   A. thread (r, element) takes the plane r: its k xi lines (., q, r)
//      write w_r c11 w_q (At u) into the output tile O, then its k eta
//      lines (m, ., r) add w_r c22 w_m (At u): both terms of each of the
//      plane's points come from this thread, so they meet without a
//      barrier;
//   B. after one barrier, the zeta lines (m, q, .) add c33 w_m w_q (At u)
//      to O and store the sums to device memory, a warp's store a whole
//      row of TE elements (128 bytes in float32; evict-first), so that the
//      device memory sees the bound's 2 C k^3 E words;
//
// and a barrier before the next unit's stage A writes O again.  Shared
// memory sees one access per point and stage, not one per FFMA.  At k = 8
// in float32 a block is 8 consumer warps and the producer, with two 64 KB
// stages and the 64 KB output tile; at 16^3 elements, C = 3, 384 units,
// at most 3 a block.
//
// At 16^3 elements, order 7, C = 3 on an H100 at 700 W this design takes
// 25.6 us, 1.7x its bound; variant builds
// (tests/torch_port_split2d_uniform3d_variants.py) take 20.9 us without the
// field copies, 17.7 without the FFMA stages and 18.5 without the stores:
// copies, products and stores each add 5-8 us, partly overlapped.  The
// first version (one thread per (m, q) line and element, 8-element tiles,
// 4 rows x 32 bytes a warp request, every FFMA of the xi and eta terms
// reading shared memory, load -> barrier -> compute -> store with no
// overlap, 1536 blocks of 512 threads) took 60.5 us.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma.cuh"

namespace {

constexpr int kMaxComponents = 4;
constexpr int kMinK = 2;
constexpr int kMaxK = 10;
constexpr int kSmemLimit = 232448;
constexpr int kMaxStages = 4;
constexpr int kMaxBoxRows = 256;  // TMA's limit on a box's rows

struct Pointers {
  const void* u[kMaxComponents];
  void* out[kMaxComponents];
};

// Sizes of the plan (constexpr; the Plan below puts them together).
constexpr int boxes_of(int points) {
  return (points + kMaxBoxRows - 1) / kMaxBoxRows;
}
// A box's rows: the points in equal boxes, each a multiple of 128 bytes
// (TMA's shared-memory alignment).
constexpr int box_rows_of(int points, int te, int size) {
  const int align = te * size >= 128 ? 1 : 128 / (te * size);
  const int rows = (points + boxes_of(points) - 1) / boxes_of(points);
  return (rows + align - 1) / align * align;
}
constexpr int stage_bytes_of(int points, int te, int size) {
  return boxes_of(points) * box_rows_of(points, te, size) * te * size;
}
// The table: At^T (rows padded to 16 bytes), w, c11 w, c22 w, c33 w w^T.
constexpr int table_of(int k, int size) {
  return k * ((k * size + 15) / 16 * 16 / size) + 3 * k + k * k;
}
// The mbarriers (128 bytes), the table and the output tile.
constexpr int fixed_bytes_of(int k, int te, int size) {
  return 128 + (table_of(k, size) * size + 127) / 128 * 128 +
         (k * k * k * te * size + 127) / 128 * 128;
}
// 128-byte rows where two stages fit beside the output tile, else half
// (128 bytes of slack align the whole).
constexpr int tile_e_of(int k, int size) {
  int te = 128 / size;
  while (te > 1 && 128 + fixed_bytes_of(k, te, size) +
                           2 * stage_bytes_of(k * k * k, te, size) >
                       kSmemLimit) {
    te /= 2;
  }
  return te;
}

// The geometry of the kernel at (T, K); mirrored by
// cuda_stiffness3d.uniform3d_plan (tested on the CPU).
template <typename T, int K>
struct Plan {
  static constexpr int kSize = static_cast<int>(sizeof(T));
  static constexpr int kPoints = K * K * K;
  static constexpr int kBoxes = boxes_of(kPoints);
  static constexpr int kVec = 16 / kSize;
  static constexpr int kLd = (K + kVec - 1) / kVec * kVec;  // At^T's rows
  static constexpr int kTableBytes =
      (table_of(K, kSize) * kSize + 127) / 128 * 128;
  static constexpr int kTE = tile_e_of(K, kSize);
  static constexpr int kBoxRows = box_rows_of(kPoints, kTE, kSize);
  static constexpr int kStageBytes = stage_bytes_of(kPoints, kTE, kSize);
  static constexpr int kStageElems = kStageBytes / kSize;
  static constexpr int kFixed = fixed_bytes_of(K, kTE, kSize);
  static constexpr int kStagesFit = (kSmemLimit - 128 - kFixed) / kStageBytes;
  static constexpr int kStages =
      kStagesFit < kMaxStages ? kStagesFit : kMaxStages;
  static constexpr int kSmem = 128 + kFixed + kStages * kStageBytes;
  static constexpr int kSlots = 32 / kTE;  // planes (lines) a warp holds
  static constexpr int kWarps = (K + kSlots - 1) / kSlots;
  static constexpr int kThreads = 32 * kWarps;  // the consumers
  static constexpr int kNS = kWarps * kSlots;    // line slots of a block
  static constexpr int kRounds = (K * K + kNS - 1) / kNS;  // zeta lines each

  static_assert(kStages >= 2, "two stages");
  static_assert(kSmem <= kSmemLimit, "shared memory");
  static_assert(kBoxRows <= kMaxBoxRows, "box rows");
  static_assert(kTE * kSize >= 32 && kTE <= 32, "tile width");
};

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
// to Plan::kLd).
template <typename T, int K>
__device__ __forceinline__ void axpy_row(const T* mrow, T x, T (&acc)[K]) {
  constexpr int V = Plan<T, K>::kVec;
#pragma unroll
  for (int i0 = 0; i0 < K; i0 += V) {
    T v[V];
    load_vec(mrow + i0, v);
#pragma unroll
    for (int t = 0; t < V; ++t) {
      if (i0 + t < K) acc[i0 + t] = fma(v[t], x, acc[i0 + t]);
    }
  }
}

// The consumers' barrier (named barrier 1: the producer warp is not in it).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// The producer warp: fills the ring along the block's units.
template <typename T, int K>
__device__ void produce(const Pointers& ptrs, const tma::FieldMaps& maps,
                        int tiles, int num_e, long long begin, long long end,
                        bool vec, T* ring, uint64_t* full, uint64_t* empty) {
  using P = Plan<T, K>;
  constexpr int TE = P::kTE;
  const int lane = threadIdx.x & 31;
  int i = 0;
  for (long long u = begin; u < end; ++u, ++i) {
    const int slot = i % P::kStages;
    tma::mbar_wait(empty + slot, ((i / P::kStages) & 1) ^ 1);
    const int c = static_cast<int>(u / tiles);
    const int e0 = static_cast<int>(u - static_cast<long long>(c) * tiles) * TE;
    T* dst = ring + slot * P::kStageElems;
    if (vec) {
      if (lane == 0) tma::mbar_expect(full + slot, P::kStageBytes);
      __syncwarp();
      if (lane < P::kBoxes) {
        tma::tensor_copy(dst + lane * P::kBoxRows * TE, &maps.m[c], e0,
                         lane * P::kBoxRows, full + slot);
      }
    } else {
      const T* __restrict__ src = static_cast<const T*>(ptrs.u[c]);
      for (int idx = lane; idx < P::kPoints * TE; idx += 32) {
        const int p = idx / TE;
        const int x = idx - p * TE;
        dst[idx] = e0 + x < num_e
                       ? src[static_cast<long long>(p) * num_e + e0 + x]
                       : T(0);
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) tma::mbar_arrive(full + slot);
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(Plan<T, K>::kThreads + 32, 1)
stiffness3d_uniform_kernel(const T* __restrict__ table, Pointers ptrs,
                           const __grid_constant__ tma::FieldMaps maps,
                           int num_c, int num_e, bool vec) {
  using P = Plan<T, K>;
  constexpr int TE = P::kTE;
  constexpr int kLd = P::kLd;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((128 - (tma::smem_addr(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + P::kStages;
  T* ats = reinterpret_cast<T*>(base + 128);  // At^T: At[m][a] at a kLd + m
  const T* w = ats + K * kLd;
  const T* cw1 = w + K;
  const T* cw2 = cw1 + K;
  const T* cw3 = cw2 + K;
  T* o_s = reinterpret_cast<T*>(base + 128 + P::kTableBytes);  // [point][TE]
  T* ring = reinterpret_cast<T*>(base + P::kFixed);

  const int tid = threadIdx.x;
  for (int i = tid; i < K * kLd; i += blockDim.x) {
    const int a = i / kLd;
    const int m = i - a * kLd;
    ats[i] = m < K ? table[m * K + a] : T(0);
  }
  for (int i = tid; i < 3 * K + K * K; i += blockDim.x) {
    ats[K * kLd + i] = table[K * K + i];
  }
  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      tma::mbar_init(full + s, 1);
      tma::mbar_init(empty + s, P::kWarps);
    }
    tma::fence_mbar_init();
  }
  __syncthreads();

  const int tiles = (num_e + TE - 1) / TE;
  const long long units = static_cast<long long>(num_c) * tiles;
  const long long begin = blockIdx.x * units / gridDim.x;
  const long long end = (blockIdx.x + 1) * units / gridDim.x;
  if (tid >= P::kThreads) {
    produce<T, K>(ptrs, maps, tiles, num_e, begin, end, vec, ring, full,
                  empty);
    return;
  }

  // This thread: element `el` of the tile, line slot `slot` (the plane r =
  // slot in stage A; zeta lines slot + kNS j in stage B).
  const int lane = tid & 31;
  const int el = lane % TE;
  const int slot = (tid >> 5) * P::kSlots + lane / TE;
  int i = 0;
  for (long long u = begin; u < end; ++u, ++i) {
    const int st = i % P::kStages;
    tma::mbar_wait(full + st, (i / P::kStages) & 1);
    const T* u_s = ring + st * P::kStageElems;
    const int c = static_cast<int>(u / tiles);
    const long long e =
        (u - static_cast<long long>(c) * tiles) * TE + el;

    // A. The plane r: xi lines into O, then eta lines added.
    if (slot < K) {
      const int r = slot;
      const T wr = w[r];
#pragma unroll 1
      for (int q = 0; q < K; ++q) {
        const int l0 = (q * K + r) * TE + el;  // point (0, q, r)
        T acc[K];
#pragma unroll
        for (int m = 0; m < K; ++m) acc[m] = T(0);
#pragma unroll
        for (int a = 0; a < K; ++a) {
          axpy_row<T, K>(ats + a * kLd, u_s[l0 + a * K * K * TE], acc);
        }
        const T cq = wr * cw1[q];
#pragma unroll
        for (int m = 0; m < K; ++m) o_s[l0 + m * K * K * TE] = cq * acc[m];
      }
#pragma unroll 1
      for (int m = 0; m < K; ++m) {
        const int l0 = (m * K * K + r) * TE + el;  // point (m, 0, r)
        T acc[K];
#pragma unroll
        for (int q = 0; q < K; ++q) acc[q] = T(0);
#pragma unroll
        for (int b = 0; b < K; ++b) {
          axpy_row<T, K>(ats + b * kLd, u_s[l0 + b * K * TE], acc);
        }
        const T cm = wr * cw2[m];
#pragma unroll
        for (int q = 0; q < K; ++q) {
          T* o = o_s + l0 + q * K * TE;
          *o = fma(cm, acc[q], *o);
        }
      }
    }
    consumers_sync(P::kThreads);

    // B. Zeta lines (m, q): add their term and store the sums.
    T* __restrict__ out = static_cast<T*>(ptrs.out[c]);
#pragma unroll
    for (int j = 0; j < P::kRounds; ++j) {
      const int line = slot + P::kNS * j;
      if (line >= K * K) continue;
      const int l0 = line * K * TE + el;  // point (m, q, 0)
      T acc[K];
#pragma unroll
      for (int r = 0; r < K; ++r) acc[r] = T(0);
#pragma unroll
      for (int cc = 0; cc < K; ++cc) {
        axpy_row<T, K>(ats + cc * kLd, u_s[l0 + cc * TE], acc);
      }
      const T c3 = cw3[line];
      if (e < num_e) {
#pragma unroll
        for (int r = 0; r < K; ++r) {
          __stcs(out + static_cast<long long>(line * K + r) * num_e + e,
                 fma(c3, acc[r], o_s[l0 + r * TE]));
        }
      }
    }
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(empty + st);  // this warp is done with U
    consumers_sync(P::kThreads);                  // and every warp with O
  }
}

template <typename T, int K>
int launch_k(const T* table, const Pointers& ptrs, int num_c, int num_e,
             int grid, cudaStream_t stream) {
  using P = Plan<T, K>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      stiffness3d_uniform_kernel<T, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // TMA boxes where every row is 16-byte aligned and a tile wide.
  const bool vec = tma::boxes_fit(ptrs.u, num_c, num_e, P::kSize, P::kTE);
  tma::FieldMaps maps = {};
  if (vec) {
    const int err = tma::field_maps(
        ptrs.u, num_c, P::kPoints, num_e,
        P::kSize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
        P::kSize, P::kTE, P::kBoxRows, CU_TENSOR_MAP_SWIZZLE_NONE, &maps);
    if (err != 0) return err;
  }
  stiffness3d_uniform_kernel<T, K>
      <<<grid, P::kThreads + 32, P::kSmem, stream>>>(table, ptrs, maps, num_c,
                                                     num_e, vec);
  return static_cast<int>(cudaGetLastError());
}

// out = [tile_e, threads, shared bytes, resident blocks per SM].
template <typename T, int K>
int layout_k(int* out) {
  using P = Plan<T, K>;
  const cudaError_t err = cudaFuncSetAttribute(
      stiffness3d_uniform_kernel<T, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = P::kTE;
  out[1] = P::kThreads + 32;
  out[2] = P::kSmem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], stiffness3d_uniform_kernel<T, K>, P::kThreads + 32, P::kSmem));
}

template <typename T, int K = kMinK>
int dispatch(int k, const T* table, const Pointers* ptrs, int num_c,
             int num_e, int grid, cudaStream_t stream, int* layout_out) {
  if constexpr (K > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k == K) {
      if (layout_out != nullptr) return layout_k<T, K>(layout_out);
      return launch_k<T, K>(table, *ptrs, num_c, num_e, grid, stream);
    }
    return dispatch<T, K + 1>(k, table, ptrs, num_c, num_e, grid, stream,
                              layout_out);
  }
}

template <typename T>
int launch(const void* table, const void* const* us, void* const* outs,
           int num_c, int k, int num_e, int grid, void* stream) {
  if (num_c < 1 || num_c > kMaxComponents || k < kMinK || k > kMaxK ||
      num_e < 0 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_e == 0) return static_cast<int>(cudaGetLastError());
  Pointers ptrs = {};
  for (int c = 0; c < num_c; ++c) {
    ptrs.u[c] = us[c];
    ptrs.out[c] = outs[c];
  }
  return dispatch<T>(k, static_cast<const T*>(table), &ptrs, num_c, num_e,
                     grid, static_cast<cudaStream_t>(stream), nullptr);
}

}  // namespace

// table: uniform_table_np (2 k^2 + 3 k); us, outs: (k, k, k, num_e), all
// float32 (or all float64); grid: persistent blocks
// (cuda_stiffness3d.uniform3d_grid).
extern "C" int stiffness3d_uniform_f32(const void* table, const void* const* us,
                                       void* const* outs, int num_c, int k,
                                       int num_e, int grid, void* stream) {
  return launch<float>(table, us, outs, num_c, k, num_e, grid, stream);
}

extern "C" int stiffness3d_uniform_f64(const void* table, const void* const* us,
                                       void* const* outs, int num_c, int k,
                                       int num_e, int grid, void* stream) {
  return launch<double>(table, us, outs, num_c, k, num_e, grid, stream);
}

// The kernel's geometry at k (f64: the float64 instance): out = [tile_e,
// threads, shared bytes, resident blocks per SM on the current device].
extern "C" int stiffness3d_uniform_layout(int k, int f64, int* out) {
  return f64 ? dispatch<double>(k, nullptr, nullptr, 0, 0, 1, nullptr, out)
             : dispatch<float>(k, nullptr, nullptr, 0, 0, 1, nullptr, out);
}
