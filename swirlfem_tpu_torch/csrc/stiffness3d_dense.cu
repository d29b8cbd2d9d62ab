// Congruent-element 3D stiffness as ONE dense (k^3, k^3) operator:
// out_c = A @ u_c for every component c, for C <= 4 components.
//
// Replaces swirlfem_tpu/ops/pallas_stiffness3d.py:stiffness3d_el_pallas_dense
// (_kernel_uniform_mm, precision 'highest').  On an axis-aligned box of
// identical elements the element operator
//
//   A = c11 (At x W x W) + c22 (W x At x W) + c33 (W x W x At),  At = D^T W D,
//
// is one static matrix, built in float64 on the host and cast to the working
// dtype; the apply is the product of A with the (k^3, E) field of each
// component (element axis last).  The caller passes A TRANSPOSED,
// at[j * k^3 + i] = A[i][j], so that both operand panels are read along
// their contiguous axis.
//
// Design (exact in the working precision: FFMA, no TF32).  At order 7 the
// operator is 512 x 512 x 4 B = 1 MiB, more than a block's shared memory, so
// it is not staged whole: the contraction axis is cut into panels of kBK = 8
// and the operator's panels are streamed (they stay in L2; every block reads
// all of A^T's rows of its output tile once).  A block of 256 threads owns a
// (BM x BM) output tile of one component (blockIdx.z): 128 x 128 in
// float32, 64 x 64 in float64.  Per panel it stores the (8, BM) slice of A^T
// and the (8, BM) slice of u in shared memory; each thread holds an
// 8 x 8 (float64: 4 x 4) register tile split in two halves per axis so that
// its shared-memory reads are 16-byte vectors on distinct banks.  The next
// panel is fetched into registers while the current one is multiplied.
// wgmma (3xTF32 or BF16 splits) and TMA are later work.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32) at 16^3 elements,
// order 7, C = 3, float32: 2 k^6 E C = 6.44 GFLOP, 96.2 us; (2 C k^3 E + k^6)
// 4 B = 51.4 MB, 15.3 us.  Operations set the bound.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxComponents = 4;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kBK = 8;         // contraction panel depth
constexpr int kMaxK3 = 1000;   // k <= 10

struct Pointers {
  const void* u[kMaxComponents];
  void* out[kMaxComponents];
};

// Register tile edge TM (two halves of TM / 2 = one 16-byte vector each) and
// the block tile edge 16 TM.
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int kTM = 8;
};
template <>
struct Tile<double> {
  static constexpr int kTM = 4;
};

__device__ __forceinline__ void load_half(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load_half(const double* p, double (&v)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x;
  v[1] = t.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stiffness3d_dense_kernel(const T* __restrict__ at, Pointers ptrs, int k3,
                         int num_e) {
  constexpr int TM = Tile<T>::kTM;
  constexpr int H = TM / 2;
  constexpr int BM = 16 * TM;                // rows and columns of the tile
  constexpr int LD = kBK * BM / kThreads;    // panel entries per thread
  __shared__ __align__(16) T a_s[kBK * BM];  // a_s[kk][i] = A[i0 + i][j0 + kk]
  __shared__ __align__(16) T b_s[kBK * BM];  // b_s[kk][n] = u[j0 + kk][e0 + n]

  const T* __restrict__ u = static_cast<const T*>(ptrs.u[blockIdx.z]);
  T* __restrict__ out = static_cast<T*>(ptrs.out[blockIdx.z]);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = blockIdx.y * BM;
  const int e0 = blockIdx.x * BM;

  T acc[TM][TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int c = 0; c < TM; ++c) acc[r][c] = T(0);
  }

  // Panel entry s of this thread: row kk = idx / BM, column idx % BM.
  T ra[LD], rb[LD];
#pragma unroll
  for (int s = 0; s < LD; ++s) {
    const int idx = tid + s * kThreads;
    const int j = idx / BM;
    const int n = idx % BM;
    ra[s] = (j < k3 && i0 + n < k3)
                ? at[static_cast<long long>(j) * k3 + i0 + n] : T(0);
    rb[s] = (j < k3 && e0 + n < num_e)
                ? u[static_cast<long long>(j) * num_e + e0 + n] : T(0);
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
                    ? at[static_cast<long long>(j) * k3 + i0 + n] : T(0);
        rb[s] = (j < k3 && e0 + n < num_e)
                    ? u[static_cast<long long>(j) * num_e + e0 + n] : T(0);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      T a_lo[H], a_hi[H], b_lo[H], b_hi[H];
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

template <typename T>
int launch(const void* at, const void* const* us, void* const* outs,
           int num_c, int k3, int num_e, void* stream) {
  if (num_c < 1 || num_c > kMaxComponents || k3 < 1 || k3 > kMaxK3 ||
      num_e < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_e == 0) return static_cast<int>(cudaGetLastError());
  Pointers ptrs = {};
  for (int c = 0; c < num_c; ++c) {
    ptrs.u[c] = us[c];
    ptrs.out[c] = outs[c];
  }
  constexpr int BM = 16 * Tile<T>::kTM;
  const dim3 grid((num_e + BM - 1) / BM, (k3 + BM - 1) / BM, num_c);
  stiffness3d_dense_kernel<T>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(at), ptrs, k3, num_e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stiffness3d_dense_f32(const void* at, const void* const* us,
                                     void* const* outs, int num_c, int k3,
                                     int num_e, void* stream) {
  return launch<float>(at, us, outs, num_c, k3, num_e, stream);
}

extern "C" int stiffness3d_dense_f64(const void* at, const void* const* us,
                                     void* const* outs, int num_c, int k3,
                                     int num_e, void* stream) {
  return launch<double>(at, us, outs, num_c, k3, num_e, stream);
}
