// Periodic 2D direct-stiffness summation (Q Q^T) in element-local form.
//
// Replaces swirlfem_tpu/ops/pallas_exchange.py:exchange2d_pallas (_kernel),
// the TPU kernel that runs the two sequential axis passes in VMEM.  Input and
// output are (k, k, n0, n1), contiguous, element axes last:
//
//   pass 1 (local axis 1 <-> element axis n1): s = w[a,p,e0,e1] + w[a,0,e0,e1+1]
//     is written to face p of element e1 and face 0 of element e1+1;
//   pass 2 (local axis 0 <-> element axis n0), on pass 1's output, the same
//     along e0 — so corners receive all four contributions.
//
// Design.  Hopper blocks run in no order, so the two in-place passes are not
// carried over.  Each thread computes one output entry in GATHER form, adding
// its node's copies in exactly the order of the two-pass reference:
//   face node:   w[a,p,.,e1] + w[a,0,.,e1+1]
//   corner node: (w[p,p] + w[p,0]+) + (w[0,p]+ + w[0,0]++)
// Every copy of a node therefore comes out bitwise identical to the plain
// torch.roll version (sem2d.exchange_el's plain path), which the chip test
// checks with exact equality.  There are no multiplies, so no FMA contraction
// can change the rounding.
//
// Bound.  Memory: one read of each face value (interior values once) and one
// write per entry; at the datagen shape (9, 9, 64, 64) in float32 that is
// 1.3 MB moved, well under a microsecond of HBM time, so the kernel is
// launch-bound in practice.  Grid-stride loop, 256 threads per block.

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T load(const T* __restrict__ w, int a, int b,
                                  int e0, int e1, int k, int n0, int n1) {
  const long long plane = static_cast<long long>(n0) * n1;
  return w[static_cast<long long>(a * k + b) * plane +
           static_cast<long long>(e0) * n1 + e1];
}

// Value of entry (a, b, e0, e1) after pass 1.
template <typename T>
__device__ __forceinline__ T pass1(const T* __restrict__ w, int a, int b,
                                   int e0, int e1, int k, int n0, int n1) {
  const int p = k - 1;
  if (b == p) {
    const int f1 = (e1 + 1 == n1) ? 0 : e1 + 1;
    return load(w, a, p, e0, e1, k, n0, n1) + load(w, a, 0, e0, f1, k, n0, n1);
  }
  if (b == 0) {
    const int f1 = (e1 == 0) ? n1 - 1 : e1 - 1;
    return load(w, a, p, e0, f1, k, n0, n1) + load(w, a, 0, e0, e1, k, n0, n1);
  }
  return load(w, a, b, e0, e1, k, n0, n1);
}

template <typename T>
__global__ void exchange2d_kernel(const T* __restrict__ w, T* __restrict__ out,
                                  int k, int n0, int n1, long long total) {
  const int p = k - 1;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int e1 = static_cast<int>(idx % n1);
    long long r = idx / n1;
    const int e0 = static_cast<int>(r % n0);
    r /= n0;
    const int b = static_cast<int>(r % k);
    const int a = static_cast<int>(r / k);
    T v;
    if (a == p) {
      const int f0 = (e0 + 1 == n0) ? 0 : e0 + 1;
      v = pass1(w, p, b, e0, e1, k, n0, n1) + pass1(w, 0, b, f0, e1, k, n0, n1);
    } else if (a == 0) {
      const int f0 = (e0 == 0) ? n0 - 1 : e0 - 1;
      v = pass1(w, p, b, f0, e1, k, n0, n1) + pass1(w, 0, b, e0, e1, k, n0, n1);
    } else {
      v = pass1(w, a, b, e0, e1, k, n0, n1);
    }
    out[idx] = v;
  }
}

template <typename T>
int launch(const void* w, void* out, int k, int n0, int n1, void* stream) {
  const long long total = static_cast<long long>(k) * k * n0 * n1;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  exchange2d_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<T*>(out), k, n0, n1, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int exchange2d_f32(const void* w, void* out, int k, int n0, int n1,
                              void* stream) {
  return launch<float>(w, out, k, n0, n1, stream);
}

extern "C" int exchange2d_f64(const void* w, void* out, int k, int n0, int n1,
                              void* stream) {
  return launch<double>(w, out, k, n0, n1, stream);
}
