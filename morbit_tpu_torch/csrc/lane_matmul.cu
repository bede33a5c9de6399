// K7: a batched matrix product whose every entry is one fixed sum.
//
// Replaces no TPU kernel. It replaces the card's float64 library product
// (a @ b) in lane_matmul on the port's float64 paths: cuBLAS picks its
// algorithm, and with it the order of each sum, by the batch size (at one
// column and one lane another order than at sixteen lanes), so a lane's
// last bits depended on the width of its batch (ROADMAP 3.15). Its plain
// PyTorch twin, in the same operation order, is
// morbit_tpu_torch/ops/lane_linalg.py::lane_matmul_plain.
//
// out[l, i, j] = sum over t = 0 .. q-1 of a[l, i, t] * b[l, t, j], from +0,
// in ascending t, each product rounded and then added (built with
// --fmad=false). One thread computes one output entry; the wrapper flattens
// broadcast batch axes, so the kernel sees (N, p, q) @ (N, q, m).
//
// Bound on the H100: 2 p q m operations and (p q + q m + p m) values a lane;
// at the port's shapes (matrix-vector products, m <= 3, and the RBF fit's
// residual, q = k up to 1,377) it reads a once and is bound by those bytes.
// A thread walks its row of a in order; the threads of a warp take
// neighbouring outputs (j fastest, then i), so one load of b serves the warp.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void lane_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                   T* __restrict__ out, long long total, int p, int q, int m) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long pm = (long long)p * m;
  const long long l = e / pm;
  const long long r = e - l * pm;
  const int i = (int)(r / m), j = (int)(r - (long long)i * m);
  const T* ar = a + (l * p + i) * q;
  const T* bc = b + l * q * m + j;
  T s = T(0);
  for (int t = 0; t < q; ++t) {
    const T prod = ar[t] * bc[(long long)t * m];
    s = s + prod;
  }
  out[e] = s;
}

}  // namespace

// a: N x p x q, b: N x q x m, out: N x p x m, all contiguous
extern "C" {

int lane_matmul_f64(const double* a, const double* b, double* out, long long N, int p, int q,
                    int m, void* stream) {
  const long long total = N * p * m;
  if (total <= 0) return 0;
  if (q < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  lane_matmul_kernel<double><<<(unsigned)blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a, b, out, total, p, q, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
