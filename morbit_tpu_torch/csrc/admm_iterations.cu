// K5: `iters` OSQP splitting steps with the KKT inverse given, one thread per
// instance.
//
// Replaces the TPU kernel `admm_iterations` (morbit_tpu/ops/pallas_kernels.py:78-138,
// its `pl.pallas_call` at :127). Its plain PyTorch twin is
// morbit_tpu_torch/ops/dense_kernels.py::admm_iterations_plain. Neither package
// calls it (morbit_tpu/ops/qp.py:47-52 records it as superseded by K1); it is
// held against its twin only.
//
// Per instance, with Minv (n, n), A (m, n) and the vectors rho, q, l, u, z, zz, y:
//     rhs = sigma z - q + A' (rho * zz - y)
//     xt  = Minv rhs,  zt = A xt
//     z   = alpha xt + (1 - alpha) z
//     zz' = clip(alpha zt + (1 - alpha) zz + y / rho, l, u)
//     y   = y + rho * (alpha zt + (1 - alpha) zz - zz'),  zz = zz'
//
// Design: one thread per instance, Minv and A read from device memory (L1)
// every step, the vectors in local memory (n <= 64, m <= 128), sums in index
// order. Bound on the H100: ~2 (n^2 + 2 n m) operations per step and the
// operands read once; a serial chain of `iters` dependent steps per thread
// makes this simple kernel latency-bound.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_N = 64, MAX_M = 128, THREADS = 128;

// jnp.clip: NaN stays NaN
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  T y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
admm_iterations_kernel(const T* __restrict__ Minv, const T* __restrict__ A,
                       const T* __restrict__ rho, const T* __restrict__ q,
                       const T* __restrict__ l, const T* __restrict__ u,
                       const T* __restrict__ z0, const T* __restrict__ zz0,
                       const T* __restrict__ y0, T* __restrict__ z_out,
                       T* __restrict__ zz_out, T* __restrict__ y_out, int B, int n,
                       int m, int iters, T sigma, T alpha, T one_m_alpha) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* Mi = Minv + (long long)b * n * n;
  const T* Am = A + (long long)b * m * n;
  const long long vn = (long long)b * n, vm = (long long)b * m;
  T z[MAX_N], rhs[MAX_N], xt[MAX_N], zz[MAX_M], y[MAX_M], zt[MAX_M];
  for (int i = 0; i < n; ++i) z[i] = z0[vn + i];
  for (int r = 0; r < m; ++r) {
    zz[r] = zz0[vm + r];
    y[r] = y0[vm + r];
  }
  for (int it = 0; it < iters; ++it) {
    for (int j = 0; j < n; ++j) {
      T acc = T(0);
      for (int r = 0; r < m; ++r) acc += (rho[vm + r] * zz[r] - y[r]) * Am[r * n + j];
      rhs[j] = (sigma * z[j] - q[vn + j]) + acc;
    }
    for (int i = 0; i < n; ++i) {
      T acc = T(0);
      for (int j = 0; j < n; ++j) acc += rhs[j] * Mi[i * n + j];
      xt[i] = acc;
    }
    for (int r = 0; r < m; ++r) {
      T acc = T(0);
      for (int i = 0; i < n; ++i) acc += xt[i] * Am[r * n + i];
      zt[r] = acc;
    }
    for (int i = 0; i < n; ++i) z[i] = alpha * xt[i] + one_m_alpha * z[i];
    for (int r = 0; r < m; ++r) {
      const T rr = rho[vm + r];
      const T relaxed = alpha * zt[r] + one_m_alpha * zz[r];
      const T zz_new = clip(relaxed + y[r] / rr, l[vm + r], u[vm + r]);
      y[r] = y[r] + rr * (relaxed - zz_new);
      zz[r] = zz_new;
    }
  }
  for (int i = 0; i < n; ++i) z_out[vn + i] = z[i];
  for (int r = 0; r < m; ++r) {
    zz_out[vm + r] = zz[r];
    y_out[vm + r] = y[r];
  }
}

template <typename T>
int launch(const T* Minv, const T* A, const T* rho, const T* q, const T* l, const T* u,
           const T* z0, const T* zz0, const T* y0, T* z, T* zz, T* y, int B, int n, int m,
           int iters, double sigma, double alpha, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || m < 1 || n > MAX_N || m > MAX_M) return static_cast<int>(cudaErrorInvalidValue);
  admm_iterations_kernel<T><<<(B + THREADS - 1) / THREADS, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      Minv, A, rho, q, l, u, z0, zz0, y0, z, zz, y, B, n, m, iters, T(sigma), T(alpha),
      T(1.0 - alpha));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MORBIT_K5_EXPORT(NAME, T)                                                      \
  extern "C" int NAME(const T* Minv, const T* A, const T* rho, const T* q, const T* l, \
                      const T* u, const T* z0, const T* zz0, const T* y0, T* z, T* zz, \
                      T* y, int B, int n, int m, int iters, double sigma, double alpha, \
                      void* stream) {                                                  \
    return launch<T>(Minv, A, rho, q, l, u, z0, zz0, y0, z, zz, y, B, n, m, iters,     \
                     sigma, alpha, stream);                                            \
  }

MORBIT_K5_EXPORT(admm_iterations_f32, float)
MORBIT_K5_EXPORT(admm_iterations_f64, double)
