// K4: masked, identity-padded RBF Gram matrices, batched over lanes.
//
// Replaces the TPU kernel `rbf_gram_matrix` (morbit_tpu/ops/pallas_kernels.py:71,
// bodies `_gram_kernel` :36-49 and `_gram_kernel_static` :141-155). Its plain
// PyTorch twin is morbit_tpu_torch/ops/dense_kernels.py::rbf_gram_matrix_plain.
//
// Per lane, for sites S (P, n) and a mask (P,):
//     r2[i][j]  = max(|s_i|^2 + |s_j|^2 - 2 s_i . s_j, 0)
//     out[i][j] = phi(r2[i][j])   where both rows are valid,
//                 the identity    elsewhere.
// phi is one of the five RBF kernels (rbf_phi.cuh); the exponent kernels get
// their exponent from the wrapper, the smooth ones the lane's shape parameter.
//
// Design: one block per (lane, 32 x 32 output tile), 256 threads, each thread
// four outputs of one column. The tile's 32 row sites and 32 column sites are
// staged in shared memory in chunks of 32 coordinates; the cross term is summed
// with FP32 (or FP64) FMAs in the kernel's own loop (the Pallas kernel asks for
// HIGHEST precision: no TF32, no library GEMM). The squared norms come from the
// same staged chunks.
//
// Bound on the H100: the output dominates the bytes (B P^2 values: 258 MB at
// B=1024, P=251, float32, ~0.08 ms at 3.35 TB/s) and the cross term the
// operations (2 n per entry, ~0.04 ms at the FP32 peak), so the kernel is
// bound by its writes; each output is written once, coalesced along a row.

#include <cuda_runtime.h>
#include <math.h>

#include "rbf_phi.cuh"

namespace {

using morbit::Phi;
using morbit::phi;

constexpr int TILE = 32, KC = 32, TX = 32, TY = 8, ROWS_PER_THREAD = TILE / TY;

template <typename T>
__global__ void __launch_bounds__(TX * TY)
rbf_gram_kernel(const T* __restrict__ S, const unsigned char* __restrict__ mask,
                const T* __restrict__ param, T* __restrict__ out, int P, int n, Phi f) {
  __shared__ T si[TILE][KC + 1], sj[TILE][KC + 1];
  __shared__ T sqi[TILE], sqj[TILE];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const T* Sl = S + (long long)b * P * n;

  T acc[ROWS_PER_THREAD];
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) acc[k] = T(0);
  T sq = T(0);  // threads 0-31: |s_{i0+tid}|^2; threads 32-63: |s_{j0+tid-32}|^2
  for (int k0 = 0; k0 < n; k0 += KC) {
    for (int idx = tid; idx < TILE * KC; idx += TX * TY) {
      const int r = idx / KC, c = idx % KC, gk = k0 + c;
      const int gi = i0 + r, gj = j0 + r;
      si[r][c] = (gi < P && gk < n) ? Sl[(long long)gi * n + gk] : T(0);
      sj[r][c] = (gj < P && gk < n) ? Sl[(long long)gj * n + gk] : T(0);
    }
    __syncthreads();
    if (tid < TILE) {
      for (int c = 0; c < KC; ++c) sq = fma(si[tid][c], si[tid][c], sq);
    } else if (tid < 2 * TILE) {
      for (int c = 0; c < KC; ++c) sq = fma(sj[tid - TILE][c], sj[tid - TILE][c], sq);
    }
#pragma unroll 8
    for (int c = 0; c < KC; ++c) {
      const T bj = sj[tx][c];
#pragma unroll
      for (int k = 0; k < ROWS_PER_THREAD; ++k) acc[k] = fma(si[ty + TY * k][c], bj, acc[k]);
    }
    __syncthreads();
  }
  if (tid < TILE) sqi[tid] = sq;
  else if (tid < 2 * TILE) sqj[tid - TILE] = sq;
  __syncthreads();

  const int j = j0 + tx;
  if (j >= P) return;
  const T p = param[b];
  const bool mj = mask[(long long)b * P + j] != 0;
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int i = i0 + ty + TY * k;
    if (i >= P) break;
    T r2 = (sqi[ty + TY * k] + sqj[tx]) - T(2) * acc[k];
    r2 = r2 < T(0) ? T(0) : r2;  // jnp.maximum(r2, 0): NaN stays NaN
    const bool mm = mj && mask[(long long)b * P + i] != 0;
    out[((long long)b * P + i) * P + j] = mm ? phi(f, r2, p) : (i == j ? T(1) : T(0));
  }
}

template <typename T>
int launch(const T* S, const unsigned char* mask, const T* param, T* out, int B, int P,
           int n, int kernel_id, double exponent, double coef, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (n < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((P + TILE - 1) / TILE, (P + TILE - 1) / TILE, B), block(TX, TY);
  rbf_gram_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      S, mask, param, out, P, n, Phi{kernel_id, exponent, coef});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rbf_gram_f32(const float* S, const unsigned char* mask, const float* param, float* out,
                 int B, int P, int n, int kernel_id, double exponent, double coef,
                 void* stream) {
  return launch<float>(S, mask, param, out, B, P, n, kernel_id, exponent, coef, stream);
}

int rbf_gram_f64(const double* S, const unsigned char* mask, const double* param,
                 double* out, int B, int P, int n, int kernel_id, double exponent,
                 double coef, void* stream) {
  return launch<double>(S, mask, param, out, B, P, n, kernel_id, exponent, coef, stream);
}

}  // extern "C"
