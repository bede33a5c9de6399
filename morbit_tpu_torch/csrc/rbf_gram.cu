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
// Design: one block per lane, 256 threads (8 warps). The lane's P x n sites
// are staged once in shared memory (rows padded with zeros to a multiple of
// 4 coordinates, 16-byte vector loads), with their squared norms and the
// mask. The output is exactly symmetric (row and column norms come from the
// same FMA chain, and fma(a, b, c) = fma(b, a, c)), so only the 32 x 32
// tiles with I <= J are computed: each warp takes whole tiles, lane j one
// column, its coordinates in registers (16 at a time) against 16 rows at a
// time. The tile's cross terms go to a padded 32 x 33 shared-memory tile;
// phi (one kernel instance per RBF kernel) replaces them there, row by row,
// while the tile is written along its rows, and the mirror tile is written
// along its rows from the same buffer. Each output row is padded to a
// multiple of 8 values (the wrapper returns a view), so every row segment a
// warp stores is whole 32-byte sectors. At P = 251 a lane has 36 tiles,
// 4-5 a warp.
//
// Every output keeps the bits of the earlier one-block-per-tile design: the
// cross term and the norms are FMA chains in ascending coordinate order
// from +0 (a padded
// coordinate adds fma(0, 0, acc) = acc, acc never being -0), then
// r2 = (|s_i|^2 + |s_j|^2) - 2 acc (2 acc is exact, so contracting it into
// an FMA changes nothing), the clamp, and the same rbf_phi.cuh.
//
// Bound on the H100: the output dominates the bytes (B P^2 values: 258 MB at
// B=1024, P=251, float32, ~0.08 ms at 3.35 TB/s) and the cross term the
// operations (2 n per entry, ~0.04 ms at the FP32 peak), so the kernel is
// bound by its writes; phi (a pow for the cubic kernel) is evaluated once
// per symmetric pair. The writes are 128-byte row segments scattered over
// the lane's rows, not one stream: they alone take longer than a
// contiguous fill of the same bytes (PERF.md).

#include <cuda_runtime.h>
#include <math.h>

#include "rbf_phi.cuh"

namespace {

using morbit::Phi;
using morbit::phi;

constexpr int TILE = 32, HALF = 16, WARPS = 8, THREADS = 32 * WARPS, CH = 16, TLD = TILE + 1;

// row stride of the staged sites: n rounded up to 4, and an odd number of
// 16-byte vectors (conflict-free vector loads of 8 different rows)
__host__ __device__ inline int gram_ld(int n) {
  int ld = (n + 3) / 4 * 4;
  return (ld / 4) % 2 == 0 ? ld + 4 : ld;
}

// dynamic shared memory: sites, norms, the warps' tiles, the mask
__host__ __device__ inline size_t gram_smem_bytes(int P, int n, int item) {
  const size_t rows = (P + TILE - 1) / TILE * TILE;
  return item * (rows * gram_ld(n) + rows + (size_t)WARPS * TILE * TLD) + rows;
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, T* x);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
template <>
__device__ __forceinline__ void load4<double>(const double* p, double* x) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 c = reinterpret_cast<const double2*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = c.x, x[3] = c.y;
}

// the cross terms s_i . s_j of rows i0 .. i0 + 15 with the lane's column j,
// FMA chains in ascending coordinate order from +0, into buf[lane][r0 + r]
template <typename T>
__device__ __forceinline__ void cross_half(const T* s, int ld, int i0, int j, T* brow) {
  T acc[HALF];
#pragma unroll
  for (int r = 0; r < HALF; ++r) acc[r] = T(0);
  for (int t0 = 0; t0 < ld; t0 += CH) {
    T sj[CH];
#pragma unroll
    for (int v = 0; v < CH; v += 4)
      if (t0 + v < ld) load4(s + j * ld + t0 + v, sj + v);
#pragma unroll
    for (int r = 0; r < HALF; ++r) {
      const T* si = s + (i0 + r) * ld + t0;
#pragma unroll
      for (int v = 0; v < CH; v += 4) {
        if (t0 + v < ld) {
          T x[4];
          load4(si + v, x);
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[r] = fma(x[u], sj[v + u], acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < HALF; ++r) brow[r] = acc[r];
}

template <typename T, int KID>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 4 : 2)
rbf_gram_kernel(const T* __restrict__ S, const unsigned char* __restrict__ mask,
                const T* __restrict__ param, T* __restrict__ out, int P, int n, int ldo,
                Phi f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = (P + TILE - 1) / TILE, rows = nb * TILE, ld = gram_ld(n);
  T* s = reinterpret_cast<T*>(smem_raw);
  T* sq = s + (size_t)rows * ld;
  T* buf = sq + rows + warp * TILE * TLD;
  unsigned char* mk = reinterpret_cast<unsigned char*>(sq + rows + WARPS * TILE * TLD);
  const T* Sl = S + (long long)b * P * n;
  for (int idx = tid; idx < rows * ld; idx += THREADS) {
    const int i = idx / ld, t = idx % ld;
    s[idx] = i < P && t < n ? Sl[(long long)i * n + t] : T(0);
  }
  for (int i = tid; i < rows; i += THREADS) mk[i] = i < P ? mask[(long long)b * P + i] : 0;
  __syncthreads();
  for (int i = tid; i < rows; i += THREADS) {
    T a = T(0);
    for (int t = 0; t < n; ++t) a = fma(s[i * ld + t], s[i * ld + t], a);
    sq[i] = a;
  }
  __syncthreads();

  f.id = KID;
  const T p = param[b];
  T* O = out + (long long)b * P * ldo;
  const int ntile = nb * (nb + 1) / 2;
  for (int tt = warp; tt < ntile; tt += WARPS) {
    int I = 0, rem = tt;
    while (rem >= nb - I) rem -= nb - I++;
    const int J = I + rem, i0 = I * TILE, j0 = J * TILE, j = j0 + lane;
    // buf[lane][r]: the entry (i0 + r, j), first its cross term, then Phi
    cross_half(s, ld, i0, j, buf + lane * TLD);
    cross_half(s, ld, i0 + HALF, j, buf + lane * TLD + HALF);
    const bool mj = mk[j] != 0;
    const T sqj = sq[j];
    for (int r = 0; r < TILE; ++r) {
      const int i = i0 + r;
      T r2 = (sq[i] + sqj) - T(2) * buf[lane * TLD + r];
      r2 = r2 < T(0) ? T(0) : r2;  // jnp.maximum(r2, 0): NaN stays NaN
      const T val = mj && mk[i] != 0 ? phi(f, r2, p) : (i == j ? T(1) : T(0));
      if (i < P && j < ldo) O[(long long)i * ldo + j] = val;
      buf[lane * TLD + r] = val;
    }
    if (I != J) {  // the mirror tile, along its rows
      __syncwarp();
      for (int q = 0; q < TILE; ++q) {
        const int jr = j0 + q, ic = i0 + lane;
        if (jr < P && ic < ldo) O[(long long)jr * ldo + ic] = buf[q * TLD + lane];
      }
    }
    __syncwarp();
  }
}

template <typename T, int KID>
int launch_id(const T* S, const unsigned char* mask, const T* param, T* out, int B, int P,
              int n, int ldo, Phi f, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rbf_gram_kernel<T, KID>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rbf_gram_kernel<T, KID><<<B, THREADS, smem, s>>>(S, mask, param, out, P, n, ldo, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* S, const unsigned char* mask, const T* param, T* out, int B, int P,
           int n, int ldo, int kernel_id, double exponent, double coef, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  if (n < 1 || ldo < P || ldo % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = gram_smem_bytes(P, n, sizeof(T));
  const Phi f{kernel_id, exponent, coef};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one instance per RBF kernel: phi's switch is resolved at compile time
  switch (kernel_id) {
    case morbit::CUBIC:
      return launch_id<T, morbit::CUBIC>(S, mask, param, out, B, P, n, ldo, f, smem, s);
    case morbit::MULTIQUADRIC:
      return launch_id<T, morbit::MULTIQUADRIC>(S, mask, param, out, B, P, n, ldo, f, smem, s);
    case morbit::INV_MULTIQUADRIC:
      return launch_id<T, morbit::INV_MULTIQUADRIC>(S, mask, param, out, B, P, n, ldo, f, smem, s);
    case morbit::GAUSSIAN:
      return launch_id<T, morbit::GAUSSIAN>(S, mask, param, out, B, P, n, ldo, f, smem, s);
    case morbit::TPS:
      return launch_id<T, morbit::TPS>(S, mask, param, out, B, P, n, ldo, f, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// `out` holds B x P rows of `ldo` values (ldo >= P, a multiple of 8: every
// row starts on a 32-byte sector); the columns past P are padding.
extern "C" {

int rbf_gram_f32(const float* S, const unsigned char* mask, const float* param, float* out,
                 int B, int P, int n, int ldo, int kernel_id, double exponent, double coef,
                 void* stream) {
  return launch<float>(S, mask, param, out, B, P, n, ldo, kernel_id, exponent, coef,
                       stream);
}

int rbf_gram_f64(const double* S, const unsigned char* mask, const double* param,
                 double* out, int B, int P, int n, int ldo, int kernel_id, double exponent,
                 double coef, void* stream) {
  return launch<double>(S, mask, param, out, B, P, n, ldo, kernel_id, exponent, coef,
                        stream);
}

}  // extern "C"
