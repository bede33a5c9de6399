// qp_admm.cu — fixed-trip ADMM for batches of tiny dense QPs (kernel K1).
//
// Replaces the TPU kernel `_pallas_admm` (morbit_tpu/ops/qp_lane.py:289,
// body `admm_lane_batched` at :91-215). For every lane it solves
//     min 1/2 z'Pz + q'z   s.t.   l <= Az <= u
// with `n_stages` rho-stages of `n_steps` alpha-relaxed OSQP splitting steps
// (Stellato et al. 2020), exactly the formulas of `admm_lane_batched`:
// per stage M = P + sigma I + A' diag(rho) A, an unrolled Cholesky (lanes
// whose factor is not finite re-factor with jitter 1e-3 (tr M / nv + 1)),
// an explicit M^-1 = L^-T L^-1 and 1/rho so the splitting steps carry no
// division, zz clipped to [l, u], then rho rescaled by sqrt(pr / dr),
// clipped to [0.1, 10] and to [rho_lo, rho_hi]. Infinite bounds arrive as
// +-1e30 from the wrapper (morbit_tpu_torch/ops/qp_lane.py).
//
// Design: one thread per lane, 128-thread blocks over the batch, all stages
// and steps in one launch. P, q, A, l, u, rho, M^-1 and the z/zz/y state
// live in registers: NV and M are template parameters, instantiated for the
// shapes the solver meets (nv=3/m=6: the steepest-descent LP of a 2-variable
// problem; nv=4/m=8: of a 3-variable problem), and a generic instance with
// runtime sizes up to 32 x 64 covers the rest from local memory (nv=21/m=42:
// the LP of the 20-variable ZDT path), its loops rolled and one warp per
// block.
//
// Bound on an H100: the work is ~165 flops per splitting step per lane at
// nv=3/m=6, ~66 kflop per lane for a 400-step solve, ~68 Mflop per launch
// at B=1024, against ~260 KB of operands — tiny, and compute-bound on paper
// (about 1 us at the fp32 peak). This simple design is latency- and
// occupancy-bound instead: each thread runs a serial chain of 400 dependent
// steps, and B=1024 lanes fill only 8 of the 132 SMs. Spreading a lane's
// rows over a warp, or many lanes per SM, is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxNV = 32;
constexpr int kMaxM = 64;
constexpr int kThreads = 128;
// the generic instance runs one warp per block, so B=1024 lanes spread over
// 32 SMs instead of 8
constexpr int kGenericThreads = 32;

// NaN-propagating max/clip: jnp.maximum and jnp.clip propagate NaN, fmax
// does not.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  T y = x < lo ? lo : x;  // NaN x stays NaN
  return y > hi ? hi : y;
}

// x - x is 0 for finite x and NaN for +-inf and NaN (IEEE; no fast-math).
template <typename T>
__device__ __forceinline__ bool finite(T x) { return (x - x) == T(0); }

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

// Unrolled Cholesky of the lower triangle of M (same order as
// ops.batched_linalg.chol_factor); returns whether every entry is finite.
template <typename T, int NVC, int NV_T>
__device__ __forceinline__ bool chol(const T (&M)[NVC][NVC], T (&L)[NVC][NVC],
                                     int nv) {
  bool ok = true;
#pragma unroll (NV_T > 0 ? 64 : 1)
  for (int j = 0; j < NVC; ++j) {
    if (j >= nv) break;
    T s = M[j][j];
#pragma unroll (NV_T > 0 ? 64 : 1)
    for (int t = 0; t < NVC; ++t) {
      if (t >= j) break;
      s = s - L[j][t] * L[j][t];
    }
    L[j][j] = dsqrt(s);
    ok = ok && finite(L[j][j]);
#pragma unroll (NV_T > 0 ? 64 : 1)
    for (int i = 0; i < NVC; ++i) {
      if (i <= j || i >= nv) continue;
      T s2 = M[i][j];
#pragma unroll (NV_T > 0 ? 64 : 1)
      for (int t = 0; t < NVC; ++t) {
        if (t >= j) break;
        s2 = s2 - L[i][t] * L[j][t];
      }
      L[i][j] = s2 / L[j][j];
      ok = ok && finite(L[i][j]);
    }
  }
  return ok;
}

// NV_T/M_T > 0: compile-time sizes (registers); 0: runtime sizes up to
// kMaxNV x kMaxM.
template <typename T, int NV_T, int M_T>
__global__ void __launch_bounds__(kThreads)
qp_admm_kernel(const T* __restrict__ P, const T* __restrict__ q,
               const T* __restrict__ A, const T* __restrict__ l,
               const T* __restrict__ u, const T* __restrict__ rho0,
               T* __restrict__ z_out, T* __restrict__ zz_out,
               T* __restrict__ y_out, int B, int nv_rt, int m_rt,
               int n_stages, int n_steps, T sigma, T alpha, T rho_lo,
               T rho_hi) {
  constexpr int NVC = NV_T > 0 ? NV_T : kMaxNV;
  constexpr int MC = M_T > 0 ? M_T : kMaxM;
  const int nv = NV_T > 0 ? NV_T : nv_rt;
  const int m = M_T > 0 ? M_T : m_rt;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  T Pk[NVC][NVC], qk[NVC], Ak[MC][NVC], lk[MC], uk[MC], rho[MC];
  T z[NVC], zz[MC], y[MC];
#pragma unroll (NV_T > 0 ? 64 : 1)
  for (int i = 0; i < NVC; ++i) {
    if (i >= nv) break;
    qk[i] = q[(size_t)b * nv + i];
    z[i] = T(0);
#pragma unroll (NV_T > 0 ? 64 : 1)
    for (int j = 0; j < NVC; ++j) {
      if (j >= nv) break;
      Pk[i][j] = P[((size_t)b * nv + i) * nv + j];
    }
  }
#pragma unroll (NV_T > 0 ? 64 : 1)
  for (int r = 0; r < MC; ++r) {
    if (r >= m) break;
    lk[r] = l[(size_t)b * m + r];
    uk[r] = u[(size_t)b * m + r];
    rho[r] = rho0[(size_t)b * m + r];
    zz[r] = clip(T(0), lk[r], uk[r]);
    y[r] = T(0);
#pragma unroll (NV_T > 0 ? 64 : 1)
    for (int i = 0; i < NVC; ++i) {
      if (i >= nv) break;
      Ak[r][i] = A[((size_t)b * m + r) * nv + i];
    }
  }

  const T one_m_alpha = T(1) - alpha;
  for (int stage = 0; stage < n_stages; ++stage) {
    // ---- M = P + sigma I + A' diag(rho) A (lower triangle, mirrored)
    T M[NVC][NVC];
#pragma unroll (NV_T > 0 ? 64 : 1)
    for (int i = 0; i < NVC; ++i) {
      if (i >= nv) break;
#pragma unroll (NV_T > 0 ? 64 : 1)
      for (int j = 0; j < NVC; ++j) {
        if (j > i) break;
        T acc = Pk[i][j] + (i == j ? sigma : T(0));
#pragma unroll (NV_T > 0 ? 64 : 1)
        for (int r = 0; r < MC; ++r) {
          if (r >= m) break;
          acc = acc + Ak[r][i] * rho[r] * Ak[r][j];
        }
        M[i][j] = acc;
        M[j][i] = acc;
      }
    }
    T L[NVC][NVC];
    const bool ok = chol<T, NVC, NV_T>(M, L, nv);
    if (!ok) {  // jittered refactorization on breakdown
      T tr = M[0][0];
#pragma unroll (NV_T > 0 ? 64 : 1)
      for (int i = 1; i < NVC; ++i) {
        if (i >= nv) break;
        tr = tr + M[i][i];
      }
      const T jit = T(1e-3) * (tr / T(nv) + T(1));
#pragma unroll (NV_T > 0 ? 64 : 1)
      for (int i = 0; i < NVC; ++i) {
        if (i >= nv) break;
        M[i][i] = M[i][i] + jit;
      }
      chol<T, NVC, NV_T>(M, L, nv);
    }

    // ---- Minv = L^-T L^-1 and 1/rho, once per stage
    T Li[NVC][NVC];
#pragma unroll (NV_T > 0 ? 64 : 1)
    for (int j = 0; j < NVC; ++j) {
      if (j >= nv) break;
      Li[j][j] = T(1) / L[j][j];
#pragma unroll (NV_T > 0 ? 64 : 1)
      for (int i = 0; i < NVC; ++i) {
        if (i <= j || i >= nv) continue;
        T s = L[i][j] * Li[j][j];
#pragma unroll (NV_T > 0 ? 64 : 1)
        for (int t = 0; t < NVC; ++t) {
          if (t <= j) continue;
          if (t >= i) break;
          s = s + L[i][t] * Li[t][j];
        }
        Li[i][j] = -s / L[i][i];
      }
    }
    T Mi[NVC][NVC];
#pragma unroll (NV_T > 0 ? 64 : 1)
    for (int i = 0; i < NVC; ++i) {
      if (i >= nv) break;
#pragma unroll (NV_T > 0 ? 64 : 1)
      for (int j = 0; j < NVC; ++j) {
        if (j > i) break;
        T acc = Li[i][i] * Li[i][j];  // t = max(i, j) = i
#pragma unroll (NV_T > 0 ? 64 : 1)
        for (int t = 0; t < NVC; ++t) {
          if (t <= i) continue;
          if (t >= nv) break;
          acc = acc + Li[t][i] * Li[t][j];
        }
        Mi[i][j] = acc;
        Mi[j][i] = acc;
      }
    }
    T rinv[MC];
#pragma unroll (NV_T > 0 ? 64 : 1)
    for (int r = 0; r < MC; ++r) {
      if (r >= m) break;
      rinv[r] = T(1) / rho[r];
    }

    // ---- n_steps splitting iterations
    for (int step = 0; step < n_steps; ++step) {
      T t1[MC];
#pragma unroll (NV_T > 0 ? 64 : 1)
      for (int r = 0; r < MC; ++r) {
        if (r >= m) break;
        t1[r] = rho[r] * zz[r] - y[r];
      }
      T rhs[NVC];
#pragma unroll (NV_T > 0 ? 64 : 1)
      for (int i = 0; i < NVC; ++i) {
        if (i >= nv) break;
        T acc = sigma * z[i] - qk[i];
#pragma unroll (NV_T > 0 ? 64 : 1)
        for (int r = 0; r < MC; ++r) {
          if (r >= m) break;
          acc = acc + Ak[r][i] * t1[r];
        }
        rhs[i] = acc;
      }
      T xt[NVC];
#pragma unroll (NV_T > 0 ? 64 : 1)
      for (int i = 0; i < NVC; ++i) {
        if (i >= nv) break;
        T acc = Mi[i][0] * rhs[0];
#pragma unroll (NV_T > 0 ? 64 : 1)
        for (int j = 1; j < NVC; ++j) {
          if (j >= nv) break;
          acc = acc + Mi[i][j] * rhs[j];
        }
        xt[i] = acc;
      }
#pragma unroll (NV_T > 0 ? 64 : 1)
      for (int i = 0; i < NVC; ++i) {
        if (i >= nv) break;
        z[i] = alpha * xt[i] + one_m_alpha * z[i];
      }
#pragma unroll (NV_T > 0 ? 64 : 1)
      for (int r = 0; r < MC; ++r) {
        if (r >= m) break;
        T zt = Ak[r][0] * xt[0];
#pragma unroll (NV_T > 0 ? 64 : 1)
        for (int i = 1; i < NVC; ++i) {
          if (i >= nv) break;
          zt = zt + Ak[r][i] * xt[i];
        }
        const T relaxed = alpha * zt + one_m_alpha * zz[r];
        const T zzr = clip(relaxed + y[r] * rinv[r], lk[r], uk[r]);
        y[r] = y[r] + rho[r] * (relaxed - zzr);
        zz[r] = zzr;
      }
    }

    // ---- residuals -> rho rescale (next stage's factorization)
    if (stage + 1 < n_stages) {
      T pr = T(0);
#pragma unroll (NV_T > 0 ? 64 : 1)
      for (int r = 0; r < MC; ++r) {
        if (r >= m) break;
        T Az = Ak[r][0] * z[0];
#pragma unroll (NV_T > 0 ? 64 : 1)
        for (int i = 1; i < NVC; ++i) {
          if (i >= nv) break;
          Az = Az + Ak[r][i] * z[i];
        }
        pr = nan_max(pr, dabs(Az - zz[r]));
      }
      T dr = T(0);
#pragma unroll (NV_T > 0 ? 64 : 1)
      for (int i = 0; i < NVC; ++i) {
        if (i >= nv) break;
        T g = qk[i];
#pragma unroll (NV_T > 0 ? 64 : 1)
        for (int j = 0; j < NVC; ++j) {
          if (j >= nv) break;
          g = g + Pk[i][j] * z[j];
        }
#pragma unroll (NV_T > 0 ? 64 : 1)
        for (int r = 0; r < MC; ++r) {
          if (r >= m) break;
          g = g + Ak[r][i] * y[r];
        }
        dr = nan_max(dr, dabs(g));
      }
      T scale = dsqrt(nan_max(pr, T(1e-30)) / nan_max(dr, T(1e-30)));
      scale = clip(scale, T(0.1), T(10));
#pragma unroll (NV_T > 0 ? 64 : 1)
      for (int r = 0; r < MC; ++r) {
        if (r >= m) break;
        rho[r] = clip(rho[r] * scale, rho_lo, rho_hi);
      }
    }
  }

#pragma unroll (NV_T > 0 ? 64 : 1)
  for (int i = 0; i < NVC; ++i) {
    if (i >= nv) break;
    z_out[(size_t)b * nv + i] = z[i];
  }
#pragma unroll (NV_T > 0 ? 64 : 1)
  for (int r = 0; r < MC; ++r) {
    if (r >= m) break;
    zz_out[(size_t)b * m + r] = zz[r];
    y_out[(size_t)b * m + r] = y[r];
  }
}

template <typename T>
int launch(const T* P, const T* q, const T* A, const T* l, const T* u,
           const T* rho0, T* z, T* zz, T* y, int B, int nv, int m,
           int n_stages, int n_steps, double sigma, double alpha,
           double rho_lo, double rho_hi, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (nv < 1 || m < 1 || nv > kMaxNV || m > kMaxM) return cudaErrorInvalidValue;
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  const dim3 grid_g((B + kGenericThreads - 1) / kGenericThreads), block_g(kGenericThreads);
  const T s = T(sigma), a = T(alpha), lo = T(rho_lo), hi = T(rho_hi);
  if (nv == 3 && m == 6) {
    qp_admm_kernel<T, 3, 6><<<grid, block, 0, stream>>>(
        P, q, A, l, u, rho0, z, zz, y, B, nv, m, n_stages, n_steps, s, a, lo, hi);
  } else if (nv == 4 && m == 8) {
    qp_admm_kernel<T, 4, 8><<<grid, block, 0, stream>>>(
        P, q, A, l, u, rho0, z, zz, y, B, nv, m, n_stages, n_steps, s, a, lo, hi);
  } else {
    qp_admm_kernel<T, 0, 0><<<grid_g, block_g, 0, stream>>>(
        P, q, A, l, u, rho0, z, zz, y, B, nv, m, n_stages, n_steps, s, a, lo, hi);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int qp_admm_f32(const float* P, const float* q, const float* A,
                const float* l, const float* u, const float* rho0, float* z,
                float* zz, float* y, int B, int nv, int m, int n_stages,
                int n_steps, double sigma, double alpha, double rho_lo,
                double rho_hi, void* stream) {
  return launch<float>(P, q, A, l, u, rho0, z, zz, y, B, nv, m, n_stages,
                       n_steps, sigma, alpha, rho_lo, rho_hi,
                       (cudaStream_t)stream);
}

int qp_admm_f64(const double* P, const double* q, const double* A,
                const double* l, const double* u, const double* rho0,
                double* z, double* zz, double* y, int B, int nv, int m,
                int n_stages, int n_steps, double sigma, double alpha,
                double rho_lo, double rho_hi, void* stream) {
  return launch<double>(P, q, A, l, u, rho0, z, zz, y, B, nv, m, n_stages,
                        n_steps, sigma, alpha, rho_lo, rho_hi,
                        (cudaStream_t)stream);
}

}  // extern "C"
