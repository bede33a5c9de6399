// qp_admm.cu — fixed-trip ADMM for batches of tiny dense QPs (kernel K1).
//
// Replaces the TPU kernel `_pallas_admm` (morbit_tpu/ops/qp_lane.py:289,
// body `admm_lane_batched` at :91-215). For every lane it solves
//     min 1/2 z'Pz + q'z   s.t.   l <= Az <= u
// with `n_stages` rho-stages of `n_steps` alpha-relaxed OSQP splitting steps
// (Stellato et al. 2020), exactly the formulas of `admm_lane_batched`:
// per stage M = P + sigma I + A' diag(rho) A, a Cholesky factor (lanes
// whose factor is not finite re-factor with jitter 1e-3 (tr M / nv + 1)),
// an explicit M^-1 = L^-T L^-1 and 1/rho so the splitting steps carry no
// division, zz clipped to [l, u], then rho rescaled by sqrt(pr / dr),
// clipped to [0.1, 10] and to [rho_lo, rho_hi]. Infinite bounds arrive as
// +-1e30 from the wrapper (morbit_tpu_torch/ops/qp_lane.py).
//
// Three designs, one launch for all stages and steps in each; the wrapper
// plans which at every (nv, m) and the launcher takes every shape:
//
// * Register instances, one thread per lane in 128-thread blocks, for the
//   shapes of the main paths (nv=3/m=6: the steepest-descent LP of a
//   2-variable problem; nv=4/m=8: of a 3-variable problem). P, q, A, l, u,
//   rho, M^-1 and the z/zz/y state live in registers.
// * The warp instance ("wide" below), one warp per lane and kLanesPerBlock
//   lanes per block, for every other shape up to 32 x 64 (nv=21/m=42: the
//   LP of the 20-variable ZDT path). The lane's A, P, the stage's two nv x nv
//   matrices (M and L, then L^-1 and M^-1) and the vectors the threads
//   exchange live in dynamic shared memory, sized from the runtime (nv, m)
//   (wide_layout; the wrapper computes the same size). Thread i owns
//   variable i (z_i, q_i, rhs_i, xt_i); threads t and t+32 own constraint
//   rows t and t+32 (l, u, rho, 1/rho, zz, y in registers). A splitting
//   step is three phases separated by __syncwarp: rhs_i = sigma z_i - q_i
//   + sum_r A[r][i] t1_r; xt_i = sum_j M^-1[j][i] rhs_j (M^-1 is exactly
//   symmetric, so column reads are conflict-free); per row the relaxation,
//   the clip, y and the next t1_r = rho_r zz_r - y_r. Every sum is one
//   thread's sum in the order the one-thread-per-lane kernel added it, and
//   the two updates a*b + c*d (z and the relaxation) are written as the
//   fma(a, b, c*d) that kernel was compiled to, so the wide instance rounds
//   as it did: the compiler may fuse either product. Row
//   strides are padded to an odd count of elements, so a warp reading a
//   column (thread r reads A[r][i]) hits 32 distinct banks. Per stage,
//   M's lower triangle is formed entry by entry over the threads, the
//   Cholesky runs column by column (rows over threads), L^-1 column by
//   column (one column per thread: a column's forward substitution needs
//   only its own earlier entries), and M^-1 entry by entry. The residual
//   maxima are warp shuffles with the NaN-propagating nan_max.
//
// * The strided instance, for every shape past the warp instance's (nv=51,
//   m=102: the LP of the 50-variable ZDT path): the warp instance's phases
//   and sums with each thread's variables and rows strided over the warp
//   and their state in vectors, 1, 2 or 4 lanes a block, and the lane's
//   matrices in shared memory or, where a lane does not fit, in a
//   workspace (qp_admm_strided_kernel below).
//
// The exit instances (kExit = true) add the JAX package's residual early
// exit (solve_qp(exit_eps=), morbit_tpu/ops/qp.py:216-238) per lane: after
// every stage but the last, the residuals pr and dr of the rho rescale
// (computed as the fixed-trip instances compute them) decide; a lane whose
// max(pr, dr) is not above exit_eps (NaN included) leaves the stage loop
// with its carry, and its stage count goes to `stages`. In the wide
// instance the residuals are warp-reduced first, so the exit is
// warp-uniform. The fixed-trip instances (kExit = false) compile to the
// loop they had before the exit existed.
//
// Bound on an H100: at nv=21/m=42 a 400-step solve is ~1.9 Mflop per lane,
// ~2 Gflop per launch at B=1024 against ~5 MB of operands: compute-bound
// on paper (~0.03 ms at the fp32 peak). The wide instance is bound by
// shared-memory load throughput and by the dependent chain of each thread's sums
// (~130 dependent multiply-adds a step): about 8 lanes are resident per SM
// and all 1024 lanes at once. Tensor cores (wgmma/mma) do not apply: every
// lane has its own A and M^-1 and a step multiplies each by one vector, a
// batched mat-vec with no operand reuse; TF32 would break the float32
// tolerance, and FP64 has no wgmma. TMA is not needed either: a lane's
// operands are a few KB loaded once per launch by a coalesced cooperative
// load. What matters is shared-memory capacity, occupancy and warp-level
// parallelism. The strided instance at nv=51/m=102 is ~10 Mflop a lane for
// a 400-step solve, ~10 Gflop a launch at B=1024 (~0.15 ms at the fp32
// peak); each thread's chain there is ~4x the warp instance's (two
// variables and four rows a thread), and 2-4 lanes fit an SM.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxNV = 32;
constexpr int kMaxM = 64;
constexpr int kThreads = 128;
// the wide instance: lanes (warps) per block; the wrapper's sizing
// (ops/qp_lane.py: ADMM_LANES_PER_BLOCK) uses the same count
constexpr int kLanesPerBlock = 4;
constexpr int kMaxSmemBytes = 232448;   // 227 KB, the H100's per-block limit
constexpr unsigned kFull = 0xffffffffu;

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
__device__ __forceinline__ float dfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dfma(double a, double b, double c) { return fma(a, b, c); }

// ======================================================= register instances

// Unrolled Cholesky of the lower triangle of M (same order as
// ops.batched_linalg.chol_factor); returns whether every entry is finite.
template <typename T, int NV>
__device__ __forceinline__ bool chol(const T (&M)[NV][NV], T (&L)[NV][NV]) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    T s = M[j][j];
#pragma unroll
    for (int t = 0; t < j; ++t) s = s - L[j][t] * L[j][t];
    L[j][j] = dsqrt(s);
    ok = ok && finite(L[j][j]);
#pragma unroll
    for (int i = j + 1; i < NV; ++i) {
      T s2 = M[i][j];
#pragma unroll
      for (int t = 0; t < j; ++t) s2 = s2 - L[i][t] * L[j][t];
      L[i][j] = s2 / L[j][j];
      ok = ok && finite(L[i][j]);
    }
  }
  return ok;
}

template <typename T, int NV, int M_, bool kExit>
__global__ void __launch_bounds__(kThreads)
qp_admm_kernel(const T* __restrict__ P, const T* __restrict__ q,
               const T* __restrict__ A, const T* __restrict__ l,
               const T* __restrict__ u, const T* __restrict__ rho0,
               T* __restrict__ z_out, T* __restrict__ zz_out,
               T* __restrict__ y_out, int B, int n_stages, int n_steps,
               T sigma, T alpha, T rho_lo, T rho_hi, T exit_eps,
               int* __restrict__ stages_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  T Pk[NV][NV], qk[NV], Ak[M_][NV], lk[M_], uk[M_], rho[M_];
  T z[NV], zz[M_], y[M_];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    qk[i] = q[(size_t)b * NV + i];
    z[i] = T(0);
#pragma unroll
    for (int j = 0; j < NV; ++j) Pk[i][j] = P[((size_t)b * NV + i) * NV + j];
  }
#pragma unroll
  for (int r = 0; r < M_; ++r) {
    lk[r] = l[(size_t)b * M_ + r];
    uk[r] = u[(size_t)b * M_ + r];
    rho[r] = rho0[(size_t)b * M_ + r];
    zz[r] = clip(T(0), lk[r], uk[r]);
    y[r] = T(0);
#pragma unroll
    for (int i = 0; i < NV; ++i) Ak[r][i] = A[((size_t)b * M_ + r) * NV + i];
  }

  const T one_m_alpha = T(1) - alpha;
  int ran = n_stages;
  for (int stage = 0; stage < n_stages; ++stage) {
    // ---- M = P + sigma I + A' diag(rho) A (lower triangle, mirrored)
    T M[NV][NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T acc = Pk[i][j] + (i == j ? sigma : T(0));
#pragma unroll
        for (int r = 0; r < M_; ++r) acc = acc + Ak[r][i] * rho[r] * Ak[r][j];
        M[i][j] = acc;
        M[j][i] = acc;
      }
    }
    T L[NV][NV];
    const bool ok = chol<T, NV>(M, L);
    if (!ok) {  // jittered refactorization on breakdown
      T tr = M[0][0];
#pragma unroll
      for (int i = 1; i < NV; ++i) tr = tr + M[i][i];
      const T jit = T(1e-3) * (tr / T(NV) + T(1));
#pragma unroll
      for (int i = 0; i < NV; ++i) M[i][i] = M[i][i] + jit;
      chol<T, NV>(M, L);
    }

    // ---- Minv = L^-T L^-1 and 1/rho, once per stage
    T Li[NV][NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      Li[j][j] = T(1) / L[j][j];
#pragma unroll
      for (int i = j + 1; i < NV; ++i) {
        T s = L[i][j] * Li[j][j];
#pragma unroll
        for (int t = j + 1; t < i; ++t) s = s + L[i][t] * Li[t][j];
        Li[i][j] = -s / L[i][i];
      }
    }
    T Mi[NV][NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T acc = Li[i][i] * Li[i][j];  // t = max(i, j) = i
#pragma unroll
        for (int t = i + 1; t < NV; ++t) acc = acc + Li[t][i] * Li[t][j];
        Mi[i][j] = acc;
        Mi[j][i] = acc;
      }
    }
    T rinv[M_];
#pragma unroll
    for (int r = 0; r < M_; ++r) rinv[r] = T(1) / rho[r];

    // ---- n_steps splitting iterations
    for (int step = 0; step < n_steps; ++step) {
      T t1[M_];
#pragma unroll
      for (int r = 0; r < M_; ++r) t1[r] = rho[r] * zz[r] - y[r];
      T rhs[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        T acc = sigma * z[i] - qk[i];
#pragma unroll
        for (int r = 0; r < M_; ++r) acc = acc + Ak[r][i] * t1[r];
        rhs[i] = acc;
      }
      T xt[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        T acc = Mi[i][0] * rhs[0];
#pragma unroll
        for (int j = 1; j < NV; ++j) acc = acc + Mi[i][j] * rhs[j];
        xt[i] = acc;
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) z[i] = alpha * xt[i] + one_m_alpha * z[i];
#pragma unroll
      for (int r = 0; r < M_; ++r) {
        T zt = Ak[r][0] * xt[0];
#pragma unroll
        for (int i = 1; i < NV; ++i) zt = zt + Ak[r][i] * xt[i];
        const T relaxed = alpha * zt + one_m_alpha * zz[r];
        const T zzr = clip(relaxed + y[r] * rinv[r], lk[r], uk[r]);
        y[r] = y[r] + rho[r] * (relaxed - zzr);
        zz[r] = zzr;
      }
    }

    // ---- residuals -> rho rescale (next stage's factorization)
    if (stage + 1 < n_stages) {
      T pr = T(0);
#pragma unroll
      for (int r = 0; r < M_; ++r) {
        T Az = Ak[r][0] * z[0];
#pragma unroll
        for (int i = 1; i < NV; ++i) Az = Az + Ak[r][i] * z[i];
        pr = nan_max(pr, dabs(Az - zz[r]));
      }
      T dr = T(0);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        T g = qk[i];
#pragma unroll
        for (int j = 0; j < NV; ++j) g = g + Pk[i][j] * z[j];
#pragma unroll
        for (int r = 0; r < M_; ++r) g = g + Ak[r][i] * y[r];
        dr = nan_max(dr, dabs(g));
      }
      if (kExit && !(nan_max(pr, dr) > exit_eps)) {
        ran = stage + 1;
        break;
      }
      T scale = dsqrt(nan_max(pr, T(1e-30)) / nan_max(dr, T(1e-30)));
      scale = clip(scale, T(0.1), T(10));
#pragma unroll
      for (int r = 0; r < M_; ++r) rho[r] = clip(rho[r] * scale, rho_lo, rho_hi);
    }
  }

  if (kExit) stages_out[b] = ran;
#pragma unroll
  for (int i = 0; i < NV; ++i) z_out[(size_t)b * NV + i] = z[i];
#pragma unroll
  for (int r = 0; r < M_; ++r) {
    zz_out[(size_t)b * M_ + r] = zz[r];
    y_out[(size_t)b * M_ + r] = y[r];
  }
}

// ============================================================ wide instance

// Offsets (in elements) of one lane's arrays in shared memory. `ld` is the
// padded row stride of A (m x nv) and of the nv x nv matrices.
struct WideLayout {
  int ld, A, P, W1, W2, t1, ys, rho, rhs, xt, zs, total;
};

__host__ __device__ inline WideLayout wide_layout(int nv, int m) {
  WideLayout w;
  w.ld = nv | 1;
  int o = 0;
  w.A = o;   o += m * w.ld;
  w.P = o;   o += nv * w.ld;
  w.W1 = o;  o += nv * w.ld;   // M, then L^-1
  w.W2 = o;  o += nv * w.ld;   // L, then M^-1
  w.t1 = o;  o += m;
  w.ys = o;  o += m;
  w.rho = o; o += m;
  w.rhs = o; o += nv;
  w.xt = o;  o += nv;
  w.zs = o;  o += nv;
  w.total = o;
  return w;
}

// (i, j), j <= i, of the e-th entry of a lower triangle stored by rows
__device__ __forceinline__ void tri_index(int e, int& i, int& j) {
  i = (int)((sqrtf(8.0f * (float)e + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > e) --i;
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  j = e - i * (i + 1) / 2;
}

// Cholesky of the lower triangle of M into L, column by column with the
// rows below the diagonal over the lane's threads; the same sums in the
// same order as chol(). Every thread computes the pivot (the same value;
// no column reads a diagonal entry of L); returns this thread's share of
// the finiteness test.
template <typename T>
__device__ bool chol_warp(const T* M, T* L, int ld, int nv, int t) {
  bool ok = true;
  for (int j = 0; j < nv; ++j) {
    T s = M[j * ld + j];
    for (int k = 0; k < j; ++k) s = s - L[j * ld + k] * L[j * ld + k];
    const T d = dsqrt(s);
    ok = ok && finite(d);
    if (t == j) L[j * ld + j] = d;
    if (t > j && t < nv) {
      T s2 = M[t * ld + j];
      for (int k = 0; k < j; ++k) s2 = s2 - L[t * ld + k] * L[j * ld + k];
      const T v = s2 / d;
      L[t * ld + j] = v;
      ok = ok && finite(v);
    }
    __syncwarp();
  }
  return ok;
}

template <typename T, bool kExit>
__global__ void __launch_bounds__(kLanesPerBlock * 32)
qp_admm_wide_kernel(const T* __restrict__ P, const T* __restrict__ q,
                    const T* __restrict__ A, const T* __restrict__ l,
                    const T* __restrict__ u, const T* __restrict__ rho0,
                    T* __restrict__ z_out, T* __restrict__ zz_out,
                    T* __restrict__ y_out, int B, int nv, int m,
                    int n_stages, int n_steps, T sigma, T alpha, T rho_lo,
                    T rho_hi, T exit_eps, int* __restrict__ stages_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * kLanesPerBlock + warp;
  if (b >= B) return;  // a whole warp leaves; the lane's sync is __syncwarp
  const WideLayout w = wide_layout(nv, m);
  const int ld = w.ld;
  T* s = reinterpret_cast<T*>(smem_raw) + (size_t)warp * w.total;
  T *sA = s + w.A, *sP = s + w.P, *W1 = s + w.W1, *W2 = s + w.W2;
  T *t1 = s + w.t1, *ys = s + w.ys, *srho = s + w.rho;
  T *rhs = s + w.rhs, *xt = s + w.xt, *zs = s + w.zs;

  // ---- coalesced load of the lane's A and P
  const T* Ab = A + (size_t)b * m * nv;
  for (int e = t; e < m * nv; e += 32) {
    const int r = e / nv;
    sA[r * ld + (e - r * nv)] = Ab[e];
  }
  const T* Pb = P + (size_t)b * nv * nv;
  for (int e = t; e < nv * nv; e += 32) {
    const int i = e / nv;
    sP[i * ld + (e - i * nv)] = Pb[e];
  }
  // rows t and t + 32 (h = 0, 1) and variable t, in registers
  T lk[2], uk[2], rho[2], rinv[2], zz[2], y[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = t + 32 * h;
    lk[h] = uk[h] = rho[h] = rinv[h] = zz[h] = y[h] = T(0);
    if (r < m) {
      lk[h] = l[(size_t)b * m + r];
      uk[h] = u[(size_t)b * m + r];
      rho[h] = rho0[(size_t)b * m + r];
      zz[h] = clip(T(0), lk[h], uk[h]);
    }
  }
  const T qi = t < nv ? q[(size_t)b * nv + t] : T(0);
  T z = T(0);
  __syncwarp();

  const T one_m_alpha = T(1) - alpha;
  const int tri = nv * (nv + 1) / 2;
  int ran = n_stages;
  for (int stage = 0; stage < n_stages; ++stage) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (t + 32 * h < m) srho[t + 32 * h] = rho[h];
    __syncwarp();
    // ---- M = P + sigma I + A' diag(rho) A (lower triangle, mirrored) in W1
    for (int e = t; e < tri; e += 32) {
      int i, j;
      tri_index(e, i, j);
      T acc = sP[i * ld + j] + (i == j ? sigma : T(0));
      for (int r = 0; r < m; ++r)
        acc = acc + sA[r * ld + i] * srho[r] * sA[r * ld + j];
      W1[i * ld + j] = acc;
      W1[j * ld + i] = acc;
    }
    __syncwarp();
    // ---- L in W2, refactored with jitter where not finite
    if (!__all_sync(kFull, chol_warp(W1, W2, ld, nv, t))) {
      T tr = W1[0];
      for (int i = 1; i < nv; ++i) tr = tr + W1[i * ld + i];
      const T jit = T(1e-3) * (tr / T(nv) + T(1));
      __syncwarp();
      if (t < nv) W1[t * ld + t] = W1[t * ld + t] + jit;
      __syncwarp();
      chol_warp(W1, W2, ld, nv, t);
    }
    // ---- L^-1 in W1, one column per thread (M is no longer read)
    if (t < nv) {
      const int j = t;
      const T ljj = T(1) / W2[j * ld + j];
      W1[j * ld + j] = ljj;
      for (int i = j + 1; i < nv; ++i) {
        T sum = W2[i * ld + j] * ljj;
        for (int k = j + 1; k < i; ++k) sum = sum + W2[i * ld + k] * W1[k * ld + j];
        W1[i * ld + j] = -sum / W2[i * ld + i];
      }
    }
    __syncwarp();
    // ---- M^-1 = L^-T L^-1 in W2 (L is no longer read)
    for (int e = t; e < tri; e += 32) {
      int i, j;
      tri_index(e, i, j);
      T acc = W1[i * ld + i] * W1[i * ld + j];
      for (int k = i + 1; k < nv; ++k) acc = acc + W1[k * ld + i] * W1[k * ld + j];
      W2[i * ld + j] = acc;
      W2[j * ld + i] = acc;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = t + 32 * h;
      if (r < m) {
        rinv[h] = T(1) / rho[h];
        t1[r] = rho[h] * zz[h] - y[h];
      }
    }
    __syncwarp();

    // ---- n_steps splitting iterations
    for (int step = 0; step < n_steps; ++step) {
      if (t < nv) {
        T acc = sigma * z - qi;
        for (int r = 0; r < m; ++r) acc = acc + sA[r * ld + t] * t1[r];
        rhs[t] = acc;
      }
      __syncwarp();
      if (t < nv) {
        T acc = W2[t] * rhs[0];
        for (int j = 1; j < nv; ++j) acc = acc + W2[j * ld + t] * rhs[j];
        xt[t] = acc;
        z = dfma(alpha, acc, one_m_alpha * z);
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = t + 32 * h;
        if (r < m) {
          const T* Ar = sA + r * ld;
          T zt = Ar[0] * xt[0];
          for (int i = 1; i < nv; ++i) zt = zt + Ar[i] * xt[i];
          const T relaxed = dfma(alpha, zt, one_m_alpha * zz[h]);
          const T zzr = clip(relaxed + y[h] * rinv[h], lk[h], uk[h]);
          y[h] = y[h] + rho[h] * (relaxed - zzr);
          zz[h] = zzr;
          t1[r] = rho[h] * zz[h] - y[h];
        }
      }
      __syncwarp();
    }

    // ---- residuals -> rho rescale (next stage's factorization)
    if (stage + 1 < n_stages) {
      if (t < nv) zs[t] = z;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (t + 32 * h < m) ys[t + 32 * h] = y[h];
      __syncwarp();
      T pr = T(0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = t + 32 * h;
        if (r < m) {
          const T* Ar = sA + r * ld;
          T Az = Ar[0] * zs[0];
          for (int i = 1; i < nv; ++i) Az = Az + Ar[i] * zs[i];
          pr = nan_max(pr, dabs(Az - zz[h]));
        }
      }
      T dr = T(0);
      if (t < nv) {
        T g = qi;
        for (int j = 0; j < nv; ++j) g = g + sP[t * ld + j] * zs[j];
        for (int r = 0; r < m; ++r) g = g + sA[r * ld + t] * ys[r];
        dr = dabs(g);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        pr = nan_max(pr, __shfl_xor_sync(kFull, pr, off));
        dr = nan_max(dr, __shfl_xor_sync(kFull, dr, off));
      }
      if (kExit && !(nan_max(pr, dr) > exit_eps)) {  // the same on every thread
        ran = stage + 1;
        break;
      }
      T scale = dsqrt(nan_max(pr, T(1e-30)) / nan_max(dr, T(1e-30)));
      scale = clip(scale, T(0.1), T(10));
#pragma unroll
      for (int h = 0; h < 2; ++h) rho[h] = clip(rho[h] * scale, rho_lo, rho_hi);
      __syncwarp();
    }
  }

  if (kExit && t == 0) stages_out[b] = ran;
  if (t < nv) z_out[(size_t)b * nv + t] = z;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = t + 32 * h;
    if (r < m) {
      zz_out[(size_t)b * m + r] = zz[h];
      y_out[(size_t)b * m + r] = y[h];
    }
  }
}

// ========================================================= strided instance

// Every shape the warp instance does not take (nv > 32 or m > 64): one warp
// per lane, `lanes` (1, 2 or 4) lanes a block as the wrapper plans them
// (ops/qp_lane.py: admm_plan). Thread t owns the variables i = t (mod 32)
// and the rows r = t (mod 32); the per-row and per-variable state (l, u,
// rho, 1/rho, zz, y, t1, q, z, rhs, xt) lives in vectors, each thread
// touching only its own entries between the warp's barriers. The lane's
// matrices sit where the plan puts them (`place`):
//   0: A, P and the stage matrices W1, W2 in shared memory (rows padded to
//      an odd stride), then the vectors;
//   1: A and P read from the inputs (L2 holds them), W1 and W2 in the
//      workspace, the vectors in shared memory;
//   2: the vectors in the workspace too (no shared memory), for lanes whose
//      vectors alone pass a block's shared memory.
// The phases and every sum are those of the warp instance (one thread's sum
// in index order, the same fma forms), over strided loops.
struct StridedLayout {
  int ld, lda;                 // stride of W1/W2; of A/P where they are read
  long long mat, vec, work;    // a lane's matrix and vector elements; workspace
};

__host__ __device__ inline StridedLayout strided_layout(int nv, int m, int place) {
  StridedLayout w;
  w.ld = nv | 1;
  w.lda = place == 0 ? w.ld : nv;
  w.vec = 7LL * m + 4LL * nv;
  w.mat = place == 0 ? (long long)(m + 3 * nv) * w.ld : 2LL * nv * w.ld;
  w.work = place == 0 ? 0 : w.mat + (place == 2 ? w.vec : 0);
  return w;
}

// shared memory of one block of the strided instance
__host__ __device__ inline long long strided_smem_elems(int nv, int m, int place, int lanes) {
  const StridedLayout w = strided_layout(nv, m, place);
  return place == 0 ? lanes * (w.mat + w.vec) : place == 1 ? lanes * w.vec : 0;
}

// chol_warp with the rows below the diagonal strided over the lane's threads
template <typename T>
__device__ bool chol_strided(const T* M, T* L, int ld, int nv, int t) {
  bool ok = true;
  for (int j = 0; j < nv; ++j) {
    T s = M[j * ld + j];
    for (int k = 0; k < j; ++k) s = s - L[j * ld + k] * L[j * ld + k];
    const T d = dsqrt(s);
    ok = ok && finite(d);
    for (int i = t; i < nv; i += 32) {
      if (i == j) {
        L[j * ld + j] = d;
      } else if (i > j) {
        T s2 = M[i * ld + j];
        for (int k = 0; k < j; ++k) s2 = s2 - L[i * ld + k] * L[j * ld + k];
        const T v = s2 / d;
        L[i * ld + j] = v;
        ok = ok && finite(v);
      }
    }
    __syncwarp();
  }
  return ok;
}

template <typename T, bool kExit>
__global__ void __launch_bounds__(kLanesPerBlock * 32)
qp_admm_strided_kernel(const T* __restrict__ P, const T* __restrict__ q,
                       const T* __restrict__ A, const T* __restrict__ l,
                       const T* __restrict__ u, const T* __restrict__ rho0,
                       T* __restrict__ z_out, T* __restrict__ zz_out,
                       T* __restrict__ y_out, int B, int nv, int m,
                       int n_stages, int n_steps, T sigma, T alpha, T rho_lo,
                       T rho_hi, T exit_eps, int* __restrict__ stages_out,
                       int lanes, int place, T* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * lanes + warp;
  if (b >= B) return;  // a whole warp leaves; the lane's sync is __syncwarp
  const StridedLayout w = strided_layout(nv, m, place);
  const int ld = w.ld, lda = w.lda;
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* wl = work + (size_t)b * w.work;   // this lane's workspace (place > 0)
  const T *sA, *sP;
  T *W1, *W2, *v;
  if (place == 0) {
    T* base = smem + (size_t)warp * (w.mat + w.vec);
    T* aw = base;
    T* pw = aw + (size_t)m * ld;
    W1 = pw + (size_t)nv * ld;
    W2 = W1 + (size_t)nv * ld;
    v = W2 + (size_t)nv * ld;
    const T* Ab = A + (size_t)b * m * nv;
    for (int e = t; e < m * nv; e += 32) {
      const int r = e / nv;
      aw[r * ld + (e - r * nv)] = Ab[e];
    }
    const T* Pb = P + (size_t)b * nv * nv;
    for (int e = t; e < nv * nv; e += 32) {
      const int i = e / nv;
      pw[i * ld + (e - i * nv)] = Pb[e];
    }
    sA = aw;
    sP = pw;
  } else {
    sA = A + (size_t)b * m * nv;
    sP = P + (size_t)b * nv * nv;
    W1 = wl;
    W2 = W1 + (size_t)nv * ld;
    v = place == 2 ? W2 + (size_t)nv * ld : smem + (size_t)warp * w.vec;
  }
  T *vl = v, *vu = vl + m, *vrho = vu + m, *vrinv = vrho + m, *vzz = vrinv + m;
  T *vy = vzz + m, *t1 = vy + m;
  T *vq = t1 + m, *vz = vq + nv, *rhs = vz + nv, *xt = rhs + nv;
  for (int r = t; r < m; r += 32) {
    vl[r] = l[(size_t)b * m + r];
    vu[r] = u[(size_t)b * m + r];
    vrho[r] = rho0[(size_t)b * m + r];
    vzz[r] = clip(T(0), vl[r], vu[r]);
    vy[r] = T(0);
  }
  for (int i = t; i < nv; i += 32) {
    vq[i] = q[(size_t)b * nv + i];
    vz[i] = T(0);
  }
  __syncwarp();

  const T one_m_alpha = T(1) - alpha;
  const int tri = nv * (nv + 1) / 2;
  int ran = n_stages;
  for (int stage = 0; stage < n_stages; ++stage) {
    // ---- M = P + sigma I + A' diag(rho) A (lower triangle, mirrored) in W1
    for (int e = t; e < tri; e += 32) {
      int i, j;
      tri_index(e, i, j);
      T acc = sP[i * lda + j] + (i == j ? sigma : T(0));
      for (int r = 0; r < m; ++r)
        acc = acc + sA[r * lda + i] * vrho[r] * sA[r * lda + j];
      W1[i * ld + j] = acc;
      W1[j * ld + i] = acc;
    }
    __syncwarp();
    // ---- L in W2, refactored with jitter where not finite
    if (!__all_sync(kFull, chol_strided(W1, W2, ld, nv, t))) {
      T tr = W1[0];
      for (int i = 1; i < nv; ++i) tr = tr + W1[i * ld + i];
      const T jit = T(1e-3) * (tr / T(nv) + T(1));
      __syncwarp();
      for (int i = t; i < nv; i += 32) W1[i * ld + i] = W1[i * ld + i] + jit;
      __syncwarp();
      chol_strided(W1, W2, ld, nv, t);
    }
    // ---- L^-1 in W1, one column per thread (M is no longer read)
    for (int j = t; j < nv; j += 32) {
      const T ljj = T(1) / W2[j * ld + j];
      W1[j * ld + j] = ljj;
      for (int i = j + 1; i < nv; ++i) {
        T sum = W2[i * ld + j] * ljj;
        for (int k = j + 1; k < i; ++k) sum = sum + W2[i * ld + k] * W1[k * ld + j];
        W1[i * ld + j] = -sum / W2[i * ld + i];
      }
    }
    __syncwarp();
    // ---- M^-1 = L^-T L^-1 in W2 (L is no longer read)
    for (int e = t; e < tri; e += 32) {
      int i, j;
      tri_index(e, i, j);
      T acc = W1[i * ld + i] * W1[i * ld + j];
      for (int k = i + 1; k < nv; ++k) acc = acc + W1[k * ld + i] * W1[k * ld + j];
      W2[i * ld + j] = acc;
      W2[j * ld + i] = acc;
    }
    for (int r = t; r < m; r += 32) {
      vrinv[r] = T(1) / vrho[r];
      t1[r] = vrho[r] * vzz[r] - vy[r];
    }
    __syncwarp();

    // ---- n_steps splitting iterations
    for (int step = 0; step < n_steps; ++step) {
      for (int i = t; i < nv; i += 32) {
        T acc = sigma * vz[i] - vq[i];
        for (int r = 0; r < m; ++r) acc = acc + sA[r * lda + i] * t1[r];
        rhs[i] = acc;
      }
      __syncwarp();
      for (int i = t; i < nv; i += 32) {
        T acc = W2[i] * rhs[0];
        for (int j = 1; j < nv; ++j) acc = acc + W2[j * ld + i] * rhs[j];
        xt[i] = acc;
        vz[i] = dfma(alpha, acc, one_m_alpha * vz[i]);
      }
      __syncwarp();
      for (int r = t; r < m; r += 32) {
        const T* Ar = sA + r * lda;
        T zt = Ar[0] * xt[0];
        for (int i = 1; i < nv; ++i) zt = zt + Ar[i] * xt[i];
        const T relaxed = dfma(alpha, zt, one_m_alpha * vzz[r]);
        const T zzr = clip(relaxed + vy[r] * vrinv[r], vl[r], vu[r]);
        const T yr = vy[r] + vrho[r] * (relaxed - zzr);
        vy[r] = yr;
        vzz[r] = zzr;
        t1[r] = vrho[r] * zzr - yr;
      }
      __syncwarp();
    }

    // ---- residuals -> rho rescale (next stage's factorization)
    if (stage + 1 < n_stages) {
      T pr = T(0);
      for (int r = t; r < m; r += 32) {
        const T* Ar = sA + r * lda;
        T Az = Ar[0] * vz[0];
        for (int i = 1; i < nv; ++i) Az = Az + Ar[i] * vz[i];
        pr = nan_max(pr, dabs(Az - vzz[r]));
      }
      T dr = T(0);
      for (int i = t; i < nv; i += 32) {
        T g = vq[i];
        for (int j = 0; j < nv; ++j) g = g + sP[i * lda + j] * vz[j];
        for (int r = 0; r < m; ++r) g = g + sA[r * lda + i] * vy[r];
        dr = nan_max(dr, dabs(g));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        pr = nan_max(pr, __shfl_xor_sync(kFull, pr, off));
        dr = nan_max(dr, __shfl_xor_sync(kFull, dr, off));
      }
      if (kExit && !(nan_max(pr, dr) > exit_eps)) {  // the same on every thread
        ran = stage + 1;
        break;
      }
      T scale = dsqrt(nan_max(pr, T(1e-30)) / nan_max(dr, T(1e-30)));
      scale = clip(scale, T(0.1), T(10));
      for (int r = t; r < m; r += 32) vrho[r] = clip(vrho[r] * scale, rho_lo, rho_hi);
      __syncwarp();
    }
  }

  if (kExit && t == 0) stages_out[b] = ran;
  for (int i = t; i < nv; i += 32) z_out[(size_t)b * nv + i] = vz[i];
  for (int r = t; r < m; r += 32) {
    zz_out[(size_t)b * m + r] = vzz[r];
    y_out[(size_t)b * m + r] = vy[r];
  }
}

// kExit selects the exit instances; exit_eps and stages are read only there.
// `instance` is the wrapper's plan (ops/qp_lane.py: admm_plan): 0 the
// register instances, 1 the warp instance, 2 the strided instance with
// `lanes` lanes a block and its matrices at `place`; the launcher refuses a
// plan that does not fit the shape or whose sizes do not cover its layout.
template <typename T, bool kExit>
int launch(const T* P, const T* q, const T* A, const T* l, const T* u,
           const T* rho0, T* z, T* zz, T* y, int B, int nv, int m,
           int n_stages, int n_steps, double sigma, double alpha,
           double rho_lo, double rho_hi, int instance, int lanes, int place,
           long long smem_bytes, T* work, cudaStream_t stream,
           double exit_eps = 0.0, int* stages = nullptr) {
  if (B <= 0) return 0;
  if (nv < 1 || m < 0) return cudaErrorInvalidValue;
  if (kExit && (stages == nullptr || !(exit_eps > 0.0))) return cudaErrorInvalidValue;
  if (smem_bytes < 0 || smem_bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  const T s = T(sigma), a = T(alpha), lo = T(rho_lo), hi = T(rho_hi);
  const T ee = T(exit_eps);
  const dim3 grid((B + kThreads - 1) / kThreads), block(kThreads);
  if (instance == 0 && nv == 3 && m == 6) {
    qp_admm_kernel<T, 3, 6, kExit><<<grid, block, 0, stream>>>(
        P, q, A, l, u, rho0, z, zz, y, B, n_stages, n_steps, s, a, lo, hi, ee, stages);
  } else if (instance == 0 && nv == 4 && m == 8) {
    qp_admm_kernel<T, 4, 8, kExit><<<grid, block, 0, stream>>>(
        P, q, A, l, u, rho0, z, zz, y, B, n_stages, n_steps, s, a, lo, hi, ee, stages);
  } else if (instance == 1) {
    // the wrapper's size must cover this layout
    const long long need =
        (long long)kLanesPerBlock * wide_layout(nv, m).total * (long long)sizeof(T);
    if (nv > kMaxNV || m < 1 || m > kMaxM || smem_bytes < need)
      return cudaErrorInvalidValue;
    if (smem_bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          qp_admm_wide_kernel<T, kExit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem_bytes);
      if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid_w((B + kLanesPerBlock - 1) / kLanesPerBlock), block_w(kLanesPerBlock * 32);
    qp_admm_wide_kernel<T, kExit><<<grid_w, block_w, (size_t)smem_bytes, stream>>>(
        P, q, A, l, u, rho0, z, zz, y, B, nv, m, n_stages, n_steps, s, a, lo, hi, ee,
        stages);
  } else if (instance == 2) {
    if ((lanes != 1 && lanes != 2 && lanes != 4) || place < 0 || place > 2 ||
        (place > 0 && work == nullptr) ||
        smem_bytes < strided_smem_elems(nv, m, place, lanes) * (long long)sizeof(T))
      return cudaErrorInvalidValue;
    if (smem_bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          qp_admm_strided_kernel<T, kExit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem_bytes);
      if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid_s((B + lanes - 1) / lanes), block_s(lanes * 32);
    qp_admm_strided_kernel<T, kExit><<<grid_s, block_s, (size_t)smem_bytes, stream>>>(
        P, q, A, l, u, rho0, z, zz, y, B, nv, m, n_stages, n_steps, s, a, lo, hi, ee,
        stages, lanes, place, work);
  } else {
    return cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The plan (instance, lanes, place, smem_bytes) and the workspace (B lanes
// of the strided layout's `work` elements where place > 0) come from the
// wrapper.
#define MORBIT_QP_EXPORT(NAME, T)                                                     \
  extern "C" int NAME(const T* P, const T* q, const T* A, const T* l, const T* u,     \
                      const T* rho0, T* z, T* zz, T* y, int B, int nv, int m,         \
                      int n_stages, int n_steps, double sigma, double alpha,          \
                      double rho_lo, double rho_hi, int instance, int lanes,          \
                      int place, long long smem_bytes, T* work, void* stream) {       \
    return launch<T, false>(P, q, A, l, u, rho0, z, zz, y, B, nv, m, n_stages,        \
                            n_steps, sigma, alpha, rho_lo, rho_hi, instance, lanes,   \
                            place, smem_bytes, work, (cudaStream_t)stream);           \
  }

// the exit instances: exit_eps > 0, and the stages each lane ran in `stages`
#define MORBIT_QP_EXIT_EXPORT(NAME, T)                                                \
  extern "C" int NAME(const T* P, const T* q, const T* A, const T* l, const T* u,     \
                      const T* rho0, T* z, T* zz, T* y, int* stages, int B, int nv,   \
                      int m, int n_stages, int n_steps, double sigma, double alpha,   \
                      double rho_lo, double rho_hi, double exit_eps, int instance,    \
                      int lanes, int place, long long smem_bytes, T* work,            \
                      void* stream) {                                                 \
    return launch<T, true>(P, q, A, l, u, rho0, z, zz, y, B, nv, m, n_stages,         \
                           n_steps, sigma, alpha, rho_lo, rho_hi, instance, lanes,    \
                           place, smem_bytes, work, (cudaStream_t)stream, exit_eps,   \
                           stages);                                                   \
  }

MORBIT_QP_EXPORT(qp_admm_f32, float)
MORBIT_QP_EXPORT(qp_admm_f64, double)
MORBIT_QP_EXIT_EXPORT(qp_admm_exit_f32, float)
MORBIT_QP_EXIT_EXPORT(qp_admm_exit_f64, double)
