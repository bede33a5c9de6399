// K3: RBF round-4 acceptance, one thread per lane.
//
// Replaces the TPU kernel `_pallas_round4` (morbit_tpu/ops/prepare_fused.py:276,
// body morbit_tpu/ops/round4_lane.py::round4_lane_batched), whose semantics
// are `run_round4` (morbit_tpu/models/rbf_round4.py:89-301). Its plain PyTorch
// twin is morbit_tpu_torch/models/rbf_round4.py::run_round4.
//
// Per lane (RbfModel.jl:352-499): the kernel Gram Phi of the rounds-1-3 sites
// and the Householder QR of their polynomial block; then the candidates are
// scanned in database order and each is tested against the current state,
//     tau^2 = sigma - ||L^-1 v||^2 > chol_pivot2   (theta_pivot_cholesky^4),
// with a rank test while N < pd. An accepted candidate folds its polynomial row
// into R by Givens rotations (tracking the new row of the rotation product in
// closed form), appends a column to Z and rank-1 rows to L, L^-1 and Phi. The
// scan stops at max_points sites.
//
// Design: one sequential scan replaces the TPU's waves (each wave tested every
// remaining candidate and took the first that passed). The state changes only
// at an acceptance, so both give the same acceptance sequence. The state is
// maxN x maxN (maxN = max_points) in registers or local memory: (n, maxN, pd) =
// (2, 6, 3) is the main path, (3, 10, 4) the three-variable default, and a
// generic instance with runtime sizes runs from local memory up to maxN = 24.
//
// Bound on the H100: per tested candidate O(maxN^2) operations, and the bytes
// are the candidate rows read once; both give microseconds at B=1024
// (chip_smoke.py computes the bound from each run's inputs). One thread per
// lane with a serial scan leaves the kernel latency-bound: 1024 lanes fill 8 of
// 132 SMs.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int MAX_MAXN = 24, MAX_PD = 16, MAX_NN = 15;

// kernel ids, in the order of morbit_tpu_torch/ops/prepare_fused.py:_KERNEL_ID
enum { CUBIC = 0, MULTIQUADRIC = 1, INV_MULTIQUADRIC = 2, GAUSSIAN = 3, TPS = 4 };

struct Phi {
  int id;
  double exponent;  // cubic: k/2; thin-plate spline: k
  double coef;      // cubic: (-1)^ceil(k/2); thin-plate spline: 0.5 (-1)^(k+1)
};

template <typename T>
__device__ __forceinline__ T ipow(T x, int k) {
  // lax.integer_pow: binary exponentiation
  T acc = T(1), base = x;
  bool first = true;
  while (k > 0) {
    if (k & 1) {
      acc = first ? base : acc * base;
      first = false;
    }
    k >>= 1;
    if (k) base = base * base;
  }
  return acc;
}

// apply_kernel (ops/rbf.py) in r^2; p is the lane's shape parameter
template <typename T>
__device__ __forceinline__ T phi(const Phi& f, T r2, T p) {
  switch (f.id) {
    case CUBIC:
      return T(f.coef) * pow(r2, T(f.exponent));
    case MULTIQUADRIC:
      return -sqrt(T(1) + (p * p) * r2);
    case INV_MULTIQUADRIC:
      return T(1) / sqrt(T(1) + (p * p) * r2);
    case GAUSSIAN:
      return exp(-(p * p) * r2);
    default: {  // TPS
      T safe = r2 > T(0) ? r2 : T(1);
      T val = T(f.coef) * ipow(r2, int(f.exponent)) * log(safe);
      return r2 > T(0) ? val : T(0);
    }
  }
}

template <typename T>
__device__ __forceinline__ T tiny_v();
template <>
__device__ __forceinline__ float tiny_v<float>() { return FLT_MIN; }
template <>
__device__ __forceinline__ double tiny_v<double>() { return DBL_MIN; }

template <typename T>
__device__ __forceinline__ T eps_v();
template <>
__device__ __forceinline__ float eps_v<float>() { return FLT_EPSILON; }
template <>
__device__ __forceinline__ double eps_v<double>() { return DBL_EPSILON; }

// poly_basis: [1] (deg 0) or [1, x...] (deg 1); pd = 0 is no tail
template <typename T>
__device__ __forceinline__ void basis(const T* x, int pd, T* out) {
  for (int j = 0; j < pd; ++j) out[j] = j == 0 ? T(1) : x[j - 1];
}

template <typename T, int NN, int MAXN, int PD>
__global__ void rbf_round4_kernel(
    const T* __restrict__ X, long long lane_stride, long long row_stride,
    const unsigned char* __restrict__ cand, const T* __restrict__ sites0,
    long long s0_lane_stride, const int* __restrict__ count,
    const T* __restrict__ param, unsigned char* __restrict__ accepted,
    int* __restrict__ N_out, int B, int C, int n_rt, int maxn_rt, int pd_rt, Phi f,
    double pivot2_in) {
  constexpr int NA = NN ? NN : MAX_NN;
  constexpr int MA = MAXN ? MAXN : MAX_MAXN;
  constexpr int PA = NN ? PD : MAX_PD;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = NN ? NN : n_rt;
  const int maxN = MAXN ? MAXN : maxn_rt;   // = max_points
  const int pd = NN ? PD : pd_rt;
  const T p = param[b];
  const T pivot2 = T(pivot2_in);
  const T* Xl = X + b * lane_stride;
  const unsigned char* cl = cand + (long long)b * C;
  unsigned char* acc = accepted + (long long)b * C;
  for (int c = 0; c < C; ++c) acc[c] = 0;

  int N = count[b];
  if (N >= maxN) {  // full already: nothing can be accepted
    N_out[b] = N;
    return;
  }

  T S[MA][NA], Q[MA][MA], R[MA][PA], Z[MA][MA], L[MA][MA], Li[MA][MA], P[MA][MA];
  for (int i = 0; i < maxN; ++i)
    for (int j = 0; j < n; ++j) S[i][j] = i < N ? sites0[b * s0_lane_stride + i * n + j] : T(0);
  for (int i = 0; i < maxN; ++i)
    for (int j = 0; j < maxN; ++j) {
      if (i < N && j < N) {
        T r2 = T(0);
        for (int t = 0; t < n; ++t) {
          T d = S[i][t] - S[j][t];
          r2 += d * d;
        }
        P[i][j] = phi(f, r2, p);
      } else {
        P[i][j] = i == j ? T(1) : T(0);
      }
      Q[i][j] = i == j ? T(1) : T(0);
      Z[i][j] = T(0);
      L[i][j] = Li[i][j] = i == j ? T(1) : T(0);
    }
  const T phi0 = phi(f, T(0), p);

  // masked Householder QR of the polynomial block (_masked_householder_qr)
  for (int i = 0; i < maxN; ++i) {
    T row[PA];
    basis(S[i], pd, row);
    for (int j = 0; j < pd; ++j) R[i][j] = i < N ? row[j] : T(0);
  }
  for (int j = 0; j < pd; ++j) {
    T v[MA], w[MA];
    T norm2 = T(0);
    for (int i = 0; i < maxN; ++i) {
      v[i] = i >= j ? R[i][j] : T(0);
      norm2 += v[i] * v[i];
    }
    T normx = sqrt(norm2);
    T sgn = R[j][j] >= T(0) ? T(1) : T(-1);
    v[j] = v[j] - (-sgn * normx);
    T vnorm2 = T(0);
    for (int i = 0; i < maxN; ++i) vnorm2 += v[i] * v[i];
    if (!(normx > T(0) && vnorm2 > T(0))) continue;
    T beta = T(2) / vnorm2;
    for (int m = 0; m < pd; ++m) {
      T s = T(0);
      for (int i = 0; i < maxN; ++i) s += v[i] * R[i][m];
      w[m] = s;
    }
    for (int i = 0; i < maxN; ++i)
      for (int m = 0; m < pd; ++m) R[i][m] = R[i][m] - beta * (v[i] * w[m]);
    for (int i = 0; i < maxN; ++i) {
      T s = T(0);
      for (int m = 0; m < maxN; ++m) s += Q[i][m] * v[m];
      w[i] = s;
    }
    for (int i = 0; i < maxN; ++i)
      for (int m = 0; m < maxN; ++m) Q[i][m] = Q[i][m] - beta * (w[i] * v[m]);
  }

  int zc = 0;
  for (int c = 0; c < C && N < maxN; ++c) {
    if (!cl[c]) continue;
    const T* xi = Xl + c * row_stride;
    // ---- tau^2 against the current state (candidate_quantities)
    T ph[MA], g[MA], Rr[MA][PA], row[PA], cs[PA], sn[PA];
    for (int i = 0; i < maxN; ++i) {
      T r2 = T(0);
      for (int t = 0; t < n; ++t) {
        T d = S[i][t] - xi[t];
        r2 += d * d;
      }
      ph[i] = i < N ? phi(f, r2, p) : T(0);
      g[i] = T(0);
      for (int j = 0; j < pd; ++j) Rr[i][j] = R[i][j];
    }
    T gh = T(1);
    bool rank_ok = true;
    if (pd > 0) {
      basis(xi, pd, row);
      const int act = N < pd ? N : pd;
      for (int j = 0; j < pd; ++j) {
        T a = Rr[j][j], bb = row[j];
        T r = sqrt(a * a + bb * bb);
        bool has = r > T(0) && j < act;
        T safe = r > T(0) ? r : T(1);
        T cth = has ? a / safe : T(1);
        T sth = has ? bb / safe : T(0);
        cs[j] = cth;
        sn[j] = sth;
        for (int m = 0; m < pd; ++m) {
          T Rj = Rr[j][m];
          Rr[j][m] = cth * Rj + sth * row[m];
          row[m] = -sth * Rj + cth * row[m];
        }
        for (int i = 0; i < maxN; ++i) g[i] = cth * g[i] - sth * (i == j ? T(1) : T(0));
        gh = cth * gh;
      }
      if (N < pd) {
        T nr = T(0);
        for (int m = 0; m < pd; ++m) nr += row[m] * row[m];
        rank_ok = sqrt(nr) > T(10) * eps_v<T>();
      }
    }
    T Qg[MA], PQg[MA], v[MA], Lv[MA];
    for (int i = 0; i < maxN; ++i) {
      T s = T(0);
      for (int m = 0; m < maxN; ++m) s += Q[i][m] * g[m];
      Qg[i] = s;
    }
    T qpq = T(0), pq = T(0);
    for (int i = 0; i < maxN; ++i) {
      T s = T(0);
      for (int m = 0; m < maxN; ++m) s += P[i][m] * Qg[m];
      PQg[i] = s;
    }
    for (int i = 0; i < maxN; ++i) {
      qpq += Qg[i] * PQg[i];
      pq += ph[i] * Qg[i];
    }
    for (int z = 0; z < maxN; ++z) {
      T s = T(0);
      if (z < zc)
        for (int i = 0; i < maxN; ++i) s += Z[i][z] * (PQg[i] + ph[i] * gh);
      v[z] = s;
    }
    const T sigma = qpq + T(2) * gh * pq + gh * gh * phi0;
    T lvl = T(0);
    for (int i = 0; i < maxN; ++i) {
      T s = T(0);
      if (i < zc)
        for (int m = 0; m < maxN; ++m) s += Li[i][m] * v[m];
      Lv[i] = s;
      lvl += s * s;
    }
    const T tau2 = sigma - lvl;
    if (!(rank_ok && tau2 > pivot2)) continue;

    // ---- accept (the JAX package recomputes the same quantities)
    const T tau = sqrt(tau2 > tiny_v<T>() ? tau2 : tiny_v<T>());
    const int slot = N < maxN - 1 ? N : maxN - 1;
    const int zs = zc < maxN - 1 ? zc : maxN - 1;
    for (int t = 0; t < n; ++t) S[slot][t] = xi[t];
    if (pd > 0) {
      // Q <- blkdiag(Q, 1) G': the same rotations applied to the columns
      for (int j = 0; j < pd; ++j) {
        for (int i = 0; i < maxN; ++i) {
          T cj = Q[i][j], cN = Q[i][slot];
          Q[i][j] = cs[j] * cj + sn[j] * cN;
          Q[i][slot] = -sn[j] * cj + cs[j] * cN;
        }
      }
      for (int i = 0; i < maxN; ++i)
        for (int j = 0; j < pd; ++j) R[i][j] = i == slot ? row[j] : Rr[i][j];
    }
    for (int i = 0; i < maxN; ++i) Z[i][zs] = i == slot ? gh : Qg[i];
    T lrow[MA];
    for (int m = 0; m < maxN; ++m) {
      T s = T(0);
      for (int i = 0; i < maxN; ++i) s += Li[i][m] * Lv[i];
      lrow[m] = -s / tau;
    }
    for (int m = 0; m < maxN; ++m) {
      L[zs][m] = m < zc ? Lv[m] : T(0);
      Li[zs][m] = m < zc ? lrow[m] : T(0);
    }
    L[zs][zs] = tau;
    Li[zs][zs] = T(1) / tau;
    for (int m = 0; m < maxN; ++m) {
      P[slot][m] = ph[m];
      P[m][slot] = ph[m];
    }
    P[slot][slot] = phi0;
    ++N;
    ++zc;
    acc[c] = 1;
  }
  N_out[b] = N;
}

template <typename T>
int launch(const T* X, long long lane_stride, long long row_stride,
           const unsigned char* cand, const T* sites0, long long s0_lane_stride,
           const int* count, const T* param, unsigned char* accepted, int* N_out, int B,
           int C, int n, int max_points, int pd, int kernel_id, double exponent,
           double coef, double pivot2, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Phi f{kernel_id, exponent, coef};
#define MORBIT_R4_ARGS                                                            \
  X, lane_stride, row_stride, cand, sites0, s0_lane_stride, count, param, accepted, \
      N_out, B, C, n, max_points, pd, f, pivot2
  if (n == 2 && max_points == 6 && pd == 3)
    rbf_round4_kernel<T, 2, 6, 3><<<blocks, threads, 0, s>>>(MORBIT_R4_ARGS);
  else if (n == 3 && max_points == 10 && pd == 4)
    rbf_round4_kernel<T, 3, 10, 4><<<blocks, threads, 0, s>>>(MORBIT_R4_ARGS);
  else if (n >= 1 && n <= MAX_NN && max_points >= 1 && max_points <= MAX_MAXN &&
           pd >= 0 && pd <= MAX_PD)
    rbf_round4_kernel<T, 0, 0, 0><<<blocks, threads, 0, s>>>(MORBIT_R4_ARGS);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef MORBIT_R4_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MORBIT_R4_EXPORT(NAME, T)                                                    \
  extern "C" int NAME(const T* X, long long lane_stride, long long row_stride,       \
                      const unsigned char* cand, const T* sites0,                    \
                      long long s0_lane_stride, const int* count, const T* param,    \
                      unsigned char* accepted, int* N_out, int B, int C, int n,      \
                      int max_points, int pd, int kernel_id, double exponent,        \
                      double coef, double pivot2, void* stream) {                    \
    return launch<T>(X, lane_stride, row_stride, cand, sites0, s0_lane_stride, count, \
                     param, accepted, N_out, B, C, n, max_points, pd, kernel_id,     \
                     exponent, coef, pivot2, stream);                                \
  }

MORBIT_R4_EXPORT(rbf_round4_f32, float)
MORBIT_R4_EXPORT(rbf_round4_f64, double)
