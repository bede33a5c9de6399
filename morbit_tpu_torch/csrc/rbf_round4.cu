// K3: RBF round-4 acceptance.
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
// closed form), appends a column to Z and rank-1 rows to L^-1 and Phi (L
// itself is never read by the test, so it is not kept). The scan stops at
// max_points sites.
//
// Design: one sequential scan replaces the TPU's waves (each wave tested every
// remaining candidate and took the first that passed). The state changes only
// at an acceptance, so both give the same acceptance sequence. Two instances:
//
// * one thread per lane (maxN <= 24): the maxN x maxN state (maxN = max_points)
//   lives in registers or local memory: (n, maxN, pd) = (2, 6, 3) is the main
//   path, (3, 10, 4) the three-variable default, and a generic instance with
//   runtime sizes covers the rest;
// * one block per lane (maxN <= 512, n <= 32: the wide-n path, maxN = 231 at
//   n = 20): the lane's state (~1 MB at maxN = 231, float32) lives in a device
//   workspace that the wrapper allocates, and the block's threads split the
//   rows of every mat-vec. Each dot product is still summed by one thread in
//   index order, so both instances round as the twin does. Terms that are
//   exact zeros of the state's structure (the Givens vector g past the
//   polynomial block, L^-1 v past the accepted count) are skipped: adding
//   +-0 to a sum that starts at +0 never changes it.
//
// Bound on the H100: per tested candidate O(maxN^2) operations, and the bytes
// are the candidate rows read once; both give microseconds at B=1024
// (chip_smoke.py computes the bound from each run's inputs). The thread-per-lane
// instance is latency-bound (1024 lanes fill 8 of 132 SMs); the block-per-lane
// one re-reads its state from device memory (Phi, Z, L^-1: 3 maxN^2 values) for
// every tested candidate and is bound by those reads.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "rbf_phi.cuh"

namespace {

using morbit::Phi;
using morbit::phi;

constexpr int MAX_MAXN = 24, MAX_PD = 16, MAX_NN = 15;

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

  T S[MA][NA], Q[MA][MA], R[MA][PA], Z[MA][MA], Li[MA][MA], P[MA][MA];
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
      Li[i][j] = i == j ? T(1) : T(0);
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
      Li[zs][m] = m < zc ? lrow[m] : T(0);
    }
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

// ---- one block per lane (the wide instance)

constexpr int WIDE_MAX_MAXN = 512, WIDE_MAX_NN = 32, WIDE_THREADS = 256;

// Elements of T in one lane's workspace slice (ld = maxN):
//   S   [maxN][n]     sites, row-major
//   Qc  [maxN][maxN]  Q by columns: Qc[m * ld + i] = Q[i][m]
//   Pm  [maxN][maxN]  Phi; exactly symmetric, so a column read is a row read
//   Zm  [maxN][maxN]  Z, row-major: Zm[i * ld + z] = Z[i][z]
//   LiT [maxN][maxN]  L^-1 by columns: LiT[m * ld + i] = Li[i][m]
//   R   [maxN][pd]    row-major
__host__ __device__ inline long long wide_lane_elems(int maxN, int n, int pd) {
  return (long long)maxN * n + 4LL * maxN * maxN + (long long)maxN * pd;
}

// Shared vectors, in elements of T: ph, Qg, PQg, tmp, v, Lv, wq (maxN each),
// g, row, cs, sn, w (pd each), xi (n), Rr (pd x pd, the rows < pd of R
// while they are rotated).
__host__ __device__ inline int wide_smem_elems(int maxN, int n, int pd) {
  return 7 * maxN + 5 * pd + n + pd * pd;
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS)
rbf_round4_wide_kernel(const T* __restrict__ X, long long lane_stride,
                       long long row_stride, const unsigned char* __restrict__ cand,
                       const T* __restrict__ sites0, long long s0_lane_stride,
                       const int* __restrict__ count, const T* __restrict__ param,
                       unsigned char* __restrict__ accepted, int* __restrict__ N_out,
                       T* __restrict__ work, int C, int n, int maxN, int pd, Phi f,
                       double pivot2_in) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ T s_beta, s_gh, s_qpq, s_pq, s_tau2;
  __shared__ int s_flag;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int ld = maxN;
  T* sm = reinterpret_cast<T*>(smem_raw);
  T *ph = sm, *Qg = ph + maxN, *PQg = Qg + maxN, *tmp = PQg + maxN, *vv = tmp + maxN;
  T *Lv = vv + maxN, *wq = Lv + maxN, *g = wq + maxN, *row = g + pd, *cs = row + pd;
  T *sn = cs + pd, *w = sn + pd, *xi = w + pd, *Rr = xi + n;

  T* W = work + (long long)b * wide_lane_elems(maxN, n, pd);
  T *S = W, *Qc = S + (long long)maxN * n, *Pm = Qc + (long long)ld * ld;
  T *Zm = Pm + (long long)ld * ld, *LiT = Zm + (long long)ld * ld;
  T* R = LiT + (long long)ld * ld;

  const T p = param[b];
  const T pivot2 = T(pivot2_in);
  const T* Xl = X + b * lane_stride;
  const unsigned char* cl = cand + (long long)b * C;
  unsigned char* acc = accepted + (long long)b * C;
  for (int c = tid; c < C; c += nt) acc[c] = 0;

  int N = count[b];
  if (N >= maxN) {  // full already: nothing can be accepted
    if (tid == 0) N_out[b] = N;
    return;
  }

  for (int idx = tid; idx < maxN * n; idx += nt) {
    const int i = idx / n, j = idx % n;
    S[idx] = i < N ? sites0[b * s0_lane_stride + i * n + j] : T(0);
  }
  __syncthreads();
  for (long long idx = tid; idx < (long long)ld * ld; idx += nt) {
    const int i = int(idx / ld), j = int(idx % ld);
    T val;
    if (i < N && j < N) {
      T r2 = T(0);
      for (int t = 0; t < n; ++t) {
        T d = S[i * n + t] - S[j * n + t];
        r2 += d * d;
      }
      val = phi(f, r2, p);
    } else {
      val = i == j ? T(1) : T(0);
    }
    Pm[idx] = val;
    Qc[idx] = i == j ? T(1) : T(0);
    Zm[idx] = T(0);
    LiT[idx] = i == j ? T(1) : T(0);
  }
  for (int idx = tid; idx < maxN * pd; idx += nt) {
    const int i = idx / pd, j = idx % pd;
    R[idx] = i < N ? (j == 0 ? T(1) : S[i * n + j - 1]) : T(0);
  }
  const T phi0 = phi(f, T(0), p);
  __syncthreads();

  // masked Householder QR of the polynomial block (_masked_householder_qr)
  T* v = tmp;
  for (int j = 0; j < pd; ++j) {
    for (int i = tid; i < maxN; i += nt) v[i] = i >= j ? R[i * pd + j] : T(0);
    __syncthreads();
    if (tid == 0) {
      T norm2 = T(0);
      for (int i = 0; i < maxN; ++i) norm2 += v[i] * v[i];
      T normx = sqrt(norm2);
      T sgn = R[j * pd + j] >= T(0) ? T(1) : T(-1);
      v[j] = v[j] - (-sgn * normx);
      T vnorm2 = T(0);
      for (int i = 0; i < maxN; ++i) vnorm2 += v[i] * v[i];
      s_flag = normx > T(0) && vnorm2 > T(0);
      s_beta = T(2) / vnorm2;
    }
    __syncthreads();
    if (!s_flag) continue;
    const T beta = s_beta;
    for (int m = tid; m < pd; m += nt) {
      T s = T(0);
      for (int i = 0; i < maxN; ++i) s += v[i] * R[i * pd + m];
      w[m] = s;
    }
    for (int i = tid; i < maxN; i += nt) {
      T s = T(0);
      for (int m = 0; m < maxN; ++m) s += Qc[(long long)m * ld + i] * v[m];
      wq[i] = s;
    }
    __syncthreads();
    for (int idx = tid; idx < maxN * pd; idx += nt) {
      const int i = idx / pd, m = idx % pd;
      R[idx] = R[idx] - beta * (v[i] * w[m]);
    }
    for (long long idx = tid; idx < (long long)ld * ld; idx += nt) {
      const int m = int(idx / ld), i = int(idx % ld);
      Qc[idx] = Qc[idx] - beta * (wq[i] * v[m]);
    }
    __syncthreads();
  }

  int zc = 0;
  for (int c = 0; c < C && N < maxN; ++c) {
    if (!cl[c]) continue;
    const T* xg = Xl + c * row_stride;
    for (int t = tid; t < n; t += nt) xi[t] = xg[t];
    __syncthreads();
    // ---- tau^2 against the current state (candidate_quantities)
    for (int i = tid; i < maxN; i += nt) {
      T val = T(0);
      if (i < N) {
        T r2 = T(0);
        for (int t = 0; t < n; ++t) {
          T d = S[i * n + t] - xi[t];
          r2 += d * d;
        }
        val = phi(f, r2, p);
      }
      ph[i] = val;
    }
    if (tid < 32) {
      // the Givens rotations folding the candidate's polynomial row into R,
      // one warp: lane m rotates column m
      T gh = T(1);
      bool rank_ok = true;
      if (pd > 0) {
        for (int idx = tid; idx < pd * pd; idx += 32) Rr[idx] = R[idx];
        for (int m = tid; m < pd; m += 32) {
          g[m] = T(0);
          row[m] = m == 0 ? T(1) : xi[m - 1];
        }
        __syncwarp();
        const int act = N < pd ? N : pd;
        for (int j = 0; j < pd; ++j) {
          T a = Rr[j * pd + j], bb = row[j];
          T r = sqrt(a * a + bb * bb);
          bool has = r > T(0) && j < act;
          T safe = r > T(0) ? r : T(1);
          T cth = has ? a / safe : T(1);
          T sth = has ? bb / safe : T(0);
          __syncwarp();
          for (int m = tid; m < pd; m += 32) {
            T Rj = Rr[j * pd + m];
            Rr[j * pd + m] = cth * Rj + sth * row[m];
            row[m] = -sth * Rj + cth * row[m];
            g[m] = cth * g[m] - sth * (m == j ? T(1) : T(0));
          }
          if (tid == 0) {
            cs[j] = cth;
            sn[j] = sth;
          }
          gh = cth * gh;
          __syncwarp();
        }
        if (N < pd) {
          T nr = T(0);
          for (int m = 0; m < pd; ++m) nr += row[m] * row[m];
          rank_ok = sqrt(nr) > T(10) * eps_v<T>();
        }
      }
      if (tid == 0) {
        s_gh = gh;
        s_flag = rank_ok;
      }
    }
    __syncthreads();
    const T gh = s_gh;
    const bool rank_ok = s_flag;
    for (int i = tid; i < maxN; i += nt) {
      T s = T(0);
      for (int m = 0; m < pd; ++m) s += Qc[(long long)m * ld + i] * g[m];
      Qg[i] = s;
    }
    __syncthreads();
    for (int i = tid; i < maxN; i += nt) {
      T s = T(0);
      for (int m = 0; m < maxN; ++m) s += Pm[(long long)m * ld + i] * Qg[m];
      PQg[i] = s;
    }
    __syncthreads();
    for (int i = tid; i < maxN; i += nt) tmp[i] = PQg[i] + ph[i] * gh;
    if (tid == 0) {
      T qpq = T(0);
      for (int i = 0; i < maxN; ++i) qpq += Qg[i] * PQg[i];
      s_qpq = qpq;
    } else if (tid == 32) {
      T pq = T(0);
      for (int i = 0; i < maxN; ++i) pq += ph[i] * Qg[i];
      s_pq = pq;
    }
    __syncthreads();
    for (int z = tid; z < maxN; z += nt) {
      T s = T(0);
      if (z < zc)
        for (int i = 0; i < maxN; ++i) s += Zm[(long long)i * ld + z] * tmp[i];
      vv[z] = s;
    }
    __syncthreads();
    for (int i = tid; i < maxN; i += nt) {
      T s = T(0);
      if (i < zc)
        for (int m = 0; m < zc; ++m) s += LiT[(long long)m * ld + i] * vv[m];
      Lv[i] = s;
    }
    __syncthreads();
    if (tid == 0) {
      T lvl = T(0);
      for (int i = 0; i < zc; ++i) lvl += Lv[i] * Lv[i];
      const T qpq = s_qpq, pq = s_pq;
      const T sigma = qpq + T(2) * gh * pq + gh * gh * phi0;
      const T tau2 = sigma - lvl;
      s_tau2 = tau2;
      s_flag = rank_ok && tau2 > pivot2;
    }
    __syncthreads();
    if (!s_flag) continue;

    // ---- accept (the same updates as the thread-per-lane instance)
    const T tau2 = s_tau2;
    const T tau = sqrt(tau2 > tiny_v<T>() ? tau2 : tiny_v<T>());
    const int slot = N < maxN - 1 ? N : maxN - 1;
    const int zs = zc < maxN - 1 ? zc : maxN - 1;
    for (int t = tid; t < n; t += nt) S[slot * n + t] = xi[t];
    if (pd > 0) {
      // Q <- blkdiag(Q, 1) G': the same rotations applied to the columns
      for (int i = tid; i < maxN; i += nt) {
        for (int j = 0; j < pd; ++j) {
          T cj = Qc[(long long)j * ld + i], cN = Qc[(long long)slot * ld + i];
          Qc[(long long)j * ld + i] = cs[j] * cj + sn[j] * cN;
          Qc[(long long)slot * ld + i] = -sn[j] * cj + cs[j] * cN;
        }
      }
      for (int idx = tid; idx < pd * pd; idx += nt)
        R[idx] = idx / pd == slot ? row[idx % pd] : Rr[idx];
      if (slot >= pd)
        for (int m = tid; m < pd; m += nt) R[slot * pd + m] = row[m];
    }
    for (int i = tid; i < maxN; i += nt) Zm[(long long)i * ld + zs] = i == slot ? gh : Qg[i];
    for (int m = tid; m < maxN; m += nt) {
      T s = T(0);
      for (int i = 0; i < zc; ++i) s += LiT[(long long)m * ld + i] * Lv[i];
      wq[m] = -s / tau;
    }
    __syncthreads();
    for (int m = tid; m < maxN; m += nt) {
      LiT[(long long)m * ld + zs] = m == zs ? T(1) / tau : (m < zc ? wq[m] : T(0));
      Pm[(long long)slot * ld + m] = m == slot ? phi0 : ph[m];
      Pm[(long long)m * ld + slot] = m == slot ? phi0 : ph[m];
    }
    ++N;
    ++zc;
    if (tid == 0) acc[c] = 1;
    __syncthreads();
  }
  if (tid == 0) N_out[b] = N;
}

template <typename T>
int launch_wide(const T* X, long long lane_stride, long long row_stride,
                const unsigned char* cand, const T* sites0, long long s0_lane_stride,
                const int* count, const T* param, unsigned char* accepted, int* N_out,
                T* work, int B, int C, int n, int max_points, int pd, Phi f,
                double pivot2, cudaStream_t s) {
  const size_t smem = sizeof(T) * wide_smem_elems(max_points, n, pd);
  rbf_round4_wide_kernel<T><<<B, WIDE_THREADS, smem, s>>>(
      X, lane_stride, row_stride, cand, sites0, s0_lane_stride, count, param, accepted,
      N_out, work, C, n, max_points, pd, f, pivot2);
  return static_cast<int>(cudaGetLastError());
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

// The wide instance: `work` holds B * rbf_round4_wide_lane_elems(...) values.
#define MORBIT_R4_WIDE_EXPORT(NAME, T)                                               \
  extern "C" int NAME(const T* X, long long lane_stride, long long row_stride,       \
                      const unsigned char* cand, const T* sites0,                    \
                      long long s0_lane_stride, const int* count, const T* param,    \
                      unsigned char* accepted, int* N_out, T* work, int B, int C,    \
                      int n, int max_points, int pd, int kernel_id, double exponent, \
                      double coef, double pivot2, void* stream) {                    \
    if (B <= 0) return 0;                                                            \
    if (n < 1 || n > WIDE_MAX_NN || max_points < 1 || max_points > WIDE_MAX_MAXN ||  \
        pd < 0 || pd > n + 1)                                                        \
      return static_cast<int>(cudaErrorInvalidValue);                                \
    return launch_wide<T>(X, lane_stride, row_stride, cand, sites0, s0_lane_stride,  \
                          count, param, accepted, N_out, work, B, C, n, max_points,  \
                          pd, Phi{kernel_id, exponent, coef}, pivot2,                \
                          static_cast<cudaStream_t>(stream));                        \
  }

MORBIT_R4_WIDE_EXPORT(rbf_round4_wide_f32, float)
MORBIT_R4_WIDE_EXPORT(rbf_round4_wide_f64, double)

extern "C" long long rbf_round4_wide_lane_elems(int max_points, int n, int pd) {
  return wide_lane_elems(max_points, n, pd);
}
