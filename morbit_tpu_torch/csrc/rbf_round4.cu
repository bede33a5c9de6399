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
//   n = 20), 128 threads. It does only the work the live state needs. Outside
//   an active block the state is identity or zero: Phi is the identity past
//   the N sites, Q differs from the identity only in its leading max(N, pd)
//   rows and columns (a Householder reflection j of the set-up is supported
//   on rows [j, N0); an acceptance rotates the pd leading columns and the
//   slot column N), Z column z is +0 below its slot N0 + z, L^-1 is lower
//   triangular. So every loop runs over the live sizes (N rows, zc columns,
//   the N0 x N0 block of the set-up's QR, the triangle of L^-1), no padding
//   is written, and Q is kept as its pd leading columns: the slot column an
//   acceptance rotates is the implicit e_slot (a stored one while slot < pd),
//   and a column past pd is never read again once rotated. The candidates are
//   compacted once per launch into a list (a (B, C) int workspace). The small
//   vectors and the leading pd x pd rows of R live in shared memory; S, Q's
//   columns, Phi, Z, L^-1 (by columns for L^-1 v, by rows for L^-1' Lv) live
//   in a device workspace (~1.1 MB a lane at maxN = 231, float32) of which a
//   launch touches only the live block, each sum loading its column a batch
//   of 16 ahead (two columns interleaved where a thread owns two). Warp 0
//   runs the pd dependent Givens steps while the other warps evaluate phi
//   against the sites; a tested candidate costs six block barriers, an
//   accepted one a seventh. All 1024 lanes of a wide batch are resident at
//   once (8 blocks an SM at float32).
//
// Both instances sum each dot product in one thread, in the twin's index
// order, with a rounding per multiply and per add (the kernels are built
// with --fmad=false), so they round as the twin does and take the same
// decisions. A term skipped by the wide instance is an exact zero of the
// state's structure times a finite factor: adding +-0 to a sum that starts at
// +0 never changes it (a sum of such terms is never -0), so each sum keeps its
// bits. The state values the wide instance never writes (the padding, and the
// zero entries the twin recomputes) can differ from the twin's only in the
// sign of a zero; a zero enters only products and such sums, never a
// division or a comparison that tells -0 from +0, so no decision moves.
//
// Bound on the H100: per tested candidate O(N^2 + N zc + zc^2) operations on
// the live state, and the bytes are the candidate rows read once
// (chip_smoke.py counts both from each run's inputs). Neither binds: the
// launch takes as long as its longest lane's chain of tests and
// acceptances, each a few dependent passes over the lane's state (memory
// round trips of a batch each) and the Givens steps. The thread-per-lane
// instance is latency-bound (1024 lanes fill 8 of 132 SMs).

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

constexpr int WIDE_MAX_MAXN = 512, WIDE_MAX_NN = 32, WIDE_THREADS = 128;
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
// The wide instance's state lives in the workspace (L2 or device memory), so
// every sum and update over it issues its loads a batch ahead of the chain
// of arithmetic that uses them.
constexpr int WIDE_BATCH = 16;

// sum over k < len of a[k * stride] * x[k], added in index order from +0
// with a rounding per multiply and per add (the twin's seq_dot); the loads
// go out a batch at a time, unpredicated but for the last batch
template <typename T>
__device__ __forceinline__ T wide_dot(const T* __restrict__ a, int stride,
                                      const T* __restrict__ x, int len) {
  T s = T(0);
  int k = 0;
  for (; k + WIDE_BATCH <= len; k += WIDE_BATCH, a += WIDE_BATCH * stride) {
    T va[WIDE_BATCH];
#pragma unroll
    for (int u = 0; u < WIDE_BATCH; ++u) va[u] = a[u * stride];
#pragma unroll
    for (int u = 0; u < WIDE_BATCH; ++u) s += va[u] * x[k + u];
  }
  T va[WIDE_BATCH];
#pragma unroll
  for (int u = 0; u < WIDE_BATCH; ++u) va[u] = k + u < len ? a[u * stride] : T(0);
#pragma unroll
  for (int u = 0; u < WIDE_BATCH; ++u)
    if (k + u < len) s += va[u] * x[k + u];
  return s;
}

// two such sums over the same x, of len0 <= len1 terms along a0 and a1,
// their loads interleaved
template <typename T>
__device__ __forceinline__ void wide_dot2(const T* __restrict__ a0, const T* __restrict__ a1,
                                          int stride, const T* __restrict__ x, int len0,
                                          int len1, T& s0, T& s1) {
  s0 = T(0);
  s1 = T(0);
  int k = 0;
  for (; k + WIDE_BATCH <= len0;
       k += WIDE_BATCH, a0 += WIDE_BATCH * stride, a1 += WIDE_BATCH * stride) {
    T va[WIDE_BATCH], vb[WIDE_BATCH];
#pragma unroll
    for (int u = 0; u < WIDE_BATCH; ++u) {
      va[u] = a0[u * stride];
      vb[u] = a1[u * stride];
    }
#pragma unroll
    for (int u = 0; u < WIDE_BATCH; ++u) {
      s0 += va[u] * x[k + u];
      s1 += vb[u] * x[k + u];
    }
  }
  for (; k < len1; k += WIDE_BATCH, a0 += WIDE_BATCH * stride, a1 += WIDE_BATCH * stride) {
    T va[WIDE_BATCH], vb[WIDE_BATCH];
#pragma unroll
    for (int u = 0; u < WIDE_BATCH; ++u) {
      va[u] = k + u < len0 ? a0[u * stride] : T(0);
      vb[u] = k + u < len1 ? a1[u * stride] : T(0);
    }
#pragma unroll
    for (int u = 0; u < WIDE_BATCH; ++u) {
      if (k + u < len0) s0 += va[u] * x[k + u];
      if (k + u < len1) s1 += vb[u] * x[k + u];
    }
  }
}

// sum over t < n of (a[t] - b[t])^2 in index order from +0
template <typename T>
__device__ __forceinline__ T wide_sqdist(const T* __restrict__ a, const T* __restrict__ b,
                                         int n) {
  T r2 = T(0);
  for (int t0 = 0; t0 < n; t0 += WIDE_BATCH) {
    T va[WIDE_BATCH], vb[WIDE_BATCH];
#pragma unroll
    for (int u = 0; u < WIDE_BATCH; ++u) {
      va[u] = t0 + u < n ? a[t0 + u] : T(0);
      vb[u] = t0 + u < n ? b[t0 + u] : T(0);
    }
#pragma unroll
    for (int u = 0; u < WIDE_BATCH; ++u) {
      if (t0 + u < n) {
        T d = va[u] - vb[u];
        r2 += d * d;
      }
    }
  }
  return r2;
}

// y[k * stride] <- y[k * stride] - beta * (c * x[k]) for k < len
template <typename T>
__device__ __forceinline__ void wide_rank1(T* __restrict__ y, int stride, T beta, T c,
                                           const T* __restrict__ x, int len) {
  for (int k = 0; k < len; k += WIDE_BATCH) {
    T vy[WIDE_BATCH];
#pragma unroll
    for (int u = 0; u < WIDE_BATCH; ++u) vy[u] = k + u < len ? y[(k + u) * stride] : T(0);
#pragma unroll
    for (int u = 0; u < WIDE_BATCH; ++u)
      if (k + u < len) y[(k + u) * stride] = vy[u] - beta * (c * x[k + u]);
  }
}

// Elements of T in one lane's workspace slice (ld = maxN). Only the live
// parts are ever written or read; nothing is initialised to identity or zero.
//   S   [maxN][n]     sites, row-major (rows < N)
//   Qc  [pd][maxN]    the pd leading columns of Q, by columns:
//                     Qc[m * ld + i] = Q[i][m] (rows < max(N, pd))
//   Pm  [maxN][maxN]  Phi (rows and columns < N); exactly symmetric, so
//                     column i is read as row i
//   Zm  [maxN][maxN]  Z, row-major: Zm[i * ld + z] = Z[i][z] (rows <= N0 + z);
//                     during the set-up it holds the Householder Q block
//                     (N0 x N0, by columns)
//   LiT [maxN][maxN]  L^-1 by columns: LiT[m * ld + i] = Li[i][m] (m <= i < zc)
//   Lr  [maxN][maxN]  L^-1 by rows:    Lr[i * ld + m] = Li[i][m] (m <= i < zc)
//   R0  [maxN][pd]    the set-up's polynomial block (rows < N0)
__host__ __device__ inline long long wide_lane_elems(int maxN, int n, int pd) {
  return (long long)maxN * (n + 2 * pd) + 5LL * maxN * maxN;
}

// Shared vectors, in elements of T: ph, Qg, tmp, qq, pp, v, Lv, lsq (maxN
// each), two pd x pd buffers for the leading rows of R (current and
// rotated), and g, row, cs, sn, w (pd each).
__host__ __device__ inline int wide_smem_elems(int maxN, int pd) {
  return 8 * maxN + 2 * pd * pd + 5 * pd;
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS, sizeof(T) == 4 ? 8 : 4)
rbf_round4_wide_kernel(const T* __restrict__ X, long long lane_stride,
                       long long row_stride, const unsigned char* __restrict__ cand,
                       const T* __restrict__ sites0, long long s0_lane_stride,
                       const int* __restrict__ count, const T* __restrict__ param,
                       unsigned char* __restrict__ accepted, int* __restrict__ N_out,
                       T* __restrict__ work, int* __restrict__ list, int C, int n,
                       int maxN, int pd, Phi f, double pivot2_in) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ T s_beta, s_gh, s_qpq, s_pq, s_tau2;
  __shared__ int s_flag, s_rank, s_wcount[2][WIDE_WARPS];
  constexpr int nt = WIDE_THREADS;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = maxN;
  T* sm = reinterpret_cast<T*>(smem_raw);
  T *ph = sm, *Qg = ph + maxN, *tmp = Qg + maxN, *qq = tmp + maxN, *pp = qq + maxN;
  T *vv = pp + maxN, *Lv = vv + maxN, *lsq = Lv + maxN, *Ra = lsq + maxN;
  T *Rb = Ra + pd * pd, *g = Rb + pd * pd, *row = g + pd, *cs = row + pd;
  T *sn = cs + pd, *w = sn + pd;

  T* W = work + (long long)b * wide_lane_elems(maxN, n, pd);
  T *S = W, *Qc = S + (long long)maxN * n, *Pm = Qc + (long long)pd * ld;
  T *Zm = Pm + (long long)ld * ld, *LiT = Zm + (long long)ld * ld;
  T *Lr = LiT + (long long)ld * ld, *R0 = Lr + (long long)ld * ld;
  int* cl = list + (long long)b * C;

  const T p = param[b];
  const T pivot2 = T(pivot2_in);
  const T* Xl = X + b * lane_stride;
  const unsigned char* cb = cand + (long long)b * C;
  unsigned char* acc = accepted + (long long)b * C;

  // the candidates in database order, compacted once (and the flags cleared)
  int ncand = 0;
  for (int base = 0; base < C; base += nt) {
    const int c = base + tid;
    const bool on = c < C && cb[c];
    if (c < C) acc[c] = 0;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    const int buf = (base / nt) & 1;
    if (lane == 0) s_wcount[buf][warp] = __popc(bal);
    __syncthreads();
    int off = ncand, tot = 0;
    for (int k = 0; k < WIDE_WARPS; ++k) {
      const int cnt = s_wcount[buf][k];
      off += k < warp ? cnt : 0;
      tot += cnt;
    }
    if (on) cl[off + __popc(bal & ((1u << lane) - 1u))] = c;
    ncand += tot;
  }

  int N = count[b];
  if (N >= maxN) {  // full already: nothing can be accepted
    if (tid == 0) N_out[b] = N;
    return;
  }
  const int N0 = N;
  const T phi0 = phi(f, T(0), p);
  for (int idx = tid; idx < N0 * n; idx += nt) S[idx] = sites0[b * s0_lane_stride + idx];
  __syncthreads();
  // Q's N0 x N0 block, by columns, lives in Z's place during the set-up
  T* Qb = Zm;
  // Phi, the polynomial block and the identity Q on the live N0 x N0 block
  for (int idx = tid; idx < N0 * N0; idx += nt) {
    const int i = idx / N0, j = idx % N0;
    Pm[(long long)i * ld + j] = phi(f, wide_sqdist(S + i * n, S + j * n, n), p);
    Qb[i * ld + j] = i == j ? T(1) : T(0);
  }
  for (int idx = tid; idx < N0 * pd; idx += nt) {
    const int i = idx / pd, j = idx % pd;
    R0[idx] = j == 0 ? T(1) : S[i * n + j - 1];
  }
  __syncthreads();

  // masked Householder QR of the polynomial block (_masked_householder_qr),
  // on the live block: reflection j is supported on rows [j, N0), and is
  // inactive (normx = 0) for j >= N0
  {
    T *hv = ph, *hw = Qg;
    const int nref = N0 < pd ? N0 : pd;
    for (int j = 0; j < nref; ++j) {
      for (int i = tid; i < N0; i += nt) hv[i] = i >= j ? R0[i * pd + j] : T(0);
      __syncthreads();
      if (tid == 0) {
        T norm2 = T(0);
        for (int i = j; i < N0; ++i) norm2 += hv[i] * hv[i];
        T normx = sqrt(norm2);
        T sgn = R0[j * pd + j] >= T(0) ? T(1) : T(-1);
        hv[j] = hv[j] - (-sgn * normx);
        T vnorm2 = T(0);
        for (int i = j; i < N0; ++i) vnorm2 += hv[i] * hv[i];
        s_flag = normx > T(0) && vnorm2 > T(0);
        s_beta = T(2) / vnorm2;
      }
      __syncthreads();
      if (!s_flag) continue;
      const T beta = s_beta;
      for (int m = tid; m < pd; m += nt) w[m] = wide_dot(R0 + j * pd + m, pd, hv + j, N0 - j);
      for (int i = tid; i < N0; i += nt) hw[i] = wide_dot(Qb + j * ld + i, ld, hv + j, N0 - j);
      __syncthreads();
      for (int i = tid; i < N0; i += nt) {
        wide_rank1(R0 + i * pd, 1, beta, hv[i], w, pd);
        wide_rank1(Qb + i, ld, beta, hw[i], hv, N0);
      }
      __syncthreads();
    }
  }
  // keep Q's pd leading columns (rows < max(N0, pd)) and R's pd leading rows
  const int qr0 = N0 > pd ? N0 : pd;
  for (int idx = tid; idx < pd * qr0; idx += nt) {
    const int m = idx / qr0, i = idx % qr0;
    Qc[(long long)m * ld + i] = m < N0 && i < N0 ? Qb[m * ld + i] : (i == m ? T(1) : T(0));
  }
  for (int idx = tid; idx < pd * pd; idx += nt) Ra[idx] = idx / pd < N0 ? R0[idx] : T(0);
  __syncthreads();

  int zc = 0;
  T *Rc = Ra, *Rn = Rb;  // R's leading rows, and their rotated copy
  for (int k = 0; k < ncand && N < maxN; ++k) {
    const int c = cl[k];
    const T* xi = Xl + (long long)c * row_stride;
    // ---- tau^2 against the current state (candidate_quantities)
    if (warp == 0) {
      // the Givens rotations folding the candidate's polynomial row into R;
      // lane m rotates columns m and m + 32, every lane computes (c, s)
      T rw[2], gg[2];
      for (int q = 0; q < 2; ++q) {
        const int m = lane + 32 * q;
        rw[q] = m < pd ? (m == 0 ? T(1) : xi[m - 1]) : T(0);
        gg[q] = T(0);
      }
      T gh = T(1);
      const int act = N < pd ? N : pd;
      for (int j = 0; j < pd; ++j) {
        const T a = Rc[j * pd + j];
        const T bb = __shfl_sync(0xffffffffu, j < 32 ? rw[0] : rw[1], j & 31);
        T r = sqrt(a * a + bb * bb);
        bool has = r > T(0) && j < act;
        T safe = r > T(0) ? r : T(1);
        T cth = has ? a / safe : T(1);
        T sth = has ? bb / safe : T(0);
        for (int q = 0; q < 2; ++q) {
          const int m = lane + 32 * q;
          if (m < pd) {
            T Rj = Rc[j * pd + m];
            Rn[j * pd + m] = cth * Rj + sth * rw[q];
            rw[q] = -sth * Rj + cth * rw[q];
            gg[q] = cth * gg[q] - sth * (m == j ? T(1) : T(0));
          }
        }
        if (lane == 0) {
          cs[j] = cth;
          sn[j] = sth;
        }
        gh = cth * gh;
      }
      for (int q = 0; q < 2; ++q) {
        const int m = lane + 32 * q;
        if (m < pd) {
          row[m] = rw[q];
          g[m] = gg[q];
        }
      }
      __syncwarp();
      if (lane == 0) {
        bool rank_ok = true;
        if (N < pd) {
          T nr = T(0);
          for (int m = 0; m < pd; ++m) nr += row[m] * row[m];
          rank_ok = sqrt(nr) > T(10) * eps_v<T>();
        }
        s_gh = gh;
        s_rank = rank_ok;
      }
    } else {
      // phi to the live sites, on the other warps
      for (int i = tid - 32; i < N; i += nt - 32) ph[i] = phi(f, wide_sqdist(S + i * n, xi, n), p);
    }
    __syncthreads();
    const T gh = s_gh;
    // Qg = Q[:, :pd] g on the live rows (it is +0 past N), and the terms of pq
    for (int i = tid; i < N; i += nt) {
      const T s = wide_dot(Qc + i, ld, g, pd);
      Qg[i] = s;
      pp[i] = ph[i] * s;
    }
    __syncthreads();
    // PQg = Phi Qg over the live block; tmp = PQg + ph gh, and the terms of qpq
    for (int i = tid; i < N; i += 2 * nt) {
      const int i1 = i + nt;
      T s0, s1;
      if (i1 < N)
        wide_dot2(Pm + i, Pm + i1, ld, Qg, N, N, s0, s1);
      else
        s0 = wide_dot(Pm + i, ld, Qg, N);
      tmp[i] = s0 + ph[i] * gh;
      qq[i] = Qg[i] * s0;
      if (i1 < N) {
        tmp[i1] = s1 + ph[i1] * gh;
        qq[i1] = Qg[i1] * s1;
      }
    }
    __syncthreads();
    // qpq and pq, each summed in index order by one thread, beside v
    if (tid == 0) {
      T s = T(0);
      for (int i = 0; i < N; ++i) s += qq[i];
      s_qpq = s;
    } else if (tid == 1) {
      T s = T(0);
      for (int i = 0; i < N; ++i) s += pp[i];
      s_pq = s;
    }
    // v = Z' tmp: column z of Z is +0 below its slot N0 + z
    for (int z = tid; z < zc; z += 2 * nt) {
      const int z1 = z + nt;
      T s0, s1;
      if (z1 < zc)
        wide_dot2(Zm + z, Zm + z1, ld, tmp, N0 + z + 1, N0 + z1 + 1, s0, s1);
      else
        s0 = wide_dot(Zm + z, ld, tmp, N0 + z + 1);
      vv[z] = s0;
      if (z1 < zc) vv[z1] = s1;
    }
    __syncthreads();
    // Lv = L^-1 v, lower triangular
    for (int i = tid; i < zc; i += 2 * nt) {
      const int i1 = i + nt;
      T s0, s1;
      if (i1 < zc)
        wide_dot2(LiT + i, LiT + i1, ld, vv, i + 1, i1 + 1, s0, s1);
      else
        s0 = wide_dot(LiT + i, ld, vv, i + 1);
      Lv[i] = s0;
      lsq[i] = s0 * s0;
      if (i1 < zc) {
        Lv[i1] = s1;
        lsq[i1] = s1 * s1;
      }
    }
    __syncthreads();
    // the decision: ||Lv||^2 in index order, sigma and tau^2
    if (tid == 0) {
      T lvl = T(0);
      for (int i = 0; i < zc; ++i) lvl += lsq[i];
      const T qpq = s_qpq, pq = s_pq;
      const T sigma = qpq + T(2) * gh * pq + gh * gh * phi0;
      const T tau2 = sigma - lvl;
      s_tau2 = tau2;
      s_flag = s_rank && tau2 > pivot2;
    }
    __syncthreads();
    if (!s_flag) continue;

    // ---- accept (the twin's updates, on the live state)
    const T tau2 = s_tau2;
    const T tau = sqrt(tau2 > tiny_v<T>() ? tau2 : tiny_v<T>());
    const int slot = N;  // < maxN
    for (int t = tid; t < n; t += nt) S[slot * n + t] = xi[t];
    // Q <- blkdiag(Q, 1) G': the same rotations on the pd leading columns and
    // on column `slot` (the identity column e_slot unless slot < pd; it is
    // never read again once it is past the pd leading columns)
    const int qrows = N + 1 > pd ? N + 1 : pd, qlive = N > pd ? N : pd;
    for (int i = tid; i < qrows; i += nt) {
      T cN = slot < pd ? Qc[(long long)slot * ld + i] : (i == slot ? T(1) : T(0));
      for (int j0 = 0; j0 < pd; j0 += WIDE_BATCH) {
        T vc[WIDE_BATCH];
#pragma unroll
        for (int u = 0; u < WIDE_BATCH; ++u) {
          const int j = j0 + u;
          vc[u] = j < pd && j != slot && i < qlive ? Qc[(long long)j * ld + i] : T(0);
        }
#pragma unroll
        for (int u = 0; u < WIDE_BATCH; ++u) {
          const int j = j0 + u;
          if (j < pd) {
            const T cj = j == slot ? cN : vc[u];
            const T nj = cs[j] * cj + sn[j] * cN;
            cN = -sn[j] * cj + cs[j] * cN;
            if (j != slot) Qc[(long long)j * ld + i] = nj;
          }
        }
      }
      if (slot < pd) Qc[(long long)slot * ld + i] = cN;
    }
    // R <- its rotated rows, the candidate's row in the slot (rows >= pd are
    // never read again)
    if (slot < pd)
      for (int m = tid; m < pd; m += nt) Rn[slot * pd + m] = row[m];
    for (int i = tid; i <= slot; i += nt) Zm[(long long)i * ld + zc] = i == slot ? gh : Qg[i];
    // the new row of L^-1: -(L^-1' Lv) / tau, and 1 / tau on the diagonal
    for (int m = tid; m <= zc; m += nt) {
      T val;
      if (m < zc) {
        const T s = wide_dot(Lr + m * ld + m, ld, Lv + m, zc - m);
        val = -s / tau;
      } else {
        val = T(1) / tau;
      }
      Lr[(long long)zc * ld + m] = val;
      LiT[(long long)m * ld + zc] = val;
    }
    for (int m = tid; m <= slot; m += nt) {
      const T val = m == slot ? phi0 : ph[m];
      Pm[(long long)slot * ld + m] = val;
      Pm[(long long)m * ld + slot] = val;
    }
    T* t_ = Rc;
    Rc = Rn;
    Rn = t_;
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
                T* work, int* list, int B, int C, int n, int max_points, int pd, Phi f,
                double pivot2, cudaStream_t s) {
  const size_t smem = sizeof(T) * wide_smem_elems(max_points, pd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rbf_round4_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rbf_round4_wide_kernel<T><<<B, WIDE_THREADS, smem, s>>>(
      X, lane_stride, row_stride, cand, sites0, s0_lane_stride, count, param, accepted,
      N_out, work, list, C, n, max_points, pd, f, pivot2);
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

// The wide instance: `work` holds B * rbf_round4_wide_lane_elems(...) values
// and `list` B * C ints.
#define MORBIT_R4_WIDE_EXPORT(NAME, T)                                               \
  extern "C" int NAME(const T* X, long long lane_stride, long long row_stride,       \
                      const unsigned char* cand, const T* sites0,                    \
                      long long s0_lane_stride, const int* count, const T* param,    \
                      unsigned char* accepted, int* N_out, T* work, int* list, int B,\
                      int C, int n, int max_points, int pd, int kernel_id,           \
                      double exponent, double coef, double pivot2, void* stream) {   \
    if (B <= 0) return 0;                                                            \
    if (n < 1 || n > WIDE_MAX_NN || max_points < 1 || max_points > WIDE_MAX_MAXN ||  \
        pd < 0 || pd > n + 1 || pd > max_points)                                     \
      return static_cast<int>(cudaErrorInvalidValue);                                \
    return launch_wide<T>(X, lane_stride, row_stride, cand, sites0, s0_lane_stride,  \
                          count, param, accepted, N_out, work, list, B, C, n,        \
                          max_points, pd, Phi{kernel_id, exponent, coef}, pivot2,    \
                          static_cast<cudaStream_t>(stream));                        \
  }

MORBIT_R4_WIDE_EXPORT(rbf_round4_wide_f32, float)
MORBIT_R4_WIDE_EXPORT(rbf_round4_wide_f64, double)

extern "C" long long rbf_round4_wide_lane_elems(int max_points, int n, int pd) {
  return wide_lane_elems(max_points, n, pd);
}
