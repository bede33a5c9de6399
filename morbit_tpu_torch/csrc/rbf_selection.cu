// K2: RBF training-site rounds 1-3, one thread per lane.
//
// Replaces the TPU kernel `_pallas_selection` (morbit_tpu/ops/prepare_fused.py:167,
// body morbit_tpu/ops/prepare_coord.py::selection_coord_batched), whose
// semantics are `rbf_selection_core` (morbit_tpu/models/rbf_model.py:130-254).
// Its plain PyTorch twin is morbit_tpu_torch/ops/prepare_coord.py::rbf_selection_core.
//
// Per lane:
//   round 1: greedy affinely independent picks among the database rows in the
//            theta_1*Delta box (AffinelyIndependentPoints.jl): the first pick
//            maximizes ||s - x||_inf and is taken unconditionally, each later
//            one maximizes ||Z Z'(s - x)||_inf over the Householder complement
//            Z of the picks and must exceed the pivot theta_pivot*theta_1*Delta;
//   round 2: the same in the theta_2*Delta_max box, warm started from round 1,
//            skipped when nothing is missing or isclose(Delta, Delta_max);
//   round 3: sites along the improving directions (the reversed complement
//            columns), intersected with the box by `absmax`, and the
//            coordinate-axis rebuild when a pivot fails under ensure-fully-linear.
//
// Design: the lane's database rows are streamed from device memory once per
// greedy pick (cap is a runtime bound of any size; only rows below the fill
// count are read). `db.X` is a strided view of the database, so the kernel takes
// the lane and row strides instead of a copy. At most n picks are accepted per
// round, so the picked rows are a list of indices, not a cap-long mask. The n x n
// matrices Y, Z and the Householder Q live in registers (n = 2, 3) or local
// memory (the generic instance, n <= 32, one warp per block so that B=1024
// lanes spread over 32 SMs; sized for n = 32, ~50 KB a thread at float64).
//
// Bound on the H100: per lane the work is a few scans of its valid rows, each
// O(n^2) operations per row, and the bytes are the valid rows read once; both
// give microseconds at B=1024 (chip_smoke.py computes the bound from each run's
// inputs). One thread per lane with a serial chain of scans leaves the kernel
// latency-bound: 1024 lanes fill 8 of 132 SMs.
//
// Semantics kept from the JAX package: the first index of the largest score
// wins (jnp.argmax), a NaN score wins and propagates into the max, unavailable
// rows never score, the Householder sign follows LAPACK (sgn = +1 at x1 = 0,
// beta = 0 when ||v|| = 0), isclose uses rtol 1e-5 and atol 1e-8 in the working
// type.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_N = 32;

template <typename T>
__device__ __forceinline__ T pmax(T a, T b) {
  // jnp.maximum / jnp.max: a NaN operand wins
  return (a > b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T pmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T inf_v() {
  return T(INFINITY);
}

// _crossing_sigmas (ops/geometry.py): step at which x + sigma*d meets b
template <typename T>
__device__ __forceinline__ T crossing(T ax, T b, T ad, bool sense_lb) {
  const T inf = inf_v<T>();
  T tmp = b - ax;
  bool dir_nz = ad != T(0);
  bool tmp_z = tmp == T(0);
  T safe_ad = dir_nz ? ad : T(1);
  T sigma_cross = tmp / safe_ad;
  T onbound = sense_lb ? (ad > T(0) ? inf : T(0)) : (ad < T(0) ? inf : T(0));
  T sigma = tmp_z ? onbound : sigma_cross;
  return (dir_nz || tmp_z) ? sigma : inf;
}

// intersect_box(x, d, lb, ub, "absmax")
template <typename T>
__device__ T intersect_absmax(const T* x, const T* d, const T* lb, const T* ub, int n) {
  const T inf = inf_v<T>();
  T pos = inf, neg = -inf;
  bool any_nonneg = false, any_neg = false, d_zero = true;
  for (int s = 0; s < 2; ++s) {
    for (int i = 0; i < n; ++i) {
      T sig = s == 0 ? crossing(x[i], lb[i], d[i], true) : crossing(x[i], ub[i], d[i], false);
      if (sig >= T(0)) {
        any_nonneg = true;
        pos = pmin(pos, sig);
      } else {
        any_neg = true;
        neg = pmax(neg, sig);
      }
    }
  }
  for (int i = 0; i < n; ++i) d_zero = d_zero && (d[i] == T(0));
  T sp = any_nonneg ? pos : T(0);
  T sn = any_neg ? neg : T(0);
  if (d_zero) sp = sn = inf;
  return fabs(sp) >= fabs(sn) ? sp : sn;
}

// Inf-norm-normalized orthogonal complement of the first k columns of Y
// (householder_q + orthogonal_complement, ops/affine.py). Reflections j >= k
// are identities (beta = 0) and are skipped.
template <typename T, int NA>
__device__ void ortho_complement(const T (&Y)[NA][NA], int k, int n, T (&Z)[NA][NA]) {
  T A[NA][NA], Q[NA][NA], v[NA], w[NA];
  for (int i = 0; i < n; ++i)
    for (int m = 0; m < n; ++m) {
      A[i][m] = Y[i][m];
      Q[i][m] = i == m ? T(1) : T(0);
    }
  for (int j = 0; j < k && j < n; ++j) {
    T norm2 = T(0);
    for (int i = 0; i < n; ++i) {
      v[i] = i >= j ? A[i][j] : T(0);
      norm2 += v[i] * v[i];
    }
    T normx = sqrt(norm2);
    T sgn = A[j][j] >= T(0) ? T(1) : T(-1);
    T alpha = -sgn * normx;
    v[j] = v[j] - alpha;
    T vnorm2 = T(0);
    for (int i = 0; i < n; ++i) vnorm2 += v[i] * v[i];
    if (!(vnorm2 > T(0) && normx > T(0))) continue;
    T beta = T(2) / vnorm2;
    for (int m = 0; m < n; ++m) {
      T s = T(0);
      for (int i = 0; i < n; ++i) s += v[i] * A[i][m];
      w[m] = s;
    }
    for (int i = 0; i < n; ++i)
      for (int m = 0; m < n; ++m) A[i][m] = A[i][m] - beta * (v[i] * w[m]);
    for (int i = 0; i < n; ++i) {
      T s = T(0);
      for (int m = 0; m < n; ++m) s += Q[i][m] * v[m];
      w[i] = s;
    }
    for (int i = 0; i < n; ++i)
      for (int m = 0; m < n; ++m) Q[i][m] = Q[i][m] - beta * (w[i] * v[m]);
  }
  for (int m = 0; m < n; ++m) {
    T nrm = T(0);
    for (int i = 0; i < n; ++i) nrm = pmax(nrm, T(fabs(Q[i][m])));
    T safe = nrm > T(0) ? nrm : T(1);
    for (int i = 0; i < n; ++i) Z[i][m] = Q[i][m] / safe;
  }
}

template <typename T>
struct Lane {
  const T* X;            // this lane's rows: X[r * row_stride + i]
  long long row_stride;
  int rows;              // min(count, cap): rows past the fill count are never candidates
  int x_index;
  int n;
  const T* x;
  const T* lb1;
  const T* ub1;
  const T* lb2;
  const T* ub2;
};

template <typename T>
__device__ __forceinline__ bool in_box(const T* row, const T* lb, const T* ub, int n) {
  bool in = true;
  for (int i = 0; i < n; ++i) in = in && (row[i] >= lb[i]) && (row[i] <= ub[i]);
  return in;
}

// candidate test of round 1 (box 1) or round 2 (box 2 and not box 1)
template <typename T>
__device__ __forceinline__ bool is_cand(const Lane<T>& L, int r, int round) {
  if (r == L.x_index) return false;
  const T* row = L.X + r * L.row_stride;
  bool in1 = in_box(row, L.lb1, L.ub1, L.n);
  if (round == 1) return in1;
  return !in1 && in_box(row, L.lb2, L.ub2, L.n);
}

// affinely_independent_points (ops/affine.py) on a warm-started span (Y, k, Z);
// returns the picks of this call in `order` and their count.
template <typename T, int NA>
__device__ int affine_picks(const Lane<T>& L, int round, T piv, int n_pick,
                            T (&Y)[NA][NA], int& k, T (&Z)[NA][NA], int* order) {
  const int n = L.n;
  int picked = 0;
  for (int it = 0; it < n; ++it) {
    if (picked >= n_pick || k >= n) break;   // no accept possible: no scan
    const bool first = picked == 0;
    int best = 0;
    T best_val = -inf_v<T>();
    bool have_any = false;
    for (int r = 0; r < L.rows; ++r) {
      if (!is_cand(L, r, round)) continue;
      bool taken = false;
      for (int p = 0; p < picked; ++p) taken = taken || (order[p] == r);
      if (taken) continue;
      have_any = true;
      const T* row = L.X + r * L.row_stride;
      T s[NA];
      for (int i = 0; i < n; ++i) s[i] = row[i] - L.x[i];
      T score = T(0);
      if (first) {
        for (int i = 0; i < n; ++i) score = i == 0 ? T(fabs(s[i])) : pmax(score, T(fabs(s[i])));
      } else {
        T proj[NA];
        for (int m = k; m < n; ++m) {
          T acc = T(0);
          for (int c = 0; c < n; ++c) acc += s[c] * Z[c][m];
          proj[m] = acc;
        }
        for (int i = 0; i < n; ++i) {
          T pb = T(0);
          for (int m = k; m < n; ++m) pb += proj[m] * Z[i][m];
          score = i == 0 ? T(fabs(pb)) : pmax(score, T(fabs(pb)));
        }
      }
      if (score > best_val || (score != score && best_val == best_val)) {
        best_val = score;
        best = r;
      }
    }
    bool accept = have_any && (first || best_val > piv);
    if (!accept) break;
    order[picked] = best;
    const T* row = L.X + best * L.row_stride;
    for (int i = 0; i < n; ++i) Y[i][k] = row[i] - L.x[i];
    ++k;
    ++picked;
    ortho_complement<T, NA>(Y, k, n, Z);
  }
  return picked;
}

// one round-3 proposal slot: the site along d and its pivot test
template <typename T, int NA>
__device__ __forceinline__ bool r3_slot(const Lane<T>& L, const T* d, T piv, T* site) {
  T ln = intersect_absmax<T>(L.x, d, L.lb1, L.ub1, L.n);
  T mx = T(0);
  for (int i = 0; i < L.n; ++i) {
    T off = ln * d[i];
    mx = i == 0 ? T(fabs(off)) : pmax(mx, T(fabs(off)));
    site[i] = L.x[i] + off;
  }
  return mx > piv;
}

template <typename T, int NT>
__global__ void rbf_selection_kernel(
    const T* __restrict__ X, long long lane_stride, long long row_stride,
    const int* __restrict__ count, const T* __restrict__ x_s,
    const int* __restrict__ x_index, const T* __restrict__ delta,
    const T* __restrict__ lb_s, const T* __restrict__ ub_s,
    const int* __restrict__ max_new, const unsigned char* __restrict__ efl_in,
    int* __restrict__ r1_idx, int* __restrict__ r1_cnt_out,
    int* __restrict__ r2_idx, int* __restrict__ r2_cnt_out,
    T* __restrict__ sites3, unsigned char* __restrict__ active3,
    int* __restrict__ n_new_out, T* __restrict__ dirs_out,
    int* __restrict__ dirs_count_out, unsigned char* __restrict__ fl_out,
    int B, int cap, int n_rt, double theta_e1, double theta_e2_dmax,
    double theta_pivot, double delta_max, int skip2_same_theta) {
  constexpr int NA = NT ? NT : MAX_N;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = NT ? NT : n_rt;
  const bool efl = efl_in[b] != 0;

  T x[NA], lb1[NA], ub1[NA], lb2[NA], ub2[NA];
  const T dl = delta[b];
  const T delta_1 = T(theta_e1) * dl;
  const T piv1 = T(theta_pivot) * delta_1;
  const T delta_2 = T(theta_e2_dmax);
  for (int i = 0; i < n; ++i) {
    x[i] = x_s[b * n + i];
    const T lo = lb_s[b * n + i], hi = ub_s[b * n + i];
    lb1[i] = pmax(lo, x[i] - delta_1);
    ub1[i] = pmin(hi, x[i] + delta_1);
    lb2[i] = pmax(lo, x[i] - delta_2);
    ub2[i] = pmin(hi, x[i] + delta_2);
  }
  const int cnt = count[b];
  Lane<T> L{X + b * lane_stride, row_stride, cnt < cap ? (cnt > 0 ? cnt : 0) : cap,
            x_index[b], n, x, lb1, ub1, lb2, ub2};

  // ---- round 1
  T Y[NA][NA], Z[NA][NA];
  for (int i = 0; i < n; ++i)
    for (int m = 0; m < n; ++m) Y[i][m] = T(0);
  int k = 0;
  ortho_complement<T, NA>(Y, 0, n, Z);
  int order1[NA];
  for (int i = 0; i < n; ++i) order1[i] = -1;
  const int r1_cnt = affine_picks<T, NA>(L, 1, piv1, n, Y, k, Z, order1);
  const int k1 = k;
  T dirs[NA][NA];
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) dirs[i][j] = Z[j][n - 1 - i];
  const int n_missing1 = n - r1_cnt;

  // ---- round 2 (its picks are reported even where the skip test zeroes the count)
  int order2[NA];
  for (int i = 0; i < n; ++i) order2[i] = -1;
  int r2_cnt = 0;
  bool fl_after2 = true;
  if (!efl) {
    const int r2_picked = affine_picks<T, NA>(L, 2, piv1, n_missing1, Y, k, Z, order2);
    bool skip2 = n_missing1 == 0;
    if (skip2_same_theta) {
      const T dm = T(delta_max);
      const T close_tol = T(1e-8) + T(1e-5) * T(fabs(dm));
      skip2 = skip2 || dl == dm || (isfinite(dm) && T(fabs(dl - dm)) <= close_tol);
    }
    r2_cnt = skip2 ? 0 : r2_picked;
    fl_after2 = skip2;
  }
  const int n_missing2 = n_missing1 - r2_cnt;

  // ---- round 3
  const int mn = max_new[b] > 0 ? max_new[b] : 0;
  int n_new = n_missing2 > 0 ? n_missing2 : 0;
  n_new = n_new < mn ? n_new : mn;
  T s3[NA][NA];
  bool ok3[NA];
  bool fail3 = false;
  for (int i = 0; i < n; ++i) {
    ok3[i] = r3_slot<T, NA>(L, dirs[i], piv1, s3[i]);
    fail3 = fail3 || (i < n_new && !ok3[i]);
  }
  bool covers = n_new >= n_missing2;
  int r1c = r1_cnt, dirs_count = n - k1;
  const bool rebuild = efl && fail3;
  if (rebuild) {
    // coordinate-axis rebuild (RbfModel.jl:564-570, :633)
    r1c = 0;
    r2_cnt = 0;
    n_new = n < mn ? n : mn;
    covers = n_new >= n;
    dirs_count = n;
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) dirs[i][j] = i == j ? T(1) : T(0);
      ok3[i] = r3_slot<T, NA>(L, dirs[i], piv1, s3[i]);
    }
  }
  bool all_ok = true;
  for (int i = 0; i < n; ++i) all_ok = all_ok && (ok3[i] || !(i < n_new));
  const bool round3_ran = rebuild || n_missing2 > 0;
  const bool fl = (round3_ran && covers && all_ok && r2_cnt == 0) || (!round3_ran && fl_after2);

  for (int i = 0; i < n; ++i) {
    r1_idx[b * n + i] = order1[i];
    r2_idx[b * n + i] = efl ? -1 : order2[i];
    active3[b * n + i] = i < n_new ? 1 : 0;
    for (int j = 0; j < n; ++j) {
      sites3[(b * n + i) * n + j] = s3[i][j];
      dirs_out[(b * n + i) * n + j] = dirs[i][j];
    }
  }
  r1_cnt_out[b] = r1c;
  r2_cnt_out[b] = r2_cnt;
  n_new_out[b] = n_new;
  dirs_count_out[b] = dirs_count;
  fl_out[b] = fl ? 1 : 0;
}

// ---- launch

template <typename T>
int launch(const T* X, long long lane_stride, long long row_stride, const int* count,
           const T* x_s, const int* x_index, const T* delta, const T* lb, const T* ub,
           const int* max_new, const unsigned char* efl, int* r1_idx, int* r1_cnt,
           int* r2_idx, int* r2_cnt, T* sites3, unsigned char* active3, int* n_new,
           T* dirs, int* dirs_count, unsigned char* fl, int B, int cap, int n,
           double theta_e1, double theta_e2_dmax, double theta_pivot, double delta_max,
           int skip2_same_theta, void* stream) {
  if (B <= 0) return 0;
  const int threads = (n == 2 || n == 3) ? 128 : 32;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MORBIT_SEL_ARGS                                                              \
  X, lane_stride, row_stride, count, x_s, x_index, delta, lb, ub, max_new, efl,      \
      r1_idx, r1_cnt, r2_idx, r2_cnt, sites3, active3, n_new, dirs, dirs_count, fl, \
      B, cap, n, theta_e1, theta_e2_dmax, theta_pivot, delta_max, skip2_same_theta
  if (n == 2)
    rbf_selection_kernel<T, 2><<<blocks, threads, 0, s>>>(MORBIT_SEL_ARGS);
  else if (n == 3)
    rbf_selection_kernel<T, 3><<<blocks, threads, 0, s>>>(MORBIT_SEL_ARGS);
  else if (n >= 1 && n <= MAX_N)
    rbf_selection_kernel<T, 0><<<blocks, threads, 0, s>>>(MORBIT_SEL_ARGS);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef MORBIT_SEL_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MORBIT_SEL_EXPORT(NAME, T)                                                    \
  extern "C" int NAME(const T* X, long long lane_stride, long long row_stride,        \
                      const int* count, const T* x_s, const int* x_index,             \
                      const T* delta, const T* lb, const T* ub, const int* max_new,   \
                      const unsigned char* efl, int* r1_idx, int* r1_cnt,             \
                      int* r2_idx, int* r2_cnt, T* sites3, unsigned char* active3,    \
                      int* n_new, T* dirs, int* dirs_count, unsigned char* fl, int B, \
                      int cap, int n, double theta_e1, double theta_e2_dmax,          \
                      double theta_pivot, double delta_max, int skip2_same_theta,     \
                      void* stream) {                                                 \
    return launch<T>(X, lane_stride, row_stride, count, x_s, x_index, delta, lb, ub,  \
                     max_new, efl, r1_idx, r1_cnt, r2_idx, r2_cnt, sites3, active3,   \
                     n_new, dirs, dirs_count, fl, B, cap, n, theta_e1, theta_e2_dmax, \
                     theta_pivot, delta_max, skip2_same_theta, stream);               \
  }

MORBIT_SEL_EXPORT(rbf_selection_f32, float)
MORBIT_SEL_EXPORT(rbf_selection_f64, double)
