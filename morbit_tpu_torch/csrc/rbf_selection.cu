// K2: RBF training-site rounds 1-3.
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
// `db.X` is a strided view of the database, so the kernel takes the lane and
// row strides instead of a copy; only rows below the fill count are read.
// Two designs:
//
// * Register instances (n = 2, 3: the main paths), one thread per lane: the
//   lane's rows are streamed once per greedy pick and Y, Z and the
//   Householder Q live in registers.
// * The block instance (every other n <= 32; n = 20 on the wide ZDT path),
//   one block of kBlockThreads threads per lane, its state in dynamic shared
//   memory (block_layout; the wrapper computes the same size). Each round
//   first compacts its candidates (the box tests and r != x_index, once per
//   round) into a list in row order, in a workspace the wrapper allocates,
//   and stages the offsets s = row - x of the first stage_rows of them in
//   shared memory; the rest are read from the database in each scan. A scan
//   strides the list over the threads; a taken row is marked in the list.
//   Each row's score is one thread's sums in the twin's order (proj[m] over
//   c, then pb_i over m >= k, then the inf-norm in i order), reading the
//   complement, stored by rows and by columns, with 16-byte broadcast loads. The argmax
//   is a block reduction under a total order: the larger score wins, equal
//   scores go to the lower row, a NaN beats every number and the lowest NaN
//   wins. That is the order of jnp.argmax and of a sequential scan, so the
//   winner does not depend on how the rows fall to threads. After a pick,
//   one warp updates the complement incrementally: the new column takes the
//   earlier reflections, then its own reflection updates Q (thread i owns
//   row i) and Z = Q with inf-normalized columns. A from-scratch rebuild
//   would repeat the earlier reflections on unchanged columns, so both give
//   the same bits. Round 3 runs one direction per thread. The build has no
//   multiply-add contraction (prepare_fused.NO_FMA), so every operation
//   rounds as in the twin and the outputs equal the twin's to the bit.
// * The wide instance (every n > 32; n = 50 on the 50-variable ZDT path):
//   the block instance's design and arithmetic without its per-thread
//   arrays of MAX_N and its warp-wide complement update (see
//   rbf_selection_wide_kernel below); its matrices in shared memory or, past
//   a block's, in a workspace. The wrapper plans the instance at every n.
//
// Bound on the H100: per lane the work is a few scans of its candidate rows,
// each O(n^2) operations per row, and the bytes are the valid rows read once;
// both give microseconds at B=1024 (chip_smoke.py computes the bound from each
// run's inputs). The block instance is bound by the shared-memory broadcasts
// of the complement in the scans and by the serial chain of picks (one block
// reduction and one warp's complement update per pick).
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
    int B, int cap, double theta_e1, double theta_e2_dmax,
    double theta_pivot, double delta_max, int skip2_same_theta) {
  constexpr int NA = NT;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  constexpr int n = NT;
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

// ================================================== block-per-lane instance

constexpr int kBlockThreads = 128;
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kNoPos = 0x7fffffff;      // no candidate seen
constexpr int kMaxSmemBytes = 232448;   // 227 KB, the H100's per-block limit
constexpr unsigned kFull = 0xffffffffu;

// 16-byte vectors for the broadcast loads of the complement and the staged rows
template <typename T> struct Vec;
template <> struct Vec<float> { typedef float4 type; static constexpr int N = 4; };
template <> struct Vec<double> { typedef double2 type; static constexpr int N = 2; };
__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ double comp(const double2& v, int e) { return e == 0 ? v.x : v.y; }

// Shared-memory layout of one lane (block), offsets in elements: the working
// type's arrays first (16-byte aligned where read as vectors), then ints.
// Z is the complement by rows and ZT by columns (row m = column m of Z), D
// the round-3 directions, Q and V the Householder Q and reflection vectors
// (rows padded to an odd stride: thread i walks row i).
struct BlockLayout {
  int ldq, ldz;
  int Z, ZT, stage, D, x, lb1, ub1, lb2, ub2, safe, beta, Q, V, red_v, t_total;
  int order1, order2, act, red_p, wcount, i_total;
  long long bytes;
};

__host__ __device__ inline BlockLayout block_layout(int n, int stage_rows, int item) {
  BlockLayout L;
  const int vec = 16 / item;
  L.ldq = n | 1;
  L.ldz = (n + vec - 1) / vec * vec;
  int o = 0;
  L.Z = o;     o += n * L.ldz;
  L.ZT = o;    o += n * L.ldz;
  L.stage = o; o += stage_rows * L.ldz;
  L.D = o;     o += n * L.ldz;
  L.x = o;     o += L.ldz;
  L.lb1 = o;   o += L.ldz;
  L.ub1 = o;   o += L.ldz;
  L.lb2 = o;   o += L.ldz;
  L.ub2 = o;   o += L.ldz;
  L.safe = o;  o += L.ldz;
  L.beta = o;  o += L.ldz;
  L.Q = o;     o += n * L.ldq;
  L.V = o;     o += n * L.ldq;
  L.red_v = o; o += kBlockWarps;
  L.t_total = o;
  int p = 0;
  L.order1 = p; p += MAX_N;
  L.order2 = p; p += MAX_N;
  L.act = p;    p += MAX_N;
  L.red_p = p;  p += kBlockWarps;
  L.wcount = p; p += kBlockWarps;
  L.i_total = p;
  L.bytes = (long long)o * item + (long long)p * 4;
  return L;
}

// a beats b under the total order of jnp.argmax (see the note at the top)
template <typename T>
__device__ __forceinline__ bool beats(T va, int pa, T vb, int pb) {
  const bool na = va != va, nb = vb != vb;
  if (na || nb) return na && (!nb || pa < pb);
  return va > vb || (va == vb && pa < pb);
}

template <typename T>
struct BlockLane {
  const T* X;            // this lane's rows: X[r * row_stride + i]
  long long row_stride;
  int rows, x_index, n, stage_rows, ldq, ldz;
  int* list;             // this lane's candidate list (workspace, cap entries)
  T *Z, *ZT, *stage, *D, *x, *lb1, *ub1, *lb2, *ub2, *safe, *beta, *Q, *V, *red_v;
  int *act, *red_p, *wcount;
};

// The round's candidates (round 1: box 1; round 2: box 2 and not box 1; never
// the center row) into c.list in row order, the offsets of the first
// stage_rows of them into c.stage. Returns their count.
template <typename T>
__device__ int compact(const BlockLane<T>& c, int round) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // earlier scans are done with the list and the stage
  int base = 0;
  for (int r0 = 0; r0 < c.rows; r0 += kBlockThreads) {
    const int r = r0 + tid;
    const T* row = c.X + (long long)r * c.row_stride;
    bool cand = false;
    if (r < c.rows && r != c.x_index) {
      const bool in1 = in_box(row, c.lb1, c.ub1, c.n);
      cand = round == 1 ? in1 : (!in1 && in_box(row, c.lb2, c.ub2, c.n));
    }
    const unsigned bal = __ballot_sync(kFull, cand);
    if (lane == 0) c.wcount[warp] = __popc(bal);
    __syncthreads();
    int off = base, total = 0;
    for (int w = 0; w < kBlockWarps; ++w) {
      if (w < warp) off += c.wcount[w];
      total += c.wcount[w];
    }
    off += __popc(bal & ((1u << lane) - 1u));
    if (cand) {
      c.list[off] = r;
      if (off < c.stage_rows) {
        T* st = c.stage + (long long)off * c.ldz;
        for (int i = 0; i < c.n; ++i) st[i] = row[i] - c.x[i];
      }
    }
    base += total;
    __syncthreads();  // wcount is rewritten by the next chunk
  }
  return base;
}

// Score of one candidate: ||s||_inf for a call's first pick, else
// ||Z Z'_{m>=k} s||_inf, each sum in the twin's order: proj[m] over c for
// m >= k (ZT's row m), then pb_i over m (Z's row i) from the 16-byte block
// that holds m = k. Its terms below k are +0 * Z[i][m], which leave a sum
// that starts at +0 as it is, so pb_i keeps the twin's bits.
template <typename T>
__device__ __forceinline__ T block_score(const T (&s)[MAX_N], const T* Z, const T* ZT,
                                         int ldz, int n, int k, bool first) {
  typedef typename Vec<T>::type VT;
  constexpr int VN = Vec<T>::N;
  if (first) {
    T sc = T(fabs(s[0]));
#pragma unroll
    for (int i = 1; i < MAX_N; ++i)
      if (i < n) sc = pmax(sc, T(fabs(s[i])));
    return sc;
  }
  T proj[MAX_N];
#pragma unroll
  for (int m = 0; m < MAX_N; ++m) {
    proj[m] = T(0);
    if (m >= k && m < n) {
      T acc = T(0);
#pragma unroll
      for (int c0 = 0; c0 < MAX_N; c0 += VN) {
        if (c0 < n) {
          const VT z = *reinterpret_cast<const VT*>(ZT + m * ldz + c0);
#pragma unroll
          for (int e = 0; e < VN; ++e)
            if (c0 + e < n) acc = acc + s[c0 + e] * comp(z, e);
        }
      }
      proj[m] = acc;
    }
  }
  // rows i one at a time (a rolled loop): only proj stays in registers
  T sc = T(0);
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const T* Zi = Z + i * ldz;
    T pb = T(0);
#pragma unroll
    for (int m0 = 0; m0 < MAX_N; m0 += VN) {
      if (m0 + VN > k && m0 < n) {
        const VT z = *reinterpret_cast<const VT*>(Zi + m0);
#pragma unroll
        for (int e = 0; e < VN; ++e)
          if (m0 + e < n) pb = pb + proj[m0 + e] * comp(z, e);
      }
    }
    sc = i == 0 ? T(fabs(pb)) : pmax(sc, T(fabs(pb)));
  }
  return sc;
}

// One warp: add column k_old (the picked row minus x) to the span. The
// column takes the earlier reflections in order, its own reflection updates
// Q, and ZT becomes Q with inf-normalized columns (ortho_complement's
// arithmetic, thread i on row i).
template <typename T>
__device__ void complement_add(const BlockLane<T>& c, int row, int k_old) {
  const int i = threadIdx.x & 31, n = c.n, ldq = c.ldq;
  const T* xr = c.X + (long long)row * c.row_stride;
  T a = i < n ? xr[i] - c.x[i] : T(0);
  for (int j = 0; j < k_old; ++j) {
    if (!c.act[j]) continue;
    const T* v = c.V + j * ldq;
    T w = T(0);
    for (int ii = 0; ii < n; ++ii) w = w + v[ii] * __shfl_sync(kFull, a, ii);
    if (i < n) a = a - c.beta[j] * (v[i] * w);
  }
  const int j = k_old;
  const T xi = (i >= j && i < n) ? a : T(0);
  T norm2 = T(0);
  for (int ii = 0; ii < n; ++ii) {
    const T xv = __shfl_sync(kFull, xi, ii);
    norm2 = norm2 + xv * xv;
  }
  const T normx = sqrt(norm2);
  const T sgn = __shfl_sync(kFull, a, j) >= T(0) ? T(1) : T(-1);
  const T alpha = -sgn * normx;
  const T vi = i == j ? xi - alpha : xi;
  T vnorm2 = T(0);
  for (int ii = 0; ii < n; ++ii) {
    const T vv = __shfl_sync(kFull, vi, ii);
    vnorm2 = vnorm2 + vv * vv;
  }
  const bool active = vnorm2 > T(0) && normx > T(0);
  if (i < n) c.V[j * ldq + i] = vi;
  if (i == 0) c.act[j] = active ? 1 : 0;
  if (active) {
    const T beta = T(2) / vnorm2;
    if (i == 0) c.beta[j] = beta;
    T* Qi = c.Q + (i < n ? i : 0) * ldq;
    T qv = T(0);
    for (int m = 0; m < n; ++m) qv = qv + Qi[m] * __shfl_sync(kFull, vi, m);
    for (int m = 0; m < n; ++m) {
      const T vm = __shfl_sync(kFull, vi, m);
      if (i < n) Qi[m] = Qi[m] - beta * (qv * vm);
    }
  }
  __syncwarp();
  if (i < n) {
    T nrm = T(0);
    for (int ii = 0; ii < n; ++ii) nrm = pmax(nrm, T(fabs(c.Q[ii * ldq + i])));
    c.safe[i] = nrm > T(0) ? nrm : T(1);
  }
  __syncwarp();
  if (i < n) {
    for (int m = 0; m < n; ++m) {
      const T zim = c.Q[i * ldq + m] / c.safe[m];
      c.Z[i * c.ldz + m] = zim;
      c.ZT[m * c.ldz + i] = zim;
    }
  }
}

// affinely_independent_points (ops/affine.py) on the warm-started span in
// shared memory; returns the picks of this call in `order` and their count.
template <typename T>
__device__ int block_picks(const BlockLane<T>& c, int round, T piv, int n_pick,
                           int& k, int* order) {
  typedef typename Vec<T>::type VT;
  constexpr int VN = Vec<T>::N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n = c.n;
  if (n_pick <= 0 || k >= n) return 0;   // no accept possible: no scan
  const int ncand = compact(c, round);
  int picked = 0;
  for (int it = 0; it < n; ++it) {
    if (picked >= n_pick || k >= n) break;
    const bool first = picked == 0;
    T bv = -inf_v<T>();
    int bp = kNoPos;
    for (int p = tid; p < ncand; p += kBlockThreads) {
      const int r = c.list[p];
      if (r < 0) continue;  // taken
      T s[MAX_N];
      if (p < c.stage_rows) {
        const T* st = c.stage + (long long)p * c.ldz;
#pragma unroll
        for (int c0 = 0; c0 < MAX_N; c0 += VN) {
          if (c0 < n) {
            const VT v = *reinterpret_cast<const VT*>(st + c0);
#pragma unroll
            for (int e = 0; e < VN; ++e) s[c0 + e] = comp(v, e);
          }
        }
      } else {
        const T* row = c.X + (long long)r * c.row_stride;
#pragma unroll
        for (int i = 0; i < MAX_N; ++i)
          if (i < n) s[i] = row[i] - c.x[i];
      }
      const T sc = block_score<T>(s, c.Z, c.ZT, c.ldz, n, k, first);
      if (beats(sc, p, bv, bp)) {
        bv = sc;
        bp = p;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_xor_sync(kFull, bv, off);
      const int op = __shfl_xor_sync(kFull, bp, off);
      if (beats(ov, op, bv, bp)) {
        bv = ov;
        bp = op;
      }
    }
    if (lane == 0) {
      c.red_v[warp] = bv;
      c.red_p[warp] = bp;
    }
    __syncthreads();
    bv = c.red_v[0];
    bp = c.red_p[0];
    for (int w = 1; w < kBlockWarps; ++w) {
      if (beats(c.red_v[w], c.red_p[w], bv, bp)) {
        bv = c.red_v[w];
        bp = c.red_p[w];
      }
    }
    const bool accept = bp != kNoPos && (first || bv > piv);
    if (!accept) break;
    if (warp == 0) {
      const int row = c.list[bp];
      __syncwarp();
      if (lane == 0) {
        order[picked] = row;
        c.list[bp] = -1;
      }
      complement_add<T>(c, row, k);
    }
    ++k;
    ++picked;
    __syncthreads();  // the new complement and the mark before the next scan
  }
  return picked;
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
rbf_selection_block_kernel(
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
    int* work, int cap, int n, int stage_rows, double theta_e1,
    double theta_e2_dmax, double theta_pivot, double delta_max,
    int skip2_same_theta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const BlockLayout Ly = block_layout(n, stage_rows, (int)sizeof(T));
  T* sm = reinterpret_cast<T*>(smem_raw);
  int* si = reinterpret_cast<int*>(smem_raw + (long long)Ly.t_total * sizeof(T));
  const int cnt = count[b];
  BlockLane<T> c;
  c.X = X + b * lane_stride;
  c.row_stride = row_stride;
  c.rows = cnt < cap ? (cnt > 0 ? cnt : 0) : cap;
  c.x_index = x_index[b];
  c.n = n;
  c.stage_rows = stage_rows;
  c.ldq = Ly.ldq;
  c.ldz = Ly.ldz;
  c.list = work + (long long)b * cap;
  c.Z = sm + Ly.Z; c.ZT = sm + Ly.ZT; c.stage = sm + Ly.stage; c.D = sm + Ly.D; c.x = sm + Ly.x;
  c.lb1 = sm + Ly.lb1; c.ub1 = sm + Ly.ub1; c.lb2 = sm + Ly.lb2; c.ub2 = sm + Ly.ub2;
  c.safe = sm + Ly.safe; c.beta = sm + Ly.beta; c.Q = sm + Ly.Q; c.V = sm + Ly.V;
  c.red_v = sm + Ly.red_v;
  c.act = si + Ly.act; c.red_p = si + Ly.red_p; c.wcount = si + Ly.wcount;
  int* order1 = si + Ly.order1;
  int* order2 = si + Ly.order2;

  const bool efl = efl_in[b] != 0;
  const T dl = delta[b];
  const T delta_1 = T(theta_e1) * dl;
  const T piv1 = T(theta_pivot) * delta_1;
  const T delta_2 = T(theta_e2_dmax);
  if (tid < n) {
    const T xi = x_s[b * n + tid];
    const T lo = lb_s[b * n + tid], hi = ub_s[b * n + tid];
    c.x[tid] = xi;
    c.lb1[tid] = pmax(lo, xi - delta_1);
    c.ub1[tid] = pmin(hi, xi + delta_1);
    c.lb2[tid] = pmax(lo, xi - delta_2);
    c.ub2[tid] = pmin(hi, xi + delta_2);
  }
  for (int e = tid; e < n * n; e += kBlockThreads) {
    const int i = e / n, m = e - (e / n) * n;
    c.Q[i * c.ldq + m] = i == m ? T(1) : T(0);
    c.Z[i * c.ldz + m] = i == m ? T(1) : T(0);
    c.ZT[i * c.ldz + m] = i == m ? T(1) : T(0);
  }
  if (tid < MAX_N) {
    order1[tid] = -1;
    order2[tid] = -1;
  }
  __syncthreads();

  // ---- round 1
  int k = 0;
  const int r1_cnt = block_picks<T>(c, 1, piv1, n, k, order1);
  const int k1 = k;
  // directions: the reversed complement columns, row i = column n-1-i of Z
  if (warp == 0 && lane < n)
    for (int j = 0; j < n; ++j) c.D[lane * c.ldz + j] = c.ZT[(n - 1 - lane) * c.ldz + j];
  const int n_missing1 = n - r1_cnt;

  // ---- round 2 (its picks are reported even where the skip test zeroes the count)
  int r2_cnt = 0;
  bool fl_after2 = true;
  if (!efl) {
    const int r2_picked = block_picks<T>(c, 2, piv1, n_missing1, k, order2);
    bool skip2 = n_missing1 == 0;
    if (skip2_same_theta) {
      const T dm = T(delta_max);
      const T close_tol = T(1e-8) + T(1e-5) * T(fabs(dm));
      skip2 = skip2 || dl == dm || (isfinite(dm) && T(fabs(dl - dm)) <= close_tol);
    }
    r2_cnt = skip2 ? 0 : r2_picked;
    fl_after2 = skip2;
  }
  __syncthreads();
  if (warp != 0) return;

  // ---- round 3, one direction per thread of warp 0
  const int i = lane;
  const int n_missing2 = n_missing1 - r2_cnt;
  const int mn = max_new[b] > 0 ? max_new[b] : 0;
  int n_new = n_missing2 > 0 ? n_missing2 : 0;
  n_new = n_new < mn ? n_new : mn;
  Lane<T> L{c.X, row_stride, c.rows, c.x_index, n, c.x, c.lb1, c.ub1, c.lb2, c.ub2};
  T* Di = c.D + (i < n ? i : 0) * c.ldz;
  T* site = sites3 + ((long long)b * n + (i < n ? i : 0)) * n;  // written in place
  bool ok3 = i < n ? r3_slot<T, MAX_N>(L, Di, piv1, site) : true;
  const bool fail3 = __any_sync(kFull, i < n && i < n_new && !ok3);
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
    if (i < n) {
      for (int j = 0; j < n; ++j) Di[j] = i == j ? T(1) : T(0);
      ok3 = r3_slot<T, MAX_N>(L, Di, piv1, site);
    }
  }
  const bool all_ok = __all_sync(kFull, i >= n || ok3 || !(i < n_new));
  const bool round3_ran = rebuild || n_missing2 > 0;
  const bool fl = (round3_ran && covers && all_ok && r2_cnt == 0) || (!round3_ran && fl_after2);

  if (i < n) {
    r1_idx[b * n + i] = order1[i];
    r2_idx[b * n + i] = efl ? -1 : order2[i];
    active3[b * n + i] = i < n_new ? 1 : 0;
    for (int j = 0; j < n; ++j) dirs_out[(b * n + i) * n + j] = Di[j];
  }
  if (i == 0) {
    r1_cnt_out[b] = r1c;
    r2_cnt_out[b] = r2_cnt;
    n_new_out[b] = n_new;
    dirs_count_out[b] = dirs_count;
    fl_out[b] = fl ? 1 : 0;
  }
}

// ============================================ wide instance (n > MAX_N)

// One block of kBlockThreads threads per lane, as the block instance, for
// every n the block instance's per-thread arrays and warp-wide complement
// update do not take. The phases and every sum are the block instance's:
// a candidate's score reads its offsets from the stage or the database
// (s_i = row_i - x_i, rounded as the stage rounds it) and keeps proj in a
// per-thread column of the `proj` array (proj[m] at m * kBlockThreads +
// thread); the complement update runs over the whole block, thread i on
// rows i (mod kBlockThreads), the picked column in `acol`; round 3 takes
// one direction per thread the same way. The matrices (Z, ZT, D, Q, V and
// proj) sit in shared memory behind the vectors (place 0) or, where they do
// not fit, in a workspace of `mat` elements a lane (place 1); at place 2 the
// vectors and ints follow them there (no shared memory).
struct WideSelLayout {
  int ldq, ldz;
  long long Z, ZT, D, Q, V, proj, mat;  // matrix offsets, and a lane's matrix elements
  int stage, x, lb1, ub1, lb2, ub2, safe, beta, acol, red_v, mat_at, t_total;
  int order1, order2, act, red_p, wcount, i_total;
  long long bytes;  // the vectors' and ints' bytes, with the matrices' at place 0
  long long work;   // a lane's workspace elements
};

__host__ __device__ inline WideSelLayout wide_sel_layout(int n, int stage_rows, int item,
                                                         int place) {
  WideSelLayout L;
  const int vec = 16 / item;
  L.ldq = n | 1;
  L.ldz = (n + vec - 1) / vec * vec;
  long long m = 0;
  L.Z = m;    m += (long long)n * L.ldz;
  L.ZT = m;   m += (long long)n * L.ldz;
  L.D = m;    m += (long long)n * L.ldz;
  L.Q = m;    m += (long long)n * L.ldq;
  L.V = m;    m += (long long)n * L.ldq;
  L.proj = m; m += (long long)n * kBlockThreads;
  L.mat = (m + vec - 1) / vec * vec;
  int o = 0;
  L.stage = o; o += stage_rows * L.ldz;
  L.x = o;     o += L.ldz;
  L.lb1 = o;   o += L.ldz;
  L.ub1 = o;   o += L.ldz;
  L.lb2 = o;   o += L.ldz;
  L.ub2 = o;   o += L.ldz;
  L.safe = o;  o += L.ldz;
  L.beta = o;  o += L.ldz;
  L.acol = o;  o += L.ldz;
  L.red_v = o; o += (kBlockWarps + vec - 1) / vec * vec;
  L.mat_at = o;
  if (place == 0) o += (int)L.mat;
  L.t_total = o;
  int p = 0;
  L.order1 = p; p += n;
  L.order2 = p; p += n;
  L.act = p;    p += n;
  L.red_p = p;  p += kBlockWarps;
  L.wcount = p; p += kBlockWarps;
  L.i_total = p;
  L.bytes = (long long)o * item + (long long)p * 4;
  L.work = place == 0 ? 0 : L.mat + (place == 2 ? (L.bytes + item - 1) / item : 0);
  return L;
}

template <typename T>
struct WideLane : BlockLane<T> {
  T* acol;   // the picked column during a complement update
  T* proj;   // proj[m * kBlockThreads + thread]
};

// block_score's arithmetic for any n (see there)
template <typename T>
__device__ T wide_score(const WideLane<T>& c, int p, int r, int k, bool first) {
  constexpr int VN = Vec<T>::N;
  const int n = c.n, ldz = c.ldz;
  const T* st = p < c.stage_rows ? c.stage + (long long)p * ldz : nullptr;
  const T* row = c.X + (long long)r * c.row_stride;
  if (first) {
    T sc = T(fabs(st ? st[0] : row[0] - c.x[0]));
    for (int i = 1; i < n; ++i) sc = pmax(sc, T(fabs(st ? st[i] : row[i] - c.x[i])));
    return sc;
  }
  T* pj = c.proj + threadIdx.x;
  for (int m = k; m < n; ++m) {
    const T* zt = c.ZT + (long long)m * ldz;
    T acc = T(0);
    if (st) {
      for (int cc = 0; cc < n; ++cc) acc = acc + st[cc] * zt[cc];
    } else {
      for (int cc = 0; cc < n; ++cc) acc = acc + (row[cc] - c.x[cc]) * zt[cc];
    }
    pj[(long long)m * kBlockThreads] = acc;
  }
  // pb_i from the 16-byte block that holds m = k, proj = +0 below k
  const int m0 = k / VN * VN;
  T sc = T(0);
  for (int i = 0; i < n; ++i) {
    const T* Zi = c.Z + (long long)i * ldz;
    T pb = T(0);
    for (int m = m0; m < n; ++m)
      pb = pb + (m >= k ? pj[(long long)m * kBlockThreads] : T(0)) * Zi[m];
    sc = i == 0 ? T(fabs(pb)) : pmax(sc, T(fabs(pb)));
  }
  return sc;
}

// complement_add's arithmetic over the whole block (see there)
template <typename T>
__device__ void wide_complement_add(const WideLane<T>& c, int row, int k_old) {
  const int tid = threadIdx.x, n = c.n, ldq = c.ldq;
  const T* xr = c.X + (long long)row * c.row_stride;
  T* a = c.acol;
  for (int i = tid; i < n; i += kBlockThreads) a[i] = xr[i] - c.x[i];
  __syncthreads();
  for (int j = 0; j < k_old; ++j) {
    if (!c.act[j]) continue;
    const T* v = c.V + (long long)j * ldq;
    T w = T(0);
    for (int ii = 0; ii < n; ++ii) w = w + v[ii] * a[ii];
    __syncthreads();  // every thread has its w before a changes
    for (int i = tid; i < n; i += kBlockThreads) a[i] = a[i] - c.beta[j] * (v[i] * w);
    __syncthreads();
  }
  const int j = k_old;
  T norm2 = T(0);
  for (int ii = 0; ii < n; ++ii) {
    const T xv = ii >= j ? a[ii] : T(0);
    norm2 = norm2 + xv * xv;
  }
  const T normx = sqrt(norm2);
  const T sgn = a[j] >= T(0) ? T(1) : T(-1);
  const T alpha = -sgn * normx;
  T vnorm2 = T(0);
  for (int ii = 0; ii < n; ++ii) {
    const T xv = ii >= j ? a[ii] : T(0);
    const T vv = ii == j ? xv - alpha : xv;
    vnorm2 = vnorm2 + vv * vv;
  }
  const bool active = vnorm2 > T(0) && normx > T(0);
  T* Vj = c.V + (long long)j * ldq;
  for (int i = tid; i < n; i += kBlockThreads) {
    const T xi = i >= j ? a[i] : T(0);
    Vj[i] = i == j ? xi - alpha : xi;
  }
  const T beta = T(2) / vnorm2;
  if (tid == 0) {
    c.act[j] = active ? 1 : 0;
    if (active) c.beta[j] = beta;
  }
  __syncthreads();  // the reflection is written
  if (active) {
    for (int i = tid; i < n; i += kBlockThreads) {
      T* Qi = c.Q + (long long)i * ldq;
      T qv = T(0);
      for (int m = 0; m < n; ++m) qv = qv + Qi[m] * Vj[m];
      for (int m = 0; m < n; ++m) Qi[m] = Qi[m] - beta * (qv * Vj[m]);
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += kBlockThreads) {
    T nrm = T(0);
    for (int ii = 0; ii < n; ++ii) nrm = pmax(nrm, T(fabs(c.Q[(long long)ii * ldq + i])));
    c.safe[i] = nrm > T(0) ? nrm : T(1);
  }
  __syncthreads();
  for (int i = tid; i < n; i += kBlockThreads) {
    for (int m = 0; m < n; ++m) {
      const T zim = c.Q[(long long)i * ldq + m] / c.safe[m];
      c.Z[(long long)i * c.ldz + m] = zim;
      c.ZT[(long long)m * c.ldz + i] = zim;
    }
  }
}

// block_picks for the wide instance
template <typename T>
__device__ int wide_picks(const WideLane<T>& c, int round, T piv, int n_pick, int& k,
                          int* order) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n = c.n;
  if (n_pick <= 0 || k >= n) return 0;   // no accept possible: no scan
  const int ncand = compact(c, round);
  int picked = 0;
  for (int it = 0; it < n; ++it) {
    if (picked >= n_pick || k >= n) break;
    const bool first = picked == 0;
    T bv = -inf_v<T>();
    int bp = kNoPos;
    for (int p = tid; p < ncand; p += kBlockThreads) {
      const int r = c.list[p];
      if (r < 0) continue;  // taken
      const T sc = wide_score<T>(c, p, r, k, first);
      if (beats(sc, p, bv, bp)) {
        bv = sc;
        bp = p;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_xor_sync(kFull, bv, off);
      const int op = __shfl_xor_sync(kFull, bp, off);
      if (beats(ov, op, bv, bp)) {
        bv = ov;
        bp = op;
      }
    }
    if (lane == 0) {
      c.red_v[warp] = bv;
      c.red_p[warp] = bp;
    }
    __syncthreads();
    bv = c.red_v[0];
    bp = c.red_p[0];
    for (int w = 1; w < kBlockWarps; ++w) {
      if (beats(c.red_v[w], c.red_p[w], bv, bp)) {
        bv = c.red_v[w];
        bp = c.red_p[w];
      }
    }
    const bool accept = bp != kNoPos && (first || bv > piv);
    if (!accept) break;
    const int row = c.list[bp];
    __syncthreads();  // every thread has read the winner's row
    if (tid == 0) {
      order[picked] = row;
      c.list[bp] = -1;
    }
    wide_complement_add<T>(c, row, k);
    ++k;
    ++picked;
    __syncthreads();  // the new complement and the mark before the next scan
  }
  return picked;
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
rbf_selection_wide_kernel(
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
    int* work, int cap, int n, int stage_rows, int place, T* mat_work,
    double theta_e1, double theta_e2_dmax, double theta_pivot, double delta_max,
    int skip2_same_theta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const WideSelLayout Ly = wide_sel_layout(n, stage_rows, (int)sizeof(T), place);
  T* lw = mat_work + (long long)b * Ly.work;   // this lane's workspace (place > 0)
  T* sm = place == 2 ? lw + Ly.mat : reinterpret_cast<T*>(smem_raw);
  int* si = reinterpret_cast<int*>(sm + Ly.t_total);
  T* mat = place == 0 ? sm + Ly.mat_at : lw;
  const int cnt = count[b];
  WideLane<T> c;
  c.X = X + b * lane_stride;
  c.row_stride = row_stride;
  c.rows = cnt < cap ? (cnt > 0 ? cnt : 0) : cap;
  c.x_index = x_index[b];
  c.n = n;
  c.stage_rows = stage_rows;
  c.ldq = Ly.ldq;
  c.ldz = Ly.ldz;
  c.list = work + (long long)b * cap;
  c.Z = mat + Ly.Z; c.ZT = mat + Ly.ZT; c.D = mat + Ly.D; c.Q = mat + Ly.Q; c.V = mat + Ly.V;
  c.proj = mat + Ly.proj;
  c.stage = sm + Ly.stage; c.x = sm + Ly.x;
  c.lb1 = sm + Ly.lb1; c.ub1 = sm + Ly.ub1; c.lb2 = sm + Ly.lb2; c.ub2 = sm + Ly.ub2;
  c.safe = sm + Ly.safe; c.beta = sm + Ly.beta; c.acol = sm + Ly.acol;
  c.red_v = sm + Ly.red_v;
  c.act = si + Ly.act; c.red_p = si + Ly.red_p; c.wcount = si + Ly.wcount;
  int* order1 = si + Ly.order1;
  int* order2 = si + Ly.order2;

  const bool efl = efl_in[b] != 0;
  const T dl = delta[b];
  const T delta_1 = T(theta_e1) * dl;
  const T piv1 = T(theta_pivot) * delta_1;
  const T delta_2 = T(theta_e2_dmax);
  for (int i = tid; i < n; i += kBlockThreads) {
    const T xi = x_s[(long long)b * n + i];
    const T lo = lb_s[(long long)b * n + i], hi = ub_s[(long long)b * n + i];
    c.x[i] = xi;
    c.lb1[i] = pmax(lo, xi - delta_1);
    c.ub1[i] = pmin(hi, xi + delta_1);
    c.lb2[i] = pmax(lo, xi - delta_2);
    c.ub2[i] = pmin(hi, xi + delta_2);
    order1[i] = -1;
    order2[i] = -1;
  }
  for (long long e = tid; e < (long long)n * n; e += kBlockThreads) {
    const int i = (int)(e / n), m = (int)(e - (e / n) * n);
    c.Q[(long long)i * c.ldq + m] = i == m ? T(1) : T(0);
    c.Z[(long long)i * c.ldz + m] = i == m ? T(1) : T(0);
    c.ZT[(long long)i * c.ldz + m] = i == m ? T(1) : T(0);
  }
  __syncthreads();

  // ---- round 1
  int k = 0;
  const int r1_cnt = wide_picks<T>(c, 1, piv1, n, k, order1);
  const int k1 = k;
  // directions: the reversed complement columns, row i = column n-1-i of Z
  for (int i = tid; i < n; i += kBlockThreads)
    for (int j = 0; j < n; ++j)
      c.D[(long long)i * c.ldz + j] = c.ZT[(long long)(n - 1 - i) * c.ldz + j];
  const int n_missing1 = n - r1_cnt;

  // ---- round 2 (its picks are reported even where the skip test zeroes the count)
  int r2_cnt = 0;
  bool fl_after2 = true;
  if (!efl) {
    const int r2_picked = wide_picks<T>(c, 2, piv1, n_missing1, k, order2);
    bool skip2 = n_missing1 == 0;
    if (skip2_same_theta) {
      const T dm = T(delta_max);
      const T close_tol = T(1e-8) + T(1e-5) * T(fabs(dm));
      skip2 = skip2 || dl == dm || (isfinite(dm) && T(fabs(dl - dm)) <= close_tol);
    }
    r2_cnt = skip2 ? 0 : r2_picked;
    fl_after2 = skip2;
  }
  __syncthreads();

  // ---- round 3, one direction per thread (strided)
  const int n_missing2 = n_missing1 - r2_cnt;
  const int mn = max_new[b] > 0 ? max_new[b] : 0;
  int n_new = n_missing2 > 0 ? n_missing2 : 0;
  n_new = n_new < mn ? n_new : mn;
  Lane<T> L{c.X, row_stride, c.rows, c.x_index, n, c.x, c.lb1, c.ub1, c.lb2, c.ub2};
  bool fail_l = false, ok_l = true;
  for (int i = tid; i < n; i += kBlockThreads) {
    const bool ok3 = r3_slot<T, MAX_N>(L, c.D + (long long)i * c.ldz, piv1,
                                       sites3 + ((long long)b * n + i) * n);
    fail_l = fail_l || (i < n_new && !ok3);
    ok_l = ok_l && (ok3 || !(i < n_new));
  }
  const bool fail3 = __syncthreads_or(fail_l) != 0;
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
    ok_l = true;
    for (int i = tid; i < n; i += kBlockThreads) {
      T* Di = c.D + (long long)i * c.ldz;
      for (int j = 0; j < n; ++j) Di[j] = i == j ? T(1) : T(0);
      const bool ok3 = r3_slot<T, MAX_N>(L, Di, piv1, sites3 + ((long long)b * n + i) * n);
      ok_l = ok_l && (ok3 || !(i < n_new));
    }
  }
  const bool all_ok = __syncthreads_and(ok_l) != 0;
  const bool round3_ran = rebuild || n_missing2 > 0;
  const bool fl = (round3_ran && covers && all_ok && r2_cnt == 0) || (!round3_ran && fl_after2);

  for (int i = tid; i < n; i += kBlockThreads) {
    const long long o = (long long)b * n + i;
    r1_idx[o] = order1[i];
    r2_idx[o] = efl ? -1 : order2[i];
    active3[o] = i < n_new ? 1 : 0;
    for (int j = 0; j < n; ++j) dirs_out[o * n + j] = c.D[(long long)i * c.ldz + j];
  }
  if (tid == 0) {
    r1_cnt_out[b] = r1c;
    r2_cnt_out[b] = r2_cnt;
    n_new_out[b] = n_new;
    dirs_count_out[b] = dirs_count;
    fl_out[b] = fl ? 1 : 0;
  }
}

// ---- launch

// `instance` is the wrapper's plan (ops/prepare_fused.py: selection_plan):
// 0 the register instances (n = 2, 3), 1 the block instance (n <= MAX_N),
// 2 the wide instance with its matrices at `place`; the launcher refuses a
// plan that does not fit n or whose sizes do not cover its layout.
template <typename T>
int launch(const T* X, long long lane_stride, long long row_stride, const int* count,
           const T* x_s, const int* x_index, const T* delta, const T* lb, const T* ub,
           const int* max_new, const unsigned char* efl, int* r1_idx, int* r1_cnt,
           int* r2_idx, int* r2_cnt, T* sites3, unsigned char* active3, int* n_new,
           T* dirs, int* dirs_count, unsigned char* fl, int* work, int B, int cap,
           int n, int stage_rows, int instance, int place, T* mat_work,
           long long smem_bytes, double theta_e1, double theta_e2_dmax,
           double theta_pivot, double delta_max, int skip2_same_theta, void* stream) {
  if (B <= 0) return 0;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MORBIT_SEL_ARGS                                                              \
  X, lane_stride, row_stride, count, x_s, x_index, delta, lb, ub, max_new, efl,      \
      r1_idx, r1_cnt, r2_idx, r2_cnt, sites3, active3, n_new, dirs, dirs_count, fl
  const int threads = 128, blocks = (B + threads - 1) / threads;
  if (instance == 0 && n == 2) {
    rbf_selection_kernel<T, 2><<<blocks, threads, 0, s>>>(
        MORBIT_SEL_ARGS, B, cap, theta_e1, theta_e2_dmax, theta_pivot, delta_max,
        skip2_same_theta);
  } else if (instance == 0 && n == 3) {
    rbf_selection_kernel<T, 3><<<blocks, threads, 0, s>>>(
        MORBIT_SEL_ARGS, B, cap, theta_e1, theta_e2_dmax, theta_pivot, delta_max,
        skip2_same_theta);
  } else if (instance == 1) {
    // the wrapper's size must cover this layout, and its workspace B x cap
    if (n > MAX_N || work == nullptr || stage_rows < 0 ||
        smem_bytes < block_layout(n, stage_rows, (int)sizeof(T)).bytes ||
        smem_bytes > kMaxSmemBytes)
      return static_cast<int>(cudaErrorInvalidValue);
    if (smem_bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          rbf_selection_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem_bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    rbf_selection_block_kernel<T><<<B, kBlockThreads, (size_t)smem_bytes, s>>>(
        MORBIT_SEL_ARGS, work, cap, n, stage_rows, theta_e1, theta_e2_dmax,
        theta_pivot, delta_max, skip2_same_theta);
  } else if (instance == 2) {
    if (work == nullptr || stage_rows < 0 || place < 0 || place > 2 ||
        (place > 0 && mat_work == nullptr) ||
        (place < 2 && smem_bytes < wide_sel_layout(n, stage_rows, (int)sizeof(T), place).bytes) ||
        smem_bytes > kMaxSmemBytes)
      return static_cast<int>(cudaErrorInvalidValue);
    if (smem_bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          rbf_selection_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem_bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    rbf_selection_wide_kernel<T><<<B, kBlockThreads, (size_t)smem_bytes, s>>>(
        MORBIT_SEL_ARGS, work, cap, n, stage_rows, place, mat_work, theta_e1,
        theta_e2_dmax, theta_pivot, delta_max, skip2_same_theta);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MORBIT_SEL_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan (instance, place, stage_rows, smem_bytes) and the workspaces
// (`work`: B x cap ints for the block and wide instances; `mat_work`: B
// lanes of the wide layout's `work` elements at place 1 or 2) come from the
// wrapper.
#define MORBIT_SEL_EXPORT(NAME, T)                                                    \
  extern "C" int NAME(const T* X, long long lane_stride, long long row_stride,        \
                      const int* count, const T* x_s, const int* x_index,             \
                      const T* delta, const T* lb, const T* ub, const int* max_new,   \
                      const unsigned char* efl, int* r1_idx, int* r1_cnt,             \
                      int* r2_idx, int* r2_cnt, T* sites3, unsigned char* active3,    \
                      int* n_new, T* dirs, int* dirs_count, unsigned char* fl,        \
                      int* work, int B, int cap, int n, int stage_rows, int instance, \
                      int place, T* mat_work, long long smem_bytes, double theta_e1,  \
                      double theta_e2_dmax, double theta_pivot, double delta_max,     \
                      int skip2_same_theta, void* stream) {                           \
    return launch<T>(X, lane_stride, row_stride, count, x_s, x_index, delta, lb, ub,  \
                     max_new, efl, r1_idx, r1_cnt, r2_idx, r2_cnt, sites3, active3,   \
                     n_new, dirs, dirs_count, fl, work, B, cap, n, stage_rows,        \
                     instance, place, mat_work, smem_bytes, theta_e1, theta_e2_dmax,  \
                     theta_pivot, delta_max, skip2_same_theta, stream);               \
  }

MORBIT_SEL_EXPORT(rbf_selection_f32, float)
MORBIT_SEL_EXPORT(rbf_selection_f64, double)
