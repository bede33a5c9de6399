// K6: LU factorization with partial pivoting and its solve, one lane a block.
//
// Replaces no TPU kernel. It replaces the card's library solves
// (torch.linalg.solve_ex, lu_factor_ex + lu_solve) on the port's float64
// paths: those choose their algorithm by the number of lanes in the batch,
// so a lane's last bits depended on the width of its batch (ROADMAP 3.15).
// Here every lane's result depends on its own inputs alone: one block
// factors or solves one lane, and every value is computed by one fixed
// sequence of roundings whatever the batch, the block size or the
// placement. Its plain PyTorch twins, in the same operation order, are
// morbit_tpu_torch/ops/lane_linalg.py::lane_lu_factor_plain and
// ::lane_lu_solve_plain. Built with --fmad=false: every a - l * u is a
// multiply and a subtract, each rounded, as in the twins.
//
// Factor, per lane, for a (k, k) matrix A, columns j = 0 .. k-1:
//   p     = the first row i >= j of the largest |a_ij| (LAPACK's idamax
//           rule; NaN counts as largest, as torch.argmax), found by a
//           block-wide reduction: a maximum is exact, so the tree's shape
//           cannot move it;
//   rows j and p swap, whole (the permutation records it);
//   d = a_jj; d == 0 sets info to j + 1 (the first such column) and leaves
//           the column below it as it is (all zeros), as LAPACK's dgetf2;
//   l_i   = a_ij / d for i > j;
//   a_ic  = a_ic - l_i * a_jc for i, c > j (right-looking: each entry's
//           updates run in column order).
// Solve, per lane, for LU, the permutation and b (k, m):
//   x = the rows of b in the permutation's order;
//   forward, j = 0 .. k-2:   x_i = x_i - L_ij x_j for i > j;
//   back,    j = k-1 .. 0:   x_j = x_j / U_jj, then x_i = x_i - U_ij x_j
//                            for i < j.
// Each x_i's sums run in the order the unknowns are found: ascending in the
// forward pass, descending in the back pass.
//
// Where the lane lives: the factor keeps its matrix in shared memory (rows
// padded to an odd count of values) where it fits the 227 KB a block may
// use, k <= 169 at float64, and factors it in place in the output otherwise
// (the n = 50 path's fits, k = 1,377), there in panels of kPanel columns
// (lane_lu_factor_blocked_kernel): the panel is factored column by column,
// its rows of U are finished by a forward substitution, and the trailing
// matrix takes the panel's kPanel updates at once, tile by tile through
// shared memory, so it streams through memory once a panel rather than
// once a column. Each entry still takes its updates one at a time in
// column order, so the blocked factor equals the unblocked one to the bit.
// The solve keeps x in shared memory where k m values fit, in the output
// otherwise. The wrapper plans the placement from (k, m, dtype) alone
// (ops/lane_linalg.py: lu_factor_plan, lu_solve_plan), and the arithmetic
// is the same in either.
//
// Bound on the H100: the factor does 2k^3/3 operations on k^2 values a lane
// (at k = 1,377: 1.74 GFLOP on 15 MB, so operations bound it, ~0.03 ms a
// lane at the card's 67 TFLOP/s float64 peak); this design runs one lane on
// one SM with separate multiplies and subtracts, so it is far from that
// bound (PERF.md). The solve does 2k^2 m operations on k^2 + 2km values and
// is bound by reading LU.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr size_t kMaxSmemBytes = 232448;   // 227 KB, the H100's per-block limit
constexpr int kWarps = 32;                 // at most 1024 threads a block
// the blocked factor: panel width, and the trailing update's tiles (rows x
// columns; 1024 threads, each a row and every kTileLanes-th column)
constexpr int kPanel = 32;
constexpr int kTileRows = 64, kTileCols = 64, kTileLanes = 16;

// threads of a factor block: enough for the trailing matrix's rows, at most
// 1024 (the lane's arithmetic is the same for any count)
__host__ inline int factor_threads(int k) { return k <= 64 ? 128 : 256; }
__host__ inline int solve_threads(int k, int m) {
  const long long e = (long long)k * m;
  return e <= 128 ? 128 : e <= 256 ? 256 : 1024;
}

// row stride of the factor's shared copy: odd, so that a column's values
// fall in different banks
__host__ __device__ inline int factor_ld(int k) { return k % 2 == 0 ? k + 1 : k; }

// dynamic shared memory of a factor block: the reduction's values and rows,
// the permutation, and where `shared` the lane's matrix, else the blocked
// factor's tiles (L's kTileRows x kPanel, U's kPanel x kTileCols)
__host__ __device__ inline size_t factor_smem_bytes(int k, int item, bool shared) {
  return (size_t)kWarps * (item + 4) + (size_t)k * 4 +
         (shared ? (size_t)k * factor_ld(k) * item
                 : (size_t)(kTileRows + kTileCols) * kPanel * item);
}

// |v| at row i against the best so far (bv at row bi; bi < 0: none yet)
template <typename T>
__device__ __forceinline__ bool better(T v, int i, T bv, int bi) {
  if (bi < 0) return true;
  if (isnan(v)) return isnan(bv) ? i < bi : true;
  if (isnan(bv)) return false;
  return v > bv || (v == bv && i < bi);
}

// Column j of a factor block's matrix a (row stride ld): the pivot, the
// first row p >= j of the largest |a_pj| (a block-wide reduction), the
// swap of rows j and p, whole, and the permutation's; then l_i = a_ij / d
// below the diagonal, or, where d = a_jj is 0, info (the first such
// column, from 1) and the column left as it is. Ends at a barrier.
template <typename T>
__device__ void pivot_column(T* a, int ld, int k, int j, T* red_v, int* red_i, int* perm,
                             int* piv, int* info) {
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, wl = tid & 31;
  const int nwarps = nt >> 5;
  T bv = T(0);
  int bi = -1;
  for (int i = j + tid; i < k; i += nt) {
    const T v = fabs(a[(long long)i * ld + j]);
    if (better(v, i, bv, bi)) bv = v, bi = i;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (oi >= 0 && better(ov, oi, bv, bi)) bv = ov, bi = oi;
  }
  if (wl == 0) red_v[warp] = bv, red_i[warp] = bi;
  __syncthreads();
  if (warp == 0) {
    bv = wl < nwarps ? red_v[wl] : T(0);
    bi = wl < nwarps ? red_i[wl] : -1;
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (oi >= 0 && better(ov, oi, bv, bi)) bv = ov, bi = oi;
    }
    if (wl == 0) {
      *piv = bi;
      if (bi != j) {
        const int t = perm[j];
        perm[j] = perm[bi], perm[bi] = t;
      }
    }
  }
  __syncthreads();
  const int p = *piv;
  if (p != j)
    for (int c = tid; c < k; c += nt) {
      const T t = a[(long long)j * ld + c];
      a[(long long)j * ld + c] = a[(long long)p * ld + c];
      a[(long long)p * ld + c] = t;
    }
  __syncthreads();
  const T d = a[(long long)j * ld + j];
  if (d == T(0)) {
    if (tid == 0 && *info == 0) *info = j + 1;
  } else {
    for (int i = j + 1 + tid; i < k; i += nt) a[(long long)i * ld + j] /= d;
  }
  __syncthreads();
}

// The factor with the lane's matrix in shared memory (k <= 169 at float64).
template <typename T>
__global__ void lane_lu_factor_kernel(const T* __restrict__ A, T* __restrict__ LU,
                                      int* __restrict__ perm_out, int* __restrict__ info_out,
                                      int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* red_v = reinterpret_cast<T*>(smem);
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);
  int* perm = red_i + kWarps;
  const long long lane = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, wl = tid & 31;
  const int nwarps = nt >> 5;
  const T* Ag = A + lane * k * k;
  T* LUg = LU + lane * k * k;
  const int ld = factor_ld(k);
  T* a = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(perm) +
                              ((size_t)k * 4 + 15) / 16 * 16);
  for (int r = warp; r < k; r += nwarps)
    for (int c = wl; c < k; c += 32) a[r * ld + c] = Ag[(long long)r * k + c];
  for (int i = tid; i < k; i += nt) perm[i] = i;
  __shared__ int info, piv;
  if (tid == 0) info = 0;
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    pivot_column(a, ld, k, j, red_v, red_i, perm, &piv, &info);
    // trailing update, rows over the warps and columns over their lanes
    for (int i = j + 1 + warp; i < k; i += nwarps) {
      T* row = a + (long long)i * ld;
      const T l = row[j];
      const T* u = a + (long long)j * ld;
      for (int c = j + 1 + wl; c < k; c += 32) row[c] = row[c] - l * u[c];
    }
    __syncthreads();
  }

  for (int r = warp; r < k; r += nwarps)
    for (int c = wl; c < k; c += 32) LUg[(long long)r * k + c] = a[r * ld + c];
  for (int i = tid; i < k; i += nt) perm_out[lane * k + i] = perm[i];
  if (tid == 0) info_out[lane] = info;
}

// The factor in place in global memory, in panels of kPanel columns (see the
// header). For the panel j0 .. j1-1:
//   1. each column j of it: pivot_column, then a_ic = a_ic - l_i * a_jc for
//      rows i > j and the panel's columns c in (j, j1);
//   2. the panel's rows of U right of it: for c >= j1 and j = j0+1 .. j1-1,
//      a_jc = a_jc - l_jt * a_tc for t = j0 .. j-1 in turn;
//   3. the trailing matrix, i, c >= j1: a_ic = a_ic - l_it * a_tc for
//      t = j0 .. j1-1 in turn, by tiles of kTileRows x kTileCols with the
//      tile's l and u staged in shared memory.
// Every entry so takes the updates of the unblocked factor, from the same
// values and in the same column order, each a multiply and a subtract.
template <typename T>
__global__ void lane_lu_factor_blocked_kernel(const T* __restrict__ A, T* __restrict__ LU,
                                              int* __restrict__ perm_out,
                                              int* __restrict__ info_out, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* red_v = reinterpret_cast<T*>(smem);
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);
  int* perm = red_i + kWarps;
  T* ls = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(perm) +
                               ((size_t)k * 4 + 15) / 16 * 16);   // kTileRows x kPanel
  T* us = ls + kTileRows * kPanel;                                 // kPanel x kTileCols
  const long long lane = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, wl = tid & 31;
  const int nwarps = nt >> 5;
  const T* Ag = A + lane * k * k;
  T* a = LU + lane * k * k;
  for (long long e = tid; e < (long long)k * k; e += nt) a[e] = Ag[e];
  for (int i = tid; i < k; i += nt) perm[i] = i;
  __shared__ int info, piv;
  if (tid == 0) info = 0;
  __syncthreads();

  for (int j0 = 0; j0 < k; j0 += kPanel) {
    const int j1 = min(j0 + kPanel, k);
    // 1. the panel, column by column
    for (int j = j0; j < j1; ++j) {
      pivot_column(a, k, k, j, red_v, red_i, perm, &piv, &info);
      for (int i = j + 1 + warp; i < k; i += nwarps) {
        T* row = a + (long long)i * k;
        const int c = j + 1 + wl;
        if (c < j1) row[c] = row[c] - row[j] * a[(long long)j * k + c];
      }
      __syncthreads();
    }
    if (j1 == k) break;
    // 2. the panel's rows of U, one column a thread, the unknowns in turn
    for (int c = j1 + tid; c < k; c += nt)
      for (int j = j0 + 1; j < j1; ++j) {
        T s = a[(long long)j * k + c];
        for (int t = j0; t < j; ++t) s = s - a[(long long)j * k + t] * a[(long long)t * k + c];
        a[(long long)j * k + c] = s;
      }
    __syncthreads();
    // 3. the trailing matrix, tile by tile
    const int w = j1 - j0;
    const int tr = tid / kTileLanes, tc = tid % kTileLanes;   // columns tc + kTileLanes q
    for (int r0 = j1; r0 < k; r0 += kTileRows) {
      for (int e = tid; e < kTileRows * kPanel; e += nt) {
        const int r = r0 + e / kPanel, t = e % kPanel;
        ls[e] = (r < k && t < w) ? a[(long long)r * k + j0 + t] : T(0);
      }
      for (int c0 = j1; c0 < k; c0 += kTileCols) {
        for (int e = tid; e < kPanel * kTileCols; e += nt) {
          const int t = e / kTileCols, c = c0 + e % kTileCols;
          us[e] = (t < w && c < k) ? a[(long long)(j0 + t) * k + c] : T(0);
        }
        __syncthreads();
        const int r = r0 + tr;
        if (tr < kTileRows && r < k) {
          T* row = a + (long long)r * k;
          T v[kTileCols / kTileLanes];
#pragma unroll
          for (int q = 0; q < kTileCols / kTileLanes; ++q) {
            const int c = c0 + tc + kTileLanes * q;
            v[q] = c < k ? row[c] : T(0);
          }
          for (int t = 0; t < w; ++t) {
            const T l = ls[tr * kPanel + t];
#pragma unroll
            for (int q = 0; q < kTileCols / kTileLanes; ++q)
              v[q] = v[q] - l * us[t * kTileCols + tc + kTileLanes * q];
          }
#pragma unroll
          for (int q = 0; q < kTileCols / kTileLanes; ++q) {
            const int c = c0 + tc + kTileLanes * q;
            if (c < k) row[c] = v[q];
          }
        }
        __syncthreads();
      }
    }
  }

  for (int i = tid; i < k; i += nt) perm_out[lane * k + i] = perm[i];
  if (tid == 0) info_out[lane] = info;
}

template <typename T>
__global__ void lane_lu_solve_kernel(const T* __restrict__ LU, const int* __restrict__ perm,
                                     const T* __restrict__ b, T* __restrict__ x_out, int k,
                                     int m, int shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long lane = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* L = LU + lane * k * k;
  const int* pr = perm + lane * k;
  const T* bg = b + lane * k * m;
  T* xg = x_out + lane * k * m;
  T* x = shared ? reinterpret_cast<T*>(smem) : xg;
  const int km = k * m;
  // x = P b; where x is the output, each thread gathers its own entries and
  // reads only them until the barrier
  for (int e = tid; e < km; e += nt) {
    const int i = e / m, c = e - i * m;
    x[e] = bg[(long long)pr[i] * m + c];
  }
  __syncthreads();
  for (int j = 0; j + 1 < k; ++j) {
    const int rows = (k - j - 1) * m;
    for (int e = tid; e < rows; e += nt) {
      const int r = e / m, c = e - r * m, i = j + 1 + r;
      x[i * m + c] = x[i * m + c] - L[(long long)i * k + j] * x[j * m + c];
    }
    __syncthreads();
  }
  for (int j = k - 1; j >= 0; --j) {
    const T d = L[(long long)j * k + j];
    for (int c = tid; c < m; c += nt) x[j * m + c] = x[j * m + c] / d;
    __syncthreads();
    const int rows = j * m;
    for (int e = tid; e < rows; e += nt) {
      const int i = e / m, c = e - i * m;
      x[i * m + c] = x[i * m + c] - L[(long long)i * k + j] * x[j * m + c];
    }
    __syncthreads();
  }
  if (shared)
    for (int e = tid; e < km; e += nt) xg[e] = x[e];
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

// `shared` and `smem` are the wrapper's plan (ops/lane_linalg.py:
// lu_factor_plan); the launcher refuses a plan that does not cover its
// layout or passes the card's limit
template <typename T>
int factor(const T* A, T* LU, int* perm, int* info, long long B, int k, int shared,
           size_t smem, void* stream) {
  if (B <= 0) return 0;
  if (k < 1 || B > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t need = factor_smem_bytes(k, sizeof(T), shared != 0) + 16;
  if (smem < need || smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared) {
    cudaError_t e = allow_smem(reinterpret_cast<const void*>(lane_lu_factor_kernel<T>), smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    lane_lu_factor_kernel<T><<<(unsigned)B, factor_threads(k), smem, st>>>(A, LU, perm, info, k);
  } else {
    cudaError_t e =
        allow_smem(reinterpret_cast<const void*>(lane_lu_factor_blocked_kernel<T>), smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    lane_lu_factor_blocked_kernel<T><<<(unsigned)B, 1024, smem, st>>>(A, LU, perm, info, k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int solve(const T* LU, const int* perm, const T* b, T* x, long long B, int k, int m,
          int shared, size_t smem, void* stream) {
  if (B <= 0 || m <= 0) return 0;
  if (k < 1 || B > 2147483647LL || (long long)k * m > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t need = shared ? (size_t)k * m * sizeof(T) : 0;
  if (smem < need || smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(lane_lu_solve_kernel<T>), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  lane_lu_solve_kernel<T><<<(unsigned)B, solve_threads(k, m), smem,
                            static_cast<cudaStream_t>(stream)>>>(LU, perm, b, x, k, m, shared);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A, LU: B x k x k; perm: B x k (int32, row i of LU factors row perm[i] of A);
// info: B (int32); b, x: B x k x m; all contiguous.
extern "C" {

int lane_lu_factor_f32(const float* A, float* LU, int* perm, int* info, long long B, int k,
                       int shared, long long smem, void* stream) {
  return factor<float>(A, LU, perm, info, B, k, shared, (size_t)smem, stream);
}

int lane_lu_factor_f64(const double* A, double* LU, int* perm, int* info, long long B, int k,
                       int shared, long long smem, void* stream) {
  return factor<double>(A, LU, perm, info, B, k, shared, (size_t)smem, stream);
}

int lane_lu_solve_f32(const float* LU, const int* perm, const float* b, float* x, long long B,
                      int k, int m, int shared, long long smem, void* stream) {
  return solve<float>(LU, perm, b, x, B, k, m, shared, (size_t)smem, stream);
}

int lane_lu_solve_f64(const double* LU, const int* perm, const double* b, double* x,
                      long long B, int k, int m, int shared, long long smem, void* stream) {
  return solve<double>(LU, perm, b, x, B, k, m, shared, (size_t)smem, stream);
}

}  // extern "C"
