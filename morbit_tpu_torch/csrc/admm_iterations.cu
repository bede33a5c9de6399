// K5: `iters` OSQP splitting steps with the KKT inverse given, one warp per
// instance.
//
// Replaces the TPU kernel `admm_iterations` (morbit_tpu/ops/pallas_kernels.py:78-138,
// its `pl.pallas_call` at :127). Its plain PyTorch twin is
// morbit_tpu_torch/ops/dense_kernels.py::admm_iterations_plain. Neither package
// calls it (morbit_tpu/ops/qp.py:47-52 records it as superseded by K1); it is
// held against its twin only.
//
// Per instance, with Minv (n, n), A (m, n) and the vectors rho, q, l, u, z, zz, y:
//     rhs = sigma z - q + A' (rho * zz - y)
//     xt  = Minv rhs,  zt = A xt
//     z   = alpha xt + (1 - alpha) z
//     zz' = clip(alpha zt + (1 - alpha) zz + y / rho, l, u)
//     y   = y + rho * (alpha zt + (1 - alpha) zz - zz'),  zz = zz'
//
// Design: one warp per instance, `lanes` instances (warps) a block, as K1's
// wide instance (qp_admm.cu). The instance's A and Minv are loaded once,
// coalesced, into dynamic shared memory, each row padded with zeros to an
// odd count of 16-byte vectors, so that a warp reading one vector from each
// of 8 rows hits distinct banks. The kernel computes that layout from n and
// m (`layout`): a build that took the offsets as arguments ran slower at
// (21, 42) and (64, 128) f32 on the H100. The wrapper's
// dense_kernels.admm_iterations_smem_bytes mirrors its size, and the
// launcher refuses any size but its own. Thread t owns variables t and
// t + 32 (z, q in registers) and constraint rows t + 32h, h < 4 (l, u,
// rho, zz, y in registers); the vectors the threads
// exchange (t1 = rho * zz - y, rhs, xt) live in shared memory and are read
// as 16-byte broadcasts. A step is three phases separated by __syncwarp:
// rhs_j (thread j sums over the m rows, reading its column of A), xt_i and
// the z update (thread i sums over row i of Minv), zt_r and the row updates
// (thread r sums over row r of A), which also write the next t1.
//
// Rounding: every sum is one thread's, from +0 and in index order, and the
// expressions are written as the fused multiply-adds nvcc contracted the
// one-thread-per-instance kernel before this design to (acc + a*b ->
// fma(a, b, acc); a*b + c*d -> fma(a, b, c*d); a*b - c -> fma(a, b, -c)),
// so the outputs equal that kernel's bit for bit. A padded term is
// fma(0, 0, acc) == acc: a sum that starts at +0 never becomes -0 under
// round-to-nearest, so the zeros leave it unchanged.
//
// Bound on an H100: 4nm + 2n^2 + 6n + 12m operations a step (counted from
// the function, chip_smoke.admm_iterations_work) and the operands read
// once; at (21, 42), B=1024 and 100 steps 0.0077 ms of FP32 work. The kernel
// is held instead by each lane's chain of dependent steps: three sums (m + 2n
// multiply-adds in sequence, each waiting on its shared-memory loads), the
// division and three __syncwarp a step. All 1024 lanes are resident at once
// (~8 an SM), and a lane alone takes nearly as long as among 1024, so the
// time is the chain's latency, not a throughput (PERF.md gives the cycles
// per phase). Tensor cores do not apply: every lane has its own A and Minv,
// each multiplied by one vector.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64, kMaxM = 128, kMaxLanes = 4;

// 16-byte vectors of T
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int width = 4;
  __device__ static void load(const float* p, float (&o)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec<double> {
  static constexpr int width = 2;
  __device__ static void load(const double* p, double (&o)[2]) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
};

__device__ __forceinline__ float dfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dfma(double a, double b, double c) { return fma(a, b, c); }

// jnp.clip: NaN stays NaN
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  T y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

// Offsets (in elements) of one instance's arrays in shared memory, for
// vectors of `width` elements. `ld` is the row stride of A and Minv (n
// rounded up to whole vectors, then to an odd count of them), `mp` the
// rows of A (m rounded up to whole vectors); the padding is zero.
struct Layout {
  int ld, mp, A, Minv, t1, rhs, xt, total;
};

__host__ __device__ inline Layout layout(int n, int m, int width) {
  Layout w;
  w.ld = (n + width - 1) / width * width;
  if ((w.ld / width) % 2 == 0) w.ld += width;
  w.mp = (m + width - 1) / width * width;
  int o = 0;
  w.A = o;    o += w.mp * w.ld;
  w.Minv = o; o += n * w.ld;
  w.t1 = o;   o += w.mp;
  w.rhs = o;  o += w.ld;
  w.xt = o;   o += w.ld;
  w.total = o;
  return w;
}

template <typename T>
struct Params {
  const T *Minv, *A, *rho, *q, *l, *u, *z0, *zz0, *y0;
  T *z, *zz, *y;
  int B, n, m, lanes, iters;
  T sigma, alpha, one_m_alpha;
};

// V variables and H constraint rows a thread: V = ceil(n / 32), H = ceil(m / 32)
template <typename T, int V, int H>
__global__ void __launch_bounds__(kMaxLanes * 32)
admm_iterations_kernel(const Params<T> p) {
  constexpr int W = Vec<T>::width;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * p.lanes + warp;
  if (b >= p.B) return;  // a whole warp leaves; the lane's sync is __syncwarp
  const int n = p.n, m = p.m;
  const Layout w = layout(n, m, W);
  const int ld = w.ld, mp = w.mp, np = (n + W - 1) / W * W;
  T* s = reinterpret_cast<T*>(smem_raw) + (size_t)warp * w.total;
  T *sA = s + w.A, *sM = s + w.Minv, *t1 = s + w.t1, *rhs = s + w.rhs, *xt = s + w.xt;

  // ---- zero A, Minv and t1 (their padding stays 0), then a coalesced load
  // of the instance's A and Minv, four loads in flight a thread
  for (int e = t * W; e < w.t1 + w.mp; e += 32 * W) {
#pragma unroll
    for (int k = 0; k < W; ++k) s[e + k] = T(0);
  }
  __syncwarp();
  const T* Ab = p.A + (size_t)b * m * n;
#pragma unroll 4
  for (int e = t; e < m * n; e += 32) {
    const int r = e / n;
    sA[r * ld + (e - r * n)] = Ab[e];
  }
  const T* Mb = p.Minv + (size_t)b * n * n;
#pragma unroll 4
  for (int e = t; e < n * n; e += 32) {
    const int r = e / n;
    sM[r * ld + (e - r * n)] = Mb[e];
  }
  for (int e = t; e < ld; e += 32) rhs[e] = xt[e] = T(0);

  // variables t + 32v and rows t + 32h in registers; threads past n (m)
  // compute on the last variable (row) and store nothing
  T z[V], qv[V], lk[H], uk[H], rho[H], zz[H], y[H];
  int vi[V], ri[H];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    vi[v] = min(t + 32 * v, n - 1);
    z[v] = p.z0[(size_t)b * n + vi[v]];
    qv[v] = p.q[(size_t)b * n + vi[v]];
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    ri[h] = min(t + 32 * h, m - 1);
    const size_t o = (size_t)b * m + ri[h];
    lk[h] = p.l[o];
    uk[h] = p.u[o];
    rho[h] = p.rho[o];
    zz[h] = p.zz0[o];
    y[h] = p.y0[o];
    if (t + 32 * h < m) t1[ri[h]] = dfma(rho[h], zz[h], -y[h]);
  }
  __syncwarp();

  const T sigma = p.sigma, alpha = p.alpha, oma = p.one_m_alpha;
  for (int it = 0; it < p.iters; ++it) {
    // ---- rhs_j = (sigma z_j - q_j) + sum_r t1_r A[r][j]
    T acc[V > H ? V : H];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = T(0);
#pragma unroll 2
    for (int r0 = 0; r0 < mp; r0 += W) {
      T tv[W];
      Vec<T>::load(t1 + r0, tv);
#pragma unroll
      for (int k = 0; k < W; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[v] = dfma(tv[k], sA[(r0 + k) * ld + vi[v]], acc[v]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (t + 32 * v < n) rhs[vi[v]] = dfma(sigma, z[v], -qv[v]) + acc[v];
    __syncwarp();

    // ---- xt_i = sum_j rhs_j Minv[i][j]; z = alpha xt + (1 - alpha) z
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = T(0);
#pragma unroll 2
    for (int j0 = 0; j0 < np; j0 += W) {
      T rv[W];
      Vec<T>::load(rhs + j0, rv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        T mv[W];
        Vec<T>::load(sM + vi[v] * ld + j0, mv);
#pragma unroll
        for (int k = 0; k < W; ++k) acc[v] = dfma(rv[k], mv[k], acc[v]);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      z[v] = dfma(alpha, acc[v], oma * z[v]);
      if (t + 32 * v < n) xt[vi[v]] = acc[v];
    }
    __syncwarp();

    // ---- zt_r = sum_i xt_i A[r][i]
#pragma unroll
    for (int h = 0; h < H; ++h) acc[h] = T(0);
#pragma unroll 2
    for (int i0 = 0; i0 < np; i0 += W) {
      T xv[W];
      Vec<T>::load(xt + i0, xv);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        T av[W];
        Vec<T>::load(sA + ri[h] * ld + i0, av);
#pragma unroll
        for (int k = 0; k < W; ++k) acc[h] = dfma(xv[k], av[k], acc[h]);
      }
    }
    // ---- per row the relaxation, the clip, y and the next t1
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const T relaxed = dfma(alpha, acc[h], oma * zz[h]);
      const T zz_new = clip(relaxed + y[h] / rho[h], lk[h], uk[h]);
      y[h] = dfma(rho[h], relaxed - zz_new, y[h]);
      zz[h] = zz_new;
      if (t + 32 * h < m) t1[ri[h]] = dfma(rho[h], zz_new, -y[h]);
    }
    __syncwarp();
  }

  // ---- outputs
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (t + 32 * v < n) p.z[(size_t)b * n + vi[v]] = z[v];
#pragma unroll
  for (int h = 0; h < H; ++h)
    if (t + 32 * h < m) {
      p.zz[(size_t)b * m + ri[h]] = zz[h];
      p.y[(size_t)b * m + ri[h]] = y[h];
    }
}

template <typename T, int V, int H>
int launch_vh(const Params<T>& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        admm_iterations_kernel<T, V, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  admm_iterations_kernel<T, V, H>
      <<<(p.B + p.lanes - 1) / p.lanes, p.lanes * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* Minv, const T* A, const T* rho, const T* q, const T* l, const T* u,
           const T* z0, const T* zz0, const T* y0, T* z, T* zz, T* y, int B, int n, int m,
           int iters, double sigma, double alpha, int lanes, long long smem_bytes,
           long long smem_limit, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || m < 1 || n > kMaxN || m > kMaxM || lanes < 1 || lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  // the wrapper's size must be this layout's, within the card's limit it passes
  const long long need =
      (long long)lanes * layout(n, m, Vec<T>::width).total * (long long)sizeof(T);
  if (smem_bytes != need || smem_bytes > smem_limit) return (int)cudaErrorInvalidValue;
  const Params<T> p{Minv, A, rho, q, l, u, z0, zz0, y0, z, zz, y, B, n, m, lanes, iters,
                    T(sigma), T(alpha), T(1.0 - alpha)};
  const size_t smem = (size_t)smem_bytes;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int V = (n + 31) / 32, H = (m + 31) / 32;
  switch (V * 10 + H) {
    case 11: return launch_vh<T, 1, 1>(p, smem, st);
    case 12: return launch_vh<T, 1, 2>(p, smem, st);
    case 13: return launch_vh<T, 1, 3>(p, smem, st);
    case 14: return launch_vh<T, 1, 4>(p, smem, st);
    case 21: return launch_vh<T, 2, 1>(p, smem, st);
    case 22: return launch_vh<T, 2, 2>(p, smem, st);
    case 23: return launch_vh<T, 2, 3>(p, smem, st);
    default: return launch_vh<T, 2, 4>(p, smem, st);
  }
}

}  // namespace

#define MORBIT_K5_EXPORT(NAME, T)                                                      \
  extern "C" int NAME(const T* Minv, const T* A, const T* rho, const T* q, const T* l, \
                      const T* u, const T* z0, const T* zz0, const T* y0, T* z, T* zz, \
                      T* y, int B, int n, int m, int iters, double sigma, double alpha, \
                      int lanes, long long smem_bytes, long long smem_limit,           \
                      void* stream) {                                                  \
    return launch<T>(Minv, A, rho, q, l, u, z0, zz0, y0, z, zz, y, B, n, m, iters,     \
                     sigma, alpha, lanes, smem_bytes, smem_limit, stream);             \
  }

MORBIT_K5_EXPORT(admm_iterations_f32, float)
MORBIT_K5_EXPORT(admm_iterations_f64, double)
