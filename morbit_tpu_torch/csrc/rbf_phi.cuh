// rbf_phi.cuh — the RBF kernel functions phi(r^2), shared by K3
// (rbf_round4.cu) and K4 (rbf_gram.cu).
//
// The same formulas as apply_kernel (morbit_tpu_torch/ops/rbf.py) in r^2.
// The exponent kernels (cubic, thin-plate spline) take their exponent and
// coefficient from the wrapper (ops/prepare_fused.py:_phi_constants); the
// smooth kernels take the lane's shape parameter p.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace morbit {

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
#ifdef MORBIT_LINKED_POW
// K3's float64 build: defined in csrc/rbf_pow.cu, built with multiply-add
// contraction as PyTorch's pow is (see there); float32 keeps the inline pow
}  // namespace morbit
extern __device__ double morbit_pow_f64(double x, double e);
namespace morbit {
__device__ __forceinline__ double phi_pow(double x, double e) { return morbit_pow_f64(x, e); }
#else
__device__ __forceinline__ double phi_pow(double x, double e) { return pow(x, e); }
#endif
__device__ __forceinline__ float phi_pow(float x, float e) { return pow(x, e); }

template <typename T>
__device__ __forceinline__ T phi(const Phi& f, T r2, T p) {
  switch (f.id) {
    case CUBIC:
      return T(f.coef) * phi_pow(r2, T(f.exponent));
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

}  // namespace morbit
