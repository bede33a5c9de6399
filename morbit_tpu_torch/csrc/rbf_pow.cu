// The float64 power of the cubic RBF kernel for K3 (csrc/rbf_round4.cu).
//
// K3 is built without multiply-add contraction (--fmad=false), so that its
// sums round as its plain twin's do. CUDA's double pow built that way
// differs in the last bit from the same pow built with contraction on a few
// arguments in a million (24 of 4,000,000 uniform in [0, 3) at exponent
// 1.5 on an H100), and PyTorch's CUDA pow, which the twin's r2 ** 1.5 calls,
// is built with contraction. A long round-4 chain at float64 meets such an
// argument and its decisions part from the twin's. This translation unit is
// compiled with the default flags and linked into K3's float64 build as
// relocatable device code (ops/cuda_build.py: build's `linked`;
// ops/prepare_fused.py: build_round4), so its cubic phi rounds as the
// twin's. The float32 pow agrees either way; the float32 build stays one
// translation unit (relocatable device code costs its block instance ~10 %).

#include <cuda_runtime.h>
#include <math.h>

__device__ double morbit_pow_f64(double x, double e) { return pow(x, e); }
