// Helpers shared by the hand-written kernels (backpass.cu, rollout.cu).
//
// The per-lane functions are __host__ __device__ so that their arithmetic
// can also be compiled by a host C++ compiler; the kernels only map a
// thread to a lane and call them.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#ifndef __CUDACC__
#include <cmath>
#endif

namespace ddp {

// Negative return codes of the C entry points (positive codes are
// cudaError_t values from cudaGetLastError()).
enum ErrorCode {
  kBadShape = -1,      // N, B or block size out of range
  kBadDtype = -2,      // dtype code not 0 (float32) or 1 (float64)
  kBadVariant = -3,    // (n_x, n_u) / reg_type / model not instantiated
  kNullPointer = -4,   // a required operand pointer is NULL
};

template <typename T>
__host__ __device__ __forceinline__ bool is_finite(T v) {
#ifdef __CUDACC__
  return isfinite(v);
#else
  return std::isfinite(v);
#endif
}

// NaN-propagating min/max: the semantics of torch.minimum / torch.maximum
// (and jnp.minimum / jnp.maximum), unlike fmin/fmax.
template <typename T>
__host__ __device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}

template <typename T>
__host__ __device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}

// AL penalties (ddp_generator_tpu/al.py: _eq_penalty, _ineq_penalty), in
// the same operation order as the plain PyTorch version.
template <typename T>
__host__ __device__ __forceinline__ T eq_penalty(T mu, T h, T w) {
  return mu * h + T(0.5) * w * h * h;
}

template <typename T>
__host__ __device__ __forceinline__ T ineq_penalty(T mu, T h, T w) {
  const T active = mu * h * (T(1) + w * h);
  const T inactive = mu * h / (T(1) - w * h);
  return h >= T(0) ? active : inactive;
}

inline unsigned grid_for(long long threads, int block) {
  return static_cast<unsigned>((threads + block - 1) / block);
}

}  // namespace ddp
