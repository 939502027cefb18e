// Helpers shared by the hand-written kernels (backpass.cu, rollout.cu,
// fused.cu).
//
// The per-lane functions are __host__ __device__ so that their arithmetic
// can also be compiled by a host C++ compiler (tests/test_torch_dual_host.py
// does so with g++); the kernels only map a thread to a lane and call them.
// Without nvcc the CUDA qualifiers expand to nothing (or `inline`).
#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include <math.h>

#include <cmath>
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace ddp {

// Negative return codes of the C entry points (positive codes are
// cudaError_t values from cudaGetLastError()).
enum ErrorCode {
  kBadShape = -1,      // N, B or block size out of range
  kBadDtype = -2,      // dtype code not 0 (float32) or 1 (float64)
  kBadVariant = -3,    // (n_x, n_u) / reg_type / model not instantiated
  kNullPointer = -4,   // a required operand pointer is NULL
  kNotCapturing = -5,  // a device loop outside a CUDA graph capture
  kOldCuda = -6,       // built with a CUDA toolkit before 12.4
};

// Length of a per-lane array of n entries (C++ has no zero-length arrays).
__host__ __device__ constexpr int arr(int n) { return n > 0 ? n : 1; }

// An int as a type, to pick a template instantiation in a generic lambda.
template <int N>
struct IntC {
  static constexpr int value = N;
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
// the same operation order as the plain PyTorch version.  The multiplier
// and weight are plain numbers T; the constraint value H is T or a
// forward-mode number (dual.cuh), whose branch is chosen by its value.
template <typename T, typename H>
__host__ __device__ __forceinline__ H eq_penalty(T mu, H h, T w) {
  return mu * h + T(0.5) * w * h * h;
}

template <typename T, typename H>
__host__ __device__ __forceinline__ H ineq_penalty(T mu, H h, T w) {
  const H active = mu * h * (T(1) + w * h);
  const H inactive = mu * h / (T(1) - w * h);
  return h >= T(0) ? active : inactive;
}

// Running cost with the hle/hli penalties (al.py: augmented_L) of a CUDA
// model M at (x, u) of type S (T or a forward-mode number); params p,
// multipliers mu_le/mu_li and the weight w are plain T.
template <class M, typename S, typename T>
__host__ __device__ __forceinline__ S aug_L(const S* x, const S* u,
                                            const T* p, int k,
                                            const T* mu_le, const T* mu_li,
                                            T w) {
  S c = M::L(x, u, p, k);
#pragma unroll
  for (int i = 0; i < M::NHLE; ++i)
    c = c + eq_penalty(mu_le[i], M::hle(i, x, u, p, k), w);
#pragma unroll
  for (int i = 0; i < M::NHLI; ++i)
    c = c + ineq_penalty(mu_li[i], M::hli(i, x, u, p, k), w);
  return c;
}

// Final cost with the hfe/hfi penalties (al.py: augmented_F), k = N.
template <class M, typename S, typename T>
__host__ __device__ __forceinline__ S aug_F(const S* x, const T* p, int N,
                                            const T* mu_fe, const T* mu_fi,
                                            T w) {
  S c = M::F(x, p, N);
#pragma unroll
  for (int i = 0; i < M::NHFE; ++i)
    c = c + eq_penalty(mu_fe[i], M::hfe(i, x, p, N), w);
#pragma unroll
  for (int i = 0; i < M::NHFI; ++i)
    c = c + ineq_penalty(mu_fi[i], M::hfi(i, x, p, N), w);
  return c;
}

// f(p) with the parameters a model reads: the fixed ones copied to
// registers, or (M::TAIL) all of them read where they lie.
template <class M, typename T, class F>
__host__ __device__ __forceinline__ void with_params(const T* params, F f) {
  if (M::TAIL) {
    f(params);
  } else {
    T p[arr(M::NP)];
#pragma unroll
    for (int i = 0; i < M::NP; ++i) p[i] = params[i];
    f(static_cast<const T*>(p));
  }
}

// Per-lane parameters: lane b's are row b of a lane-major (B, ld) matrix,
// each row the flat parameter array of one lane in model order (a
// [k]-indexed tail included).
template <typename T>
struct LaneRows {
  const T* rows;
  long long ld;
};

// Lane b's parameters: shared ones as they are (where the kernel's
// with_params placed them), per-lane ones from the lane's row, copied into
// buf as with_params copies them, or (M::TAIL) read where they lie.  buf:
// arr(M::NP) values of the caller's (registers, or shared memory).
template <class M, typename T>
__host__ __device__ __forceinline__ const T* params_for(const T* p,
                                                        int /*b*/,
                                                        T* /*buf*/) {
  return p;
}

template <class M, typename T>
__host__ __device__ __forceinline__ const T* params_for(
    const LaneRows<T>& r, int b, T* buf) {
  const T* row = r.rows + static_cast<size_t>(b) * r.ld;
  if (M::TAIL) return row;
#pragma unroll
  for (int i = 0; i < M::NP; ++i) buf[i] = row[i];
  return buf;
}

inline unsigned grid_for(long long threads, int block) {
  return static_cast<unsigned>((threads + block - 1) / block);
}

#ifdef __CUDACC__
// The message of a return code of the C entry points (ddp_error_string).
inline const char* error_string(int code) {
  switch (code) {
    case kBadShape: return "N, B or block size out of range";
    case kBadDtype: return "dtype code must be 0 (float32) or 1 (float64)";
    case kBadVariant:
      return "no kernel instantiated for these widths/options/model";
    case kNullPointer: return "a required operand pointer is NULL";
    case kNotCapturing: return "the stream is not capturing a CUDA graph";
    case kOldCuda:
      return "built with a CUDA toolkit before 12.4 (no WHILE nodes)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
#endif

}  // namespace ddp
