// Forward-mode numbers for the in-kernel derivatives of kernel B3
// (fused.cu, derivs.cuh).
//
// Dual2<T>{v, d1, d2, d12} is a hyper-dual number: seeding direction e_a
// into d1 and e_b into d2 and evaluating a model function once gives the
// value, df/da, df/db and d2f/da db -- exact to rounding, no finite
// differences.  This is the CUDA form of the nested jax.jvp inside
// jax.linearize along basis directions in
// ddp_generator_tpu/ops/pallas_fused.py:184-238.  Dual<T>{v, d} is the
// first-order number (one directional derivative).
//
// The value part of every operation is the plain T operation on the value
// parts, so a model evaluated on duals has the same values, bit for bit, as
// the same model evaluated on T; comparisons look at the value only (the
// branch of ineq_penalty, the clamps of the box limits).  Mixed operations
// take a plain T on either side: model parameters and AL multipliers stay
// plain numbers.
#pragma once

#include "common.cuh"

namespace ddp {

// The plain overloads stay visible beside the dual ones declared below.
using ::acos;
using ::asin;
using ::atan;
using ::atan2;
using ::cos;
using ::exp;
using ::fabs;
using ::log;
using ::pow;
using ::sin;
using ::sqrt;
using ::tanh;

// 1/sqrt(v) as ATen computes torch.rsqrt (and x ** -0.5): the card's
// rsqrt in a kernel, a division on the host.
__host__ __device__ __forceinline__ float rsqrt_of(float v) {
#ifdef __CUDA_ARCH__
  return rsqrtf(v);
#else
  return 1.0f / sqrt(v);
#endif
}
__host__ __device__ __forceinline__ double rsqrt_of(double v) {
#ifdef __CUDA_ARCH__
  return rsqrt(v);
#else
  return 1.0 / sqrt(v);
#endif
}

template <typename T>
struct Dual2 {
  T v, d1, d2, d12;
  __host__ __device__ Dual2() {}
  __host__ __device__ Dual2(T c) : v(c), d1(0), d2(0), d12(0) {}
  __host__ __device__ Dual2(T v_, T a, T b, T ab)
      : v(v_), d1(a), d2(b), d12(ab) {}
};

template <typename T>
struct Dual {
  T v, d;
  __host__ __device__ Dual() {}
  __host__ __device__ Dual(T c) : v(c), d(0) {}
  __host__ __device__ Dual(T v_, T d_) : v(v_), d(d_) {}
};

// f(x) with f(x.v) = f0, f'(x.v) = f1, f''(x.v) = f2.
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> chain(const Dual2<T>& x, T f0,
                                                   T f1, T f2) {
  return Dual2<T>(f0, f1 * x.d1, f1 * x.d2, f1 * x.d12 + f2 * x.d1 * x.d2);
}

template <typename T>
__host__ __device__ __forceinline__ Dual<T> chain(const Dual<T>& x, T f0,
                                                  T f1, T /*f2*/) {
  return Dual<T>(f0, f1 * x.d);
}

// f(a, b) with f = f0 and its partials fa, fb, faa, fab, fbb at the values.
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> chain2(const Dual2<T>& a,
                                                    const Dual2<T>& b, T f0,
                                                    T fa, T fb, T faa, T fab,
                                                    T fbb) {
  return Dual2<T>(f0, fa * a.d1 + fb * b.d1, fa * a.d2 + fb * b.d2,
                  fa * a.d12 + fb * b.d12 + faa * a.d1 * a.d2 +
                      fab * (a.d1 * b.d2 + a.d2 * b.d1) + fbb * b.d1 * b.d2);
}

template <typename T>
__host__ __device__ __forceinline__ Dual<T> chain2(const Dual<T>& a,
                                                   const Dual<T>& b, T f0,
                                                   T fa, T fb, T, T, T) {
  return Dual<T>(f0, fa * a.d + fb * b.d);
}

// ---- Dual2 arithmetic ----
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> operator-(const Dual2<T>& a) {
  return Dual2<T>(-a.v, -a.d1, -a.d2, -a.d12);
}
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> operator+(const Dual2<T>& a,
                                                       const Dual2<T>& b) {
  return Dual2<T>(a.v + b.v, a.d1 + b.d1, a.d2 + b.d2, a.d12 + b.d12);
}
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> operator+(const Dual2<T>& a,
                                                       T c) {
  return Dual2<T>(a.v + c, a.d1, a.d2, a.d12);
}
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> operator+(T c,
                                                       const Dual2<T>& a) {
  return Dual2<T>(c + a.v, a.d1, a.d2, a.d12);
}
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> operator-(const Dual2<T>& a,
                                                       const Dual2<T>& b) {
  return Dual2<T>(a.v - b.v, a.d1 - b.d1, a.d2 - b.d2, a.d12 - b.d12);
}
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> operator-(const Dual2<T>& a,
                                                       T c) {
  return Dual2<T>(a.v - c, a.d1, a.d2, a.d12);
}
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> operator-(T c,
                                                       const Dual2<T>& a) {
  return Dual2<T>(c - a.v, -a.d1, -a.d2, -a.d12);
}
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> operator*(const Dual2<T>& a,
                                                       const Dual2<T>& b) {
  return Dual2<T>(a.v * b.v, a.d1 * b.v + a.v * b.d1,
                  a.d2 * b.v + a.v * b.d2,
                  a.d12 * b.v + a.d1 * b.d2 + a.d2 * b.d1 + a.v * b.d12);
}
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> operator*(const Dual2<T>& a,
                                                       T c) {
  return Dual2<T>(a.v * c, a.d1 * c, a.d2 * c, a.d12 * c);
}
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> operator*(T c,
                                                       const Dual2<T>& a) {
  return Dual2<T>(c * a.v, c * a.d1, c * a.d2, c * a.d12);
}
// q = a/b: from a = q*b, q' = (a' - q b')/b and
// q'' = (a'' - q1 b2 - q2 b1 - q b'')/b.
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> operator/(const Dual2<T>& a,
                                                       const Dual2<T>& b) {
  const T q = a.v / b.v;
  const T q1 = (a.d1 - q * b.d1) / b.v;
  const T q2 = (a.d2 - q * b.d2) / b.v;
  return Dual2<T>(q, q1, q2,
                  (a.d12 - q1 * b.d2 - q2 * b.d1 - q * b.d12) / b.v);
}
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> operator/(const Dual2<T>& a,
                                                       T c) {
  return Dual2<T>(a.v / c, a.d1 / c, a.d2 / c, a.d12 / c);
}
template <typename T>
__host__ __device__ __forceinline__ Dual2<T> operator/(T c,
                                                       const Dual2<T>& b) {
  return Dual2<T>(c) / b;
}

// ---- Dual arithmetic ----
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator-(const Dual<T>& a) {
  return Dual<T>(-a.v, -a.d);
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator+(const Dual<T>& a,
                                                      const Dual<T>& b) {
  return Dual<T>(a.v + b.v, a.d + b.d);
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator+(const Dual<T>& a, T c) {
  return Dual<T>(a.v + c, a.d);
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator+(T c, const Dual<T>& a) {
  return Dual<T>(c + a.v, a.d);
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator-(const Dual<T>& a,
                                                      const Dual<T>& b) {
  return Dual<T>(a.v - b.v, a.d - b.d);
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator-(const Dual<T>& a, T c) {
  return Dual<T>(a.v - c, a.d);
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator-(T c, const Dual<T>& a) {
  return Dual<T>(c - a.v, -a.d);
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator*(const Dual<T>& a,
                                                      const Dual<T>& b) {
  return Dual<T>(a.v * b.v, a.d * b.v + a.v * b.d);
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator*(const Dual<T>& a, T c) {
  return Dual<T>(a.v * c, a.d * c);
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator*(T c, const Dual<T>& a) {
  return Dual<T>(c * a.v, c * a.d);
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator/(const Dual<T>& a,
                                                      const Dual<T>& b) {
  const T q = a.v / b.v;
  return Dual<T>(q, (a.d - q * b.d) / b.v);
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator/(const Dual<T>& a, T c) {
  return Dual<T>(a.v / c, a.d / c);
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator/(T c, const Dual<T>& b) {
  return Dual<T>(c) / b;
}

// ---- comparisons on the value part (so where, minimum and maximum of a
// generated model compile on dual numbers too) ----
#define DDP_DUAL_CMP(D, OP)                                                  \
  template <typename T>                                                      \
  __host__ __device__ __forceinline__ bool operator OP(const D<T>& a, T c) { \
    return a.v OP c;                                                         \
  }                                                                          \
  template <typename T>                                                      \
  __host__ __device__ __forceinline__ bool operator OP(T c, const D<T>& a) { \
    return c OP a.v;                                                         \
  }                                                                          \
  template <typename T>                                                      \
  __host__ __device__ __forceinline__ bool operator OP(const D<T>& a,        \
                                                       const D<T>& b) {      \
    return a.v OP b.v;                                                       \
  }
#define DDP_DUAL_CMPS(D) \
  DDP_DUAL_CMP(D, <)     \
  DDP_DUAL_CMP(D, <=)    \
  DDP_DUAL_CMP(D, >)     \
  DDP_DUAL_CMP(D, >=)    \
  DDP_DUAL_CMP(D, ==)    \
  DDP_DUAL_CMP(D, !=)
DDP_DUAL_CMPS(Dual2)
DDP_DUAL_CMPS(Dual)
#undef DDP_DUAL_CMPS
#undef DDP_DUAL_CMP

// ---- elementary functions: f0, f', f'' at the value ----
#define DDP_DUAL_FN(NAME, ...)                                           \
  template <typename T>                                                  \
  __host__ __device__ __forceinline__ Dual2<T> NAME(const Dual2<T>& x) { \
    __VA_ARGS__                                                          \
  }                                                                      \
  template <typename T>                                                  \
  __host__ __device__ __forceinline__ Dual<T> NAME(const Dual<T>& x) {   \
    __VA_ARGS__                                                          \
  }
DDP_DUAL_FN(sin, {
  const T s = sin(x.v), c = cos(x.v);
  return chain(x, s, c, -s);
})
DDP_DUAL_FN(cos, {
  const T s = sin(x.v), c = cos(x.v);
  return chain(x, c, -s, -c);
})
// sqrt: f' = 1/(2 sqrt v), f'' = -f'/(2 v)
DDP_DUAL_FN(sqrt, {
  const T r = sqrt(x.v);
  const T f1 = T(0.5) / r;
  return chain(x, r, f1, -f1 / (T(2) * x.v));
})
// asin: f' = (1 - v^2)^(-1/2), f'' = v f' / (1 - v^2)
DDP_DUAL_FN(asin, {
  const T w = T(1) - x.v * x.v;
  const T f1 = T(1) / sqrt(w);
  return chain(x, asin(x.v), f1, x.v * f1 / w);
})
// fabs: the derivative of sign(v), 0 at 0 (torch.abs and jnp.abs alike)
DDP_DUAL_FN(fabs, {
  const T sg = x.v > T(0) ? T(1) : (x.v < T(0) ? T(-1) : T(0));
  return chain(x, fabs(x.v), sg, T(0));
})
// The functions a generated model may call beyond the hand-written ones'
// (codegen.py; the JAX kernels' set, ops/pallas_math.py).
DDP_DUAL_FN(exp, {
  const T e = exp(x.v);
  return chain(x, e, e, e);
})
// log: f' = 1/v, f'' = -1/v^2
DDP_DUAL_FN(log, {
  const T f1 = T(1) / x.v;
  return chain(x, log(x.v), f1, -f1 * f1);
})
// tanh: f' = 1 - t^2, f'' = -2 t f'
DDP_DUAL_FN(tanh, {
  const T t = tanh(x.v);
  const T f1 = T(1) - t * t;
  return chain(x, t, f1, T(-2) * t * f1);
})
// acos: f' = -(1 - v^2)^(-1/2), f'' = v f' / (1 - v^2)
DDP_DUAL_FN(acos, {
  const T w = T(1) - x.v * x.v;
  const T f1 = T(-1) / sqrt(w);
  return chain(x, acos(x.v), f1, x.v * f1 / w);
})
// atan: f' = 1/(1 + v^2), f'' = -2 v f'^2
DDP_DUAL_FN(atan, {
  const T f1 = T(1) / (T(1) + x.v * x.v);
  return chain(x, atan(x.v), f1, T(-2) * x.v * f1 * f1);
})
// rsqrt: f = v^(-1/2), f' = -f/(2 v), f'' = 3 f/(4 v^2)
DDP_DUAL_FN(rsqrt_of, {
  const T r = rsqrt_of(x.v);
  return chain(x, r, T(-0.5) * r / x.v, T(0.75) * r / (x.v * x.v));
})
#undef DDP_DUAL_FN

// pow by a constant exponent c: f' = c v^(c-1), f'' = c (c-1) v^(c-2)
#define DDP_DUAL_POW(D)                                                   \
  template <typename T>                                                   \
  __host__ __device__ __forceinline__ D<T> pow(const D<T>& x, T c) {      \
    return chain(x, pow(x.v, c), c * pow(x.v, c - T(1)),                  \
                 c * (c - T(1)) * pow(x.v, c - T(2)));                    \
  }
DDP_DUAL_POW(Dual2)
DDP_DUAL_POW(Dual)
#undef DDP_DUAL_POW

// atan2(y, x): f_y = x/r2, f_x = -y/r2 (r2 = x^2 + y^2), f_yy = -2xy/r2^2,
// f_xx = 2xy/r2^2, f_yx = (y^2 - x^2)/r2^2; a plain operand is a constant.
#define DDP_DUAL_ATAN2(D)                                                   \
  template <typename T>                                                     \
  __host__ __device__ __forceinline__ D<T> atan2(const D<T>& y,             \
                                                 const D<T>& x) {           \
    const T r2 = x.v * x.v + y.v * y.v;                                     \
    const T q = T(2) * x.v * y.v / (r2 * r2);                               \
    return chain2(y, x, atan2(y.v, x.v), x.v / r2, -y.v / r2, -q,           \
                  (y.v * y.v - x.v * x.v) / (r2 * r2), q);                  \
  }                                                                         \
  template <typename T>                                                     \
  __host__ __device__ __forceinline__ D<T> atan2(const D<T>& y, T x) {      \
    return atan2(y, D<T>(x));                                               \
  }                                                                         \
  template <typename T>                                                     \
  __host__ __device__ __forceinline__ D<T> atan2(T y, const D<T>& x) {      \
    return atan2(D<T>(y), x);                                               \
  }
DDP_DUAL_ATAN2(Dual2)
DDP_DUAL_ATAN2(Dual)
#undef DDP_DUAL_ATAN2

}  // namespace ddp
