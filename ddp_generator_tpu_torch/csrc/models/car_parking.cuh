// CarParking as __device__ functions: the hand-written twin of
// ddp_generator_tpu_torch/models/car_parking.py for the rollout kernel.
//
// 4 states [x_, y_, t, v], 2 inputs [w, a], front-axle kinematics with the
// rolling distance s = d + h*v*cos(w) - sqrt(d^2 - (h*v*sin(w))^2)
// (optDefCar.mac:4), smooth-abs costs and 4 box constraints.  Every
// expression keeps the operation order of the torch functions, so the two
// round alike.
#pragma once

#include "../common.cuh"

namespace ddp {

struct CarParking {
  static constexpr int NX = 4, NU = 2;
  static constexpr int NH = 4;  // box constraints h1..h4
  static constexpr int NHLE = 0, NHLI = 0, NHFE = 0, NHFI = 0;
  // Flat parameter order (models/car_parking.py: CUDA_MODEL):
  // d, h, pf[4], cf[4], cu[2], cx[2], px[2], limW[2], limA[2].
  static constexpr int P_D = 0, P_H = 1, P_PF = 2, P_CF = 6, P_CU = 10,
                       P_CX = 12, P_PX = 14, P_LIMW = 16, P_LIMA = 18;
  static constexpr int NP = 20;

  // box_meta (u_index, sign) of h1..h4: lower/upper bound on w, then on a.
  __host__ __device__ static constexpr int box_index(int i) {
    return i < 2 ? 0 : 1;
  }
  __host__ __device__ static constexpr int box_sign(int i) {
    return (i % 2 == 0) ? -1 : 1;
  }

  template <typename T>
  __host__ __device__ static T sqrt_abs(T x, T e) {
    // sqrtAbs(x, e) := sqrt(x^2 + e^2) - e  (optDefCar.mac:9)
    return sqrt(x * x + e * e) - e;
  }

  template <typename T>
  __host__ __device__ static void f(const T* x, const T* u, const T* p,
                                    int /*k*/, T* xn) {
    const T w = u[0], a = u[1];
    const T t = x[2], v = x[3];
    const T d = p[P_D], h = p[P_H];
    const T hvs = h * v * sin(w);
    const T s = d + h * v * cos(w) - sqrt(d * d - hvs * hvs);
    xn[0] = x[0] + s * cos(t);
    xn[1] = x[1] + s * sin(t);
    xn[2] = t + asin(sin(w) * h * v / d);
    xn[3] = v + h * a;
  }

  template <typename T>
  __host__ __device__ static T L(const T* x, const T* u, const T* p,
                                 int /*k*/) {
    const T* cu = p + P_CU;
    const T* cx = p + P_CX;
    const T* px = p + P_PX;
    return cu[0] * (u[0] * u[0]) + cu[1] * (u[1] * u[1]) +
           cx[0] * sqrt_abs(x[0], px[0]) + cx[1] * sqrt_abs(x[1], px[1]);
  }

  template <typename T>
  __host__ __device__ static T F(const T* x, const T* p, int /*k*/) {
    const T* cf = p + P_CF;
    const T* pf = p + P_PF;
    const T* cx = p + P_CX;
    const T* px = p + P_PX;
    return cf[0] * sqrt_abs(x[0], pf[0]) + cf[1] * sqrt_abs(x[1], pf[1]) +
           cf[2] * sqrt_abs(x[2], pf[2]) + cf[3] * sqrt_abs(x[3], pf[3]) +
           cx[0] * sqrt_abs(x[0], px[0]) + cx[1] * sqrt_abs(x[1], px[1]);
  }

  // h[i] < 0 (optDefCar.mac:17-19)
  template <typename T>
  __host__ __device__ static T h(int i, const T* /*x*/, const T* u,
                                 const T* p, int /*k*/) {
    switch (i) {
      case 0: return -u[0] + p[P_LIMW];
      case 1: return u[0] - p[P_LIMW + 1];
      case 2: return -u[1] + p[P_LIMA];
      default: return u[1] - p[P_LIMA + 1];
    }
  }

  // No general constraints: the AL families are empty.
  template <typename T>
  __host__ __device__ static T hle(int, const T*, const T*, const T*, int) {
    return T(0);
  }
  template <typename T>
  __host__ __device__ static T hli(int, const T*, const T*, const T*, int) {
    return T(0);
  }
  template <typename T>
  __host__ __device__ static T hfe(int, const T*, const T*, int) {
    return T(0);
  }
  template <typename T>
  __host__ __device__ static T hfi(int, const T*, const T*, int) {
    return T(0);
  }
};

}  // namespace ddp
