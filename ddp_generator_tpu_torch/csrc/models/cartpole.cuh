// Cartpole as __host__ __device__ functions: the hand-written twin of
// ddp_generator_tpu_torch/models/cartpole.py for the rollout kernel (B2)
// and the fused derivatives + backward-pass kernel (B3).
//
// 4 states [z, th, dz, dth] (cart position, pole angle from upright, their
// rates), 1 input fc (cart force), the cart-pole manipulator equations with
// semi-implicit Euler steps, quadratic costs and 2 box constraints on fc.
// Every expression keeps the operation order of the torch functions, so the
// two round alike; in particular the divisions by mc + mp sin^2(th) and by
// l (mc + mp sin^2(th)) are the torch function's, one each.  States and
// inputs have type T (plain, or a forward-mode number of dual.cuh when B3
// differentiates); parameters stay plain (P).
#pragma once

#include "../common.cuh"

namespace ddp {

struct Cartpole {
  static constexpr int NX = 4, NU = 1;
  static constexpr int NH = 2;  // box constraints h1, h2
  static constexpr int NHLE = 0, NHLI = 0, NHFE = 0, NHFI = 0;
  // Flat parameter order (models/cartpole.py: CUDA_MODEL):
  // mc, mp, l, g, dt, cu, cz, cf[4], limF[2].
  static constexpr int P_MC = 0, P_MP = 1, P_L = 2, P_G = 3, P_DT = 4,
                       P_CU = 5, P_CZ = 6, P_CF = 7, P_LIMF = 11;
  static constexpr int NP = 13;
  static constexpr bool TAIL = false;  // no [k]-indexed parameter

  // box_meta (u_index, sign) of h1, h2: a lower, then an upper bound on fc.
  __host__ __device__ static constexpr int box_index(int) { return 0; }
  __host__ __device__ static constexpr int box_sign(int i) {
    return i == 0 ? -1 : 1;
  }

  template <typename T, typename P>
  __host__ __device__ static void f(const T* x, const T* u, const P* p,
                                    int /*k*/, T* xn) {
    const T th = x[1], dz = x[2], dth = x[3];
    const T fc = u[0];
    const P mc = p[P_MC], mp = p[P_MP], lp = p[P_L], g = p[P_G],
            dt = p[P_DT];
    const T s = sin(th), c = cos(th);
    const T denom = mc + mp * s * s;
    const T ddz = (fc + mp * s * (lp * dth * dth + g * c)) / denom;
    const T ddth = (-fc * c - mp * lp * dth * dth * c * s - (mc + mp) * g * s) /
                   (lp * denom);
    // semi-implicit Euler: rates first, then positions with the new rates
    const T dz_n = dz + dt * ddz;
    const T dth_n = dth + dt * ddth;
    xn[0] = x[0] + dt * dz_n;
    xn[1] = th + dt * dth_n;
    xn[2] = dz_n;
    xn[3] = dth_n;
  }

  template <typename T, typename P>
  __host__ __device__ static T L(const T* x, const T* u, const P* p,
                                 int /*k*/) {
    return p[P_CU] * (u[0] * u[0]) + p[P_CZ] * (x[0] * x[0]);
  }

  template <typename T, typename P>
  __host__ __device__ static T F(const T* x, const P* p, int /*k*/) {
    const P* cf = p + P_CF;
    return cf[0] * (x[0] * x[0]) + cf[1] * (P(1) - cos(x[1])) +
           cf[2] * (x[2] * x[2]) + cf[3] * (x[3] * x[3]);
  }

  // h[i] < 0: h1 = -fc + limF[0], h2 = fc - limF[1]
  template <typename T, typename P>
  __host__ __device__ static T h(int i, const T* /*x*/, const T* u,
                                 const P* p, int /*k*/) {
    return i == 0 ? -u[0] + p[P_LIMF] : u[0] - p[P_LIMF + 1];
  }

  // No general constraints: the AL families are empty.
  template <typename T, typename P>
  __host__ __device__ static T hle(int, const T*, const T*, const P*, int) {
    return T(0);
  }
  template <typename T, typename P>
  __host__ __device__ static T hli(int, const T*, const T*, const P*, int) {
    return T(0);
  }
  template <typename T, typename P>
  __host__ __device__ static T hfe(int, const T*, const P*, int) {
    return T(0);
  }
  template <typename T, typename P>
  __host__ __device__ static T hfi(int, const T*, const P*, int) {
    return T(0);
  }
};

}  // namespace ddp
