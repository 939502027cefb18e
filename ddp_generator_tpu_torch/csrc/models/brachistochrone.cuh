// Brachistochrone as __host__ __device__ functions: the hand-written twins
// of ddp_generator_tpu_torch/models/brachistochrone.py for the rollout
// kernel (B2) and the fused derivatives + backward-pass kernel (B3).
//
// One state y (height, negative), one input dy (slope over a horizontal
// step dx); the running cost is the closed-form travel time of a segment
// (optDefBrachi.mac:10), its difference of square roots rationalized as in
// models/brachistochrone.py (no cancellation where dy is small):
//   L = 2*sqrt((1 + dy^2) / (2 g)) * dx / (sqrt(-y - dx*dy) + sqrt(-y)).
// Every expression keeps the operation order of the torch functions, so the
// two round alike.  States and inputs have type T (plain or a forward-mode
// number of dual.cuh); parameters stay plain (P).
#pragma once

#include "../common.cuh"

namespace ddp {

struct BrachiBase {
  static constexpr int NX = 1, NU = 1;
  static constexpr int NH = 0;  // no box constraints
  static constexpr int NHLE = 0, NHFI = 0;

  __host__ __device__ static constexpr int box_index(int) { return 0; }
  __host__ __device__ static constexpr int box_sign(int) { return 1; }

  template <typename T, typename P>
  __host__ __device__ static T segment_time(T y, T dy, P g, P dx) {
    const T s = sqrt((P(1) + dy * dy) / (P(2) * g));
    return P(2) * s * dx / (sqrt(-y - dx * dy) + sqrt(-y));
  }

  template <typename T, typename P>
  __host__ __device__ static T F(const T* x, const P*, int) {
    return T(0);
  }
  template <typename T, typename P>
  __host__ __device__ static T h(int, const T*, const T*, const P*, int) {
    return T(0);
  }
  template <typename T, typename P>
  __host__ __device__ static T hle(int, const T*, const T*, const P*, int) {
    return T(0);
  }
  template <typename T, typename P>
  __host__ __device__ static T hfi(int, const T*, const P*, int) {
    return T(0);
  }
};

// brachistochrone(): terminal equality hfe = y - yf (optDefBrachi.mac:13).
struct Brachistochrone : BrachiBase {
  static constexpr int NHLI = 0, NHFE = 1;
  // Flat parameter order (models/brachistochrone.py: CUDA_MODEL): g, yf, dx.
  static constexpr int P_G = 0, P_YF = 1, P_DX = 2;
  static constexpr int NP = 3;
  static constexpr bool TAIL = false;

  template <typename T, typename P>
  __host__ __device__ static void f(const T* x, const T* u, const P* p, int,
                                    T* xn) {
    xn[0] = x[0] + u[0] * p[P_DX];
  }
  template <typename T, typename P>
  __host__ __device__ static T L(const T* x, const T* u, const P* p, int) {
    return segment_time(x[0], u[0], p[P_G], p[P_DX]);
  }
  template <typename T, typename P>
  __host__ __device__ static T hli(int, const T*, const T*, const P*, int) {
    return T(0);
  }
  template <typename T, typename P>
  __host__ __device__ static T hfe(int, const T* x, const P* p, int) {
    return x[0] - p[P_YF];
  }
};

// brachistochrone_hli(): the moving floor hli = ymin[k] - y and the
// terminal equality hfe = y - ymin[N] (optDefBrachi_hli.mac:13-14).  ymin
// has N+1 entries and comes last in the flat order, so it is read at
// p[P_YMIN + k]: the parameter array stays in device memory (TAIL).
struct BrachistochroneHli : BrachiBase {
  static constexpr int NHLI = 1, NHFE = 1;
  // Flat parameter order (models/brachistochrone.py: CUDA_MODEL_HLI):
  // g, dx, ymin[N+1].
  static constexpr int P_G = 0, P_DX = 1, P_YMIN = 2;
  static constexpr int NP = 2;  // fixed entries before the tail
  static constexpr bool TAIL = true;

  template <typename T, typename P>
  __host__ __device__ static void f(const T* x, const T* u, const P* p, int,
                                    T* xn) {
    xn[0] = x[0] + u[0] * p[P_DX];
  }
  template <typename T, typename P>
  __host__ __device__ static T L(const T* x, const T* u, const P* p, int) {
    return segment_time(x[0], u[0], p[P_G], p[P_DX]);
  }
  template <typename T, typename P>
  __host__ __device__ static T hli(int, const T* x, const T*, const P* p,
                                   int k) {
    return p[P_YMIN + k] - x[0];
  }
  template <typename T, typename P>
  __host__ __device__ static T hfe(int, const T* x, const P* p, int k) {
    return x[0] - p[P_YMIN + k];
  }
};

}  // namespace ddp
