// Kernel B2: the line-search rollouts, one thread per trajectory.
//
// Replaces ddp_generator_tpu/ops/pallas_rollout.py:rollout_call
// (pl.pallas_call at line 424, body _make_rollout_kernel).  The TPU kernel
// walked time as a sequential grid with the state in VMEM scratch and traced
// the user's Python functions inside itself; here each thread loops
// k = 0 .. N-1 with the state in registers and calls the hand-written
// __device__ functions of a CUDA model (models/*.cuh), templated in.
//
// Two modes:
//  * MULTI: the cost sweep, one thread per (alpha, lane): total cost and ok
//    flag per alpha, no trajectories;
//  * selected: one thread per lane with its own alpha; writes xs, xf, us
//    and, with WANT_COST, the total cost and ok flag.
//
// What bounds it on an H100: the dependent chain of transcendentals per
// step (sin, cos, asin, sqrt for CarParking) at low occupancy (16k threads
// in the sweep, 2k in the selected rollout); the ~16 values read per step
// are coalesced over lanes, and the sweep's alphas of one lane read the
// same addresses.
//
// Semantics (pallas_rollout.py:_make_rollout_kernel, ops/forward.py):
// u = u_nom + alpha*l + L*dx, exactly u_nom when alpha == 0; sequential
// clamping in constraint order, every limit from the unclamped u; the
// running cost with AL penalties; ok needs a finite cost and state at every
// step while the cost keeps accumulating; the final cost F(x_N, p, N) with
// the hfe/hfi penalties.
#include "common.cuh"
#include "models/car_parking.cuh"

#include <string.h>

namespace ddp {
namespace {

template <typename T>
struct RolloutArgs {
  const T* xnom;   // (N, NX, B)
  const T* unom;   // (N, NU, B)
  const T* l;      // (N, NU, B)
  const T* L;      // (N, NU*NX, B)
  const T* mu_le;  // (N, NHLE, B)
  const T* mu_li;  // (N, NHLI, B)
  const T* x0;     // (NX, B)
  const T* wpl;    // (1, B)
  const T* wpf;    // (1, B)
  const T* mu_fe;  // (NHFE, B)
  const T* mu_fi;  // (NHFI, B)
  const T* alpha;  // MULTI: the (A,) schedule; selected: (1, B) per lane
  const T* params; // (NP,) flat, model order
  T* cost;         // MULTI: (A, B); selected + WANT_COST: (1, B)
  bool* ok;        // same shape as cost
  T* xs;           // (N, NX, B)   selected only
  T* xf;           // (NX, B)      selected only
  T* us;           // (N, NU, B)   selected only
  int N, B, A;
};

template <typename M, typename T, bool MULTI, bool WANT_COST>
__host__ __device__ void rollout_lane(const RolloutArgs<T>& A, int idx) {
  constexpr int NX = M::NX, NU = M::NU;
  const int N = A.N, B = A.B;
  int b, ai;
  T alpha;
  if (MULTI) {
    ai = idx / B;
    b = idx - ai * B;
    alpha = A.alpha[ai];
  } else {
    ai = 0;
    b = idx;
    alpha = A.alpha[b];
  }
  T p[M::NP];
#pragma unroll
  for (int i = 0; i < M::NP; ++i) p[i] = A.params[i];
  T x[NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) x[a] = A.x0[a * B + b];
  const T wpl = A.wpl[b], wpf = A.wpf[b];
  T c_acc = T(0);
  bool ok = true;

  for (int k = 0; k < N; ++k) {
    const size_t kb = static_cast<size_t>(k);
    T dx[NX];
#pragma unroll
    for (int a = 0; a < NX; ++a)
      dx[a] = x[a] - A.xnom[(kb * NX + a) * B + b];
    T u0[NU], u[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      T du = alpha * A.l[(kb * NU + j) * B + b];
#pragma unroll
      for (int a = 0; a < NX; ++a)
        du = du + A.L[(kb * NU * NX + j * NX + a) * B + b] * dx[a];
      const T un = A.unom[(kb * NU + j) * B + b];
      // alpha == 0: the exact open-loop branch (iLQG_func.tem:155-158)
      u0[j] = alpha == T(0) ? un : un + du;
      u[j] = u0[j];
    }
    // clampU (iLQG_func.tem:68-73)
#pragma unroll
    for (int i = 0; i < M::NH; ++i) {
      const int j = M::box_index(i);
      const T s = static_cast<T>(M::box_sign(i));
      const T lim = -s * (M::h(i, x, u0, p, k) - s * u0[j]);
      u[j] = M::box_sign(i) > 0 ? nan_min(u[j], lim) : nan_max(u[j], lim);
    }
    T c = M::L(x, u, p, k);
#pragma unroll
    for (int i = 0; i < M::NHLE; ++i)
      c = c + eq_penalty(A.mu_le[(kb * M::NHLE + i) * B + b],
                         M::hle(i, x, u, p, k), wpl);
#pragma unroll
    for (int i = 0; i < M::NHLI; ++i)
      c = c + ineq_penalty(A.mu_li[(kb * M::NHLI + i) * B + b],
                           M::hli(i, x, u, p, k), wpl);
    T xn[NX];
    M::f(x, u, p, k, xn);
    bool ok_k = is_finite(c);
#pragma unroll
    for (int a = 0; a < NX; ++a) ok_k = ok_k && is_finite(xn[a]);
    if (!MULTI) {
#pragma unroll
      for (int a = 0; a < NX; ++a) A.xs[(kb * NX + a) * B + b] = x[a];
#pragma unroll
      for (int j = 0; j < NU; ++j) A.us[(kb * NU + j) * B + b] = u[j];
    }
    c_acc = c_acc + c;
    ok = ok && ok_k;
#pragma unroll
    for (int a = 0; a < NX; ++a) x[a] = xn[a];
  }
  if (MULTI || WANT_COST) {
    T cf = M::F(x, p, N);
#pragma unroll
    for (int i = 0; i < M::NHFE; ++i)
      cf = cf + eq_penalty(A.mu_fe[i * B + b], M::hfe(i, x, p, N), wpf);
#pragma unroll
    for (int i = 0; i < M::NHFI; ++i)
      cf = cf + ineq_penalty(A.mu_fi[i * B + b], M::hfi(i, x, p, N), wpf);
    A.cost[ai * B + b] = c_acc + cf;
    A.ok[ai * B + b] = ok && is_finite(cf);
  }
  if (!MULTI) {
#pragma unroll
    for (int a = 0; a < NX; ++a) A.xf[a * B + b] = x[a];
  }
}

template <typename M, typename T, bool MULTI, bool WANT_COST>
__global__ void rollout_kernel(const RolloutArgs<T> args) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int total = MULTI ? args.A * args.B : args.B;
  if (idx < total) rollout_lane<M, T, MULTI, WANT_COST>(args, idx);
}

template <typename M, typename T>
int launch_model(bool multi, bool want_cost, const RolloutArgs<T>& a,
                 int block, cudaStream_t stream) {
  const bool need_al = (M::NHLE && !a.mu_le) || (M::NHLI && !a.mu_li) ||
                       (M::NHFE && !a.mu_fe) || (M::NHFI && !a.mu_fi);
  if (need_al) return kNullPointer;
  if (multi) {
    if (!a.cost || !a.ok) return kNullPointer;
    const unsigned grid = grid_for(static_cast<long long>(a.A) * a.B, block);
    rollout_kernel<M, T, true, true><<<grid, block, 0, stream>>>(a);
  } else {
    if (!a.xs || !a.xf || !a.us) return kNullPointer;
    const unsigned grid = grid_for(a.B, block);
    if (want_cost) {
      if (!a.cost || !a.ok) return kNullPointer;
      rollout_kernel<M, T, false, true><<<grid, block, 0, stream>>>(a);
    } else {
      rollout_kernel<M, T, false, false><<<grid, block, 0, stream>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const char* model, bool multi, bool want_cost, int N, int B,
           int A, int block, void* const* p, cudaStream_t stream) {
  RolloutArgs<T> a;
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(p[i]); };
  a.xnom = in(0); a.unom = in(1); a.l = in(2); a.L = in(3);
  a.mu_le = in(4); a.mu_li = in(5); a.x0 = in(6); a.wpl = in(7);
  a.wpf = in(8); a.mu_fe = in(9); a.mu_fi = in(10); a.alpha = in(11);
  a.params = in(12);
  a.cost = out(13);
  a.ok = static_cast<bool*>(p[14]);
  a.xs = out(15); a.xf = out(16); a.us = out(17);
  a.N = N;
  a.B = B;
  a.A = A;
  for (int i : {0, 1, 2, 3, 6, 7, 8, 11, 12})
    if (p[i] == nullptr) return kNullPointer;
  if (strcmp(model, "car_parking") == 0)
    return launch_model<CarParking, T>(multi, want_cost, a, block, stream);
  return kBadVariant;
}

}  // namespace
}  // namespace ddp

// ---- C interface ----
//
// ptrs: xnom, unom, l, L, mu_le, mu_li, x0, w_pen_l, w_pen_f, mu_fe, mu_fi,
// alpha, params, then the outputs cost, ok, xs, xf, us (NULL where a mode
// or an empty AL family has none).  model: a CUDA model name
// ("car_parking").  dtype: 0 float32, 1 float64.  Launches on `stream`,
// does not synchronize, returns cudaGetLastError() or a negative ddp code.
extern "C" int ddp_rollout(int dtype, const char* model, int multi,
                           int want_cost, int N, int B, int A, int block,
                           void* const* ptrs, void* stream) {
  if (N < 1 || B < 1 || A < 1 || block < 1 || block > 1024)
    return ddp::kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ddp::launch<float>(model, multi != 0, want_cost != 0, N, B, A,
                              block, ptrs, s);
  if (dtype == 1)
    return ddp::launch<double>(model, multi != 0, want_cost != 0, N, B, A,
                               block, ptrs, s);
  return ddp::kBadDtype;
}
