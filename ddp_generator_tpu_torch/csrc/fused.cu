// Kernel B3: derivatives and backward pass fused, one thread per batch lane.
//
// Replaces ddp_generator_tpu/ops/pallas_fused.py:fused_derivs_back_pass
// (line 587; pl.pallas_call at line 715, body _make_fused_kernel at :456).
// Like kernel B1 (backpass.cu) each thread walks t = N-1 .. 0 with Vx/Vxx,
// dV, g and the failure flag in registers, but it reads only the nominal
// (x_t, u_t) and the running multipliers of its step (coalesced over
// lanes) and computes every derivative itself by forward mode on the
// problem's CUDA model (derivs.cuh, dual.cuh), then runs the shared
// riccati.cuh step.  At the start it forms Fx/Fxx of the AL-augmented final
// cost at x_N.  Outputs are B1's plus derivs_ok, the per-lane finiteness of
// every derivative object (fused.cuh).
//
// What bounds it on an H100: each step's derivative work (one hyper-dual
// evaluation of f and L per direction pair) does not depend on the carry,
// so it is independent work beside B1's latency-bound chain of dependent
// Riccati steps; with 2048 lanes in 64 warps, registers per thread are the
// limit, and the FULL_DDP tensor terms are folded into Vx . f** as they are
// formed rather than held.  What no longer exists: the packed derivative
// bundle of the emission path (ops/cm_derivs.py), ~650 MB in float32 per
// body call at B=2048, N=500 (159 components x 4 B x 500 x 2048), written
// and read back, and the ~4k eager launches that emitted it.
//
// The model is a template parameter dispatched by name, as in rollout.cu.
#include "common.cuh"
#include "fused.cuh"
#include "models/brachistochrone.cuh"
#include "models/car_parking.cuh"

#include <string.h>

namespace ddp {
namespace {

template <class M, typename T, int REG, bool FULL>
__global__ void fused_kernel(const FusedArgs<T> args) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < args.B) fused_lane<M, T, REG, FULL>(args, b);
}

template <class M, typename T>
int launch_model(int reg_type, bool full_ddp, const FusedArgs<T>& a,
                 int block, cudaStream_t stream) {
  const bool need_al = (M::NHLE && !a.mu_le) || (M::NHLI && !a.mu_li) ||
                       (M::NHFE && !a.mu_fe) || (M::NHFI && !a.mu_fi);
  if (need_al) return kNullPointer;
  const unsigned grid = grid_for(a.B, block);
  if (reg_type == 1 && full_ddp)
    fused_kernel<M, T, 1, true><<<grid, block, 0, stream>>>(a);
  else if (reg_type == 1)
    fused_kernel<M, T, 1, false><<<grid, block, 0, stream>>>(a);
  else if (reg_type == 2 && full_ddp)
    fused_kernel<M, T, 2, true><<<grid, block, 0, stream>>>(a);
  else if (reg_type == 2)
    fused_kernel<M, T, 2, false><<<grid, block, 0, stream>>>(a);
  else
    return kBadVariant;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const char* model, int reg_type, bool full_ddp, int N, int B,
           int block, void* const* p, cudaStream_t stream) {
  FusedArgs<T> a;
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(p[i]); };
  a.x = in(0); a.u = in(1); a.mu_le = in(2); a.mu_li = in(3);
  a.xf = in(4); a.wpl = in(5); a.wpf = in(6); a.lam = in(7);
  a.mu_fe = in(8); a.mu_fi = in(9); a.params = in(10);
  a.l = out(11); a.L = out(12); a.dV = out(13); a.g_norm = out(14);
  a.failed = static_cast<bool*>(p[15]);
  a.derivs_ok = static_cast<bool*>(p[16]);
  a.N = N;
  a.B = B;
  for (int i : {0, 1, 4, 5, 6, 7, 10, 11, 12, 13, 14, 15, 16})
    if (p[i] == nullptr) return kNullPointer;
  if (strcmp(model, "car_parking") == 0)
    return launch_model<CarParking, T>(reg_type, full_ddp, a, block, stream);
  if (strcmp(model, "brachistochrone") == 0)
    return launch_model<Brachistochrone, T>(reg_type, full_ddp, a, block,
                                            stream);
  if (strcmp(model, "brachistochrone_hli") == 0)
    return launch_model<BrachistochroneHli, T>(reg_type, full_ddp, a, block,
                                               stream);
  return kBadVariant;
}

}  // namespace
}  // namespace ddp

// ---- C interface ----
//
// ptrs: x, u, mu_le, mu_li, xf, w_pen_l, w_pen_f, lam, mu_fe, mu_fi,
// params, then the outputs l, L, dV, g_norm, failed, derivs_ok (the mu_*
// NULL where the model's AL family is empty).  model: a CUDA model name
// ("car_parking", "brachistochrone", "brachistochrone_hli").  dtype: 0
// float32, 1 float64.  Launches on `stream`, does not synchronize, returns
// cudaGetLastError() or a negative ddp code.
extern "C" int ddp_fused(int dtype, const char* model, int reg_type,
                         int full_ddp, int N, int B, int block,
                         void* const* ptrs, void* stream) {
  if (N < 1 || B < 1 || block < 1 || block > 1024) return ddp::kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ddp::launch<float>(model, reg_type, full_ddp != 0, N, B, block,
                              ptrs, s);
  if (dtype == 1)
    return ddp::launch<double>(model, reg_type, full_ddp != 0, N, B, block,
                               ptrs, s);
  return ddp::kBadDtype;
}
