// The kernel path's derivative emission for the hand-written CUDA models
// (the kernels themselves: emit_launch.cuh, emit.cuh).  Replaces
// ops/cm_derivs.py:cm_emit on a card.  A problem without a hand-written
// model gets a generated one, built at first use from generated/emit.cu
// (codegen.py, _build.build_model).
#include "emit_launch.cuh"
#include "models/hand_written.cuh"

// ---- C interface ----
//
// ptrs: xs, us, mu_le, mu_li, mu_fe, mu_fi, w_pen_l, w_pen_f, params, then
// the outputs bundle (NT, N, B), final_cx (n_x, B), final_cxx (n_x*n_x, B),
// ok (B,) bool (the mu_* NULL where the model's AL family is empty).  per:
// work items a thread takes, 1 .. the items of a point.  params_ld: 0
// where params is the one flat array every lane reads, else params is
// lane-major (B, params_ld), row b lane b's flat array.  model: a CUDA
// model name ("car_parking", "cartpole", "brachistochrone",
// "brachistochrone_hli").  dtype: 0 float32, 1 float64.  Launches on
// `stream`, does not synchronize, returns cudaGetLastError() or a negative
// ddp code.
extern "C" int ddp_emit(int dtype, const char* model, int full_ddp, int per,
                        int N, int B, long long params_ld, void* const* ptrs,
                        void* stream) {
  return ddp::emit_entry<ddp::Models>(dtype, model, full_ddp, per, N, B,
                                      params_ld, ptrs, stream);
}

// out: threads a block, work items a point, then registers and local bytes
// a thread of the step kernel and of the final kernel (shared params).
extern "C" int ddp_emit_info(int dtype, const char* model, int full_ddp,
                             int* out) {
  return ddp::emit_info_entry<ddp::Models>(dtype, model, full_ddp, out);
}
