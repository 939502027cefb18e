// Kernel B2 for the hand-written CUDA models (the kernel itself:
// rollout_launch.cuh).  Replaces
// ddp_generator_tpu/ops/pallas_rollout.py:rollout_call (the pl.pallas_call
// at line 424).  A problem without a hand-written model gets a generated
// one, built at first use from generated/rollout.cu (codegen.py,
// _build.build_model).
#include "models/hand_written.cuh"
#include "rollout_launch.cuh"

// ---- C interface ----
//
// ptrs: xnom, unom, l, L, mu_le, mu_li, x0, w_pen_l, w_pen_f, mu_fe, mu_fi,
// alpha, params, then the outputs cost, ok, xs, xf, us (NULL where a mode
// or an empty AL family has none), then the stage flag run (NULL: always
// run; else a device int, 0 = return at entry, writing nothing).
// params_ld: 0 where params is the one flat array every lane reads, else
// params is lane-major (B, params_ld), row b lane b's flat array (the
// per-lane instantiation: rollout_kernel<M, T, true, ...>).  model: a
// CUDA model name
// ("car_parking", "cartpole", "brachistochrone", "brachistochrone_hli").
// dtype: 0 float32, 1 float64.  block: checked and otherwise unused; the
// block's shape follows from the tile constants (rollout.cuh).  Launches on
// `stream`, does not synchronize, returns cudaGetLastError() or a negative
// ddp code.
extern "C" int ddp_rollout(int dtype, const char* model, int multi,
                           int want_cost, int N, int B, int A, int block,
                           long long params_ld, void* const* ptrs,
                           void* stream) {
  return ddp::rollout_entry<ddp::Models>(dtype, model, multi, want_cost, N, B,
                                         A, block, params_ld, ptrs, stream);
}

// The tile shape and resources of one instantiation (shared params), as
// ddp_backpass_info; out[2] counts all the warps of a block that rolls
// kAlphaChunk alphas (sweep) or one (selected).
extern "C" int ddp_rollout_info(int dtype, const char* model, int multi,
                                int want_cost, int* out) {
  return ddp::rollout_info_entry<ddp::Models>(dtype, model, multi, want_cost,
                                              out);
}
