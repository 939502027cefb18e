// Kernel B2 on one generated model (codegen.py): the translation unit that
// _build.build_model compiles with the model's header as "model.cuh" on the
// include path and -DDDP_MODEL=<its struct>.  The entry points are
// rollout.cu's, for that one model's name.
#include "one_model.cuh"
#include "rollout_launch.cuh"

extern "C" int ddp_rollout(int dtype, const char* model, int multi,
                           int want_cost, int N, int B, int A, int block,
                           long long params_ld, void* const* ptrs,
                           void* stream) {
  return ddp::rollout_entry<ddp::Models>(dtype, model, multi, want_cost, N, B,
                                         A, block, params_ld, ptrs, stream);
}

extern "C" int ddp_rollout_info(int dtype, const char* model, int multi,
                                int want_cost, int* out) {
  return ddp::rollout_info_entry<ddp::Models>(dtype, model, multi, want_cost,
                                              out);
}

extern "C" const char* ddp_error_string(int code) {
  return ddp::error_string(code);
}
