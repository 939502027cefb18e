// The emission kernel on one generated model (codegen.py), compiled beside
// generated/rollout.cu and generated/fused.cu into the model's library
// (_build.build_model).  The entry points are emit.cu's, for that one
// model's name.
#include "emit_launch.cuh"
#include "one_model.cuh"

extern "C" int ddp_emit(int dtype, const char* model, int full_ddp, int per,
                        int N, int B, long long params_ld, void* const* ptrs,
                        void* stream) {
  return ddp::emit_entry<ddp::Models>(dtype, model, full_ddp, per, N, B,
                                      params_ld, ptrs, stream);
}

extern "C" int ddp_emit_info(int dtype, const char* model, int full_ddp,
                             int* out) {
  return ddp::emit_info_entry<ddp::Models>(dtype, model, full_ddp, out);
}
