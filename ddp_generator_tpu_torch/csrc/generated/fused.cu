// Kernel B3 on one generated model (codegen.py), compiled beside
// generated/rollout.cu into the model's library (_build.build_model).  The
// entry points are fused.cu's, for that one model's name.
#include "fused_launch.cuh"
#include "model.cuh"

namespace ddp {
namespace {

struct Models {
  template <class G>
  static int with(const char* model, G g) {
    return strcmp(model, DDP_MODEL::NAME) == 0 ? g(DDP_MODEL()) : kBadVariant;
  }
};

}  // namespace
}  // namespace ddp

extern "C" int ddp_fused(int dtype, const char* model, int reg_type,
                         int full_ddp, int N, int B, void* const* ptrs,
                         void* stream) {
  return ddp::fused_entry<ddp::Models>(dtype, model, reg_type, full_ddp, N, B,
                                       ptrs, stream);
}

extern "C" int ddp_fused_info(int dtype, const char* model, int reg_type,
                              int full_ddp, int* out) {
  return ddp::fused_info_entry<ddp::Models>(dtype, model, reg_type, full_ddp,
                                            out);
}
