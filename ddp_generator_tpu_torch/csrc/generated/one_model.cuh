// The `Models` dispatcher of one generated model (codegen.py): the model's
// header is "model.cuh" on the include path and -DDDP_MODEL names its
// struct (_build.build_model).  generated/rollout.cu, fused.cu and emit.cu
// instantiate their launches on it, as rollout.cu, fused.cu and emit.cu do
// on models/hand_written.cuh.
#pragma once

#include <string.h>

#include "model.cuh"

namespace ddp {

struct Models {
  template <class G>
  static int with(const char* model, G g) {
    return strcmp(model, DDP_MODEL::NAME) == 0 ? g(DDP_MODEL()) : kBadVariant;
  }
};

}  // namespace ddp
