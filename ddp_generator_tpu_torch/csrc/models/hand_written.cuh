// The `Models` dispatcher of the hand-written CUDA models: Models::with(name,
// g) calls g on the named model's struct, or returns kBadVariant.  The
// launches of B2 (rollout_launch.cuh), B3 (fused_launch.cuh) and the
// emission kernel (emit_launch.cuh) take it as their template parameter in
// rollout.cu, fused.cu and emit.cu; a generated model has a one-model
// dispatcher of its own (generated/*.cu).
#pragma once

#include <string.h>

#include "brachistochrone.cuh"
#include "car_parking.cuh"
#include "cartpole.cuh"

namespace ddp {

struct Models {
  template <class G>
  static int with(const char* model, G g) {
    if (strcmp(model, "car_parking") == 0) return g(CarParking());
    if (strcmp(model, "cartpole") == 0) return g(Cartpole());
    if (strcmp(model, "brachistochrone") == 0) return g(Brachistochrone());
    if (strcmp(model, "brachistochrone_hli") == 0)
      return g(BrachistochroneHli());
    return kBadVariant;
  }
};

}  // namespace ddp
