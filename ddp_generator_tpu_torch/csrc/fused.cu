// Kernel B3 for the hand-written CUDA models (the kernel itself:
// fused_launch.cuh).  Replaces
// ddp_generator_tpu/ops/pallas_fused.py:fused_derivs_back_pass (line 587;
// pl.pallas_call at line 715).  A problem without a hand-written model gets
// a generated one, built at first use from generated/fused.cu (codegen.py,
// _build.build_model).
#include "fused_launch.cuh"
#include "models/brachistochrone.cuh"
#include "models/car_parking.cuh"
#include "models/cartpole.cuh"

namespace ddp {
namespace {

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

}  // namespace
}  // namespace ddp

// ---- C interface ----
//
// ptrs: x, u, mu_le, mu_li, xf, w_pen_l, w_pen_f, lam, mu_fe, mu_fi,
// params, then the outputs l, L, dV, g_norm, failed, derivs_ok (the mu_*
// NULL where the model's AL family is empty).  model: a CUDA model name
// ("car_parking", "cartpole", "brachistochrone", "brachistochrone_hli").
// dtype: 0 float32, 1 float64.  Launches on `stream`, does not
// synchronize, returns cudaGetLastError() or a negative ddp code.
extern "C" int ddp_fused(int dtype, const char* model, int reg_type,
                         int full_ddp, int N, int B, void* const* ptrs,
                         void* stream) {
  return ddp::fused_entry<ddp::Models>(dtype, model, reg_type, full_ddp, N, B,
                                       ptrs, stream);
}

// The tile shape and resources of one instantiation, as ddp_backpass_info.
extern "C" int ddp_fused_info(int dtype, const char* model, int reg_type,
                              int full_ddp, int* out) {
  return ddp::fused_info_entry<ddp::Models>(dtype, model, reg_type, full_ddp,
                                            out);
}
