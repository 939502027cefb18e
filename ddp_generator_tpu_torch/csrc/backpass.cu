// Kernel B1 for the built-in models' shapes (the kernel itself:
// backpass_launch.cuh).  Replaces
// ddp_generator_tpu/ops/pallas_backpass.py:pallas_back_pass_cm (the
// pl.pallas_call at line 682).  Other (n_x, n_u) are built at first use
// from generated/backpass.cu (_build.build_backpass_shape).
#include "backpass_launch.cuh"

namespace ddp {
namespace {

// CarParking (4, 2), Cartpole (4, 1), the Brachistochrones (1, 1).
struct Shapes {
  template <class G>
  static int with(int n_x, int n_u, G g) {
    if (n_x == 4 && n_u == 2) return g(IntC<4>(), IntC<2>());
    if (n_x == 4 && n_u == 1) return g(IntC<4>(), IntC<1>());
    if (n_x == 1 && n_u == 1) return g(IntC<1>(), IntC<1>());
    return kBadVariant;
  }
};

}  // namespace
}  // namespace ddp

// ---- C interface ----
//
// ptrs: fx, fu, cx, cu, cxx, cuu, cxu, fxx, fuu, fxu, lower, upper,
// lower_hx, upper_hx, lower_sign, upper_sign, us, lam, final_cx, final_cxx,
// then the outputs l, L, dV, g_norm, failed (fxx/fuu/fxu NULL when
// full_ddp == 0).  dtype: 0 float32, 1 float64.  Launches on `stream`,
// does not synchronize, returns cudaGetLastError() or a negative ddp code.
extern "C" int ddp_backpass(int dtype, int n_x, int n_u, int reg_type,
                            int full_ddp, int N, int B, void* const* ptrs,
                            void* stream) {
  return ddp::backpass_entry<ddp::Shapes>(dtype, n_x, n_u, reg_type, full_ddp,
                                         N, B, ptrs, stream);
}

// The tile shape and resources of one instantiation: out[0..6] = lanes per
// block, steps per tile, producer warps, dynamic shared memory per block
// (bytes), registers per thread, local memory per thread (bytes; stack
// frame and spill), threads per lane.
extern "C" int ddp_backpass_info(int dtype, int n_x, int n_u, int reg_type,
                                 int full_ddp, int* out) {
  return ddp::backpass_info_entry<ddp::Shapes>(dtype, n_x, n_u, reg_type,
                                              full_ddp, out);
}

extern "C" const char* ddp_error_string(int code) {
  return ddp::error_string(code);
}
