// Kernel B1 at one (n_x, n_u) outside backpass.cu's shapes, built at first
// use with -DDDP_NX=<n_x> -DDDP_NU=<n_u> (_build.build_backpass_shape).
// The entry points are backpass.cu's, for that one shape.
#include "backpass_launch.cuh"

namespace ddp {
namespace {

struct Shapes {
  template <class G>
  static int with(int n_x, int n_u, G g) {
    if (n_x == DDP_NX && n_u == DDP_NU)
      return g(IntC<DDP_NX>(), IntC<DDP_NU>());
    return kBadVariant;
  }
};

}  // namespace
}  // namespace ddp

extern "C" int ddp_backpass(int dtype, int n_x, int n_u, int reg_type,
                            int full_ddp, int N, int B, void* const* ptrs,
                            void* stream) {
  return ddp::backpass_entry<ddp::Shapes>(dtype, n_x, n_u, reg_type, full_ddp,
                                         N, B, ptrs, stream);
}

extern "C" int ddp_backpass_info(int dtype, int n_x, int n_u, int reg_type,
                                 int full_ddp, int* out) {
  return ddp::backpass_info_entry<ddp::Shapes>(dtype, n_x, n_u, reg_type,
                                              full_ddp, out);
}

extern "C" const char* ddp_error_string(int code) {
  return ddp::error_string(code);
}
