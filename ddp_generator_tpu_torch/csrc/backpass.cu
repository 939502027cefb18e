// Kernel B1: the whole DDP backward pass, one thread per batch lane.
//
// Replaces ddp_generator_tpu/ops/pallas_backpass.py:pallas_back_pass_cm
// (pl.pallas_call at line 682; math in riccati_step, _sym_solve_small and
// _patterns).  The TPU kernel walked time as a sequential grid and carried
// Vx/Vxx in VMEM scratch; here each thread loops t = N-1 .. 0 and keeps
// Vx/Vxx, dV, g and the failure flag in registers.
//
// What bounds it on an H100: latency, not bandwidth.  Each step needs the
// previous step's value function, so a lane is one long dependent chain of
// ~2k flops per step, and B=2048 lanes are only 64 warps.  The bundle
// (~160 components per step) is read once, coalesced: component c of step
// t for lane b sits at c*N*B + t*B + b, so a warp reads 32 consecutive
// values.  Small blocks (32 threads, chosen by the wrapper) spread those
// warps over as many SMs as possible.
//
// Semantics (back_pass.c:38-257, as pallas_backpass.py): each step is
// riccati.cuh:riccati_step on the step's bundle entries; once a step fails
// the lane writes zeros and its carry, dV and g freeze (riccati.cuh:
// advance); g_norm is divided by N-1.
#include "common.cuh"
#include "riccati.cuh"

namespace ddp {
namespace {

template <typename T>
struct BackpassArgs {
  // inputs, component-outer (C, N, B); cxx, cuu and the last two axes of
  // fxx/fuu packed as row-major upper triangles
  const T *fx, *fu, *cx, *cu, *cxx, *cuu, *cxu, *fxx, *fuu, *fxu;
  const T *lower, *upper, *lo_hx, *up_hx, *lo_s, *up_s;
  const T* us;         // (n_u, N, B)
  const T* lam;        // (1, B)
  const T* final_cx;   // (n_x, B)
  const T* final_cxx;  // (n_x*n_x, B)
  // outputs, (N, C, B)
  T* l;                // (N, n_u, B)
  T* L;                // (N, n_u*n_x, B)
  T* dV;               // (2, B)
  T* g_norm;           // (1, B)
  bool* failed;        // (1, B)
  int N, B;
};

template <typename T, int NX, int NU, int REG, bool FULL>
__host__ __device__ void backpass_lane(const BackpassArgs<T>& A, int b) {
  constexpr int TX = NX * (NX + 1) / 2, TU = NU * (NU + 1) / 2;
  const int N = A.N, B = A.B;
  const size_t NB = static_cast<size_t>(N) * B;

  Carry<T, NX> c;
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    c.Vx[a] = A.final_cx[a * B + b];
#pragma unroll
    for (int e = 0; e < NX; ++e) c.Vxx[a][e] = A.final_cxx[(a * NX + e) * B + b];
  }
  c.dv0 = c.dv1 = c.g = c.fail = T(0);
  const T lam = A.lam[b];

  for (int t = N - 1; t >= 0; --t) {
    const size_t o = static_cast<size_t>(t) * B + b;
    auto ld = [&](const T* p, int comp) -> T {
      return p[static_cast<size_t>(comp) * NB + o];
    };
    // ---- loads (one coalesced read per component) ----
    StepTerms<T, NX, NU> d;
    T u[NU];
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      d.cx[a] = ld(A.cx, a);
#pragma unroll
      for (int e = 0; e < NX; ++e) {
        d.fx[a][e] = ld(A.fx, a * NX + e);
        d.cxx[a][e] = ld(A.cxx, tri(a, e, NX));
      }
#pragma unroll
      for (int e = 0; e < NU; ++e) {
        d.fu[a][e] = ld(A.fu, a * NU + e);
        d.cxu[a][e] = ld(A.cxu, a * NU + e);
      }
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      d.cu[a] = ld(A.cu, a);
#pragma unroll
      for (int e = 0; e < NU; ++e) d.cuu[a][e] = ld(A.cuu, tri(a, e, NU));
      d.lower[a] = ld(A.lower, a);
      d.upper[a] = ld(A.upper, a);
      d.lo_s[a] = ld(A.lo_s, a);
      d.up_s[a] = ld(A.up_s, a);
      u[a] = ld(A.us, a);
#pragma unroll
      for (int e = 0; e < NX; ++e) {
        d.lo_hx[a][e] = ld(A.lo_hx, a * NX + e);
        d.up_hx[a][e] = ld(A.up_hx, a * NX + e);
      }
    }
    if (FULL) {
      // Vx . f**: contraction over the dynamics output index i
#pragma unroll
      for (int a = 0; a < NX; ++a) {
#pragma unroll
        for (int e = 0; e < NU; ++e) {
          T s = c.Vx[0] * ld(A.fxu, (0 * NX + a) * NU + e);
#pragma unroll
          for (int i = 1; i < NX; ++i)
            s = s + c.Vx[i] * ld(A.fxu, (i * NX + a) * NU + e);
          d.vfxu[a][e] = s;
        }
#pragma unroll
        for (int e = 0; e < NX; ++e) {
          T s = c.Vx[0] * ld(A.fxx, 0 * TX + tri(a, e, NX));
#pragma unroll
          for (int i = 1; i < NX; ++i)
            s = s + c.Vx[i] * ld(A.fxx, i * TX + tri(a, e, NX));
          d.vfxx[a][e] = s;
        }
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int e = 0; e < NU; ++e) {
          T s = c.Vx[0] * ld(A.fuu, 0 * TU + tri(a, e, NU));
#pragma unroll
          for (int i = 1; i < NX; ++i)
            s = s + c.Vx[i] * ld(A.fuu, i * TU + tri(a, e, NU));
          d.vfuu[a][e] = s;
        }
      }
    }

    StepOut<T, NX, NU> so;
    riccati_step<T, NX, NU, REG, FULL>(d, u, lam, c.Vx, c.Vxx, so);
    const T live = advance(c, so);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      A.l[(static_cast<size_t>(t) * NU + a) * B + b] = live * so.l[a];
#pragma unroll
      for (int e = 0; e < NX; ++e)
        A.L[(static_cast<size_t>(t) * NU * NX + a * NX + e) * B + b] =
            live * so.L[a][e];
    }
  }
  A.dV[b] = c.dv0;
  A.dV[B + b] = c.dv1;
  A.g_norm[b] = c.g / static_cast<T>(N - 1);
  A.failed[b] = c.fail > T(0);
}

template <typename T, int NX, int NU, int REG, bool FULL>
__global__ void backpass_kernel(const BackpassArgs<T> args) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < args.B) backpass_lane<T, NX, NU, REG, FULL>(args, b);
}

template <typename T, int NX, int NU>
int launch_shape(int reg_type, bool full_ddp, const BackpassArgs<T>& args,
                 int block, cudaStream_t stream) {
  const unsigned grid = grid_for(args.B, block);
  if (reg_type == 1 && full_ddp)
    backpass_kernel<T, NX, NU, 1, true><<<grid, block, 0, stream>>>(args);
  else if (reg_type == 1)
    backpass_kernel<T, NX, NU, 1, false><<<grid, block, 0, stream>>>(args);
  else if (reg_type == 2 && full_ddp)
    backpass_kernel<T, NX, NU, 2, true><<<grid, block, 0, stream>>>(args);
  else if (reg_type == 2)
    backpass_kernel<T, NX, NU, 2, false><<<grid, block, 0, stream>>>(args);
  else
    return kBadVariant;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int n_x, int n_u, int reg_type, bool full_ddp, int N, int B,
           int block, void* const* p, cudaStream_t stream) {
  BackpassArgs<T> a;
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(p[i]); };
  a.fx = in(0);  a.fu = in(1);  a.cx = in(2);  a.cu = in(3);
  a.cxx = in(4); a.cuu = in(5); a.cxu = in(6);
  a.fxx = in(7); a.fuu = in(8); a.fxu = in(9);
  a.lower = in(10); a.upper = in(11); a.lo_hx = in(12); a.up_hx = in(13);
  a.lo_s = in(14);  a.up_s = in(15);
  a.us = in(16); a.lam = in(17); a.final_cx = in(18); a.final_cxx = in(19);
  a.l = out(20); a.L = out(21); a.dV = out(22); a.g_norm = out(23);
  a.failed = static_cast<bool*>(p[24]);
  a.N = N;
  a.B = B;
  for (int i = 0; i < 25; ++i) {
    const bool full_only = i >= 7 && i <= 9;
    if (p[i] == nullptr && !(full_only && !full_ddp)) return kNullPointer;
  }
  if (n_x == 4 && n_u == 2)
    return launch_shape<T, 4, 2>(reg_type, full_ddp, a, block, stream);
  if (n_x == 4 && n_u == 1)
    return launch_shape<T, 4, 1>(reg_type, full_ddp, a, block, stream);
  if (n_x == 1 && n_u == 1)
    return launch_shape<T, 1, 1>(reg_type, full_ddp, a, block, stream);
  return kBadVariant;
}

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
                            int full_ddp, int N, int B, int block,
                            void* const* ptrs, void* stream) {
  if (N < 1 || B < 1 || block < 1 || block > 1024) return ddp::kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ddp::launch<float>(n_x, n_u, reg_type, full_ddp != 0, N, B, block,
                              ptrs, s);
  if (dtype == 1)
    return ddp::launch<double>(n_x, n_u, reg_type, full_ddp != 0, N, B, block,
                               ptrs, s);
  return ddp::kBadDtype;
}

extern "C" const char* ddp_error_string(int code) {
  switch (code) {
    case ddp::kBadShape: return "N, B or block size out of range";
    case ddp::kBadDtype: return "dtype code must be 0 (float32) or 1 (float64)";
    case ddp::kBadVariant: return "no kernel instantiated for these widths/options/model";
    case ddp::kNullPointer: return "a required operand pointer is NULL";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
