// Kernel B1's operands, its per-lane reference and its producer's tile
// copy.  __host__ __device__, so tests/test_torch_dual_host.py runs them on
// the CPU: backpass_lane is the one-thread-per-lane recursion B1 ran before
// it was staged (kept as the reference the staged kernel must equal bit for
// bit), bundle_fill the copy B1's producer warp makes, with the copy
// itself passed in (cp.async on the card, a plain loop on the host).
#pragma once

#include "common.cuh"
#include "riccati.cuh"
#include "staged.cuh"

namespace ddp {

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

// The carry at t = N: Vx = final_cx, Vxx = final_cxx, accumulators 0.
template <typename T, int NX>
__host__ __device__ __forceinline__ void backpass_start(
    const BackpassArgs<T>& A, int b, Carry<T, NX>& c) {
  const int B = A.B;
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    c.Vx[a] = A.final_cx[a * B + b];
#pragma unroll
    for (int e = 0; e < NX; ++e) c.Vxx[a][e] = A.final_cxx[(a * NX + e) * B + b];
  }
  c.dv0 = c.dv1 = c.g = c.fail = T(0);
}

// One lane's whole recursion, reading the bundle directly.
template <typename T, int NX, int NU, int REG, bool FULL>
__host__ __device__ void backpass_lane(const BackpassArgs<T>& A, int b) {
  constexpr int TX = NX * (NX + 1) / 2, TU = NU * (NU + 1) / 2;
  const int N = A.N, B = A.B;
  const size_t NB = static_cast<size_t>(N) * B;

  Carry<T, NX> c;
  backpass_start(A, b, c);
  const T lam = A.lam[b];

  for (int t = N - 1; t >= 0; --t) {
    const size_t o = static_cast<size_t>(t) * B + b;
    auto ld = [&](const T* p, int comp) -> T {
      return p[static_cast<size_t>(comp) * NB + o];
    };
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
  finish_lane(c, N, B, b, A.dV, A.g_norm, A.failed);
}

// Tile (t0, lanes b0 ..) of the bundle into a slot (staged.cuh: Terms
// order, [term][step][lane]).  The work is cut into chunks of 16 bytes of
// consecutive lanes of one (term, step); this caller takes chunks first,
// first + stride, ...  copy(dst, src, n) moves n <= 16/sizeof(T) values
// (fewer at the ragged lane edge).  Steps t < 0 and lanes >= B are left
// unwritten: the consumer reads neither.
template <typename T, int NX, int NU, bool FULL, int S, class Copy>
__host__ __device__ __forceinline__ void bundle_fill(
    const BackpassArgs<T>& A, int t0, int b0, T* slot, int first, int stride,
    Copy copy) {
  constexpr int TX = NX * (NX + 1) / 2, TU = NU * (NU + 1) / 2;
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // values per chunk
  constexpr int CH = kLanes / E;                       // chunks per row
  static_assert(kLanes % E == 0, "a slot row is whole 16-byte chunks");
  const size_t NB = static_cast<size_t>(A.N) * A.B;
  const T* const field[17] = {A.fx, A.fu, A.cx, A.cu, A.cxx, A.cuu,
                              A.cxu, A.fxx, A.fuu, A.fxu, A.lower, A.upper,
                              A.lo_hx, A.up_hx, A.lo_s, A.up_s, A.us};
  constexpr int ncomp[17] = {NX * NX, NX * NU, NX, NU, TX, TU, NX * NU,
                             FULL ? NX * TX : 0, FULL ? NX * TU : 0,
                             FULL ? NX * NX * NU : 0, NU, NU, NU * NX,
                             NU * NX, NU, NU, NU};
  int term = 0;
#pragma unroll
  for (int f = 0; f < 17; ++f) {
    for (int i = first; i < ncomp[f] * S * CH; i += stride) {
      const int comp = i / (S * CH), s = (i / CH) % S, ch = i % CH;
      const int t = t0 - s, b = b0 + ch * E;
      if (t < 0 || b >= A.B) continue;
      const int n = A.B - b < E ? A.B - b : E;
      copy(slot + ((term + comp) * S + s) * kLanes + ch * E,
           field[f] + static_cast<size_t>(comp) * NB +
               static_cast<size_t>(t) * A.B + b,
           n);
    }
    term += ncomp[f];
  }
}

}  // namespace ddp
