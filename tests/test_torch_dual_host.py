"""Kernel B3's arithmetic compiled for the host and held against the plain
PyTorch versions, float64.

``csrc/common.cuh`` compiles without CUDA, so the very headers kernel B3
runs -- ``dual.cuh`` (forward-mode numbers), ``derivs.cuh`` (per-step and
final derivatives, box limits), ``riccati.cuh`` (the backward step shared
with B1), ``fused.cuh`` (one lane) and the CUDA models
``models/car_parking.cuh``, ``models/cartpole.cuh`` and
``models/brachistochrone.cuh`` -- are built
here with ``g++`` into a small shared library in a temporary directory and
called through ``ctypes``:

* the derivative objects (``fx``, ``fu``, ``cx``, ``cu``, ``cxx``, ``cuu``,
  ``cxu``, ``fxx``/``fxu``/``fuu`` through their contraction with unit
  ``Vx``, the final ``Fx``/``Fxx`` and the box limits with ``hx``) against
  ``ops/cm_derivs.py`` to 1e-12;
* whole lanes of B3 against ``fused_derivs_back_pass_plain`` (emission and
  B1's plain version) to 1e-10 of the largest value;
* two saved ``brachistochrone_hli`` lanes solved on the CPU with the host
  build in the solver's place (for this model it equals the card's kernel
  bit for bit): every call held to the plain version, and the solve to the
  one the plain version makes.

This is tier-1 coverage of B3's arithmetic without a card.  Skips when no
C++ compiler is found.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch import _build
from ddp_generator_tpu_torch import solver as tsolver
from ddp_generator_tpu_torch.models import brachistochrone as tbr
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.models import cartpole as tcp
from ddp_generator_tpu_torch.ops.cm_derivs import (
    final_derivative_components,
    step_derivative_components,
)
from ddp_generator_tpu_torch.ops.cuda_backpass import result_from_cm
from ddp_generator_tpu_torch.ops.cuda_fused import fused_derivs_back_pass_plain

SHIM = r"""
#include <algorithm>
#include <cmath>
#include <vector>

#include "backpass.cuh"
#include "backpass_coop.cuh"
#include "fused.cuh"
#include "models/brachistochrone.cuh"
#include "models/car_parking.cuh"
#include "models/cartpole.cuh"
#include "staged.cuh"

using namespace ddp;

template <class M, bool FULL>
int step(const double* x, const double* u, const double* p, int k,
         const double* mu_le, const double* mu_li, double wpl,
         const double* Vx, double* out) {
  StepTerms<double, M::NX, M::NU> d;
  const bool ok = step_derivs<M, FULL>(x, u, p, k, mu_le, mu_li, wpl, Vx, d);
  const double* q = reinterpret_cast<const double*>(&d);
  for (size_t i = 0; i < sizeof(d) / sizeof(double); ++i) out[i] = q[i];
  return ok;
}

template <class M>
int fin(const double* xf, const double* p, int N, const double* mu_fe,
        const double* mu_fi, double wpf, double* Fx, double* Fxx) {
  double fx[M::NX], fxx[M::NX][M::NX];
  const bool ok = final_derivs<M>(xf, p, N, mu_fe, mu_fi, wpf, fx, fxx);
  for (int a = 0; a < M::NX; ++a) {
    Fx[a] = fx[a];
    for (int b = 0; b < M::NX; ++b) Fxx[a * M::NX + b] = fxx[a][b];
  }
  return ok;
}

template <class M>
void lanes(int reg, int full, const FusedArgs<double>& a) {
  for (int b = 0; b < a.B; ++b) {
    if (reg == 1 && full) fused_lane<M, double, 1, true>(a, b);
    else if (reg == 1) fused_lane<M, double, 1, false>(a, b);
    else if (full) fused_lane<M, double, 2, true>(a, b);
    else fused_lane<M, double, 2, false>(a, b);
  }
}

#define DISPATCH(model, ...)                                \
  switch (model) {                                          \
    case 0: { using M = CarParking; __VA_ARGS__; }          \
    case 1: { using M = Brachistochrone; __VA_ARGS__; }     \
    case 3: { using M = Cartpole; __VA_ARGS__; }            \
    default: { using M = BrachistochroneHli; __VA_ARGS__; } \
  }

extern "C" int host_step(int model, int full, const double* x,
                         const double* u, const double* p, int k,
                         const double* mu_le, const double* mu_li,
                         double wpl, const double* Vx, double* out) {
  DISPATCH(model, return full ? step<M, true>(x, u, p, k, mu_le, mu_li, wpl,
                                              Vx, out)
                              : step<M, false>(x, u, p, k, mu_le, mu_li,
                                               wpl, Vx, out))
}

extern "C" int host_final(int model, const double* xf, const double* p,
                          int N, const double* mu_fe, const double* mu_fi,
                          double wpf, double* Fx, double* Fxx) {
  DISPATCH(model, return fin<M>(xf, p, N, mu_fe, mu_fi, wpf, Fx, Fxx))
}

// Kernel B3's schedule run serially: per block of kLanes lanes, per time
// tile, every producer work item into a slot first filled with NaN, then
// every lane's consumer share of the tile.
template <class M, int REG, bool FULL>
void staged_fused(const FusedArgs<double>& A) {
  constexpr int S = tile_steps<double, Terms<M::NX, M::NU, FULL>::NT>();
  std::vector<double> slot(Terms<M::NX, M::NU, FULL>::NT * S * kLanes);
  with_params<M>(A.params, [&](const double* p) {
    for (int b0 = 0; b0 < A.B; b0 += kLanes) {
      const int n = std::min(kLanes, A.B - b0);
      int ok[kLanes];
      bool dok[kLanes];
      Carry<double, M::NX> c[kLanes];
      for (int g = 0; g < n; ++g) {
        ok[g] = 1;
        dok[g] = fused_lane_start<M>(A, p, b0 + g, c[g]);
      }
      for (int j = 0; j < num_tiles(A.N, S); ++j) {
        const int t0 = tile_t0(A.N, S, j);
        std::fill(slot.begin(), slot.end(), NAN);
        fused_fill<M, FULL, S>(A, p, t0, b0, slot.data(), ok, 0, 1);
        for (int g = 0; g < n; ++g)
          consume_tile<double, M::NX, M::NU, REG, FULL, S>(
              slot.data(), t0, g, b0 + g, A.B, A.lam[b0 + g], c[g], A.l,
              A.L);
      }
      for (int g = 0; g < n; ++g) {
        finish_lane(c[g], A.N, A.B, b0 + g, A.dV, A.g_norm, A.failed);
        A.derivs_ok[b0 + g] = dok[g] && ok[g] != 0;
      }
    }
  });
}

template <class M>
void lanes_staged(int reg, int full, const FusedArgs<double>& a) {
  if (reg == 1 && full) staged_fused<M, 1, true>(a);
  else if (reg == 1) staged_fused<M, 1, false>(a);
  else if (full) staged_fused<M, 2, true>(a);
  else staged_fused<M, 2, false>(a);
}

// A lane's group of P threads run one rank after another, in ascending or
// descending order: what one rank writes in a phase no other may read in
// it, so both orders give the card's results.
template <int P>
struct SerialGroup {
  bool down;
  template <class F>
  void each(F f) const {
    for (int i = 0; i < P; ++i) f(down ? P - 1 - i : i);
  }
  template <class L>
  struct Own {
    L v[P];
    L& operator[](int r) { return v[r]; }
  };
};

// Kernel B1's schedule run serially, the producer's copies a plain loop:
// per block of kLanes lanes, per time tile, the tile into a slot first
// filled with NaN, then each lane's group of threads on it.
template <int NX, int NU, int REG, bool FULL>
void coop_backpass(const BackpassArgs<double>& A, bool down) {
  constexpr int S = coop_tile_steps<double, NX, NU, FULL>();
  constexpr int SLOT = Terms<NX, NU, FULL>::NT * S * kLanes;
  constexpr int SC = CoopLayout<NX, NU>::SIZE;
  using Grp = SerialGroup<kLaneThreads>;
  const Grp grp{down};
  std::vector<typename Grp::template Own<Carry<double, NX>>> carry(kLanes);
  std::vector<double> sm(SLOT + kLanes * SC);
  auto copy = [](double* dst, const double* src, int n) {
    for (int e = 0; e < n; ++e) dst[e] = src[e];
  };
  for (int b0 = 0; b0 < A.B; b0 += kLanes) {
    const int n = std::min(kLanes, A.B - b0);
    std::fill(sm.begin(), sm.end(), NAN);
    for (int g = 0; g < n; ++g)
      coop_start<double, NX, NU>(grp, carry[g], sm.data() + SLOT + g * SC,
                                 A.final_cx, A.final_cxx, b0 + g, A.B, true);
    for (int j = 0; j < num_tiles(A.N, S); ++j) {
      const int t0 = tile_t0(A.N, S, j);
      std::fill(sm.begin(), sm.begin() + SLOT, NAN);
      bundle_fill<double, NX, NU, FULL, S>(A, t0, b0, sm.data(), 0, 1, copy);
      for (int g = 0; g < n; ++g)
        coop_tile<double, NX, NU, REG, FULL, S>(
            grp, carry[g], sm.data(), 0, SLOT + g * SC, t0, g, b0 + g, A.B,
            true, A.lam[b0 + g], A.l, A.L);
    }
    for (int g = 0; g < n; ++g)
      coop_finish<double, NX>(grp, carry[g], A.N, A.B, b0 + g, true, A.dV,
                              A.g_norm, A.failed);
  }
}

// mode 0: backpass_lane per lane; 1, 2: the cooperative schedule, ranks
// ascending or descending.
template <int NX, int NU, int REG, bool FULL>
void backpass(int mode, const BackpassArgs<double>& a) {
  if (mode) {
    coop_backpass<NX, NU, REG, FULL>(a, mode == 2);
  } else {
    for (int b = 0; b < a.B; ++b) backpass_lane<double, NX, NU, REG, FULL>(a, b);
  }
}

template <int NX, int NU>
void backpass_shape(int mode, int reg, int full,
                    const BackpassArgs<double>& a) {
  if (reg == 1 && full) backpass<NX, NU, 1, true>(mode, a);
  else if (reg == 1) backpass<NX, NU, 1, false>(mode, a);
  else if (full) backpass<NX, NU, 2, true>(mode, a);
  else backpass<NX, NU, 2, false>(mode, a);
}

// f(IntC<NX>(), IntC<NU>()) at the B1 shapes the tests take.
template <class F>
int b1_shape(int n_x, int n_u, F f) {
  if (n_x == 4 && n_u == 2) return f(IntC<4>(), IntC<2>());
  if (n_x == 4 && n_u == 1) return f(IntC<4>(), IntC<1>());
  if (n_x == 2 && n_u == 1) return f(IntC<2>(), IntC<1>());
  if (n_x == 6 && n_u == 3) return f(IntC<6>(), IntC<3>());
  return f(IntC<1>(), IntC<1>());
}

extern "C" int host_tile_lanes() { return kLanes; }

// Steps per tile of B3 (model >= 0) or of B1 (model < 0, shape n_x, n_u).
extern "C" int host_tile_steps(int model, int n_x, int n_u, int full) {
  if (model >= 0) {
    auto steps = [&](auto nx, auto nu) {
      constexpr int NX = decltype(nx)::value, NU = decltype(nu)::value;
      return full ? tile_steps<double, Terms<NX, NU, true>::NT>()
                  : tile_steps<double, Terms<NX, NU, false>::NT>();
    };
    DISPATCH(model, return steps(IntC<M::NX>(), IntC<M::NU>()))
  }
  return b1_shape(n_x, n_u, [&](auto nx, auto nu) {
    constexpr int NX = decltype(nx)::value, NU = decltype(nu)::value;
    return full ? coop_tile_steps<double, NX, NU, true>()
                : coop_tile_steps<double, NX, NU, false>();
  });
}

// Threads per lane of B1.
extern "C" int host_lane_threads() { return kLaneThreads; }

// ptrs as ddp_backpass's; mode as backpass's.
extern "C" void host_backpass(int mode, int n_x, int n_u, int reg,
                              int full, int N, int B, void* const* p) {
  BackpassArgs<double> a;
  auto in = [&](int i) { return static_cast<const double*>(p[i]); };
  auto out = [&](int i) { return static_cast<double*>(p[i]); };
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
  b1_shape(n_x, n_u, [&](auto nx, auto nu) {
    backpass_shape<decltype(nx)::value, decltype(nu)::value>(mode, reg,
                                                             full, a);
    return 0;
  });
}

extern "C" void host_lanes(int model, int staged, int reg, int full, int N,
                           int B, void* const* q) {
  FusedArgs<double> a;
  auto in = [&](int i) { return static_cast<const double*>(q[i]); };
  auto out = [&](int i) { return static_cast<double*>(q[i]); };
  a.x = in(0); a.u = in(1); a.mu_le = in(2); a.mu_li = in(3);
  a.xf = in(4); a.wpl = in(5); a.wpf = in(6); a.lam = in(7);
  a.mu_fe = in(8); a.mu_fi = in(9); a.params = in(10);
  a.l = out(11); a.L = out(12); a.dV = out(13); a.g_norm = out(14);
  a.failed = static_cast<bool*>(q[15]);
  a.derivs_ok = static_cast<bool*>(q[16]);
  a.N = N;
  a.B = B;
  DISPATCH(model, if (staged) lanes_staged<M>(reg, full, a);
                  else lanes<M>(reg, full, a);
                  return)
}
"""

MODELS = {"car_parking": 0, "brachistochrone": 1, "brachistochrone_hli": 2,
          "cartpole": 3}
TOL = dict(rtol=1e-12, atol=1e-12)
N, B = 12, 6


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler: B3's host build needs g++")
    out = tmp_path_factory.mktemp("dual_host")
    src = out / "shim.cpp"
    src.write_text(SHIM)
    so = out / "shim.so"
    # no FMA contraction, as the kernels are built (--fmad=false)
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", "-I", str(_build.CSRC), "-o", str(so),
         str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    P = ctypes.POINTER(ctypes.c_double)
    i, d = ctypes.c_int, ctypes.c_double
    lib.host_step.argtypes = [i, i, P, P, P, i, P, P, d, P, P]
    lib.host_final.argtypes = [i, P, P, i, P, P, d, P, P]
    lib.host_lanes.argtypes = [i, i, i, i, i, i,
                               ctypes.POINTER(ctypes.c_void_p)]
    lib.host_backpass.argtypes = [i, i, i, i, i, i, i,
                                  ctypes.POINTER(ctypes.c_void_p)]
    lib.host_tile_steps.argtypes = [i, i, i, i]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _problem(name):
    return {"car_parking": tcar.car_parking, "cartpole": tcp.cartpole,
            "brachistochrone": tbr.brachistochrone,
            "brachistochrone_hli": tbr.brachistochrone_hli}[name]()


def _case(name, seed, N=N, B=B):
    """A nominal trajectory of B lanes over N steps, params and AL inputs
    with every term live; float64 numpy."""
    rng = np.random.default_rng(seed)
    if name == "car_parking":
        p, x0, _ = tcar.default_setup(T=N, seed=0)
        xs = np.tile(x0, (B, N + 1, 1)) + 0.3 * rng.standard_normal(
            (B, N + 1, 4))
        xs[..., 3] += rng.uniform(0.5, 2.0, (B, 1))  # nonzero speed
        us = 0.4 * rng.standard_normal((B, N, 2))  # some beyond the limits
    elif name == "cartpole":
        p, x0, _ = tcp.default_setup(T=N, seed=0)
        xs = np.tile(x0, (B, N + 1, 1)) + rng.standard_normal((B, N + 1, 4))
        us = 20.0 * rng.standard_normal((B, N, 1))  # some beyond +-15
    else:
        p, _, _ = (tbr.default_setup if name == "brachistochrone"
                   else tbr.default_setup_hli)(N)
        xs = -rng.uniform(0.2, 4.0, (B, N + 1, 1))
        us = -rng.uniform(0.5, 1.5, (B, N, 1))
    prob = _problem(name)
    mu = lambda *s: rng.uniform(0.2, 2.0, s)
    return dict(
        prob=prob, p=p, xs=xs, us=us,
        mu_le=mu(B, N, prob.n_hle), mu_li=mu(B, N, prob.n_hli),
        mu_fe=rng.standard_normal((B, prob.n_hfe)), mu_fi=mu(B, prob.n_hfi),
        wpl=rng.uniform(0.5, 40.0, B), wpf=rng.uniform(0.5, 40.0, B),
        lam=np.abs(rng.standard_normal(B)) * 0.1)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)


def _flat_params(c):
    return c["prob"].cuda_model.flat_params(
        td.params_from_jax(c["p"], torch.float64, "cpu"), torch.float64,
        "cpu", c["us"].shape[1]).numpy()


def _step_fields(n_x, n_u):
    """riccati.cuh:StepTerms, field by field."""
    return [("fx", (n_x, n_x)), ("fu", (n_x, n_u)), ("cx", (n_x,)),
            ("cu", (n_u,)), ("cxx", (n_x, n_x)), ("cuu", (n_u, n_u)),
            ("cxu", (n_x, n_u)), ("vfxx", (n_x, n_x)), ("vfxu", (n_x, n_u)),
            ("vfuu", (n_u, n_u)), ("lower", (n_u,)), ("upper", (n_u,)),
            ("lower_hx", (n_u, n_x)), ("upper_hx", (n_u, n_x)),
            ("lower_sign", (n_u,)), ("upper_sign", (n_u,))]


def _unpack_step(out, n_x, n_u):
    res, o = {}, 0
    for key, shape in _step_fields(n_x, n_u):
        n = int(np.prod(shape))
        res[key] = out[o:o + n].reshape(shape)
        o += n
    return res


def _host_step(lib, c, b, k, full, Vx):
    prob = c["prob"]
    n_x, n_u = prob.n_x, prob.n_u
    out = np.zeros(sum(int(np.prod(s)) for _, s in _step_fields(n_x, n_u)))
    arrs = [np.ascontiguousarray(v, dtype=np.float64) for v in (
        c["xs"][b, k], c["us"][b, k], _flat_params(c),
        np.append(c["mu_le"][b, k], 0.0), np.append(c["mu_li"][b, k], 0.0),
        Vx)]
    ok = lib.host_step(MODELS[prob.cuda_model.name], int(full),
                       *map(_ptr, arrs[:3]), k, _ptr(arrs[3]), _ptr(arrs[4]),
                       float(c["wpl"][b]), _ptr(arrs[5]), _ptr(out))
    return _unpack_step(out, n_x, n_u), bool(ok)


def _plain_step(c, b, k, full):
    """cm_derivs.step_derivative_components at lane b, step k, unpacked."""
    prob = c["prob"]
    n_x, n_u = prob.n_x, prob.n_u
    col = lambda a: _t(a[b, k])[:, None, None]  # (c,) -> (c, 1, 1)
    sd = step_derivative_components(
        prob, col(c["xs"]), col(c["us"]),
        td.params_from_jax(c["p"], torch.float64, "cpu"),
        torch.tensor([[k]]), col(c["mu_le"]), col(c["mu_li"]),
        _t(c["wpl"][b:b + 1]), full)
    v = {key: t[:, 0, 0].numpy() for key, t in sd.items()}

    def sym(packed, n):
        return np.array([[packed[a * n - a * (a - 1) // 2 + (e - a)]
                          if a <= e else packed[e * n - e * (e - 1) // 2
                                                + (a - e)]
                          for e in range(n)] for a in range(n)])

    res = dict(fx=v["fx"].reshape(n_x, n_x), fu=v["fu"].reshape(n_x, n_u),
               cx=v["cx"], cu=v["cu"], cxx=sym(v["cxx"], n_x),
               cuu=sym(v["cuu"], n_u), cxu=v["cxu"].reshape(n_x, n_u),
               lower=v["lower"], upper=v["upper"],
               lower_hx=v["lower_hx"].reshape(n_u, n_x),
               upper_hx=v["upper_hx"].reshape(n_u, n_x),
               lower_sign=v["lower_sign"], upper_sign=v["upper_sign"])
    if full:
        tx, tu = n_x * (n_x + 1) // 2, n_u * (n_u + 1) // 2
        res["fxx"] = np.stack([sym(r, n_x)
                               for r in v["fxx"].reshape(n_x, tx)])
        res["fuu"] = np.stack([sym(r, n_u)
                               for r in v["fuu"].reshape(n_x, tu)])
        res["fxu"] = v["fxu"].reshape(n_x, n_x, n_u)
    return res


@pytest.mark.parametrize("full", [True, False], ids=["full", "gn"])
@pytest.mark.parametrize("name", list(MODELS))
def test_step_derivatives_match_cm_derivs(lib, name, full):
    c = _case(name, 3)
    n_x = c["prob"].n_x
    for b, k in ((0, 0), (2, 5), (5, N - 1)):
        ref = _plain_step(c, b, k, full)
        out, ok = _host_step(lib, c, b, k, full, np.zeros(n_x))
        assert ok
        for key in ("fx", "fu", "cx", "cu", "cxx", "cuu", "cxu", "lower",
                    "upper", "lower_hx", "upper_hx", "lower_sign",
                    "upper_sign"):
            np.testing.assert_allclose(out[key], ref[key], err_msg=key,
                                       **TOL)
        if full:
            # f** of output i: the contraction with Vx = e_i
            for i in range(n_x):
                e_i, _ = _host_step(lib, c, b, k, full, np.eye(n_x)[i])
                for key, t in (("vfxx", "fxx"), ("vfxu", "fxu"),
                               ("vfuu", "fuu")):
                    np.testing.assert_allclose(e_i[key], ref[t][i],
                                               err_msg=f"{t}[{i}]", **TOL)
    if name == "car_parking":
        # hx is zero for CarParking's input-only bounds; some bind
        assert np.isfinite(out["lower"]).all() and (out["lower_sign"] < 0).all()


@pytest.mark.parametrize("name", list(MODELS))
def test_final_derivatives_match_cm_derivs(lib, name):
    c = _case(name, 4)
    prob = c["prob"]
    n_x = prob.n_x
    p_t = td.params_from_jax(c["p"], torch.float64, "cpu")
    ref_x, ref_xx = final_derivative_components(
        prob, _t(c["xs"][:, N].T), p_t, N, _t(c["mu_fe"].T),
        _t(c["mu_fi"].T), _t(c["wpf"]))
    for b in range(B):
        Fx, Fxx = np.zeros(n_x), np.zeros(n_x * n_x)
        arrs = [np.ascontiguousarray(c["xs"][b, N]), _flat_params(c),
                np.append(c["mu_fe"][b], 0.0), np.append(c["mu_fi"][b], 0.0)]
        ok = lib.host_final(MODELS[prob.cuda_model.name], _ptr(arrs[0]),
                            _ptr(arrs[1]), N, _ptr(arrs[2]), _ptr(arrs[3]),
                            float(c["wpf"][b]), _ptr(Fx), _ptr(Fxx))
        assert ok
        np.testing.assert_allclose(Fx, ref_x[:, b].numpy(), **TOL)
        np.testing.assert_allclose(Fxx, ref_xx[:, b].numpy(), **TOL)


def _host_lanes(lib, c, reg, full, staged=False):
    prob = c["prob"]
    n_x, n_u = prob.n_x, prob.n_u
    B, N = c["us"].shape[:2]
    cm = lambda a: np.ascontiguousarray(np.transpose(a, (1, 2, 0)))
    row = lambda a: np.ascontiguousarray(a[None])
    ins = [cm(c["xs"][:, :N]), cm(c["us"]), cm(c["mu_le"]), cm(c["mu_li"]),
           np.ascontiguousarray(c["xs"][:, N].T), row(c["wpl"]),
           row(c["wpf"]), row(c["lam"]), np.ascontiguousarray(c["mu_fe"].T),
           np.ascontiguousarray(c["mu_fi"].T), _flat_params(c)]
    outs = [np.zeros((N, n_u, B)), np.zeros((N, n_u * n_x, B)),
            np.zeros((2, B)), np.zeros((1, B)), np.zeros((1, B), bool),
            np.zeros((1, B), bool)]
    q = (ctypes.c_void_p * 17)(*[a.ctypes.data for a in ins + outs])
    lib.host_lanes(MODELS[prob.cuda_model.name], int(staged), reg, int(full),
                   N, B, q)
    return outs


@pytest.mark.parametrize("name,reg,full", [
    ("car_parking", 1, True), ("car_parking", 1, False),
    ("car_parking", 2, True), ("car_parking", 2, False),
    ("brachistochrone", 1, False), ("brachistochrone_hli", 2, True),
    ("cartpole", 1, True), ("cartpole", 2, False),
])
def test_fused_lane_matches_plain(lib, name, reg, full):
    c = _case(name, 5)
    if name in ("car_parking", "cartpole"):
        c["lam"][1] = -1.0  # Quu - I indefinite: this lane fails
    bp, ok = fused_derivs_back_pass_plain(
        c["prob"], _t(c["xs"]), _t(c["us"]), _t(c["mu_le"]),
        _t(c["mu_li"]), _t(c["mu_fe"]), _t(c["mu_fi"]), _t(c["wpl"]),
        _t(c["wpf"]), _t(c["lam"]),
        td.params_from_jax(c["p"], torch.float64, "cpu"), reg, full)
    l, L, dV, g, failed, dok = _host_lanes(lib, c, reg, full)
    np.testing.assert_array_equal(dok[0], ok.numpy())
    np.testing.assert_array_equal(failed[0], bp.failed.numpy())
    if name in ("car_parking", "cartpole"):
        assert failed[0, 1] and not failed[0].all()
    for out, ref in ((np.transpose(l, (2, 0, 1)), bp.l),
                     (np.transpose(L, (2, 0, 1)).reshape(bp.L.shape), bp.L),
                     (dV.T, bp.dV), (g[0], bp.g_norm)):
        ref = ref.numpy()
        scale = max(1.0, np.abs(ref).max())
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10 * scale)


# The staged kernels against their one-thread-per-lane references: N and B
# ragged against the tile (N not a multiple of the steps per tile, B not a
# multiple of the lanes per block), a lane that fails and a lane whose
# derivatives (B3) or bundle entries (B1) are not finite.
N_STAGED, B_STAGED = 13, 19


def _assert_ragged(lib, steps):
    lanes = lib.host_tile_lanes()
    assert N_STAGED % steps and B_STAGED % lanes, (steps, lanes)


@pytest.mark.parametrize("full", [True, False], ids=["full", "gn"])
@pytest.mark.parametrize("reg", [1, 2])
@pytest.mark.parametrize("name", list(MODELS))
def test_staged_fused_equals_fused_lane(lib, name, reg, full):
    """B3's producer work items into slots, then the shared consumer,
    equal ``fused_lane`` bit for bit."""
    c = _case(name, 6, N=N_STAGED, B=B_STAGED)
    _assert_ragged(lib, lib.host_tile_steps(MODELS[name], 0, 0, int(full)))
    c["lam"][1] = -1e3  # Quu indefinite: this lane fails
    if name == "car_parking":
        c["xs"][5, :, 3] = 1e4  # asin of more than 1: NaN derivatives
    elif name == "cartpole":
        c["xs"][5, 3:, 1] = np.inf  # sin of inf: NaN derivatives
    else:
        c["xs"][5, 3:, 0] = 0.5  # sqrt(-y) of y > 0: NaN derivatives
    ref = _host_lanes(lib, c, reg, full)
    out = _host_lanes(lib, c, reg, full, staged=True)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
    failed, dok = ref[4][0], ref[5][0]
    assert failed[1] and not failed.all()
    assert not dok[5] and dok.sum() == B_STAGED - 1


def _bundle_np(rng, n_x, n_u, full, N, B):
    """A random packed bundle ``[(C, N, B)] x 16`` in ``ddp_backpass``'s
    pointer order, ``us``, ``lam``, ``final_cx``, ``final_cxx``; lane 3's
    cuu is indefinite at step 2 (it fails there), lane 5 has a NaN in fx
    at step 4, and at step 6 lane 7's boxQP has two valid patterns: the
    free optimum of input 0 lies on its lower bound (lam = 0.5, Quu =
    0.5 I, Qu = cu: QuuF = I with regType 1, 0.5 I with 2), so the
    all-free pattern wins over the one that clamps input 0 there, which a
    group's ranks meet in either order."""
    def r(c, scale=1.0):
        return scale * rng.standard_normal((c, N, B))

    def spd_packed(n):
        a = rng.standard_normal((N, B, n, n))
        m = np.einsum("...ij,...kj->...ik", a, a) + 3.0 * np.eye(n)
        return np.stack([m[..., i, j] for i in range(n) for j in range(i, n)])

    tx, tu = n_x * (n_x + 1) // 2, n_u * (n_u + 1) // 2
    fx = r(n_x * n_x, 0.4)
    for i in range(n_x):
        fx[i * n_x + i] += 1.0
    fx[0, 4, 5] = np.nan
    cuu = spd_packed(n_u)
    for i in range(n_u):
        cuu[i * n_u - i * (i - 1) // 2, 2, 3] = -1e4
    lower = r(n_u, 0.5) - 1.0
    upper = lower + 0.3 + np.abs(r(n_u))
    lower[0, :, 1], upper[0, :, 1] = -np.inf, np.inf
    a = rng.standard_normal((B, n_x, n_x))
    fcxx = (np.einsum("bij,bkj->bik", a, a) + 3 * np.eye(n_x)).reshape(B, -1).T
    f = lambda c, sc: r(c, sc) if full else None
    ins = [fx, r(n_x * n_u, 0.4), r(n_x), r(n_u), spd_packed(n_x), cuu,
           r(n_x * n_u, 0.2), f(n_x * tx, 0.05), f(n_x * tu, 0.05),
           f(n_x * n_x * n_u, 0.05), lower, upper, r(n_u * n_x, 0.3),
           r(n_u * n_x, 0.3), -np.ones((n_u, N, B)), np.ones((n_u, N, B)),
           r(n_u), np.abs(rng.standard_normal((1, B))) * 0.1,
           r(n_x)[:, 0], fcxx]
    ins[17][0, 7] = 0.5  # lam
    ins[1][:, 6, 7] = 0.0  # fu: Qu = cu, Quu = cuu
    if full:
        ins[8][:, 6, 7] = 0.0  # fuu
    ins[5][:, 6, 7] = [0.5 if i == j else 0.0
                       for i in range(n_u) for j in range(i, n_u)]
    ins[3][:, 6, 7] = [0.5, -0.2, 0.1][:n_u]
    lower[:, 6, 7], upper[:, 6, 7] = -2.0, 2.0
    return ins


def _host_backpass(lib, ins, n_x, n_u, reg, full, mode):
    N, B = ins[0].shape[1:]
    outs = [np.zeros((N, n_u, B)), np.zeros((N, n_u * n_x, B)),
            np.zeros((2, B)), np.zeros((1, B)), np.zeros((1, B), bool)]
    arrs = [None if a is None else np.ascontiguousarray(a, np.float64)
            for a in ins]
    q = (ctypes.c_void_p * 25)(*[None if a is None else a.ctypes.data
                                 for a in arrs + outs])
    lib.host_backpass(mode, n_x, n_u, reg, int(full), N, B, q)
    return outs


@pytest.mark.parametrize("order", [1, 2], ids=["ranks_up", "ranks_down"])
@pytest.mark.parametrize("full", [True, False], ids=["full", "gn"])
@pytest.mark.parametrize("reg", [1, 2])
@pytest.mark.parametrize("n_x,n_u", [(4, 2), (4, 1), (1, 1), (2, 1),
                                     (6, 3)])
def test_staged_backpass_equals_backpass_lane(lib, n_x, n_u, reg, full,
                                              order):
    """B1's tile copies into slots, then each lane's group of threads
    (backpass_coop.cuh), ranks run one after another in either order,
    equal ``backpass_lane`` bit for bit."""
    _assert_ragged(lib, lib.host_tile_steps(-1, n_x, n_u, int(full)))
    assert lib.host_lane_threads() == 4
    rng = np.random.default_rng(10 * n_x + n_u + 100 * reg)
    ins = _bundle_np(rng, n_x, n_u, full, N_STAGED, B_STAGED)
    free = np.array([-0.5, 0.2, -0.1][:n_u]) * (1.0 if reg == 1 else 2.0)
    ins[10][0, 6, 7] = free[0]  # lower bound of input 0 at the optimum
    ref = _host_backpass(lib, ins, n_x, n_u, reg, full, mode=0)
    out = _host_backpass(lib, ins, n_x, n_u, reg, full, mode=order)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
    failed = ref[4][0]
    assert failed[3] and not failed.all()
    assert np.isnan(ref[2][:, 5]).any()
    # lane 7 at step 6 (live): the free solution won
    np.testing.assert_array_equal(ref[0][6, :, 7], free)


# Two lanes of the benchmark's brachistochrone_hli draw (N=500, float64,
# u0 = -U(0.5, 1.5) from a CUDA generator: seed 3600000023, batch 1, lane
# 15,819 and seed 3600000025, batch 5, lane 4,567 of pools of 6 x 16,384)
# that B3 ended in status 5 while the segment time was evaluated as a
# difference of square roots: where the slope is small its derivatives
# lost up to 1.5% (cxu) to cancellation, B3 and the plain version lost
# different digits, and at an ill-conditioned step the two solves parted;
# B3's went on to blow its AL weights up.  Both now end as the plain
# version's solve does, at these costs.
SAVED_LANES = Path(__file__).parent / "data" / "brachistochrone_hli_c1_lanes.npz"
SAVED_J = {3600000023: 1.4259918491500592, 3600000025: 1.425991863674701}


def _host_fused(lib, problem, xs, us, mu_le, mu_li, mu_fe, mu_fi, w_pen_l,
                w_pen_f, lam, params, reg_type, full_ddp, when=None):
    """``fused_derivs_back_pass`` on the host build (batch-major tensors
    in, as the wrapper's)."""
    B, Np1, n_x = xs.shape
    N = Np1 - 1
    cm = lambda a: np.ascontiguousarray(a.permute(1, 2, 0).numpy())
    row = lambda a: np.ascontiguousarray(a.T.numpy())
    ins = [cm(xs[:, :N]), cm(us), cm(mu_le), cm(mu_li), row(xs[:, N]),
           row(w_pen_l[None]), row(w_pen_f[None]), row(lam[None]),
           row(mu_fe), row(mu_fi),
           problem.cuda_model.flat_params(params, torch.float64, "cpu",
                                          N).numpy()]
    n_u = us.shape[-1]
    outs = [np.zeros((N, n_u, B)), np.zeros((N, n_u * n_x, B)),
            np.zeros((2, B)), np.zeros((1, B)), np.zeros((1, B), bool),
            np.zeros((1, B), bool)]
    q = (ctypes.c_void_p * 17)(*[a.ctypes.data for a in ins + outs])
    lib.host_lanes(MODELS[problem.cuda_model.name], 0, reg_type,
                   int(full_ddp), N, B, q)
    t = [torch.from_numpy(o) for o in outs]
    return result_from_cm(*t[:5]), t[5][0]


@pytest.mark.parametrize("seed", sorted(SAVED_J))
def test_saved_brachi_lane_host_b3_follows_plain(lib, monkeypatch, seed):
    u0 = np.load(SAVED_LANES)[f"u0_{seed}"][None]
    p, x0, _ = tbr.default_setup_hli(500)
    problem = tbr.brachistochrone_hli()
    opts = td.SolverOptions(max_iter=200, w_pen_init_l=40.0,
                            w_pen_init_f=1e-5, w_pen_max_f=1.0,
                            w_pen_fact2=1.0, full_ddp=False,
                            dtype="float64", backpass_method="fused",
                            linesearch_method="kernel")
    calls = []

    def host(*args, when=None):
        out = _host_fused(lib, *args)
        calls.append((out, fused_derivs_back_pass_plain(*args)))
        return out

    monkeypatch.setattr(tsolver, "fused_derivs_back_pass", host)
    sol = td.StepwiseSolver(problem, opts, device="cpu")(x0[None], u0, p)
    assert calls
    for (bp, ok), (pb, pok) in calls:
        np.testing.assert_array_equal(ok.numpy(), pok.numpy())
        np.testing.assert_array_equal(bp.failed.numpy(), pb.failed.numpy())
        for out, want in ((bp.l, pb.l), (bp.L, pb.L), (bp.dV, pb.dV),
                          (bp.g_norm, pb.g_norm)):
            scale = max(1.0, float(want.abs().max()))
            np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0,
                                       atol=1e-10 * scale)
    # the plain version's solve ends at SAVED_J too, in 14 iterations
    assert int(sol.status[0]) in (1, 2)
    assert int(sol.iterations[0]) == 14
    np.testing.assert_allclose(float(sol.cost[0]), SAVED_J[seed], rtol=1e-12)
