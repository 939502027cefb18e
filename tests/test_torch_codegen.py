"""The CUDA models generated from torch functions (``codegen.py``), built on
the host and held against the hand-written models, the torch functions and
the plain PyTorch versions of the kernels.

``csrc/common.cuh`` compiles without CUDA, so the generated headers, the
hand-written ones and the kernels' per-lane code (``dual.cuh``,
``derivs.cuh``, ``fused.cuh``, ``backpass.cuh``, ``staged.cuh``) are built
with ``g++ -ffp-contract=off`` (the kernels' ``--fmad=false``) into one
shared library and called through ``ctypes``:

* the generated models of the four built-in problems (``cuda_model``
  stripped) equal the hand-written headers bit for bit, values in float64
  and float32 and the hyper-dual derivatives of a step, and match the torch
  functions to 1e-15 (float64) and 1e-6 (float32) relative: the host libm
  and ATen's CPU ``sin``/``asin`` may differ by an ulp;
* user problems (``tests/test_al.py:21-38``, the double integrator and the
  3-input point mass of ``chip_smoke.user_problems``) match their torch
  functions to 1e-14 (their sums may order differently from ATen's), their
  hyper-dual derivatives match ``ops/cm_derivs.py`` to 1e-12 and whole B3
  lanes (``fused_lane``) match ``fused_derivs_back_pass_plain`` to 1e-10;
* B1's staged lane at the new shapes (2, 1) and (6, 3) matches
  ``back_pass_cm_plain``;
* each function ``dual.cuh`` gained for generated models matches torch
  autograd's first and second derivatives;
* what the generator cannot write raises ``NotImplementedError``.

Skips when no C++ compiler is found.
"""

import ctypes
import dataclasses
import importlib.util
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import ddp_generator_tpu_torch as td
import test_torch_dual_host as dh
from ddp_generator_tpu_torch import _build, codegen
from ddp_generator_tpu_torch.models import brachistochrone as tbr
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.models import cartpole as tcp
from ddp_generator_tpu_torch.ops.cuda_backpass import (
    _BUNDLE_KEYS,
    back_pass_cm_plain,
)
from ddp_generator_tpu_torch.ops.cuda_fused import fused_derivs_back_pass_plain

ROOT = Path(__file__).resolve().parent.parent
N, B = 12, 6


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _al_problem():
    """tests/test_al.py:21-38 in the port: one state, every AL family."""
    return td.make_problem(
        n_x=1, n_u=1, f=lambda x, u, p, k: x + u,
        L=lambda x, u, p, k: (u ** 2).sum(0),
        F=lambda x, p, k: (x ** 2).sum(0),
        hle=[lambda x, u, p, k: x[0] - 1.0],
        hli=[lambda x, u, p, k: x[0] - 2.0],
        hfe=[lambda x, p, k: x[0] - 3.0],
        hfi=[lambda x, p, k: x[0] - 4.0], example_params={})


def _strip(problem):
    return dataclasses.replace(problem, cuda_model=None)


# name: (problem, params, hand-written twin's C++ struct or None)
def _cases():
    users = _chip_smoke().user_problems()
    return {
        "car_parking": (_strip(tcar.car_parking()), tcar.default_params(),
                        "CarParking"),
        "brachistochrone": (_strip(tbr.brachistochrone()),
                            tbr.default_setup(N)[0], "Brachistochrone"),
        "brachistochrone_hli": (_strip(tbr.brachistochrone_hli()),
                                tbr.default_setup_hli(N)[0],
                                "BrachistochroneHli"),
        "cartpole": (_strip(tcp.cartpole()), tcp.default_params(),
                     "Cartpole"),
        "al_families": (_al_problem(), {}, None),
        "double_integrator": users["double_integrator"][:2] + (None,),
        "point_mass3": users["point_mass3"][:2] + (None,),
    }


BUILT_IN = ("car_parking", "brachistochrone", "brachistochrone_hli",
            "cartpole")
USERS = ("al_families", "double_integrator", "point_mass3")
HAND = {"car_parking": tcar.CUDA_MODEL, "brachistochrone": tbr.CUDA_MODEL,
        "brachistochrone_hli": tbr.CUDA_MODEL_HLI,
        "cartpole": tcp.CUDA_MODEL}

SHIM = r"""
#include <algorithm>
#include <cmath>
#include <vector>

#include "backpass.cuh"
#include "fused.cuh"
#include "models/brachistochrone.cuh"
#include "models/car_parking.cuh"
#include "models/cartpole.cuh"
#include "staged.cuh"
@INCLUDES@

using namespace ddp;

#define DISPATCH(model, ...) \
  switch (model) {           \
@CASES@
    default: { using M = CarParking; __VA_ARGS__; } \
  }

// f, L, F(N), h..., hle..., hli..., hfe(N)..., hfi(N)... at one point.
template <class M, typename S>
void eval_all(const S* x, const S* u, const S* p, int k, int N, S* out) {
  S xn[M::NX];
  M::f(x, u, p, k, xn);
  int o = 0;
  for (int a = 0; a < M::NX; ++a) out[o++] = xn[a];
  out[o++] = M::L(x, u, p, k);
  out[o++] = M::F(x, p, N);
  for (int i = 0; i < M::NH; ++i) out[o++] = M::h(i, x, u, p, k);
  for (int i = 0; i < M::NHLE; ++i) out[o++] = M::hle(i, x, u, p, k);
  for (int i = 0; i < M::NHLI; ++i) out[o++] = M::hli(i, x, u, p, k);
  for (int i = 0; i < M::NHFE; ++i) out[o++] = M::hfe(i, x, p, N);
  for (int i = 0; i < M::NHFI; ++i) out[o++] = M::hfi(i, x, p, N);
}

extern "C" void eval_f64(int model, const double* x, const double* u,
                         const double* p, int k, int N, double* out) {
  DISPATCH(model, eval_all<M, double>(x, u, p, k, N, out); return)
}

extern "C" void eval_f32(int model, const float* x, const float* u,
                         const float* p, int k, int N, float* out) {
  DISPATCH(model, eval_all<M, float>(x, u, p, k, N, out); return)
}

template <class M, bool FULL, typename S>
int step(const S* x, const S* u, const S* p, int k, const S* mu_le,
         const S* mu_li, S wpl, const S* Vx, S* out) {
  StepTerms<S, M::NX, M::NU> d;
  const bool ok = step_derivs<M, FULL>(x, u, p, k, mu_le, mu_li, wpl, Vx, d);
  const S* q = reinterpret_cast<const S*>(&d);
  for (size_t i = 0; i < sizeof(d) / sizeof(S); ++i) out[i] = q[i];
  return ok;
}

extern "C" int step_f64(int model, int full, const double* x,
                        const double* u, const double* p, int k,
                        const double* mu_le, const double* mu_li, double wpl,
                        const double* Vx, double* out) {
  DISPATCH(model, return full ? step<M, true>(x, u, p, k, mu_le, mu_li, wpl,
                                              Vx, out)
                              : step<M, false>(x, u, p, k, mu_le, mu_li,
                                               wpl, Vx, out))
}

extern "C" int step_f32(int model, int full, const float* x, const float* u,
                        const float* p, int k, const float* mu_le,
                        const float* mu_li, float wpl, const float* Vx,
                        float* out) {
  DISPATCH(model, return full ? step<M, true>(x, u, p, k, mu_le, mu_li, wpl,
                                              Vx, out)
                              : step<M, false>(x, u, p, k, mu_le, mu_li,
                                               wpl, Vx, out))
}

extern "C" int final_f64(int model, const double* xf, const double* p,
                         int N, const double* mu_fe, const double* mu_fi,
                         double wpf, double* Fx, double* Fxx) {
  DISPATCH(model, {
    double fx[M::NX], fxx[M::NX][M::NX];
    const bool ok = final_derivs<M>(xf, p, N, mu_fe, mu_fi, wpf, fx, fxx);
    for (int a = 0; a < M::NX; ++a) {
      Fx[a] = fx[a];
      for (int b = 0; b < M::NX; ++b) Fxx[a * M::NX + b] = fxx[a][b];
    }
    return ok;
  })
}

// B3 one lane at a time (fused_lane), regType 1, FULL_DDP on or off.
extern "C" void lanes_f64(int model, int full, int N, int B,
                          void* const* q) {
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
  DISPATCH(model, for (int b = 0; b < B; ++b) {
    if (full) fused_lane<M, double, 1, true>(a, b);
    else fused_lane<M, double, 1, false>(a, b);
  } return)
}

// Kernel B1's schedule run serially at a shape the main library lacks.
template <int NX, int NU, bool FULL>
void staged_backpass(const BackpassArgs<double>& A) {
  constexpr int S = tile_steps<double, Terms<NX, NU, FULL>::NT>();
  std::vector<double> slot(Terms<NX, NU, FULL>::NT * S * kLanes);
  auto copy = [](double* dst, const double* src, int n) {
    for (int e = 0; e < n; ++e) dst[e] = src[e];
  };
  for (int b0 = 0; b0 < A.B; b0 += kLanes) {
    const int n = std::min(kLanes, A.B - b0);
    Carry<double, NX> c[kLanes];
    for (int g = 0; g < n; ++g) backpass_start(A, b0 + g, c[g]);
    for (int j = 0; j < num_tiles(A.N, S); ++j) {
      const int t0 = tile_t0(A.N, S, j);
      std::fill(slot.begin(), slot.end(), NAN);
      bundle_fill<double, NX, NU, FULL, S>(A, t0, b0, slot.data(), 0, 1,
                                           copy);
      for (int g = 0; g < n; ++g)
        consume_tile<double, NX, NU, 1, FULL, S>(
            slot.data(), t0, g, b0 + g, A.B, A.lam[b0 + g], c[g], A.l, A.L);
    }
    for (int g = 0; g < n; ++g)
      finish_lane(c[g], A.N, A.B, b0 + g, A.dV, A.g_norm, A.failed);
  }
}

// ptrs as ddp_backpass's; regType 1; shapes (2, 1) and (6, 3).
extern "C" void backpass_f64(int n_x, int full, int N, int B,
                             void* const* p) {
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
  if (n_x == 2) {
    if (full) staged_backpass<2, 1, true>(a);
    else staged_backpass<2, 1, false>(a);
  } else {
    if (full) staged_backpass<6, 3, true>(a);
    else staged_backpass<6, 3, false>(a);
  }
}

// The functions dual.cuh gained, on two numbers a, b (b unused by the
// unary ones).
template <class D>
D apply(int which, const D& a, const D& b) {
  switch (which) {
    case 0: return exp(a);
    case 1: return log(a);
    case 2: return tanh(a);
    case 3: return acos(a);
    case 4: return atan(a);
    case 5: return atan2(a, b);
    case 6: return pow(a, 2.5);
    case 7: return rsqrt_of(a);
    case 8: return nan_min(a, b);
    default: return nan_max(a, b);
  }
}

extern "C" void dual2(int which, const double* a, const double* b,
                      double* out) {
  const Dual2<double> r = apply(which, Dual2<double>(a[0], a[1], a[2], a[3]),
                                Dual2<double>(b[0], b[1], b[2], b[3]));
  out[0] = r.v; out[1] = r.d1; out[2] = r.d2; out[3] = r.d12;
}

extern "C" void dual1(int which, const double* a, const double* b,
                      double* out) {
  const Dual<double> r = apply(which, Dual<double>(a[0], a[1]),
                               Dual<double>(b[0], b[1]));
  out[0] = r.v; out[1] = r.d;
}
"""


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The generated models of every case and the host library: ``(lib,
    {name: (problem, params, GeneratedModel, id, hand-written id)})``."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler: the host build needs g++")
    out = tmp_path_factory.mktemp("codegen_host")
    cases, includes, lines = {}, [], []
    structs = {"CarParking": 0, "Brachistochrone": 1,
               "BrachistochroneHli": 2, "Cartpole": 3}
    for struct, i in structs.items():
        lines.append(f"    case {i}: {{ using M = {struct}; "
                     "__VA_ARGS__; } \\")
    for i, (name, (prob, params, hand)) in enumerate(_cases().items()):
        gm = codegen.generate_cuda_model(prob, params)
        (out / f"{gm.struct}.cuh").write_text(gm.header)
        includes.append(f'#include "{gm.struct}.cuh"')
        lines.append(f"    case {10 + i}: {{ using M = {gm.struct}; "
                     "__VA_ARGS__; } \\")
        cases[name] = (prob, params, gm, 10 + i,
                       None if hand is None else structs[hand])
    src = out / "shim.cpp"
    src.write_text(SHIM.replace("@INCLUDES@", "\n".join(includes))
                   .replace("@CASES@", "\n".join(lines)))
    so = out / "shim.so"
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", "-I", str(_build.CSRC), "-I", str(out),
         "-o", str(so), str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    i, d, f = ctypes.c_int, ctypes.c_double, ctypes.c_float
    Pd, Pf = ctypes.POINTER(d), ctypes.POINTER(f)
    vp = ctypes.POINTER(ctypes.c_void_p)
    lib.eval_f64.argtypes = [i, Pd, Pd, Pd, i, i, Pd]
    lib.eval_f32.argtypes = [i, Pf, Pf, Pf, i, i, Pf]
    lib.step_f64.argtypes = [i, i, Pd, Pd, Pd, i, Pd, Pd, d, Pd, Pd]
    lib.step_f32.argtypes = [i, i, Pf, Pf, Pf, i, Pf, Pf, f, Pf, Pf]
    lib.final_f64.argtypes = [i, Pd, Pd, i, Pd, Pd, d, Pd, Pd]
    lib.lanes_f64.argtypes = [i, i, i, i, vp]
    lib.backpass_f64.argtypes = [i, i, i, i, vp]
    lib.dual2.argtypes = lib.dual1.argtypes = [i, Pd, Pd, Pd]
    return lib, cases


def _ptr(a: np.ndarray):
    ctype = ctypes.c_float if a.dtype == np.float32 else ctypes.c_double
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _n_out(prob):
    return (prob.n_x + 2 + prob.n_h + prob.n_hle + prob.n_hli + prob.n_hfe
            + prob.n_hfi)


def _flat(model, params, dtype=torch.float64):
    return np.ascontiguousarray(model.flat_params(
        td.params_from_jax(params, dtype, "cpu"), dtype, "cpu", N).numpy())


def _host_eval(lib, model_id, flat, x, u, k, n_out, np_dtype):
    out = np.zeros(n_out, np_dtype)
    arrs = [np.ascontiguousarray(a, np_dtype) for a in (x, u)]
    fn = lib.eval_f64 if np_dtype == np.float64 else lib.eval_f32
    fn(model_id, _ptr(arrs[0]), _ptr(arrs[1]), _ptr(flat), k, N, _ptr(out))
    return out


def _torch_eval(prob, params, x, u, k, dtype):
    p = td.params_from_jax(params, dtype, "cpu")
    xt = torch.as_tensor(x, dtype=dtype)
    ut = torch.as_tensor(u, dtype=dtype)
    vals = list(prob.f(xt, ut, p, k).reshape(-1))
    vals += [prob.L(xt, ut, p, k), prob.F(xt, p, N)]
    vals += [fn(xt, ut, p, k) for fn in prob.h + prob.hle + prob.hli]
    vals += [fn(xt, p, N) for fn in prob.hfe + prob.hfi]
    return np.array([float(torch.as_tensor(v)) for v in vals])


def _points(prob, name, seed, n=6):
    """Random points inside each model's domain (a nonzero speed for
    CarParking, y < 0 and a slope dy < 0 for the Brachistochrones)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        x = rng.standard_normal(prob.n_x)
        u = rng.standard_normal(prob.n_u)
        if name == "car_parking":
            x[3] = rng.uniform(0.5, 2.0)
            u *= 0.4
        elif name.startswith("brachistochrone"):
            x = -rng.uniform(0.2, 4.0, 1)
            u = -rng.uniform(0.5, 1.5, 1)
        yield x, u, int(rng.integers(0, N))


def _rel(a, ref):
    return np.abs(a - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("name", BUILT_IN)
def test_generated_equals_hand_written_bit_for_bit(built, name):
    """f, L, F and every constraint of the generated header equal the
    hand-written header's, float64 and float32, and so do the hyper-dual
    step derivatives B3 forms from them."""
    lib, cases = built
    prob, params, gm, gid, hid = cases[name]
    n_out = _n_out(prob)
    for np_dtype, dtype in ((np.float64, torch.float64),
                            (np.float32, torch.float32)):
        g_flat = _flat(gm, params, dtype)
        h_flat = _flat(HAND[name], params, dtype)
        for x, u, k in _points(prob, name, 1):
            gen = _host_eval(lib, gid, g_flat, x, u, k, n_out, np_dtype)
            hand = _host_eval(lib, hid, h_flat, x, u, k, n_out, np_dtype)
            np.testing.assert_array_equal(gen, hand)
            fn = lib.step_f64 if np_dtype == np.float64 else lib.step_f32
            outs = []
            for model_id, flat in ((gid, g_flat), (hid, h_flat)):
                n_terms = sum(int(np.prod(s))
                              for _, s in dh._step_fields(prob.n_x, prob.n_u))
                out = np.zeros(n_terms, np_dtype)
                arrs = [np.ascontiguousarray(a, np_dtype) for a in (
                    x, u, [0.7, 0.0], [1.3, 0.0],
                    np.linspace(-1.0, 1.0, prob.n_x))]
                fn(model_id, 1, _ptr(arrs[0]), _ptr(arrs[1]), _ptr(flat), k,
                   _ptr(arrs[2]), _ptr(arrs[3]), 2.5, _ptr(arrs[4]),
                   _ptr(out))
                outs.append(out)
            np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("name", BUILT_IN + USERS)
def test_generated_matches_torch_functions(built, name):
    """Each generated function against the torch function it came from:
    1e-15 relative for the built-in models (1e-6 in float32), 1e-14 for the
    user problems."""
    lib, cases = built
    prob, params, gm, gid, _ = cases[name]
    tol64 = 1e-15 if name in BUILT_IN else 1e-14
    for np_dtype, dtype, tol in ((np.float64, torch.float64, tol64),
                                 (np.float32, torch.float32, 1e-6)):
        flat = _flat(gm, params, dtype)
        for x, u, k in _points(prob, name, 2):
            x = x.astype(np_dtype)
            u = u.astype(np_dtype)
            gen = _host_eval(lib, gid, flat, x, u, k, _n_out(prob), np_dtype)
            ref = _torch_eval(prob, params, x, u, k, dtype)
            assert _rel(gen.astype(np.float64), ref) <= tol, (gen, ref)


def _case(name, prob, params, seed):
    """dh._case's operands for a generated model's problem."""
    rng = np.random.default_rng(seed)
    if name in dh.MODELS:
        c = dh._case(name, seed)
        c["prob"] = prob
        return c
    scale = 1.5 if name == "point_mass3" else 1.0  # some beyond the box
    mu = lambda *s: rng.uniform(0.2, 2.0, s)
    return dict(
        prob=prob, p=params,
        xs=rng.standard_normal((B, N + 1, prob.n_x)),
        us=scale * rng.standard_normal((B, N, prob.n_u)),
        mu_le=mu(B, N, prob.n_hle), mu_li=mu(B, N, prob.n_hli),
        mu_fe=rng.standard_normal((B, prob.n_hfe)), mu_fi=mu(B, prob.n_hfi),
        wpl=rng.uniform(0.5, 40.0, B), wpf=rng.uniform(0.5, 40.0, B),
        lam=np.abs(rng.standard_normal(B)) * 0.1)


@pytest.mark.parametrize("full", [True, False], ids=["full", "gn"])
@pytest.mark.parametrize("name", BUILT_IN + USERS)
def test_generated_derivatives_match_cm_derivs(built, name, full):
    """The hyper-dual derivatives of a step (derivs.cuh on the generated
    model) and of the final cost against ops/cm_derivs.py, 1e-12."""
    lib, cases = built
    prob, params, gm, gid, _ = cases[name]
    c = _case(name, prob, params, 3)
    flat = _flat(gm, params)
    n_x, n_u = prob.n_x, prob.n_u
    fields = dh._step_fields(n_x, n_u)
    for b, k in ((0, 0), (2, 5), (5, N - 1)):
        ref = dh._plain_step(c, b, k, full)
        Vxs = [np.zeros(n_x)] + (list(np.eye(n_x)) if full else [])
        for i, Vx in enumerate(Vxs):
            out = np.zeros(sum(int(np.prod(s)) for _, s in fields))
            arrs = [np.ascontiguousarray(v, dtype=np.float64) for v in (
                c["xs"][b, k], c["us"][b, k],
                np.append(c["mu_le"][b, k], 0.0),
                np.append(c["mu_li"][b, k], 0.0), Vx)]
            assert lib.step_f64(gid, int(full), _ptr(arrs[0]), _ptr(arrs[1]),
                                _ptr(flat), k, _ptr(arrs[2]), _ptr(arrs[3]),
                                float(c["wpl"][b]), _ptr(arrs[4]), _ptr(out))
            out = dh._unpack_step(out, n_x, n_u)
            if i == 0:
                for key in ("fx", "fu", "cx", "cu", "cxx", "cuu", "cxu",
                            "lower", "upper", "lower_hx", "upper_hx",
                            "lower_sign", "upper_sign"):
                    np.testing.assert_allclose(out[key], ref[key],
                                               err_msg=key, **dh.TOL)
            else:  # f** of output i-1: the contraction with Vx = e_(i-1)
                for key, t in (("vfxx", "fxx"), ("vfxu", "fxu"),
                               ("vfuu", "fuu")):
                    np.testing.assert_allclose(out[key], ref[t][i - 1],
                                               err_msg=t, **dh.TOL)
    p_t = td.params_from_jax(params, torch.float64, "cpu")
    ref_x, ref_xx = dh.final_derivative_components(
        prob, dh._t(c["xs"][:, N].T), p_t, N, dh._t(c["mu_fe"].T),
        dh._t(c["mu_fi"].T), dh._t(c["wpf"]))
    for b in range(B):
        Fx, Fxx = np.zeros(n_x), np.zeros(n_x * n_x)
        arrs = [np.ascontiguousarray(c["xs"][b, N]),
                np.append(c["mu_fe"][b], 0.0), np.append(c["mu_fi"][b], 0.0)]
        assert lib.final_f64(gid, _ptr(arrs[0]), _ptr(flat), N,
                             _ptr(arrs[1]), _ptr(arrs[2]), float(c["wpf"][b]),
                             _ptr(Fx), _ptr(Fxx))
        np.testing.assert_allclose(Fx, ref_x[:, b].numpy(), **dh.TOL)
        np.testing.assert_allclose(Fxx, ref_xx[:, b].numpy(), **dh.TOL)


@pytest.mark.parametrize("full", [True, False], ids=["full", "gn"])
@pytest.mark.parametrize("name", ["double_integrator", "point_mass3"])
def test_fused_lane_on_generated_model_matches_plain(built, name, full):
    """Whole B3 lanes (fused.cuh: fused_lane) on the generated model
    against fused_derivs_back_pass_plain, 1e-10 of the largest value."""
    lib, cases = built
    prob, params, gm, gid, _ = cases[name]
    c = _case(name, prob, params, 5)
    c["lam"][1] = -1e3  # Quu indefinite: this lane fails
    n_x, n_u = prob.n_x, prob.n_u
    bp, ok = fused_derivs_back_pass_plain(
        prob, dh._t(c["xs"]), dh._t(c["us"]), dh._t(c["mu_le"]),
        dh._t(c["mu_li"]), dh._t(c["mu_fe"]), dh._t(c["mu_fi"]),
        dh._t(c["wpl"]), dh._t(c["wpf"]), dh._t(c["lam"]),
        td.params_from_jax(params, torch.float64, "cpu"), 1, full)
    cm = lambda a: np.ascontiguousarray(np.transpose(a, (1, 2, 0)))
    row = lambda a: np.ascontiguousarray(a[None])
    ins = [cm(c["xs"][:, :N]), cm(c["us"]), cm(c["mu_le"]), cm(c["mu_li"]),
           np.ascontiguousarray(c["xs"][:, N].T), row(c["wpl"]),
           row(c["wpf"]), row(c["lam"]), np.ascontiguousarray(c["mu_fe"].T),
           np.ascontiguousarray(c["mu_fi"].T), _flat(gm, params)]
    outs = [np.zeros((N, n_u, B)), np.zeros((N, n_u * n_x, B)),
            np.zeros((2, B)), np.zeros((1, B)), np.zeros((1, B), bool),
            np.zeros((1, B), bool)]
    q = (ctypes.c_void_p * 17)(*[a.ctypes.data for a in ins + outs])
    lib.lanes_f64(gid, int(full), N, B, q)
    l, L, dV, g, failed, dok = outs
    np.testing.assert_array_equal(dok[0], ok.numpy())
    np.testing.assert_array_equal(failed[0], bp.failed.numpy())
    assert failed[0, 1] and not failed[0].all()
    for out, ref in ((np.transpose(l, (2, 0, 1)), bp.l),
                     (np.transpose(L, (2, 0, 1)).reshape(bp.L.shape), bp.L),
                     (dV.T, bp.dV), (g[0], bp.g_norm)):
        ref = ref.numpy()
        scale = max(1.0, np.abs(ref).max())
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10 * scale)


@pytest.mark.parametrize("full", [True, False], ids=["full", "gn"])
@pytest.mark.parametrize("n_x,n_u", [(2, 1), (6, 3)])
def test_staged_backpass_at_new_shapes_matches_plain(built, n_x, n_u, full):
    """B1's staged schedule at the shapes the user problems add, against
    back_pass_cm_plain on a random bundle (a lane that fails, a lane with a
    NaN), 1e-12 of the largest value."""
    lib = built[0]
    rng = np.random.default_rng(7 * n_x + n_u)
    Nb, Bb = 13, 19
    ins = dh._bundle_np(rng, n_x, n_u, full, Nb, Bb)
    arrs = [None if a is None else np.ascontiguousarray(a, np.float64)
            for a in ins]
    outs = [np.zeros((Nb, n_u, Bb)), np.zeros((Nb, n_u * n_x, Bb)),
            np.zeros((2, Bb)), np.zeros((1, Bb)), np.zeros((1, Bb), bool)]
    q = (ctypes.c_void_p * 25)(*[None if a is None else a.ctypes.data
                                 for a in arrs + outs])
    lib.backpass_f64(n_x, int(full), Nb, Bb, q)
    t = lambda a: None if a is None else torch.as_tensor(a)
    sd = {key: t(a) for key, a in zip(_BUNDLE_KEYS, arrs[:16])}
    if not full:
        for key in ("fxx", "fuu", "fxu"):
            sd[key] = torch.zeros((0, Nb, Bb), dtype=torch.float64)
    ref = back_pass_cm_plain(sd, t(arrs[18]), t(arrs[19]), t(arrs[16]),
                             t(arrs[17]), n_x, 1, full)
    np.testing.assert_array_equal(outs[4], ref[4].numpy())
    failed = outs[4][0]
    assert failed[3] and not failed.all()
    live = ~failed & np.isfinite(outs[2]).all(0)
    for o, r in zip(outs[:4], ref[:4]):
        r = r.numpy()[..., live]
        o = o[..., live]
        scale = max(1.0, np.abs(r).max())
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-12 * scale)


# which: (torch function of (a, b), a, b)
DUAL_FUNCTIONS = {
    "exp": (0, lambda a, b: torch.exp(a), 0.7, 0.0),
    "log": (1, lambda a, b: torch.log(a), 1.7, 0.0),
    "tanh": (2, lambda a, b: torch.tanh(a), 0.6, 0.0),
    "acos": (3, lambda a, b: torch.acos(a), 0.3, 0.0),
    "atan": (4, lambda a, b: torch.atan(a), -1.4, 0.0),
    "atan2": (5, lambda a, b: torch.atan2(a, b), -0.8, 0.5),
    "pow": (6, lambda a, b: a ** 2.5, 1.3, 0.0),
    "rsqrt": (7, lambda a, b: torch.rsqrt(a), 0.9, 0.0),
    "minimum": (8, lambda a, b: torch.minimum(a, b), 0.4, 1.1),
    "maximum": (9, lambda a, b: torch.maximum(a, b), 0.4, 1.1),
}


@pytest.mark.parametrize("fn", list(DUAL_FUNCTIONS))
def test_new_dual_functions_match_autograd(built, fn):
    """Value, gradient and Hessian of f(a, b) on Dual2 (seeds on a and b)
    and the directional derivative on Dual, against torch autograd."""
    lib = built[0]
    which, tfn, av, bv = DUAL_FUNCTIONS[fn]
    ab = torch.tensor([av, bv], dtype=torch.float64, requires_grad=True)
    val = tfn(ab[0], ab[1])
    grad = torch.autograd.grad(val, ab, create_graph=True)[0]

    def row(i):
        if not grad[i].requires_grad:
            return torch.zeros(2, dtype=torch.float64)
        g = torch.autograd.grad(grad[i], ab, retain_graph=True,
                                allow_unused=True)[0]
        return torch.zeros(2, dtype=torch.float64) if g is None else g

    hess = torch.stack([row(i) for i in range(2)]).detach().numpy()
    grad = grad.detach().numpy()
    value = float(val.detach())
    out = np.zeros(4)
    for i in range(2):
        for j in range(2):
            # direction i into d1, j into d2
            a = np.array([av, i == 0, j == 0, 0.0], dtype=np.float64)
            b = np.array([bv, i == 1, j == 1, 0.0], dtype=np.float64)
            lib.dual2(which, _ptr(a), _ptr(b), _ptr(out))
            np.testing.assert_allclose(
                out, [value, grad[i], grad[j], hess[i, j]], rtol=1e-12,
                atol=1e-12, err_msg=f"{fn} d{i} d{j}")
    out2 = np.zeros(2)
    a1, b1 = np.array([av, 0.3]), np.array([bv, -0.7])
    lib.dual1(which, _ptr(a1), _ptr(b1), _ptr(out2))
    np.testing.assert_allclose(out2, [value, 0.3 * grad[0] - 0.7 * grad[1]],
                               rtol=1e-12, atol=1e-12)


def _base():
    return dict(n_x=1, n_u=1, f=lambda x, u, p, k: x + u,
                L=lambda x, u, p, k: u[0] * u[0],
                F=lambda x, p, k: x[0] * x[0])


def _gen(**kw):
    args = _base()
    args.update(kw)
    return codegen.generate_cuda_model(
        td.make_problem(**args, validate=False), {"a": np.array([1.0, 2.0])})


def test_generator_rejects_what_it_cannot_write():
    """Each rejection raises NotImplementedError naming the function and
    what it met: an aten op outside the list, a Python branch on a traced
    value, a non-scalar output."""
    with pytest.raises(NotImplementedError, match="L.*erf"):
        _gen(L=lambda x, u, p, k: torch.erf(u[0]))
    with pytest.raises(NotImplementedError, match="F.*branch"):
        _gen(F=lambda x, p, k: x[0] if bool(x[0] > 0) else -x[0])
    with pytest.raises(NotImplementedError, match="L.*scalar"):
        _gen(L=lambda x, u, p, k: torch.stack([u[0], u[0]]))
    with pytest.raises(NotImplementedError, match=r"hle\[0\].*scalar"):
        _gen(hle=[lambda x, u, p, k: x + u])


def test_step_indexed_params_lay_out_step_major():
    """Every leaf read as p[key][k] goes after the fixed ones, one row per
    step, so the model reads p[NP + k*NTAIL + j] whatever the horizon."""
    def hli(x, u, p, k):
        return p["lo"][k] - x[0] + p["w"][k][1]

    prob = td.make_problem(**_base(), hli=[hli], validate=False)
    params = {"c": 3.0, "lo": np.arange(5.0), "w": np.ones((5, 2))}
    gm = codegen.generate_cuda_model(prob, params)
    assert gm.fixed == () and gm.n_params == 0 and gm.n_tail == 3
    assert [k for k, _ in gm.tail] == ["lo", "w"]
    assert "p[0 + (k) * 3 + 2]" in gm.header
    flat = gm.flat_params(td.params_from_jax(
        {"lo": np.arange(7.0), "w": 10 + np.arange(14.0).reshape(7, 2)},
        torch.float64, "cpu"), torch.float64, "cpu", N=4)
    np.testing.assert_array_equal(
        flat.numpy().reshape(5, 3),
        np.c_[np.arange(5.0), 10 + np.arange(10.0).reshape(5, 2)])
    with pytest.raises(td.ProblemValidationError, match="lo"):
        gm.flat_params({"lo": torch.zeros(3), "w": torch.zeros(3, 2)},
                       torch.float64, "cpu", N=4)


def test_model_for_caches_per_problem_and_structure():
    prob = _strip(tcar.car_parking())
    p = td.params_from_jax(tcar.default_params(), torch.float64, "cpu")
    gm = codegen.model_for(prob, p)
    assert codegen.model_for(prob, dict(p)) is gm
    assert codegen.by_name(gm.name) is gm
    p2 = dict(p, pf=torch.ones(5, dtype=torch.float64))
    assert codegen.model_for(prob, p2) is not gm


def test_failed_build_raises_kernel_compile_error(tmp_path, monkeypatch):
    """A build whose nvcc fails raises KernelCompileError with its output;
    nothing falls back to a plain version."""
    false = shutil.which("false")
    if false is None:
        pytest.skip("no false(1) to stand in for a failing nvcc")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: false)
    with pytest.raises(_build.KernelCompileError, match="nvcc failed"):
        _build.build_backpass_shape(5, 2)
    gm = codegen.generate_cuda_model(_al_problem(), {})
    with pytest.raises(_build.KernelCompileError, match="nvcc failed"):
        _build.build_model(gm)
