"""Count the arithmetic of kernels B1, B2 and B3 per (step, lane), for the
lower bounds ``chip_smoke.py`` puts beside their times.

    python3 scripts/count_ops.py

Builds the kernels' own headers (``ddp_generator_tpu_torch/csrc``) with
``g++`` on ``Op``, a number type that counts every add, subtract, multiply,
divide and elementary function (sin, cos, sqrt, asin, and the others a
generated model may call) as one operation;
negation, ``fabs``, comparisons and selects are free, as they are operand
modifiers or predicates on the card.  Then runs, on CarParking and on
Cartpole (FULL_DDP, regType 1) with random operands:

* ``backpass_lane`` (B1) and ``fused_lane`` (B3) over N steps and over
  2N steps, so that the difference is the work of N steps and the rest the
  work once per lane (B3's final-cost derivatives);
* the model calls of one rollout step (B2: the running cost with its AL
  penalties, the dynamics, the box limits), plus the gains
  ``u = u_nom + alpha*l + L*dx`` (``NU*(2*NX+1)`` operations and ``NX``
  subtractions for ``dx``) and the cost sum, as ``rollout.cu`` does them.

The same on the models ``codegen.py`` generates for ``chip_smoke.py``:
CarParking's from its torch functions and the two user problems of
``chip_smoke.user_problems`` (so B1 at their shapes (2, 1) and (6, 3)).

Prints one JSON object: operations per step, per lane and, for B2, per
step of one trajectory, CarParking's under plain names and the others'
with a prefix (``cartpole_``, ``gen_car_parking_``,
``double_integrator_``, ``point_mass3_``), B2's alone on the two
models of the parallel path (``brachistochrone_``: the hand-written model
of ``brachistochrone()``, ``point_mass3_free_``: the point mass without
its input boxes), and ``brachistochrone_hli``'s as its benchmark cell runs
it: B3 and B1 without FULL_DDP (``_gn_``), B2 with and without the cost
(``_rollout_nocost_``; its ``[k]``-indexed ``ymin`` from -1 to -5).
``tests/test_torch_count_ops.py`` holds the constants of ``chip_smoke.py``
to this count.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "ddp_generator_tpu_torch" / "csrc"

SHIM = r"""
#include <cmath>
#include <cstdio>
#include <vector>

// A double that counts the operations done on it.
static long g_ops = 0;
struct Op {
  double v;
  Op() : v(0) {}
  Op(double x) : v(x) {}
};
inline Op operator+(Op a, Op b) { ++g_ops; return Op(a.v + b.v); }
inline Op operator-(Op a, Op b) { ++g_ops; return Op(a.v - b.v); }
inline Op operator*(Op a, Op b) { ++g_ops; return Op(a.v * b.v); }
inline Op operator/(Op a, Op b) { ++g_ops; return Op(a.v / b.v); }
inline Op operator-(Op a) { return Op(-a.v); }
inline bool operator<(Op a, Op b) { return a.v < b.v; }
inline bool operator<=(Op a, Op b) { return a.v <= b.v; }
inline bool operator>(Op a, Op b) { return a.v > b.v; }
inline bool operator>=(Op a, Op b) { return a.v >= b.v; }
inline bool operator==(Op a, Op b) { return a.v == b.v; }
inline bool operator!=(Op a, Op b) { return a.v != b.v; }
inline Op sin(Op a) { ++g_ops; return Op(std::sin(a.v)); }
inline Op cos(Op a) { ++g_ops; return Op(std::cos(a.v)); }
inline Op sqrt(Op a) { ++g_ops; return Op(std::sqrt(a.v)); }
inline Op asin(Op a) { ++g_ops; return Op(std::asin(a.v)); }
inline Op acos(Op a) { ++g_ops; return Op(std::acos(a.v)); }
inline Op atan(Op a) { ++g_ops; return Op(std::atan(a.v)); }
inline Op atan2(Op a, Op b) { ++g_ops; return Op(std::atan2(a.v, b.v)); }
inline Op exp(Op a) { ++g_ops; return Op(std::exp(a.v)); }
inline Op log(Op a) { ++g_ops; return Op(std::log(a.v)); }
inline Op tanh(Op a) { ++g_ops; return Op(std::tanh(a.v)); }
inline Op pow(Op a, Op b) { ++g_ops; return Op(std::pow(a.v, b.v)); }
inline Op rsqrt_of(Op a) { ++g_ops; return Op(1.0 / std::sqrt(a.v)); }
inline Op fabs(Op a) { return Op(std::fabs(a.v)); }
inline bool is_finite(Op a) { return std::isfinite(a.v); }

#include "backpass.cuh"
#include "fused.cuh"
#include "models/car_parking.cuh"
#include "models/brachistochrone.cuh"
#include "models/cartpole.cuh"
@GENERATED@

using namespace ddp;

static unsigned long long g_seed = 12345;
static double rnd() {  // uniform in [-1, 1)
  g_seed = g_seed * 6364136223846793005ULL + 1442695040888963407ULL;
  return ((g_seed >> 11) * (1.0 / 9007199254740992.0)) * 2.0 - 1.0;
}

// Each model's parameters in its flat order, and a nominal state.
template <class M> struct Case;
template <> struct Case<CarParking> {
  static constexpr double params[CarParking::NP] = {
      2.0, 0.1, 0.01, 0.01, 0.01, 1.0, 0.1, 0.1, 1.0, 0.3,
      0.01, 1e-4, 1e-3, 1e-3, 0.1, 0.1, -0.5, 0.5, -2.0, 2.0};
  static constexpr double x[4] = {1.0, 1.0, 4.7, 1.0};
};
template <> struct Case<Cartpole> {
  static constexpr double params[Cartpole::NP] = {
      1.0, 0.3, 0.5, 9.81, 0.02, 1e-4, 1e-3, 1.0, 20.0, 0.1, 0.1,
      -15.0, 15.0};
  static constexpr double x[4] = {0.0, 3.1, 0.0, 0.0};
};
template <> struct Case<Brachistochrone> {
  static constexpr double params[Brachistochrone::NP] = {
      9.81, -4.0, 0.012566370614359173};
  static constexpr double x[1] = {-1.0};
};
template <> struct Case<BrachistochroneHli> {
  static constexpr double params[BrachistochroneHli::NP] = {
      9.81, 0.012566370614359173};
  static constexpr double x[1] = {-2.0};
};
@CASES@

// Entries of a model's [k]-indexed parameter tail over N steps, after its
// NP fixed ones: only the moving floor's ymin has one, N + 1 entries.
template <class M> struct Tail {
  static int size(int) { return 0; }
};
template <> struct Tail<BrachistochroneHli> {
  static int size(int N) { return N + 1; }
};

// A model's flat parameters over N steps: Case<M>::params, then the tail
// (ymin from -1 to -5, as testBrachi_hli.m's).
template <class M>
static std::vector<Op> flat_params(int N) {
  std::vector<Op> p(M::NP + Tail<M>::size(N));
  for (int i = 0; i < M::NP; ++i) p[i] = Case<M>::params[i];
  for (int k = 0; k < Tail<M>::size(N); ++k)
    p[M::NP + k] = -1.0 - 4.0 * k / N;
  return p;
}

// B3 on one lane over N steps (regType 1, FULL_DDP or not): operations.
template <class M, bool FULL = true>
static long fused_ops(int N) {
  constexpr int NX = M::NX, NU = M::NU;
  Op x[N * NX], u[N * NU], xf[NX], one(1.0), lam(1e-3), l[N * NU],
      L[N * NU * NX], dV[2], g[1];
  bool failed[1], dok[1];
  for (int k = 0; k < N; ++k) {
    for (int a = 0; a < NX; ++a) x[k * NX + a] = Case<M>::x[a] + 0.3 * rnd();
    for (int a = 0; a < NU; ++a) u[k * NU + a] = 0.3 * rnd();
  }
  for (int a = 0; a < NX; ++a) xf[a] = x[a];
  std::vector<Op> pv = flat_params<M>(N);
  const Op* p = pv.data();
  // AL multipliers of every family the model has (ones)
  std::vector<Op> mu_le(N * arr(M::NHLE), one), mu_li(N * arr(M::NHLI), one),
      mu_fe(arr(M::NHFE), one), mu_fi(arr(M::NHFI), one);
  FusedArgs<Op> A{x, u, mu_le.data(), mu_li.data(), xf, &one, &one, &lam,
                  mu_fe.data(), mu_fi.data(), p, l, L, dV, g, failed, dok,
                  N, 1};
  g_ops = 0;
  fused_lane<M, Op, 1, FULL>(A, p, 0);
  return g_ops;
}

// B1 on one lane over N steps (regType 1, FULL_DDP or not): operations.
template <int NX, int NU, bool FULL = true>
static long backpass_ops(int N) {
  constexpr int TX = NX * (NX + 1) / 2, TU = NU * (NU + 1) / 2;
  const int n[16] = {NX * NX, NX * NU, NX, NU, TX, TU, NX * NU, NX * TX,
                     NX * TU, NX * NX * NU, NU, NU, NU * NX, NU * NX, NU, NU};
  static Op buf[16][64 * 4096];
  for (int f = 0; f < 16; ++f)
    for (int i = 0; i < n[f] * N; ++i) buf[f][i] = 0.3 * rnd();
  for (int k = 0; k < N; ++k) {
    for (int a = 0; a < NX; ++a) buf[0][(a * NX + a) * N + k] = 1.0;
    for (int a = 0; a < NX; ++a)
      buf[4][tri(a, a, NX) * N + k] = 3.0;  // cxx diagonal
    for (int a = 0; a < NU; ++a) {
      buf[5][tri(a, a, NU) * N + k] = 3.0;  // cuu diagonal
      buf[10][a * N + k] = -0.5;            // lower
      buf[11][a * N + k] = 0.5;             // upper
      buf[14][a * N + k] = -1.0;
      buf[15][a * N + k] = 1.0;
    }
  }
  Op us[NU * 4096], lam(1e-3), fcx[NX], fcxx[NX * NX], l[4096 * NU],
      L[4096 * NU * NX], dV[2], g[1];
  bool failed[1];
  for (int i = 0; i < NU * N; ++i) us[i] = 0.3 * rnd();
  for (int a = 0; a < NX; ++a) {
    fcx[a] = rnd();
    for (int e = 0; e < NX; ++e) fcxx[a * NX + e] = a == e ? 2.0 : 0.0;
  }
  BackpassArgs<Op> A{buf[0], buf[1], buf[2], buf[3], buf[4], buf[5],
                     buf[6], buf[7], buf[8], buf[9], buf[10], buf[11],
                     buf[12], buf[13], buf[14], buf[15], us, &lam, fcx, fcxx,
                     l, L, dV, g, failed, N, 1};
  g_ops = 0;
  backpass_lane<Op, NX, NU, 1, FULL>(A, 0);
  return g_ops;
}

// One step of one rollout (rollout.cu: rollout_lane): the model calls
// counted, the gains and the cost sum by their formula; without the cost
// (the selected rollout that keeps no cost), no running cost and no sum.
template <class M>
static long rollout_step_ops(bool with_cost = true) {
  constexpr int NX = M::NX, NU = M::NU;
  Op x[NX], u[NU], xn[NX];
  for (int a = 0; a < NX; ++a) x[a] = Case<M>::x[a];
  for (int a = 0; a < NU; ++a) u[a] = 0.1 - 0.3 * a;
  std::vector<Op> pv = flat_params<M>(1);
  const Op* p = pv.data();
  g_ops = 0;
  for (int i = 0; i < M::NH; ++i) {
    const Op s = static_cast<Op>(M::box_sign(i));
    const Op lim = -s * (M::h(i, x, u, p, 0) - s * u[M::box_index(i)]);
    (void)lim;
  }
  const Op mu[4] = {1.0, 1.0, 1.0, 1.0};
  if (with_cost) {
    const Op c = aug_L<M>(x, u, p, 0, mu, mu, Op(1.0));
    (void)c;
  }
  M::f(x, u, p, 0, xn);
  return g_ops + NX + NU * (2 * NX + 1) + (with_cost ? 1 : 0);
}

// The counts of one model, as JSON members named with `prefix`.
template <class M>
static void print_counts(const char* prefix, const char* sep) {
  const int N = 40;
  const long b3_1 = fused_ops<M>(N), b3_2 = fused_ops<M>(2 * N);
  const long b1_1 = backpass_ops<M::NX, M::NU>(N),
             b1_2 = backpass_ops<M::NX, M::NU>(2 * N);
  std::printf(
      "\"%sfused_per_step\": %ld, \"%sfused_per_lane\": %ld, "
      "\"%sbackpass_per_step\": %ld, \"%sbackpass_per_lane\": %ld, "
      "\"%srollout_per_step\": %ld%s",
      prefix, (b3_2 - b3_1) / N, prefix, b3_1 - (b3_2 - b3_1), prefix,
      (b1_2 - b1_1) / N, prefix, b1_1 - (b1_2 - b1_1), prefix,
      rollout_step_ops<M>(), sep);
}

// B3 and B1 without FULL_DDP and B2 with and without the cost, for a
// model whose path is the fused one (the benchmark's frozen counts).
template <class M>
static void print_fused_gn(const char* prefix, const char* sep) {
  const int N = 40;
  const long b3_1 = fused_ops<M, false>(N), b3_2 = fused_ops<M, false>(2 * N);
  const long b1_1 = backpass_ops<M::NX, M::NU, false>(N),
             b1_2 = backpass_ops<M::NX, M::NU, false>(2 * N);
  std::printf(
      "\"%sfused_gn_per_step\": %ld, \"%sfused_gn_per_lane\": %ld, "
      "\"%sbackpass_gn_per_step\": %ld, \"%sbackpass_gn_per_lane\": %ld, "
      "\"%srollout_per_step\": %ld, \"%srollout_nocost_per_step\": %ld%s",
      prefix, (b3_2 - b3_1) / N, prefix, b3_1 - (b3_2 - b3_1), prefix,
      (b1_2 - b1_1) / N, prefix, b1_1 - (b1_2 - b1_1), prefix,
      rollout_step_ops<M>(), prefix, rollout_step_ops<M>(false), sep);
}

// B2's count alone, for a model that only the parallel path's line search
// runs on.
template <class M>
static void print_rollout(const char* prefix, const char* sep) {
  std::printf("\"%srollout_per_step\": %ld%s", prefix, rollout_step_ops<M>(),
              sep);
}

int main() {
  std::printf("{");
  print_counts<CarParking>("", ", ");
  print_counts<Cartpole>("cartpole_", ", ");
  print_rollout<Brachistochrone>("brachistochrone_", ", ");
  print_fused_gn<BrachistochroneHli>("brachistochrone_hli_", ", ");
@PRINTS@
  return 0;
}
"""


def _generated():
    """``[(label, model, params, nominal x, rollout only)]``: the models
    ``chip_smoke.py`` generates, CarParking's from its torch functions (the
    hand-written model stripped), the two user problems (B1 at their shapes
    comes with them) and the point mass without its input boxes (B2 only:
    the parallel path's)."""
    import dataclasses
    import importlib.util

    import numpy as np

    if str(CSRC.parent.parent) not in sys.path:  # run as a script
        sys.path.insert(0, str(CSRC.parent.parent))
    from ddp_generator_tpu_torch import codegen
    from ddp_generator_tpu_torch.models import car_parking

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CSRC.parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    car = dataclasses.replace(car_parking.car_parking(), cuda_model=None)
    cases = [("gen_car_parking", car, car_parking.default_params(),
              [1.0, 1.0, 4.7, 1.0], False)]
    smoke.USER_PROBLEMS = smoke.user_problems()
    for label, (prob, p, _, _) in smoke.USER_PROBLEMS.items():
        cases.append((label, prob, p, list(np.linspace(0.1, 0.6, prob.n_x)),
                      False))
    cases.append(("point_mass3_free", smoke.free_point_mass(),
                  smoke.USER_PROBLEMS["point_mass3"][1],
                  list(np.linspace(0.1, 0.6, 6)), True))
    return [(label, codegen.generate_cuda_model(prob, p), p, x, only)
            for label, prob, p, x, only in cases]


def _shim(generated) -> tuple[str, dict]:
    """The counting program's source and the generated headers it
    includes (file name -> text)."""
    import torch

    from ddp_generator_tpu_torch import params_from_jax

    files, includes, cases, prints = {}, [], [], []
    for i, (label, gm, p, x, rollout_only) in enumerate(generated):
        files[f"{gm.struct}.cuh"] = gm.header
        includes.append(f'#include "{gm.struct}.cuh"')
        flat = gm.flat_params(params_from_jax(p, torch.float64, "cpu"),
                              torch.float64, "cpu", 1).tolist()
        cases.append(
            f"template <> struct Case<{gm.struct}> {{\n"
            f"  static constexpr double params[{len(flat)}] = "
            f"{{{', '.join(repr(v) for v in flat)}}};\n"
            f"  static constexpr double x[{len(x)}] = "
            f"{{{', '.join(repr(float(v)) for v in x)}}};\n}};")
        sep = '"}\\n"' if i == len(generated) - 1 else '", "'
        what = "print_rollout" if rollout_only else "print_counts"
        prints.append(f'  {what}<{gm.struct}>("{label}_", {sep});')
    src = (SHIM.replace("@GENERATED@", "\n".join(includes))
           .replace("@CASES@", "\n".join(cases))
           .replace("@PRINTS@", "\n".join(prints)))
    return src, files


def count() -> dict:
    """Build and run the counting program; its JSON as a dict."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("count_ops needs g++")
    text, files = _shim(_generated())
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = Path(tmp) / "count.cpp", Path(tmp) / "count"
        src.write_text(text)
        for name, header in files.items():
            (Path(tmp) / name).write_text(header)
        proc = subprocess.run(
            [cxx, "-std=c++17", "-O1", "-Wno-unknown-pragmas", "-I",
             str(CSRC), "-I", tmp, "-o", str(exe), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr)
        out = subprocess.run([str(exe)], capture_output=True, text=True,
                             check=True).stdout
    return json.loads(out)


if __name__ == "__main__":
    print(json.dumps(count()))
    sys.exit(0)
