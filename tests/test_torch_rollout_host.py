"""Kernel B2's staged schedule compiled for the host and held against the
one-thread rollout, bit for bit.

``csrc/rollout.cuh`` compiles without CUDA, so the very functions the
staged rollout kernel is made of -- the producer's tile copy
(``rollout_fill``), the chain thread's share of a tile (``chain_tile``),
the cost warps' work items, their in-order sum and the trajectory stores
(``cost_items``, ``cost_sum``, ``store_tile``) and the final cost
(``rollout_finish``) -- are built here with ``g++`` and run serially in
the kernel's order, block by block and tile by tile, into slots first
filled with NaN.  The result must equal ``rollout_lane``, the
one-thread-per-trajectory reference, under ``np.array_equal``: a term read
from the wrong slot entry, a step left out at a ragged edge or a cost
summed in another order fails it.

Cases: CarParking and ``brachistochrone_hli`` (its ``ymin[k]`` tail and AL
terms), float32 and float64, the sweep and the selected rollout with and
without cost; ``B = G+3`` lanes, ``N = 2S+1`` steps, more alphas than one
block rolls, a lane whose rollout turns NaN and alpha = 0.  The staged line
search's stage flag: every block of the schedule starts with the kernel's
entry test (``rollout_skipped``), so with the flag at 0 the NaN-filled
outputs stay untouched and at 1 the result is the unflagged one.  Skips
when no C++ compiler is found.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch import _build
from ddp_generator_tpu_torch.models import brachistochrone as tbr
from ddp_generator_tpu_torch.models import car_parking as tcar

SHIM = r"""
#include <algorithm>
#include <cmath>
#include <limits>
#include <vector>

#include "models/brachistochrone.cuh"
#include "models/car_parking.cuh"
#include "rollout.cuh"

using namespace ddp;

template <class M, typename T, bool MULTI, bool WANT_COST>
void reference(const RolloutArgs<T>& A) {
  const int total = MULTI ? A.A * A.B : A.B;
  with_params<M>(A.params, [&](const T* p) {
    for (int idx = 0; idx < total; ++idx)
      rollout_lane<M, T, MULTI, WANT_COST>(A, p, idx);
  });
}

// Kernel B2's schedule run serially: per block (lanes b0 .., alphas a0 ..)
// and per time tile, the producer's copy into a NaN-filled input slot,
// every chain's share into a NaN-filled output slot, then the cost warps'
// items (cut over `parts` callers, as over threads), their sum and the
// stores; at the end each chain's final cost.
template <class M, typename T, bool MULTI, bool WANT_COST>
void staged(const RolloutArgs<T>& A, int parts) {
  constexpr int S = rollout_steps<M, T, MULTI>();
  constexpr int NCH = block_chains<MULTI>(), G = kRolloutLanes;
  constexpr bool COST = MULTI || WANT_COST;
  const T nan = std::numeric_limits<T>::quiet_NaN();
  std::vector<T> in(RolloutTerms<M>::NT * S * G);
  std::vector<T> out(OutSlot<M, S, NCH>::SIZE), cbuf(S * NCH), c_acc(NCH);
  bool okbuf[S * NCH], ok_acc[NCH];
  auto copy = [](T* dst, const T* src, int n) {
    for (int e = 0; e < n; ++e) dst[e] = src[e];
  };
  if (rollout_skipped(A)) return;  // rollout_kernel's entry, every block
  with_params<M>(A.params, [&](const T* p) {
    for (int b0 = 0; b0 < A.B; b0 += G) {
      for (int a0 = 0; a0 < (MULTI ? A.A : 1); a0 += kAlphaChunk) {
        const int na = MULTI ? std::min(kAlphaChunk, A.A - a0) : 1;
        const int nch = G * na;
        T x[NCH][M::NX], alpha[NCH];
        Chain ch[NCH];
        for (int c = 0; c < nch; ++c) {
          c_acc[c] = T(0);
          ok_acc[c] = true;
          ch[c] = chain_of(c, b0, a0, na, A.B);
          if (!ch[c].live) continue;
          alpha[c] = MULTI ? A.alpha[ch[c].ai] : A.alpha[ch[c].b];
          for (int a = 0; a < M::NX; ++a) x[c][a] = A.x0[a * A.B + ch[c].b];
        }
        for (int j = 0; j < num_tiles(A.N, S); ++j) {
          const int n = tile_len(A.N, S, j), k0 = tile_k0(S, j);
          std::fill(in.begin(), in.end(), nan);
          for (int q = 0; q < parts; ++q)
            rollout_fill<M, T, S>(A, k0, b0, in.data(), q, parts, copy);
          std::fill(out.begin(), out.end(), nan);
          for (int c = 0; c < nch; ++c)
            if (ch[c].live)
              chain_tile<M, T, S, NCH>(in.data(), out.data(), n, k0, ch[c].g,
                                       c, alpha[c], p, x[c]);
          for (int q = 0; q < parts; ++q) {
            if (!MULTI)
              store_tile<M, T, S, NCH>(A, out.data(), n, k0, b0, q, parts);
            if (COST)
              cost_items<M, T, S, NCH>(A, p, out.data(), n, k0, b0, a0, na,
                                       cbuf.data(), okbuf, q, parts);
          }
          if (COST)
            for (int q = 0; q < parts; ++q)
              cost_sum<T, NCH>(cbuf.data(), okbuf, n, nch, c_acc.data(),
                               ok_acc, q, parts);
        }
        for (int c = 0; c < nch; ++c)
          if (ch[c].live)
            rollout_finish<M, T, MULTI, WANT_COST>(A, p, x[c], ch[c].b,
                                                   ch[c].ai, c_acc[c],
                                                   ok_acc[c]);
      }
    }
  });
}

template <class M, typename T>
void run(int staged_schedule, int multi, int want_cost, int N, int B, int A,
         void* const* p) {
  RolloutArgs<T> a;
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(p[i]); };
  a.xnom = in(0); a.unom = in(1); a.l = in(2); a.L = in(3);
  a.mu_le = in(4); a.mu_li = in(5); a.x0 = in(6); a.wpl = in(7);
  a.wpf = in(8); a.mu_fe = in(9); a.mu_fi = in(10); a.alpha = in(11);
  a.params = in(12);
  a.cost = out(13);
  a.ok = static_cast<bool*>(p[14]);
  a.xs = out(15); a.xf = out(16); a.us = out(17);
  a.run = static_cast<const int*>(p[18]);
  a.N = N; a.B = B; a.A = A;
  const int parts = 3;
  if (multi) {
    if (staged_schedule) staged<M, T, true, true>(a, parts);
    else reference<M, T, true, true>(a);
  } else if (want_cost) {
    if (staged_schedule) staged<M, T, false, true>(a, parts);
    else reference<M, T, false, true>(a);
  } else {
    if (staged_schedule) staged<M, T, false, false>(a, parts);
    else reference<M, T, false, false>(a);
  }
}

// ptrs as ddp_rollout's (the stage flag last).  model: 0 CarParking, 1 BrachistochroneHli;
// dtype: 0 float32, 1 float64; staged_schedule 0 runs rollout_lane.
extern "C" void host_rollout(int model, int dtype, int staged_schedule,
                             int multi, int want_cost, int N, int B, int A,
                             void* const* p) {
  if (model == 0 && dtype == 0)
    run<CarParking, float>(staged_schedule, multi, want_cost, N, B, A, p);
  else if (model == 0)
    run<CarParking, double>(staged_schedule, multi, want_cost, N, B, A, p);
  else if (dtype == 0)
    run<BrachistochroneHli, float>(staged_schedule, multi, want_cost, N, B,
                                   A, p);
  else
    run<BrachistochroneHli, double>(staged_schedule, multi, want_cost, N, B,
                                    A, p);
}

// out: lanes per block, steps per tile, alphas per block.
extern "C" void host_rollout_shape(int model, int dtype, int multi,
                                   int* out) {
  auto steps = [&](auto m, auto t) {
    using M = decltype(m);
    using T = decltype(t);
    return multi ? rollout_steps<M, T, true>() : rollout_steps<M, T, false>();
  };
  out[0] = kRolloutLanes;
  out[1] = model == 0 ? (dtype == 0 ? steps(CarParking(), 0.f)
                                    : steps(CarParking(), 0.0))
                      : (dtype == 0 ? steps(BrachistochroneHli(), 0.f)
                                    : steps(BrachistochroneHli(), 0.0));
  out[2] = kAlphaChunk;
}
"""

MODELS = {"car_parking": 0, "brachistochrone_hli": 1}
DTYPES = {"f32": (0, np.float32, torch.float32),
          "f64": (1, np.float64, torch.float64)}
MODES = {"multi": (1, 1), "selected": (0, 0), "selected_cost": (0, 1)}
NAN_LANE = 5


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler: B2's host build needs g++")
    out = tmp_path_factory.mktemp("rollout_host")
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
    i = ctypes.c_int
    lib.host_rollout.argtypes = [i] * 8 + [ctypes.POINTER(ctypes.c_void_p)]
    lib.host_rollout_shape.argtypes = [i, i, i, ctypes.POINTER(i)]
    return lib


def _shape(lib, model, dtype, multi):
    out = (ctypes.c_int * 3)()
    lib.host_rollout_shape(MODELS[model], DTYPES[dtype][0], int(multi), out)
    return tuple(out)  # G, S, alphas per block


def _operands(model, np_dtype, t_dtype, N, B, A):
    """Random component-major operands of ``ddp_rollout``: a nominal
    trajectory, gains, AL inputs with every term live; lane NAN_LANE's
    rollout turns NaN; alphas with a 0 among them."""
    rng = np.random.default_rng(17)
    if model == "car_parking":
        prob = tcar.car_parking()
        p, x0, _ = tcar.default_setup(T=N, seed=0)
        xnom = np.tile(np.asarray(x0)[None, :, None], (N, 1, B))
        xnom = xnom + 0.3 * rng.standard_normal((N, 4, B))
        unom = 0.4 * rng.standard_normal((N, 2, B))  # some beyond the limits
        x0s = xnom[0] + 0.05 * rng.standard_normal((4, B))
        x0s[3, NAN_LANE], unom[:, 0, NAN_LANE] = 1e4, 0.3  # asin of > 1
    else:
        prob = tbr.brachistochrone_hli()
        p, _, _ = tbr.default_setup_hli(N)
        xnom = -rng.uniform(0.2, 4.0, (N, 1, B))
        unom = -rng.uniform(0.5, 1.5, (N, 1, B))
        x0s = xnom[0] - 0.05 * rng.uniform(0.0, 1.0, (1, B))
        x0s[0, NAN_LANE] = 0.5  # sqrt(-y) of y > 0
    n_x, n_u = prob.n_x, prob.n_u
    mu = lambda *s: rng.uniform(0.2, 2.0, s)
    alphas = np.r_[np.logspace(0, -3, A - 1), 0.0]
    alpha_vec = rng.choice(alphas, (1, B))
    alpha_vec[0, :2] = 0.0
    p_flat = prob.cuda_model.flat_params(
        td.params_from_jax(p, t_dtype, "cpu"), t_dtype, "cpu", N).numpy()
    ins = [xnom, unom, 0.1 * rng.standard_normal((N, n_u, B)),
           0.05 * rng.standard_normal((N, n_u * n_x, B)),
           mu(N, prob.n_hle, B), mu(N, prob.n_hli, B), x0s,
           rng.uniform(0.5, 40.0, (1, B)), rng.uniform(0.5, 40.0, (1, B)),
           rng.standard_normal((prob.n_hfe, B)), mu(prob.n_hfi, B)]
    return ([np.ascontiguousarray(a, np_dtype) for a in ins],
            alphas.astype(np_dtype), alpha_vec.astype(np_dtype), p_flat, prob)


def _run(lib, model, dtype, mode, staged, N, B, A, flag=None,
         fill_value=-7.0):
    code, np_dtype, t_dtype = DTYPES[dtype]
    multi, want_cost = MODES[mode]
    ins, alphas, alpha_vec, p_flat, prob = _operands(model, np_dtype,
                                                     t_dtype, N, B, A)
    alpha = alphas if multi else alpha_vec
    rows = A if multi else 1
    fill = lambda *s: np.full(s, fill_value, np_dtype)
    outs = [fill(rows, B), np.zeros((rows, B), bool),
            fill(N, prob.n_x, B), fill(prob.n_x, B), fill(N, prob.n_u, B)]
    arrs = ins + [alpha, p_flat] + outs
    run = None if flag is None else np.array([flag], np.int32)
    q = (ctypes.c_void_p * 19)(*[a.ctypes.data for a in arrs],
                               None if run is None else run.ctypes.data)
    lib.host_rollout(MODELS[model], code, int(staged), multi, want_cost, N,
                     B, A, q)
    return outs


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("model", list(MODELS))
def test_staged_rollout_equals_rollout_lane(lib, model, dtype, mode):
    G, S, chunk = _shape(lib, model, dtype, mode == "multi")
    B, N, A = G + 3, 2 * S + 1, chunk + 1
    ref = _run(lib, model, dtype, mode, False, N, B, A)
    out = _run(lib, model, dtype, mode, True, N, B, A)
    for name, o, r in zip(("cost", "ok", "xs", "xf", "us"), out, ref):
        np.testing.assert_array_equal(o, r, err_msg=name)
    cost, ok, xs, xf, us = ref
    if mode == "selected":
        assert (cost == -7.0).all()  # no cost asked for: none written
    else:
        assert not ok[:, NAN_LANE].any()
        assert ok[:, np.arange(B) != NAN_LANE].all()
        assert np.isfinite(cost[:, np.arange(B) != NAN_LANE]).all()
    if mode == "multi":
        assert (xs == -7.0).all()  # the sweep writes no trajectory
    else:
        assert np.isfinite(np.delete(xs, NAN_LANE, axis=2)).all()
        assert (us != -7.0).all() and (xf != -7.0).all()


def test_alpha_zero_is_the_nominal_control(lib):
    """alpha = 0 gives exactly u_nom clamped, whatever the gains."""
    G, S, chunk = _shape(lib, "car_parking", "f64", False)
    B, N, A = G + 3, 2 * S + 1, chunk + 1
    ins, _, alpha_vec, _, _ = _operands("car_parking", np.float64,
                                        torch.float64, N, B, A)
    _, _, _, _, us = _run(lib, "car_parking", "f64", "selected", True, N, B,
                          A)
    p, _, _ = tcar.default_setup(T=N, seed=0)
    lo = np.array([p["limW"][0], p["limA"][0]])[None, :, None]
    hi = np.array([p["limW"][1], p["limA"][1]])[None, :, None]
    zero = alpha_vec[0] == 0.0
    assert zero[:2].all()
    np.testing.assert_array_equal(us[:, :, zero],
                                  np.clip(ins[1], lo, hi)[:, :, zero])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("model", list(MODELS))
def test_stage_flag(lib, model, dtype, mode):
    """Flag 0: the staged schedule returns at entry and every NaN-filled
    output slot (and the False-filled ok) is left as it was; flag 1: the
    unflagged result, bit for bit."""
    G, S, chunk = _shape(lib, model, dtype, mode == "multi")
    B, N, A = G + 3, 2 * S + 1, chunk + 1
    nan = float("nan")
    skipped = _run(lib, model, dtype, mode, True, N, B, A, flag=0,
                   fill_value=nan)
    assert all(np.isnan(o).all() for o in skipped if o.dtype != bool)
    assert not skipped[1].any()
    ran = _run(lib, model, dtype, mode, True, N, B, A, flag=1)
    ref = _run(lib, model, dtype, mode, True, N, B, A)
    for name, o, r in zip(("cost", "ok", "xs", "xf", "us"), ran, ref):
        np.testing.assert_array_equal(o, r, err_msg=name)
