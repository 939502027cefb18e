"""The emission kernel's arithmetic compiled for the host and held against
the torch emitter, float64.

``csrc/emit.cuh`` -- the per-(step, lane) routine of the kernel path's
emission kernel (``emit_point``, over ``derivs.cuh``'s work items) and its
per-lane final terms (``emit_final``) -- compiles without CUDA, as
``tests/test_torch_dual_host.py`` builds B3's headers.  Here it is built with
``g++`` beside the hand-written models and one generated model, and run over
every point in the kernel's thread order, with each work item on a thread of
its own and with all of a point's items on one.  The packed bundle it writes
(every key of ``_BUNDLE_KEYS``, ``us_cm``), ``final_cx``/``final_cxx`` and
``ok`` are held against ``batched_calc_derivs_cm`` to 1e-12 of the largest
value, FULL_DDP on and off; a lane whose derivatives or final terms are not
finite clears only its own ``ok``.  Skips when no C++ compiler is found.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import ddp_generator_tpu_torch as td
import test_torch_codegen as cg
import test_torch_dual_host as dh
from ddp_generator_tpu_torch import _build, codegen
from ddp_generator_tpu_torch.ops.cm_derivs import cm_emit
from ddp_generator_tpu_torch.ops.cuda_backpass import _BUNDLE_KEYS
from ddp_generator_tpu_torch.ops.cuda_emit import items_per_point

SHIM = r"""
#include <algorithm>

#include "emit.cuh"
#include "models/hand_written.cuh"
@INCLUDES@

using namespace ddp;

// The two kernels' work in their order: every lane's final terms, then each
// group of `per` work items over every point (the step kernel's thread i
// is point i % (N*B) of group i / (N*B)).
template <class M, bool FULL>
void run(const EmitArgs<double>& a, int per) {
  with_params<M>(a.params, [&](const double* p) {
    for (int b = 0; b < a.B; ++b) emit_final<M>(a, p, b);
    constexpr int K = items_per_point<M, FULL>();
    const size_t np = static_cast<size_t>(a.N) * a.B;
    for (int first = 0; first < K; first += per)
      for (size_t pt = 0; pt < np; ++pt)
        emit_point<M, FULL>(a, p, pt, first, std::min(first + per, K));
  });
}

// ptrs as ddp_emit's (csrc/emit.cu); variant 2 * model + FULL_DDP.
extern "C" void host_emit(int variant, int per, int N, int B,
                          void* const* q) {
  EmitArgs<double> a;
  auto in = [&](int i) { return static_cast<const double*>(q[i]); };
  auto out = [&](int i) { return static_cast<double*>(q[i]); };
  a.xs = in(0); a.us = in(1); a.mu_le = in(2); a.mu_li = in(3);
  a.mu_fe = in(4); a.mu_fi = in(5); a.wpl = in(6); a.wpf = in(7);
  a.params = in(8);
  a.bundle = out(9); a.final_cx = out(10); a.final_cxx = out(11);
  a.ok = static_cast<bool*>(q[12]);
  a.N = N;
  a.B = B;
  switch (variant) {
@CASES@
  }
}
"""

HAND = {"car_parking": "CarParking", "cartpole": "Cartpole",
        "brachistochrone_hli": "BrachistochroneHli"}
GENERATED = "al_families"  # every AL family, on a generated model
MODELS = tuple(HAND) + (GENERATED,)
N, B = dh.N, dh.B


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The host library, the generated model and its problem and params."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler: the emission kernel's host build "
                    "needs g++")
    out = tmp_path_factory.mktemp("emit_host")
    prob, params, _ = cg._cases()[GENERATED]
    gm = codegen.generate_cuda_model(prob, params)
    (out / f"{gm.struct}.cuh").write_text(gm.header)
    structs = [HAND[n] for n in HAND] + [gm.struct]
    cases = "\n".join(
        f"    case {2 * i + full}: run<{st}, {'true' if full else 'false'}>"
        "(a, per); return;"
        for i, st in enumerate(structs) for full in (0, 1))
    src = out / "shim.cpp"
    src.write_text(SHIM.replace("@INCLUDES@", f'#include "{gm.struct}.cuh"')
                   .replace("@CASES@", cases))
    so = out / "shim.so"
    # no FMA contraction, as the kernels are built (--fmad=false)
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", "-I", str(_build.CSRC), "-I", str(out),
         "-o", str(so), str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    i = ctypes.c_int
    lib.host_emit.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_void_p)]
    return lib, (prob, params, gm)


def _case(built, name, seed):
    """Operands of ``name`` (``test_torch_dual_host._case``'s, every term
    live) and the flat params its CUDA model reads."""
    if name == GENERATED:
        prob, params, model = built[1]
        c = cg._case(name, prob, params, seed)
    else:
        c = dh._case(name, seed)
        model = c["prob"].cuda_model
    c["flat"] = np.ascontiguousarray(model.flat_params(
        td.params_from_jax(c["p"], torch.float64, "cpu"), torch.float64,
        "cpu", N).numpy())
    return c


def _host_emit(built, name, c, full, per):
    """The emission kernel's outputs on the host: ``(sd_cm, final_cx,
    final_cxx, us_cm, ok)`` as numpy, the bundle first filled with NaN."""
    prob = c["prob"]
    n_x, n_u = prob.n_x, prob.n_u
    nt = sum(t.shape[0] for t in _ref(c, full)[0].values()) + n_u
    arr = lambda a: np.ascontiguousarray(a, dtype=np.float64)
    ins = [arr(c["xs"]), arr(c["us"]), arr(c["mu_le"]), arr(c["mu_li"]),
           arr(c["mu_fe"]), arr(c["mu_fi"]), arr(c["wpl"]), arr(c["wpf"]),
           c["flat"]]
    bundle = np.full((nt, N, B), np.nan)
    outs = [bundle, np.full((n_x, B), np.nan),
            np.full((n_x * n_x, B), np.nan), np.ones(B, bool)]
    q = (ctypes.c_void_p * 13)(*[a.ctypes.data for a in ins + outs])
    built[0].host_emit(2 * MODELS.index(name) + int(full), per, N, B, q)
    sizes = np.cumsum([v.shape[0] for v in _ref(c, full)[0].values()])
    parts = np.split(bundle, sizes)
    sd = dict(zip(_BUNDLE_KEYS, parts[:-1]))
    return sd, outs[1], outs[2], parts[-1], outs[3]


def _ref(c, full):
    """``cm_emit`` (``batched_calc_derivs_cm`` and ``us_cm``) on the CPU."""
    t = dh._t
    return cm_emit(c["prob"], t(c["xs"]), t(c["us"]), t(c["mu_le"]),
                   t(c["mu_li"]), t(c["mu_fe"]), t(c["mu_fi"]), t(c["wpl"]),
                   t(c["wpf"]), td.params_from_jax(c["p"], torch.float64,
                                                   "cpu"), full)


def _close(out, ref, name):
    """Within 1e-12 of the largest finite value; +-inf where ``ref`` is."""
    ref = ref.numpy() if isinstance(ref, torch.Tensor) else ref
    assert out.shape == ref.shape, name
    fin = np.isfinite(ref)
    scale = max(1.0, np.abs(ref[fin]).max()) if fin.any() else 1.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * scale,
                               err_msg=name)


@pytest.mark.parametrize("full", [True, False], ids=["full", "gn"])
@pytest.mark.parametrize("name", MODELS)
def test_emitted_bundle_matches_cm_derivs(built, name, full):
    """Every key, us_cm, final_cx/final_cxx and ok against cm_emit, with
    one work item a thread and with all of a point's items on one thread
    (the two give the same bits)."""
    c = _case(built, name, 3)
    n_x, n_u = c["prob"].n_x, c["prob"].n_u
    ref_sd, ref_cx, ref_cxx, ref_us, ref_ok = _ref(c, full)
    items = items_per_point(n_x, n_u, full)
    one, whole = (_host_emit(built, name, c, full, per)
                  for per in (1, items))
    sd, cx, cxx, us_cm, ok = one
    for key in _BUNDLE_KEYS:
        _close(sd[key], ref_sd[key], key)
        np.testing.assert_array_equal(whole[0][key], sd[key], err_msg=key)
    for out, ref, key in ((cx, ref_cx, "final_cx"),
                          (cxx, ref_cxx, "final_cxx"),
                          (us_cm, ref_us, "us_cm")):
        _close(out, ref, key)
    np.testing.assert_array_equal(us_cm, ref_us.numpy())
    np.testing.assert_array_equal(ok, ref_ok.numpy())
    assert ok.all()
    for a, b in zip(one[1:], whole[1:]):
        np.testing.assert_array_equal(a, b)
    if name == "car_parking":  # its input bounds bind at every point
        assert np.isfinite(sd["lower"]).all() and (sd["lower_sign"] < 0).all()


@pytest.mark.parametrize("full", [True, False], ids=["full", "gn"])
def test_emit_nan_clears_ok_per_lane(built, full):
    """A lane whose f goes NaN at a step (CarParking's sqrt, as in
    test_torch_cm_derivs.py) and a lane with a NaN final state clear only
    their own ok, as in cm_emit."""
    c = _case(built, "car_parking", 4)
    c["xs"][1, 3, 3], c["us"][1, 3, 0] = 1e4, 0.4
    c["xs"][4, N, 0] = np.nan
    ref_ok = _ref(c, full)[4].numpy()
    for per in (1, items_per_point(4, 2, full)):
        ok = _host_emit(built, "car_parking", c, full, per)[4]
        np.testing.assert_array_equal(ok, ref_ok)
        assert not ok[1] and not ok[4] and ok[[0, 2, 3, 5]].all()
