"""Kernel B3 (fused derivatives + backward pass) of the PyTorch port against
the JAX package, float64 on the CPU.

The port's ``fused_derivs_back_pass`` on CPU tensors runs its plain version
(the emission ``cm_emit`` and B1's plain backward pass).  It is held

* against JAX's ``fused_derivs_back_pass(..., interpret=True)`` within the
  JAX test's own tolerances (``tests/test_pallas_fused.py:54-65``), which
  cover the Pallas kernel's polynomial ``asin``;
* against JAX's ``calc_derivs`` + serial ``back_pass`` to 1e-10,

for CarParking (FULL_DDP on/off, regType 1/2, a lane whose rollout is NaN
so that ``derivs_ok`` is false, a lane that fails) and for
``brachistochrone_hli`` with nonzero multipliers and penalty weights.  The
interpret-mode cases are few, short and without FULL_DDP: Pallas'
interpreter takes tens of seconds per call here.  The solver's fused path
is held against JAX in ``tests/test_torch_solver.py`` and
``tests/test_torch_brachistochrone.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_generator_tpu as jd
from ddp_generator_tpu.derivs import calc_derivs
from ddp_generator_tpu.models import brachistochrone as jbr
from ddp_generator_tpu.models import car_parking as jcar
from ddp_generator_tpu.ops.backpass import back_pass
from ddp_generator_tpu.ops.pallas_fused import (
    fused_derivs_back_pass as j_fused,
)
from ddp_generator_tpu.solver import _boxqp_hyper
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.launches import read_launches
from ddp_generator_tpu_torch.models import brachistochrone as tbr
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.ops import cuda_fused as cf

B = 6
# tests/test_pallas_fused.py:54-65
JAX_FUSED_TOL = dict(l=2e-5, L=2e-4, dV=1e-5, g_norm=1e-6)
SERIAL_TOL = dict(rtol=1e-10, atol=1e-10)


def _case(model: str, T: int, seed: int = 0):
    """A nominal trajectory rolled forward with the JAX model, random
    multipliers and penalty weights; float64 numpy.  CarParking: lane 5's
    rollout turns NaN, lane 3's lambda makes its pass fail."""
    rng = np.random.default_rng(seed)
    if model == "car_parking":
        jp, tp = jcar.car_parking(), tcar.car_parking()
        p, x0, _ = jcar.default_setup(T=T, seed=0)
        x0s = np.tile(x0, (B, 1)) + 0.05 * rng.standard_normal((B, 4))
        x0s[:, 3] += rng.uniform(0.5, 2.0, B)  # nonzero speed
        us = 0.3 * rng.standard_normal((B, T, 2))
        x0s[5, 3], us[5, :, 0] = 1e4, 0.3  # |h v sin w| > d: NaN
    else:
        jp, tp = jbr.brachistochrone_hli(), tbr.brachistochrone_hli()
        p, x0, _ = jbr.default_setup_hli(T)
        x0s = np.tile(x0, (B, 1)) - rng.uniform(0.0, 0.5, (B, 1))
        us = -np.abs(rng.uniform(0.5, 1.5, (B, T, 1)))
    xs = np.zeros((B, T + 1, jp.n_x))
    xs[:, 0] = x0s
    for k in range(T):
        xs[:, k + 1] = np.asarray(jax.vmap(
            lambda x, u: jp.f(x, u, p, k))(jnp.asarray(xs[:, k]),
                                            jnp.asarray(us[:, k])))
    mu = lambda *s: rng.uniform(0.2, 2.0, s)
    lam = np.abs(rng.standard_normal(B)) * 0.1
    if model == "car_parking":
        lam[3] = -1e3  # Quu indefinite: the pass fails
    return dict(
        jp=jp, tp=tp, p=p, xs=xs, us=us,
        mult=(mu(B, T, jp.n_hle), mu(B, T, jp.n_hli),
              rng.standard_normal((B, jp.n_hfe)), mu(B, jp.n_hfi)),
        wl=rng.uniform(1.0, 40.0, B), wf=rng.uniform(1e-3, 1.0, B), lam=lam)


def _port(c, reg_type, full_ddp):
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    before = read_launches()
    bp, ok = cf.fused_derivs_back_pass(
        c["tp"], t(c["xs"]), t(c["us"]), *map(t, c["mult"]), t(c["wl"]),
        t(c["wf"]), t(c["lam"]),
        td.params_from_jax(c["p"], torch.float64, "cpu"), reg_type,
        full_ddp)
    assert read_launches() == before  # plain: no launch
    return jax.tree_util.tree_map(lambda a: a.numpy(), tuple(bp)), ok.numpy()


def _compare(out, out_ok, ref, ref_ok, tols):
    """Flags on every lane; values on the lanes whose derivatives are
    finite (the solver reads nothing else of the others)."""
    np.testing.assert_array_equal(out_ok, ref_ok)
    np.testing.assert_array_equal(out[4], np.asarray(ref.failed))
    live = np.asarray(ref_ok)
    for i, name in enumerate(("l", "L", "dV", "g_norm")):
        np.testing.assert_allclose(out[i][live],
                                   np.asarray(getattr(ref, name))[live],
                                   err_msg=name, **tols(name))


@pytest.mark.parametrize("model,reg_type,full_ddp", [
    # without FULL_DDP: interpreting the nested jvp of f's second
    # derivatives takes ~45 s here; the serial cases below cover FULL_DDP
    ("car_parking", 1, False),
    ("brachistochrone_hli", 2, False),
])
def test_plain_matches_jax_fused_interpret(model, reg_type, full_ddp):
    c = _case(model, T=6, seed=1)
    mult = tuple(jnp.asarray(m) for m in c["mult"])
    ref, ref_ok = j_fused(
        c["jp"], jnp.asarray(c["xs"]), jnp.asarray(c["us"]), *mult,
        jnp.asarray(c["wl"]), jnp.asarray(c["wf"]), jnp.asarray(c["lam"]),
        jax.tree_util.tree_map(jnp.asarray, c["p"]), reg_type, full_ddp,
        interpret=True)
    out, ok = _port(c, reg_type, full_ddp)
    _compare(out, ok, ref, ref_ok,
             lambda name: dict(rtol=0, atol=JAX_FUSED_TOL[name]))
    if model == "car_parking":
        assert not ok[5] and ok[[0, 1, 2, 3, 4]].all()
        assert out[4][3] and not out[4][[0, 1, 2, 4]].any()


@pytest.mark.parametrize("model,reg_type,full_ddp", [
    ("car_parking", 1, True),
    ("car_parking", 1, False),
    ("car_parking", 2, True),
    ("car_parking", 2, False),
    ("brachistochrone_hli", 1, False),
    ("brachistochrone_hli", 2, True),
])
def test_plain_matches_jax_serial(model, reg_type, full_ddp):
    c = _case(model, T=12, seed=2)
    hyper = _boxqp_hyper(jd.SolverOptions())

    def one_lane(xs_, us_, mle, mli, mfe, mfi, wl, wf, lam):
        d = calc_derivs(c["jp"], xs_, us_, c["p"], mle, mli, mfe, mfi, wl,
                        wf, full_ddp)
        return back_pass(d, us_, lam, reg_type, full_ddp, hyper), d.ok

    c["p"] = jax.tree_util.tree_map(jnp.asarray, c["p"])  # traced k indexes
    ref, ref_ok = jax.jit(jax.vmap(one_lane))(
        c["xs"], c["us"], *c["mult"], c["wl"], c["wf"], c["lam"])
    out, ok = _port(c, reg_type, full_ddp)
    _compare(out, ok, ref, ref_ok, lambda name: SERIAL_TOL)
    if model == "car_parking":
        assert not ok[5] and out[4][3]
    else:
        assert ok.all()


def test_wrapper_refuses_other_devices():
    c = _case("car_parking", T=4)
    m = lambda a: torch.empty(np.shape(a), dtype=torch.float64,
                              device="meta")
    with pytest.raises(ValueError, match="device"):
        cf.fused_derivs_back_pass(
            c["tp"], m(c["xs"]), m(c["us"]), *map(m, c["mult"]), m(c["wl"]),
            m(c["wf"]), m(c["lam"]), {}, 1, True)
