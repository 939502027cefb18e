"""Derivative emission of the PyTorch port against the JAX package:
``cm_emit`` against JAX's ``batched_calc_derivs_cm`` and ``calc_derivs``
against JAX's ``calc_derivs`` (CarParking, N=16, B=8, float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_generator_tpu as jd
from ddp_generator_tpu.models import car_parking as jcar
from ddp_generator_tpu.ops.cm_derivs import batched_calc_derivs_cm
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.ops.cm_derivs import cm_emit

N, B = 16, 8
TOL = dict(rtol=1e-10, atol=1e-12)


def _inputs(seed=1, nan_lane=None):
    """A rolled-forward nominal trajectory (derivatives at a generic point)."""
    jp = jcar.car_parking()
    p, x0, _ = jcar.default_setup(T=N, seed=0)
    rng = np.random.default_rng(seed)
    x0s = np.tile(x0, (B, 1)) + 0.01 * rng.standard_normal((B, 4))
    x0s[:, 3] += rng.uniform(0.5, 2.0, B)  # nonzero speed: fxx etc. nonzero
    us = 0.3 * rng.standard_normal((B, N, 2))
    xs = np.zeros((B, N + 1, 4))
    xs[:, 0] = x0s
    for k in range(N):
        xs[:, k + 1] = np.asarray(jax.vmap(
            lambda x, u: jp.f(x, u, p, k))(jnp.asarray(xs[:, k]),
                                            jnp.asarray(us[:, k])))
    if nan_lane is not None:
        # |h*v*sin(w)| > d: the sqrt in f goes NaN at that lane's step 3
        xs[nan_lane, 3, 3] = 1e4
        us[nan_lane, 3, 0] = 0.4
    z = lambda *s: np.zeros(s)
    mult = (z(B, N, 0), z(B, N, 0), z(B, 0), z(B, 0))
    wl = 1.0 + rng.uniform(size=B)
    wf = 1.0 + rng.uniform(size=B)
    return jp, p, xs, us, mult, wl, wf


def _torch(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("full_ddp", [True, False])
def test_cm_emit_matches_jax(full_ddp):
    jp, p, xs, us, mult, wl, wf = _inputs()
    sd_j, fcx_j, fcxx_j, ok_j = jax.jit(
        lambda *a: batched_calc_derivs_cm(jp, *a, full_ddp=full_ddp)
    )(xs, us, p, *mult, wl, wf)
    tp = tcar.car_parking()
    p_t = td.params_from_jax(p, torch.float64, "cpu")
    sd_t, fcx_t, fcxx_t, us_cm, ok_t = cm_emit(
        tp, _torch(xs), _torch(us), *map(_torch, mult), _torch(wl),
        _torch(wf), p_t, full_ddp)
    assert set(sd_t) == set(sd_j)
    for key in sd_j:
        ref = np.asarray(sd_j[key])
        out = sd_t[key].numpy()
        assert out.shape == ref.shape, key
        np.testing.assert_allclose(out, ref, err_msg=key, **TOL)
    np.testing.assert_allclose(fcx_t.numpy(), np.asarray(fcx_j), **TOL)
    np.testing.assert_allclose(fcxx_t.numpy(), np.asarray(fcxx_j), **TOL)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(us_cm.numpy(), np.transpose(us, (2, 1, 0)))
    if full_ddp:
        # CarParking FULL_DDP: 159 bundle components per step (JAX's
        # count, cm_derivs.py:25-26), plus the 2 of us
        assert sum(v.shape[0] for v in sd_t.values()) == 159
        assert np.abs(sd_t["fxx"].numpy()).max() > 1e-3


def test_cm_emit_nan_clears_ok_per_lane():
    jp, p, xs, us, mult, wl, wf = _inputs(nan_lane=5)
    _, _, _, ok_j = jax.jit(
        lambda *a: batched_calc_derivs_cm(jp, *a, full_ddp=True)
    )(xs, us, p, *mult, wl, wf)
    tp = tcar.car_parking()
    p_t = td.params_from_jax(p, torch.float64, "cpu")
    *_, ok_t = cm_emit(tp, _torch(xs), _torch(us), *map(_torch, mult),
                       _torch(wl), _torch(wf), p_t, True)
    assert not bool(ok_t[5]) and bool(ok_t[[0, 1, 2, 3, 4, 6, 7]].all())
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))


@pytest.mark.parametrize("full_ddp", [True, False])
def test_calc_derivs_matches_jax(full_ddp):
    jp, p, xs, us, mult, wl, wf = _inputs(seed=2)
    ref = jax.jit(jax.vmap(
        lambda xs_, us_, mle, mli, mfe, mfi, wl_, wf_: jd.calc_derivs(
            jp, xs_, us_, p, mle, mli, mfe, mfi, wl_, wf_, full_ddp)
    ))(xs, us, *mult, wl, wf)
    tp = tcar.car_parking()
    p_t = td.params_from_jax(p, torch.float64, "cpu")
    out = td.batched_calc_derivs(tp, _torch(xs), _torch(us), p_t,
                                 *map(_torch, mult), _torch(wl), _torch(wf),
                                 full_ddp)
    for name in ref.step._fields:
        np.testing.assert_allclose(getattr(out.step, name).numpy(),
                                   np.asarray(getattr(ref.step, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(out.final.cx.numpy(), np.asarray(ref.final.cx),
                               **TOL)
    np.testing.assert_allclose(out.final.cxx.numpy(),
                               np.asarray(ref.final.cxx), **TOL)
    np.testing.assert_array_equal(out.ok.numpy(), np.asarray(ref.ok))


@pytest.mark.parametrize("full_ddp", [True, False])
def test_shared_emitter_matches_jax_shared(full_ddp):
    """``derivs_emitter="shared"``: the port's single-trace emitter against
    JAX's (``shared_primal=True``), every bundle component to 1e-12."""
    jp, p, xs, us, mult, wl, wf = _inputs(seed=3)
    sd_j, fcx_j, fcxx_j, ok_j = jax.jit(
        lambda *a: batched_calc_derivs_cm(jp, *a, full_ddp=full_ddp,
                                          shared_primal=True)
    )(xs, us, p, *mult, wl, wf)
    tp = tcar.car_parking()
    p_t = td.params_from_jax(p, torch.float64, "cpu")
    sd_t, fcx_t, fcxx_t, _, ok_t = cm_emit(
        tp, _torch(xs), _torch(us), *map(_torch, mult), _torch(wl),
        _torch(wf), p_t, full_ddp, shared=True)
    assert set(sd_t) == set(sd_j)
    for key in sd_j:
        np.testing.assert_allclose(sd_t[key].numpy(), np.asarray(sd_j[key]),
                                   rtol=1e-12, atol=1e-12, err_msg=key)
    np.testing.assert_allclose(fcx_t.numpy(), np.asarray(fcx_j), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(fcxx_t.numpy(), np.asarray(fcxx_j),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))


def test_shared_emitter_solve_matches_per_family():
    """tests/test_batched.py:157-177 in the port: the two emitters are two
    schedules of the same bundle, so the kernel path's solves agree (equal
    status, cost to rtol 1e-9, us to atol 1e-7)."""
    p, x0, _ = tcar.default_setup(T=40)
    rng = np.random.default_rng(5)
    x0s = np.tile(x0, (8, 1)) + 0.05 * rng.standard_normal((8, 4))
    u0s = 0.1 * rng.standard_normal((8, 40, 2))
    sols = {}
    for emitter in ("per-family", "shared"):
        o = td.SolverOptions(max_iter=20, backpass_method="kernel",
                             linesearch_method="kernel",
                             derivs_emitter=emitter)
        sols[emitter] = td.make_batched_solver(
            tcar.car_parking(), o, device="cpu")(x0s, u0s, p)
    pf, sh = sols["per-family"], sols["shared"]
    np.testing.assert_array_equal(pf.status.numpy(), sh.status.numpy())
    np.testing.assert_allclose(pf.cost.numpy(), sh.cost.numpy(), rtol=1e-9)
    np.testing.assert_allclose(pf.us.numpy(), sh.us.numpy(), atol=1e-7)
