"""Derivative emission by forward-over-reverse (``ops/cm_derivs.py``):
both emitters against the JAX package's ``batched_calc_derivs_cm`` on
CarParking (FULL_DDP) and ``brachistochrone_hli`` (an ``hli`` and an
``hfe`` family live), float64, and the same bundle bit for bit whatever
the process emitted before it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_generator_tpu.models import brachistochrone as jbrachi
from ddp_generator_tpu.models import car_parking as jcar
from ddp_generator_tpu.ops.cm_derivs import batched_calc_derivs_cm
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import brachistochrone as tbrachi
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.ops.cm_derivs import cm_emit

B = 6
# the tolerances of test_torch_cm_derivs.py for each emitter
TOL = {False: dict(rtol=1e-10, atol=1e-12), True: dict(rtol=1e-12,
                                                       atol=1e-12)}


def _rollout(jp, p, x0s, us):
    N = us.shape[1]
    xs = np.zeros((B, N + 1, x0s.shape[1]))
    xs[:, 0] = x0s
    for k in range(N):
        xs[:, k + 1] = np.asarray(jax.vmap(
            lambda x, u: jp.f(x, u, p, k))(jnp.asarray(xs[:, k]),
                                            jnp.asarray(us[:, k])))
    return xs


def _case(name):
    """``(jax problem, port problem, params, inputs)`` at a generic point,
    every multiplier and penalty weight nonzero."""
    rng = np.random.default_rng(11)
    if name == "car_parking":
        N = 12
        jp, tp = jcar.car_parking(), tcar.car_parking()
        p, x0, _ = jcar.default_setup(T=N, seed=0)
        x0s = np.tile(x0, (B, 1)) + 0.01 * rng.standard_normal((B, 4))
        x0s[:, 3] += rng.uniform(0.5, 2.0, B)
        us = 0.3 * rng.standard_normal((B, N, 2))
        mult = (np.zeros((B, N, 0)), np.zeros((B, N, 0)), np.zeros((B, 0)),
                np.zeros((B, 0)))
    else:
        N = 15
        jp, tp = jbrachi.brachistochrone_hli(), tbrachi.brachistochrone_hli()
        p, x0, _ = jbrachi.default_setup_hli(N)
        x0s = np.tile(x0, (B, 1))
        us = -np.abs(rng.uniform(0.5, 1.5, (B, N, 1)))
        mult = (np.zeros((B, N, 0)), rng.uniform(0.1, 1.0, (B, N, 1)),
                rng.uniform(-1.0, 1.0, (B, 1)), np.zeros((B, 0)))
    xs = _rollout(jp, p, x0s, us)
    wl = 1.0 + rng.uniform(size=B)
    wf = 1.0 + rng.uniform(size=B)
    return jp, tp, p, (xs, us, mult, wl, wf)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _emit(tp, p, inputs, shared):
    xs, us, mult, wl, wf = inputs
    sd, fcx, fcxx, _, ok = cm_emit(
        tp, _t(xs), _t(us), *map(_t, mult), _t(wl), _t(wf),
        td.params_from_jax(p, torch.float64, "cpu"), True, shared)
    return dict(sd, final_cx=fcx, final_cxx=fcxx, ok=ok)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("name", ["car_parking", "brachistochrone_hli"])
def test_emission_matches_jax(name, shared):
    jp, tp, p, inputs = _case(name)
    xs, us, mult, wl, wf = inputs
    sd_j, fcx_j, fcxx_j, ok_j = jax.jit(
        lambda *a: batched_calc_derivs_cm(jp, *a, full_ddp=True,
                                          shared_primal=shared)
    )(xs, us, p, *mult, wl, wf)
    got = _emit(tp, p, inputs, shared)
    ref = dict(sd_j, final_cx=fcx_j, final_cxx=fcxx_j, ok=ok_j)
    assert set(got) == set(ref)
    for key, want in ref.items():
        want = np.asarray(want)
        out = got[key].numpy()
        assert out.shape == want.shape, key
        if key == "ok":
            np.testing.assert_array_equal(out, want)
        else:
            np.testing.assert_allclose(out, want, err_msg=key,
                                       **TOL[shared])
    # the second order is live: FULL_DDP terms of the dynamics (CarParking)
    # and the AL curvature (brachistochrone_hli)
    live = "fxx" if name == "car_parking" else "cxx"
    assert np.abs(got[live].numpy()).max() > 1e-3


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("target", ["car_parking", "brachistochrone_hli"])
def test_emission_independent_of_history(target, shared):
    """Emit, emit the other problem, emit again: every component equal bit
    for bit, with each emitter."""
    other = ("brachistochrone_hli" if target == "car_parking"
             else "car_parking")
    _, tp, p, inputs = _case(target)
    _, tp_o, p_o, inputs_o = _case(other)
    first = _emit(tp, p, inputs, shared)
    _emit(tp_o, p_o, inputs_o, shared)
    _emit(tp_o, p_o, inputs_o, not shared)
    again = _emit(tp, p, inputs, shared)
    for key, v in first.items():
        assert torch.equal(v, again[key]), key


def test_emitters_agree():
    """The two emitters are two schedules of one forward-over-reverse
    bundle: equal to rounding."""
    _, tp, p, inputs = _case("car_parking")
    a, b = _emit(tp, p, inputs, False), _emit(tp, p, inputs, True)
    for key, v in a.items():
        if v.dtype == torch.bool:
            assert torch.equal(v, b[key])
        else:
            np.testing.assert_allclose(v.numpy(), b[key].numpy(),
                                       rtol=1e-12, atol=1e-12, err_msg=key)
