"""Problem helpers of the PyTorch port (clamp_u, limits_u, the CarParking
functions) against the JAX package, float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_generator_tpu as jd
from ddp_generator_tpu.models import car_parking as jcar
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import car_parking as tcar

TOL = dict(rtol=1e-12, atol=1e-12)


def _points(seed, n=16):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n, 4))
    xs[:, 3] *= 3.0
    us = 1.5 * rng.standard_normal((n, 2))  # many beyond limW / limA
    return xs, us


@pytest.fixture(scope="module")
def problems():
    p_np = jcar.default_params()
    return (jcar.car_parking(), tcar.car_parking(), p_np,
            td.params_from_jax(p_np, torch.float64, "cpu"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clamp_u_matches_jax(problems, seed):
    jp, tp, p_np, p_t = problems
    xs, us = _points(seed)
    ref = np.asarray(jax.vmap(
        lambda x, u: jd.clamp_u(jp, x, u, p_np, 0))(jnp.asarray(xs),
                                                    jnp.asarray(us)))
    # component-first batch: (n_x, n) / (n_u, n)
    out = td.clamp_u(tp, torch.as_tensor(xs.T), torch.as_tensor(us.T), p_t, 0)
    np.testing.assert_allclose(out.numpy().T, ref, **TOL)
    # and point by point
    for i in range(3):
        one = td.clamp_u(tp, torch.as_tensor(xs[i]), torch.as_tensor(us[i]),
                         p_t, 0)
        np.testing.assert_allclose(one.numpy(), ref[i], **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_limits_u_matches_jax(problems, seed):
    jp, tp, p_np, p_t = problems
    xs, us = _points(seed)
    ref = jax.vmap(lambda x, u: jd.limits_u(jp, x, u, p_np, 0))(
        jnp.asarray(xs), jnp.asarray(us))
    out = td.limits_u(tp, torch.as_tensor(xs.T), torch.as_tensor(us.T), p_t, 0)
    for r, o in zip(ref, out):
        o = o.numpy()
        o = np.moveaxis(o, -1, 0)  # batch last -> batch first
        np.testing.assert_allclose(o, np.asarray(r), **TOL)


def test_unconstrained_limits_are_infinite():
    def f(x, u, p, k):
        return torch.stack([x[0] + u[0]])

    prob = td.make_problem(1, 1, f, lambda x, u, p, k: u[0] * u[0],
                           lambda x, p, k: x[0] * x[0])
    lo, up, lo_hx, up_hx, lo_s, up_s = td.limits_u(
        prob, torch.zeros(1, 3, dtype=torch.float64),
        torch.zeros(1, 3, dtype=torch.float64), {}, 0)
    assert torch.isinf(lo).all() and (lo < 0).all()
    assert torch.isinf(up).all() and (up > 0).all()
    assert (lo_hx == 0).all() and (lo_s == 0).all() and (up_s == 0).all()


@pytest.mark.parametrize("fn", ["f", "L", "F"])
def test_car_parking_functions_match_jax(problems, fn):
    jp, tp, p_np, p_t = problems
    xs, us = _points(5)
    xs[:, 3] = np.clip(xs[:, 3], -20, 20)
    if fn == "F":
        ref = np.asarray(jax.vmap(lambda x: jp.F(x, p_np, 0))(jnp.asarray(xs)))
        out = tp.F(torch.as_tensor(xs.T), p_t, 0).numpy()
    else:
        g = getattr(jp, fn)
        ref = np.asarray(jax.vmap(lambda x, u: g(x, u, p_np, 0))(
            jnp.asarray(xs), jnp.asarray(us)))
        out = getattr(tp, fn)(torch.as_tensor(xs.T), torch.as_tensor(us.T),
                              p_t, 0).numpy()
        if fn == "f":
            out = out.T
    np.testing.assert_allclose(out, ref, **TOL)


def test_make_problem_validation():
    f = tcar.f
    # h without box_meta is probed; without example_params it cannot be
    with pytest.raises(td.ProblemValidationError, match="box_meta"):
        td.make_problem(4, 2, f, tcar.L, tcar.F, h=[tcar.h1])
    with pytest.raises(td.ProblemValidationError):
        td.make_problem(4, 2, f, tcar.L, tcar.F, h=[tcar.h1],
                        box_meta=[(0, 2.0)])
    with pytest.raises(td.ProblemValidationError):
        td.make_problem(4, 2, f, tcar.L, tcar.F, h=[tcar.h1],
                        box_meta=[(0, 1.0), (1, 1.0)])
    with pytest.raises(td.ProblemValidationError, match="states"):
        td.make_problem(4, 2, lambda x, u, p, k: x[:2], tcar.L, tcar.F,
                        example_params=tcar.default_params())


def test_cuda_model_flat_params_order():
    prob = tcar.car_parking()
    p = td.params_from_jax(tcar.default_params(), torch.float64, "cpu")
    flat = prob.cuda_model.flat_params(p, torch.float64, "cpu")
    assert flat.shape == (prob.cuda_model.n_params,) == (20,)
    expect = np.concatenate([np.atleast_1d(tcar.default_params()[k])
                             for k, _ in tcar.CUDA_MODEL.param_order])
    np.testing.assert_array_equal(flat.numpy(), expect)


def test_default_setup_identical_to_jax():
    for T, seed in ((20, 0), (7, 3)):
        pj, x0j, u0j = jcar.default_setup(T, seed)
        pt, x0t, u0t = tcar.default_setup(T, seed)
        np.testing.assert_array_equal(x0j, x0t)
        np.testing.assert_array_equal(u0j, u0t)
        assert pj.keys() == pt.keys()
        for k in pj:
            np.testing.assert_array_equal(pj[k], pt[k])
