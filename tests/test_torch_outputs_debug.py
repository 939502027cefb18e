"""The port's user outputs (``outputs.py``), debug formatters and timers
(``utils/``), backward-pass trace (``debugging.py``) and one-instance
solver (``make_solver``) against the JAX package's, float64 on the CPU
(``tests/test_outputs_debug.py`` in the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_generator_tpu as jd
from ddp_generator_tpu.debugging import backpass_trace as j_backpass_trace
from ddp_generator_tpu.debugging import (
    format_backpass_step as j_format_backpass_step,
)
from ddp_generator_tpu.models import car_parking as jcar
from ddp_generator_tpu.utils import debug as jdebug
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.debugging import (
    backpass_trace,
    format_backpass_step,
)
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.solver import _boxqp_hyper
from ddp_generator_tpu_torch.utils.debug import (
    format_mat,
    format_vec,
    print_params,
)
from ddp_generator_tpu_torch.utils.timing import Timer, bench_fn, trace
from ddp_generator_tpu_torch.utils.tree import (
    tree_where,
    tree_zeros_like_shape,
)

T = 40


def j_car_outputs(x, u, p, k):
    # rolling distance s and a lateral slip proxy (optDefCar.mac:4)
    d, h = p["d"], p["h"]
    v, w = x[3], u[0]
    s = d + h * v * jnp.cos(w) - jnp.sqrt(d * d - (h * v * jnp.sin(w)) ** 2)
    return jnp.stack([s, h * v * jnp.sin(w)])


def t_car_outputs(x, u, p, k):
    # the same, component-first in torch (x (n_x, *batch))
    d, h = p["d"], p["h"]
    v, w = x[3], u[0]
    s = (d + h * v * torch.cos(w)
         - torch.sqrt(d * d - (h * v * torch.sin(w)) ** 2))
    return torch.stack([s, h * v * torch.sin(w)])


def test_get_g_size_and_calc_g_match_jax():
    p = jcar.default_params()
    assert td.get_g_size(t_car_outputs, 4, 2, p) == jd.get_g_size(
        j_car_outputs, 4, 2, p) == 2
    rng = np.random.default_rng(0)
    N = 10
    xs = rng.normal(size=(N + 1, 4))
    us = rng.normal(size=(N, 2)) * 0.1
    ref = np.asarray(jd.calc_g(j_car_outputs, jnp.asarray(xs),
                               jnp.asarray(us), p))
    g = td.calc_g(t_car_outputs, torch.as_tensor(xs), us, p)
    assert g.shape == (N, 2) and g.dtype == torch.float64
    np.testing.assert_allclose(g.numpy(), ref, rtol=1e-13, atol=1e-15)
    # a batch of trajectories: JAX vmaps its output fn over them
    xb, ub = rng.normal(size=(3, N + 1, 4)), 0.1 * rng.normal(size=(3, N, 2))
    ref_b = np.asarray(jax.vmap(jd.make_output_fn(j_car_outputs),
                                in_axes=(0, 0, None))(xb, ub, p))
    out_b = td.make_output_fn(t_car_outputs)(torch.as_tensor(xb), ub, p)
    np.testing.assert_allclose(out_b.numpy(), ref_b, rtol=1e-13, atol=1e-15)
    with pytest.raises(ValueError, match="1-D"):
        td.get_g_size(lambda x, u, p, k: torch.stack([x, x]), 4, 2, p)


def test_debug_formatters_match_jax(capsys):
    v = np.array([1.0, 2.5, -3e-7])
    m = np.arange(9.0).reshape(3, 3) / 7.0
    assert format_vec(torch.as_tensor(v), "v") == jdebug.format_vec(v, "v")
    assert format_vec(v) == jdebug.format_vec(v)
    for tri in (False, True):
        assert format_mat(torch.as_tensor(m), "M", tri=tri) == (
            jdebug.format_mat(m, "M", tri=tri))
    p = dict(jcar.default_params(), ymin=np.linspace(-1.0, -5.0, 11),
             nested={"b": 2.0, "a": np.ones(3)})
    for k in (0, 4, 20):
        txt = print_params(td.params_from_jax(
            {k_: v_ for k_, v_ in p.items() if k_ != "nested"},
            torch.float64, "cpu") | {"nested": p["nested"]}, k=k)
        assert txt == jdebug.print_params(p, k=k)
    assert "d= 2" in txt and "limW" in txt and "ymin[k]= -5" in txt


def test_timer_bench_and_trace():
    x = torch.ones(16)
    with Timer("t", sync=x) as t:
        y = x * 2.0
    assert t.seconds >= 0
    dt, out = bench_fn(lambda a: a * 2.0, x, repeats=2)
    assert dt >= 0
    torch.testing.assert_close(out, y)
    with trace() as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert any("mm" in e.key for e in prof.key_averages())


def test_tree_where_scalar_and_lane_masks():
    a = (torch.zeros(3, 2), torch.zeros(3))
    b = (torch.ones(3, 2), torch.ones(3))
    assert tree_where(torch.tensor(True), a, b)[0].sum() == 0
    lanes = tree_where(torch.tensor([True, False, True]), a, b)
    assert lanes[0][:, 0].tolist() == [0.0, 1.0, 0.0]
    assert lanes[1].tolist() == [0.0, 1.0, 0.0]
    z = tree_zeros_like_shape((torch.empty(2, 3, device="meta"),
                               torch.empty((), dtype=torch.int32,
                                           device="meta")))
    assert z[0].shape == (2, 3) and not z[0].any() and z[1].dtype == (
        torch.int32)


@pytest.fixture(scope="module")
def car_solve():
    """One CarParking instance (T=40) solved by the JAX package's
    ``make_solver`` (serial, float64, max_iter 5)."""
    p, x0, _ = jcar.default_setup(T=T)
    u0 = 0.1 * np.random.default_rng(1).standard_normal((T, 2))
    sol = jd.make_solver(jcar.car_parking(), jd.SolverOptions(max_iter=5))(
        jnp.asarray(x0), jnp.asarray(u0), p)
    return p, x0, u0, jax.tree_util.tree_map(np.asarray, sol)


def test_make_solver_matches_jax(car_solve):
    p, x0, u0, ref = car_solve
    out = td.to_numpy(td.make_solver(tcar.car_parking(),
                                     td.SolverOptions(max_iter=5),
                                     device="cpu")(x0, u0, p))
    for f in ("status", "iterations", "body_calls", "stale_calls",
              "success"):
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f),
                                      err_msg=f)
    np.testing.assert_allclose(out.cost, ref.cost, rtol=1e-10)
    np.testing.assert_allclose(out.us, ref.us, rtol=0, atol=1e-9)
    with pytest.raises(TypeError):
        td.make_solver(tcar.car_parking(), td.SolverOptions())  # no device


def test_backpass_trace_matches_jax_and_back_pass(car_solve):
    """Every field of the trace equals JAX's to 1e-10, its l/L equal the
    port's serial ``back_pass`` on that lane exactly, and the formatted
    step equals JAX's string."""
    p, _, _, sol = car_solve
    lam = 0.1
    ref = j_backpass_trace(jcar.car_parking(), jd.SolverOptions(max_iter=5),
                           sol.xs, sol.us, lam, p)
    opts = td.SolverOptions(max_iter=5)
    tr = backpass_trace(tcar.car_parking(), opts, sol.xs, sol.us, lam, p,
                        device="cpu")
    for f in ref._fields:
        a, b = getattr(tr, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10, err_msg=f)
    assert (tr.res >= 1).all()
    P = td.params_from_jax(p, torch.float64, "cpu")
    m = td.init_multipliers(tcar.car_parking(), 1, T, torch.float64, "cpu")
    one = torch.ones(1, dtype=torch.float64)
    xs, us = (torch.as_tensor(np.array(a))[None] for a in (sol.xs, sol.us))
    d = td.batched_calc_derivs(tcar.car_parking(), xs, us, P, m.mu_le,
                               m.mu_li, m.mu_fe, m.mu_fi, one, one,
                               opts.full_ddp)
    bp = td.back_pass(d, us, torch.full((1,), lam, dtype=torch.float64),
                      opts.regType, opts.full_ddp, _boxqp_hyper(opts))
    assert torch.equal(tr.l, bp.l[0]) and torch.equal(tr.L, bp.L[0])
    torch.testing.assert_close(tr.dV.sum(0), bp.dV[0], rtol=1e-12,
                               atol=1e-14)
    s = format_backpass_step(tr, 3)
    assert s == j_format_backpass_step(ref, 3)
    for key in ("Qu", "Quu", "QuuF", "boxQP res", "l=", "L="):
        assert key in s
