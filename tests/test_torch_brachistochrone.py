"""The Brachistochrone models of the PyTorch port against the JAX package,
float64 on the CPU.

* ``f``, ``L``, ``F``, ``hli`` and ``hfe`` of ``brachistochrone()`` and
  ``brachistochrone_hli()`` at random points, the ``[k]``-indexed ``ymin``
  included, to 1e-12;
* the flat parameter order of the CUDA models, and a ``ymin`` of the wrong
  length refused;
* ``StepwiseSolver`` solves through ``backpass_method="kernel"`` (their
  plain versions on the CPU) per lane against JAX's serial batched solver:
  equal status, iterations, body, stale and retry calls, cost to 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_generator_tpu as jd
from ddp_generator_tpu.models import brachistochrone as jbr
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import brachistochrone as tbr

TOL = dict(rtol=1e-12, atol=1e-12)
COUNTS = ("status", "iterations", "body_calls", "stale_calls",
          "bp_retry_calls")


def _models(hli: bool):
    if hli:
        return (jbr.brachistochrone_hli(), tbr.brachistochrone_hli(),
                jbr.default_setup_hli, tbr.default_setup_hli)
    return (jbr.brachistochrone(), tbr.brachistochrone(), jbr.default_setup,
            tbr.default_setup)


@pytest.mark.parametrize("hli", [False, True], ids=["plain", "hli"])
def test_functions_match_jax(hli):
    jp, tp, jsetup, _ = _models(hli)
    n = 20
    p, _, _ = jsetup(n)
    rng = np.random.default_rng(3)
    ys = -rng.uniform(0.1, 4.0, (n, 1))
    dys = -rng.uniform(0.2, 2.0, (n, 1))
    ks = np.arange(n)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    pt = td.params_from_jax(p, torch.float64, "cpu")
    xt, ut = torch.as_tensor(ys.T), torch.as_tensor(dys.T)  # (1, n)
    kt = torch.as_tensor(ks)
    vm = lambda fn: jax.vmap(fn)(jnp.asarray(ys), jnp.asarray(dys),
                                 jnp.asarray(ks))
    np.testing.assert_allclose(
        tp.f(xt, ut, pt, kt).numpy().T,
        np.asarray(vm(lambda x, u, k: jp.f(x, u, pj, k))), **TOL)
    np.testing.assert_allclose(
        tp.L(xt, ut, pt, kt).numpy(),
        np.asarray(vm(lambda x, u, k: jp.L(x, u, pj, k))), **TOL)
    np.testing.assert_allclose(
        tp.F(xt, pt, n).numpy(),
        np.asarray(vm(lambda x, u, k: jp.F(x, pj, n) + 0.0 * x[0])), **TOL)
    if hli:
        # the moving floor ymin[k] at each point's own step k
        np.testing.assert_allclose(
            tp.hli[0](xt, ut, pt, kt).numpy(),
            np.asarray(vm(lambda x, u, k: jp.hli[0](x, u, pj, k))), **TOL)
    np.testing.assert_allclose(
        tp.hfe[0](xt, pt, n).numpy(),
        np.asarray(vm(lambda x, u, k: jp.hfe[0](x, pj, n))), **TOL)
    assert (tp.n_hli, tp.n_hfe) == (jp.n_hli, jp.n_hfe)


def test_setups_and_cycloid_identical_to_jax():
    for hli in (False, True):
        *_, jsetup, tsetup = _models(hli)
        for n in (7, 50):
            pj, x0j, u0j = jsetup(n)
            pt, x0t, u0t = tsetup(n)
            np.testing.assert_array_equal(x0j, x0t)
            np.testing.assert_array_equal(u0j, u0t)
            assert pj.keys() == pt.keys()
            for k in pj:
                np.testing.assert_array_equal(pj[k], pt[k])
    for a, b in zip(jbr.cycloid(33), tbr.cycloid(33)):
        np.testing.assert_array_equal(a, b)


def test_cuda_param_order_and_ymin_length():
    n = 9
    p, _, _ = tbr.default_setup(n)
    flat = tbr.brachistochrone().cuda_model.flat_params(
        td.params_from_jax(p, torch.float64, "cpu"), torch.float64, "cpu", n)
    np.testing.assert_array_equal(flat.numpy(), [p["g"], p["yf"], p["dx"]])
    model = tbr.brachistochrone_hli().cuda_model
    assert model.n_params == 2  # g, dx before the per-step tail
    p, _, _ = tbr.default_setup_hli(n)
    pt = td.params_from_jax(p, torch.float64, "cpu")
    flat = model.flat_params(pt, torch.float64, "cpu", n)
    np.testing.assert_array_equal(
        flat.numpy(), np.concatenate([[p["g"], p["dx"]], p["ymin"]]))
    with pytest.raises(td.ProblemValidationError, match="ymin"):
        model.flat_params(pt, torch.float64, "cpu", n + 1)
    with pytest.raises(ValueError, match="pass N"):
        model.flat_params(pt, torch.float64, "cpu")
    with pytest.raises(td.ProblemValidationError, match="last"):
        td.CudaModel("bad", (("ymin", td.PER_STEP), ("g", 1)))


# tests/test_solver_brachi.py: OPTS (terminal equality) and the moving-floor
# options of test_brachistochrone_hli_moving_floor
SOLVES = {
    "plain": dict(max_iter=50, w_pen_init_f=40.0, w_pen_fact2=2.0,
                  full_ddp=False),
    "hli": dict(max_iter=40, w_pen_init_l=40.0, w_pen_init_f=1e-5,
                w_pen_max_f=1.0, w_pen_fact2=1.0, full_ddp=False),
}


@pytest.mark.parametrize("hli", [False, True], ids=["plain", "hli"])
def test_kernel_solve_matches_jax_serial_per_lane(hli):
    jp, tp, jsetup, _ = _models(hli)
    B, n = 4, 30
    p, x0, _ = jsetup(n)
    rng = np.random.default_rng(2)
    x0s = np.tile(x0, (B, 1))
    u0s = -np.abs(rng.uniform(0.5, 1.5, (B, n, 1)))
    kw = SOLVES["hli" if hli else "plain"]
    ref = jax.tree_util.tree_map(np.asarray, jd.make_batched_solver(
        jp, jd.SolverOptions(debug_level=0, **kw))(x0s, u0s, p))
    out = td.to_numpy(td.StepwiseSolver(
        tp, td.SolverOptions(debug_level=0, backpass_method="kernel",
                             linesearch_method="kernel", **kw),
        min_compact_batch=2, device="cpu")(x0s, u0s, p))
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f),
                                      err_msg=f)
    assert np.isin(out.status, (1, 2)).all()
    np.testing.assert_allclose(out.cost, ref.cost, rtol=1e-8)
    np.testing.assert_allclose(out.xs, ref.xs, rtol=0, atol=1e-7)
