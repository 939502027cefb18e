"""Per-lane problem parameters (``batch_params=True``) in the port, float64
on the CPU, against the JAX package.

Every params leaf carries a leading lane axis, as in the JAX package.  The
port follows the JAX package's fallbacks: the kernel path keeps emission +
B1 (its plain version here), the fused path takes the serial derivatives
and backward pass, the kernel line search the serial one.  Held here, per
lane: status, iterations, body, stale and retry calls exactly, cost,
``xs`` and ``us`` to 1e-10, for

* ``tests/test_batched.py:215-230``: ``limW`` varied per lane, each lane
  within its own limit, on the serial, kernel and fused paths;
* ``tests/test_batched.py:285-305``: ``StepwiseSolver`` with compaction,
  bit-identical to no compaction;
* ``tests/test_pallas_fused.py:105-121``: fused falls back to serial,
  bit-identical;
* ``tests/test_pallas_rollout.py:228-248``: the kernel line search falls
  back to serial, bit-identical;
* ``brachistochrone_hli`` with a different ``ymin`` floor per lane (a
  ``[k]``-indexed param) on the kernel path against JAX's
  ``"pallas"``/``"pallas"``;
* each lane equal to its solve alone with its own shared params, and the
  serial line search reading lane ``b``'s params for every alpha.
"""

import jax
import numpy as np
import pytest
import torch

import ddp_generator_tpu as jd
from ddp_generator_tpu.models import brachistochrone as jbr
from ddp_generator_tpu.models import car_parking as jcar
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import brachistochrone as tbr
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.ops.linesearch import line_search
from ddp_generator_tpu_torch.problem import LaneParams, lanes_last, step_index

T, B, MAX_ITER = 40, 8, 30
TOL = 1e-10
COUNTS = ("status", "iterations", "body_calls", "stale_calls",
          "bp_retry_calls")
# the port's methods for each path; the JAX package's counterpart
PATHS = {"serial": ("serial", "serial"), "kernel": ("kernel", "kernel"),
         "fused": ("fused", "kernel")}
JAX_PATH = {"serial": ("serial", "serial"), "kernel": ("pallas", "pallas"),
            "fused": ("fused", "pallas")}


def _per_lane(p, n):
    return {k: np.tile(np.asarray(v, np.float64), (n,) + (1,) * np.ndim(v))
            for k, v in p.items()}


def _car_inputs():
    p, x0, _ = jcar.default_setup(T=T)
    x0s = np.tile(x0, (B, 1))
    u0s = 0.1 * np.random.default_rng(0).standard_normal((B, T, 2))
    pb = _per_lane(p, B)
    lim = np.linspace(0.5, 0.2, B)
    pb["limW"] = np.stack([-lim, lim], axis=1)
    return pb, x0s, u0s, lim


def _jax_solve(problem, x0s, u0s, pb, path, **kw):
    bp, ls = JAX_PATH[path]
    opts = jd.SolverOptions(debug_level=0, backpass_method=bp,
                            linesearch_method=ls, **kw)
    return jax.tree_util.tree_map(np.asarray, jd.make_batched_solver(
        problem, opts, batch_params=True)(x0s, u0s, pb))


def _port_opts(path, **kw):
    bp, ls = PATHS[path]
    return td.SolverOptions(debug_level=0, backpass_method=bp,
                            linesearch_method=ls, **kw)


def _stepwise(problem, x0s, u0s, pb, path, compact_levels=4, **kw):
    return td.to_numpy(td.StepwiseSolver(
        problem, _port_opts(path, **kw), chunk=3, batch_params=True,
        compact_levels=compact_levels, min_compact_batch=2,
        device="cpu")(x0s, u0s, pb))


def _assert_lanes_match(out, ref):
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f),
                                      err_msg=f)
    np.testing.assert_allclose(out.cost, ref.cost, rtol=TOL)
    for f in ("xs", "us"):
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f), rtol=0,
                                   atol=TOL, err_msg=f)


def _assert_identical(a, b):
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


@pytest.fixture(scope="module")
def car_ref():
    """JAX's per-lane solves: serial (which its fused path equals,
    ``tests/test_pallas_fused.py:105-121``) and ``"pallas"``/``"pallas"``."""
    pb, x0s, u0s, _ = _car_inputs()
    return {path: _jax_solve(jcar.car_parking(), x0s, u0s, pb, path,
                             max_iter=MAX_ITER)
            for path in ("serial", "kernel")}


@pytest.fixture(scope="module")
def car_port():
    pb, x0s, u0s, _ = _car_inputs()
    return {path: _stepwise(tcar.car_parking(), x0s, u0s, pb, path,
                            max_iter=MAX_ITER)
            for path in PATHS}


@pytest.mark.parametrize("path", list(PATHS))
def test_per_lane_limw_matches_jax(car_ref, car_port, path):
    out = car_port[path]
    _assert_lanes_match(out, car_ref["kernel" if path == "kernel"
                                     else "serial"])
    assert np.isin(out.status, (1, 2)).all()
    lim = _car_inputs()[3]
    w_max = np.abs(out.us[..., 0]).max(axis=1)
    assert (w_max <= lim + 1e-12).all()
    # the tightest limits bind: the lanes really differ by their params
    assert (w_max[-2:] > lim[-2:] - 1e-9).all()
    assert (np.abs(out.us[..., 1]) <= 2.0 + 1e-12).all()


@pytest.mark.parametrize("path", ["serial", "kernel"])
def test_compaction_with_per_lane_params_bit_identical(car_port, path):
    pb, x0s, u0s, _ = _car_inputs()
    plain = _stepwise(tcar.car_parking(), x0s, u0s, pb, path,
                      compact_levels=0, max_iter=MAX_ITER)
    _assert_identical(car_port[path], plain)
    assert len(set(car_port[path].iterations)) > 1  # compaction had work


def test_fused_falls_back_to_serial(car_port):
    """With per-lane params B3 is bypassed: the serial derivatives and
    backward pass, as ``jax:solver.py:366-371``."""
    _assert_identical(car_port["fused"], car_port["serial"])


def test_kernel_line_search_falls_back_to_serial(car_port):
    """Serial backward pass + kernel line search equals serial + serial
    exactly (``jax:solver.py:458-462``); the wrappers launch nothing."""
    pb, x0s, u0s, _ = _car_inputs()
    opts = td.SolverOptions(debug_level=0, max_iter=MAX_ITER,
                            linesearch_method="kernel")
    out = td.to_numpy(td.make_batched_solver(
        tcar.car_parking(), opts, batch_params=True, device="cpu")(
            x0s, u0s, pb))
    _assert_identical(out, car_port["serial"])


@pytest.mark.parametrize("path", list(PATHS))
def test_each_lane_equals_its_solve_alone(car_port, path):
    """Lane b of the per-lane solve against lane b solved alone with lane
    b's params, shared, through the methods the per-lane path runs."""
    pb, x0s, u0s, _ = _car_inputs()
    alone = {"serial": "serial", "kernel": "kernel", "fused": "serial"}
    opts = td.SolverOptions(debug_level=0, max_iter=MAX_ITER,
                            backpass_method=alone[path],
                            linesearch_method="serial")
    for b in (0, B - 1):
        one = td.to_numpy(td.make_batched_solver(
            tcar.car_parking(), opts, device="cpu")(
                x0s[b:b + 1], u0s[b:b + 1], {k: v[b] for k, v in pb.items()}))
        for f in one._fields:
            np.testing.assert_array_equal(getattr(one, f)[0],
                                          getattr(car_port[path], f)[b],
                                          err_msg=f"{f} lane {b}")


def test_brachistochrone_hli_per_lane_floor_matches_jax():
    """``ymin[k]`` per lane on the ``(N, B)`` plane (emission, multiplier
    updates, re-costs) and in the rollouts: kernel path against JAX's
    ``"pallas"``/``"pallas"`` with ``batch_params=True``."""
    n, nb = 20, 3
    p, x0, _ = jbr.default_setup_hli(n)
    rng = np.random.default_rng(2)
    x0s = np.tile(x0, (nb, 1))
    u0s = -np.abs(rng.uniform(0.5, 1.5, (nb, n, 1)))
    pb = _per_lane(p, nb)
    pb["ymin"] = pb["ymin"] + np.array([0.0, -0.3, 0.5])[:, None]
    kw = dict(max_iter=25, w_pen_init_l=40.0, w_pen_init_f=1e-5,
              w_pen_max_f=1.0, full_ddp=False)
    ref = _jax_solve(jbr.brachistochrone_hli(), x0s, u0s, pb, "kernel", **kw)
    out = _stepwise(tbr.brachistochrone_hli(), x0s, u0s, pb, "kernel", **kw)
    _assert_lanes_match(out, ref)
    assert np.isin(out.status, (1, 2)).all()
    # each lane meets its own terminal floor ymin[N]
    np.testing.assert_allclose(out.xs[:, -1, 0], pb["ymin"][:, -1],
                               atol=1e-3)


def test_step_index_layouts():
    N, nb = 5, 3
    ymin = torch.arange(N + 1, dtype=torch.float64)
    k = step_index({}, N, "cpu")
    assert ymin[k].shape == (N, 1)
    lanes = lanes_last({"ymin": ymin[None].repeat(nb, 1) + torch.arange(
        nb)[:, None], "g": torch.ones(nb)}, nb)
    assert isinstance(lanes, LaneParams)
    assert lanes["ymin"].shape == (N + 1, nb) and lanes["g"].shape == (nb,)
    kl = step_index(lanes, N, "cpu")
    got = lanes["ymin"][kl]
    assert type(got) is torch.Tensor and got.shape == (N, nb)
    np.testing.assert_array_equal(got.numpy(), np.arange(N)[:, None]
                                  + np.arange(nb)[None, :])
    # arithmetic sees (N, 1), as in the shared layout
    assert (kl * 0.5).shape == (N, 1) and type(kl * 0.5) is torch.Tensor
    with pytest.raises(ValueError, match="lane axis"):
        lanes_last({"g": torch.ones(nb + 1)}, nb)


def test_line_search_reads_each_lanes_params_for_every_alpha():
    """The alpha-major replication (lane a*B + b) must carry lane b's
    params: per-lane line search against each lane's alone."""
    nb, N = 3, 12
    prob = tcar.car_parking()
    p, x0, _ = tcar.default_setup(T=N)
    rng = np.random.default_rng(5)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    pb = td.to_torch(_per_lane(p, nb), torch.float64, "cpu")
    pb["limW"] = t([[-0.5, 0.5], [-0.05, 0.05], [-0.2, 0.2]])
    pb["cu"] = pb["cu"] * t([1.0, 30.0, 3.0])[:, None]
    lanes = lanes_last(pb, nb)
    x0s = t(np.tile(x0, (nb, 1)))
    xs = t(rng.standard_normal((nb, N + 1, 4)))
    xs[:, 0] = x0s
    us = t(0.1 * rng.standard_normal((nb, N, 2)))
    l = t(0.3 * rng.standard_normal((nb, N, 2)))
    L = t(0.01 * rng.standard_normal((nb, N, 2, 4)))
    dV = t(np.tile([-1.0, 0.5], (nb, 1)))
    cost = t(np.full(nb, 5.0))
    z = lambda *s: torch.zeros((nb,) + s, dtype=torch.float64)
    alphas = tuple(td.SolverOptions().alpha)
    args = lambda sl, par: (prob, alphas, x0s[sl], xs[sl], us[sl], l[sl],
                            L[sl], dV[sl], cost[sl], 0.0, par, z(N, 0)[sl],
                            z(N, 0)[sl], z(0)[sl], z(0)[sl],
                            torch.ones(nb)[sl], torch.ones(nb)[sl])
    out = line_search(*args(slice(None), lanes))
    for b in range(nb):
        one = line_search(*args(slice(b, b + 1),
                                {k: v[b] for k, v in pb.items()}))
        for f in out._fields:
            np.testing.assert_array_equal(getattr(out, f)[b].numpy(),
                                          getattr(one, f)[0].numpy(),
                                          err_msg=f"{f} lane {b}")
    # the limits differ per lane, and every alpha's rollout kept them
    assert (out.us[1, :, 0].abs() <= 0.05 + 1e-15).all()
    assert (out.us[0, :, 0].abs() > 0.05).any()
