"""Kernel B2's plain version and the line-search orchestration of the
PyTorch port against the JAX package, float64.

* ``rollout_plain`` (what ``rollout_call`` runs on CPU tensors) against the
  Pallas ``rollout_call(interpret=True)`` in both modes, to 1e-6: the Pallas
  kernel substitutes a polynomial ``asin`` (``pallas_math.py:27-46``, error
  up to ~2e-8);
* the staged and unstaged line searches against JAX's serial
  ``ops/linesearch.py:line_search`` under ``vmap``, to 1e-10;
* the initial open-loop rollout and ``cost_only`` against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_generator_tpu.models import car_parking as jcar
from ddp_generator_tpu.ops import forward as jfwd
from ddp_generator_tpu.ops.linesearch import line_search
from ddp_generator_tpu.ops.pallas_rollout import rollout_call as j_rollout
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.launches import read_launches
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.ops import cuda_rollout as cr
from ddp_generator_tpu_torch.ops import forward as tfwd

B, N = 6, 10
ALPHAS = td.DEFAULT_ALPHA


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def case():
    """A nominal CarParking trajectory with gains of a plausible size; lane
    5 drives so fast that large alphas steer it into the sqrt's NaN region
    (|h*v*sin(w)| > d) while small ones stay finite."""
    jp = jcar.car_parking()
    p, x0, _ = jcar.default_setup(T=N, seed=0)
    rng = np.random.default_rng(2)
    x0s = np.tile(x0, (B, 1)) + 0.05 * rng.standard_normal((B, 4))
    us = 0.2 * rng.standard_normal((B, N, 2))
    x0s[5, 3] = 222.0
    us[5, :, 0] = np.clip(us[5, :, 0], -0.1, 0.1)
    z = lambda *s: np.zeros(s)
    mult = (z(B, N, 0), z(B, N, 0), z(B, 0), z(B, 0))
    wl, wf = np.ones(B), np.ones(B)
    roll = jax.vmap(lambda x0_, us_: jfwd.forward_pass(
        jp, x0_, jnp.zeros((N + 1, 4)), us_, jnp.zeros((N, 2)),
        jnp.zeros((N, 2, 4)), 0.0, p, *(m[0] for m in mult), 1.0, 1.0))
    r = roll(x0s, us)
    xs = np.asarray(r.xs)
    l = 0.3 * rng.standard_normal((B, N, 2))
    L = 0.2 * rng.standard_normal((B, N, 2, 4))
    l[5, :, 0] = 3.0  # steer to the limit |w| = 0.5 at large alpha
    dV = np.stack([-np.abs(rng.standard_normal(B)),
                   0.1 * rng.standard_normal(B)], 1)
    return dict(jp=jp, tp=tcar.car_parking(), p=p,
                p_t=td.params_from_jax(p, torch.float64, "cpu"), x0s=x0s,
                xs=xs, us=np.asarray(r.us), cost=np.asarray(r.cost), l=l,
                L=L, dV=dV, mult=mult, wl=wl, wf=wf, rng=rng)


def _cm_operands(c):
    to_cm = lambda a: np.ascontiguousarray(
        np.transpose(a.reshape(B, N, -1), (1, 2, 0)))
    return (to_cm(c["xs"][:, :N]), to_cm(c["us"]), to_cm(c["l"]),
            to_cm(c["L"]), np.zeros((N, 0, B)), np.zeros((N, 0, B)),
            np.ascontiguousarray(c["x0s"].T), c["wl"][None], c["wf"][None],
            np.zeros((0, B)), np.zeros((0, B)))


@pytest.mark.parametrize("multi", [True, False])
def test_rollout_plain_matches_pallas_interpret(case, multi):
    ops = _cm_operands(case)
    alpha_vec = np.asarray(case["rng"].choice(ALPHAS, B))[None]
    alpha_vec[0, 5] = 1.0
    j_ops = [jnp.asarray(a) for a in ops]
    j_ops[4] = j_ops[5] = j_ops[9] = j_ops[10] = None  # no AL families
    ref = j_rollout(case["jp"], ALPHAS, *j_ops,
                    None if multi else jnp.asarray(alpha_vec), case["p"],
                    multi=multi, interpret=True, want_cost=not multi)
    before = read_launches()
    out = cr.rollout_call(case["tp"], ALPHAS, *map(_t, ops),
                          None if multi else _t(alpha_vec), case["p_t"],
                          multi=multi, want_cost=not multi)
    assert read_launches() == before  # plain path: no launch
    ref = [np.asarray(a) for a in ref]
    out = [a.numpy() for a in out]
    ok_ref, ok_out = ref[-1] > 0.5, out[-1]
    assert ok_out.dtype == bool
    np.testing.assert_array_equal(ok_out, ok_ref)
    assert not ok_out[..., 5].all() and ok_out[..., 0].all()
    for name, o, r in zip(("cost",) if multi else ("xs", "xf", "us", "cost"),
                          out[:-1], ref[:-1]):
        assert o.shape == r.shape, name
        # Past the NaN, the polynomial asin of the Pallas kernel stays finite
        # for |arg| > 1 where torch.asin (and jnp.arcsin) give NaN: where the
        # port is finite the reference is too, and they agree there.
        fin = np.isfinite(o)
        assert np.all(np.isfinite(r)[fin]), name
        np.testing.assert_allclose(o[fin], r[fin], rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def _jax_line_search(c):
    return jax.vmap(lambda x0, xs, us, l, L, dV, cost: line_search(
        c["jp"], jnp.asarray(ALPHAS), x0, xs, us, l, L, dV, cost, 0.0,
        c["p"], jnp.zeros((N, 0)), jnp.zeros((N, 0)), jnp.zeros(0),
        jnp.zeros(0), 1.0, 1.0))(c["x0s"], c["xs"], c["us"], c["l"],
                                 c["L"], c["dV"], c["cost"])


def _port_args(c):
    return (c["tp"], ALPHAS, _t(c["x0s"]), _t(c["xs"]), _t(c["us"]),
            _t(c["l"]), _t(c["L"]), _t(c["dV"]), _t(c["cost"]), 0.0,
            c["p_t"], *map(_t, c["mult"]), _t(c["wl"]), _t(c["wf"]))


@pytest.mark.parametrize("staged", [True, False])
def test_line_search_matches_serial_jax(case, staged):
    ref = _jax_line_search(case)
    if staged:
        out = cr.kernel_line_search_staged(
            *_port_args(case), alive=torch.ones(B, dtype=torch.bool))
    else:
        out = cr.kernel_line_search(*_port_args(case))
    assert not bool(out.success[5])  # NaN lane: every alpha rejected
    assert int(out.alpha_index[5]) == len(ALPHAS)
    for name in ref._fields:
        r, o = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        if r.dtype.kind in "bi":
            np.testing.assert_array_equal(o, r, err_msg=name)
        else:
            np.testing.assert_allclose(o, r, rtol=1e-10, atol=1e-10,
                                       err_msg=name)


def test_staged_line_search_paths(case):
    """The staged search's three shortcuts give the unstaged result on live
    lanes: all-dead lanes skip both rollouts; an alpha[0]-accepting batch
    takes the fast path; a mixed batch runs the sweep.  A rejecting lane's
    trajectory is not consumed by the solver, and may come from stage 1."""
    args = _port_args(case)
    full = cr.kernel_line_search(*args)
    dead = cr.kernel_line_search_staged(
        *args, alive=torch.zeros(B, dtype=torch.bool))
    assert not dead.success.any()
    assert torch.equal(dead.xs, args[3])
    assert (dead.alpha_index == len(ALPHAS)).all()
    for alive_lanes in ([0], [0, 1, 2, 3, 4], list(range(B))):
        alive = torch.zeros(B, dtype=torch.bool)
        alive[alive_lanes] = True
        out = cr.kernel_line_search_staged(*args, alive=alive)
        for name in full._fields:
            m = alive & full.success if name in ("xs", "us") else alive
            torch.testing.assert_close(getattr(out, name)[m],
                                       getattr(full, name)[m],
                                       rtol=0, atol=0, equal_nan=True)


def test_alpha_zero_is_exact_open_loop(case):
    """alpha == 0 rolls u_nom exactly (iLQG_func.tem:155-158), in the plain
    rollout and in the initial forward pass alike."""
    ops = [_t(a) for a in _cm_operands(case)]
    big_L = ops[3] * 1e3  # any feedback would show
    xs, xf, us = cr.rollout_call(case["tp"], ALPHAS, ops[0], ops[1], ops[2],
                                 big_L, *ops[4:], torch.zeros(1, B),
                                 case["p_t"], multi=False)
    w = torch.ones(B, dtype=torch.float64)
    r = tfwd.forward_pass(case["tp"], _t(case["x0s"]), None, _t(case["us"]),
                          None, None, 0.0, case["p_t"],
                          *map(_t, case["mult"]), w, w)
    torch.testing.assert_close(xs.permute(2, 0, 1), r.xs[:, :N], rtol=0,
                               atol=0)
    torch.testing.assert_close(us.permute(2, 0, 1), r.us, rtol=0, atol=0)
    clamped = td.clamp_u(case["tp"], xs.permute(1, 0, 2),
                         ops[1].permute(1, 0, 2), case["p_t"], 0)
    torch.testing.assert_close(us, clamped.permute(1, 0, 2), rtol=0, atol=0)


def test_forward_pass_and_cost_only_match_jax(case):
    c = case
    mult_t = list(map(_t, c["mult"]))
    w = torch.ones(B, dtype=torch.float64)
    u0 = c["us"].copy()
    u0[2, 4, 0] = 5.0  # beyond limW: clamped
    ref = jax.vmap(lambda x0_, us_: jfwd.forward_pass(
        c["jp"], x0_, jnp.zeros((N + 1, 4)), us_, jnp.zeros((N, 2)),
        jnp.zeros((N, 2, 4)), 0.0, c["p"], jnp.zeros((N, 0)),
        jnp.zeros((N, 0)), jnp.zeros(0), jnp.zeros(0), 1.0, 1.0))(
            c["x0s"], u0)
    out = tfwd.forward_pass(c["tp"], _t(c["x0s"]), None, _t(u0), None, None,
                            0.0, c["p_t"], *mult_t, w, w)
    np.testing.assert_allclose(out.xs.numpy(), np.asarray(ref.xs),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(out.us.numpy(), np.asarray(ref.us),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(out.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-12)
    np.testing.assert_array_equal(out.ok.numpy(), np.asarray(ref.ok))
    co_ref = jax.vmap(lambda xs_, us_: jfwd.cost_only(
        c["jp"], xs_, us_, c["p"], jnp.zeros((N, 0)), jnp.zeros((N, 0)),
        jnp.zeros(0), jnp.zeros(0), 1.0, 1.0))(np.asarray(ref.xs),
                                               np.asarray(ref.us))
    co = tfwd.cost_only(c["tp"], out.xs, out.us, c["p_t"], *mult_t, w, w)
    np.testing.assert_allclose(co.numpy(), np.asarray(co_ref), rtol=1e-12)


def test_forward_pass_nan_sets_ok_false(case):
    c = case
    w = torch.ones(B, dtype=torch.float64)
    x0 = c["x0s"].copy()
    x0[1, 3] = 1e4  # |h*v*sin(w)| > d: sqrt of a negative number
    u0 = c["us"].copy()
    u0[1, :, 0] = 0.4
    out = tfwd.forward_pass(c["tp"], _t(x0), None, _t(u0), None, None, 0.0,
                            c["p_t"], *map(_t, c["mult"]), w, w)
    assert not bool(out.ok[1]) and bool(out.ok[[0, 2, 3, 4, 5]].all())
