"""The port's ``lax.while_loop`` (``ops/device_loop.py``) and the loops that
run through it, on the CPU.

* The plain :func:`while_loop` against ``jax.lax.while_loop`` under
  ``jax.vmap`` (per-lane trip counts from a numpy seed: 0, 1 and many
  trips, a lane that never runs), flat and nested.
* "Reads nothing on the host": a ``TorchDispatchMode`` that raises on
  ``aten._local_scalar_dense``, ``aten.is_nonzero`` and ``aten.nonzero``
  (every ``.item()``, ``bool()`` and boolean mask), with
  ``Tensor.__bool__``/``item``/``tolist`` patched to raise too, around one
  ``cond_fn`` and one ``body_fn`` call of every device loop: the solve's
  masked body on the kernel, fused, serial and parallel paths, the inline
  lambda retries, boxQP's Newton iteration and its Armijo backtracking.
  A CUDA graph capture refuses exactly those reads, so this is the CPU's
  check that each loop can be a WHILE node.
* The restructured ``boxqp_newton`` against the JAX package's per lane in
  float64, with lanes that end in each result code and a NaN lane.
* ``lam_retry="inline"`` and ``boxqp_method="newton"`` solves, now on the
  static (graphable) route, against the JAX package per lane.
* The CUDA version check and the context managers.
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import ddp_generator_tpu as jd
from ddp_generator_tpu.models import car_parking as jcar
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch import solver as slv
from ddp_generator_tpu_torch.models import brachistochrone as tbr
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.ops import boxqp as tqp
from ddp_generator_tpu_torch.ops import device_loop as dl
from test_torch_boxqp import _assert_same
from test_torch_graphs import host_reads
from test_torch_inline import _workload
from test_torch_serial import _toy

jqp = importlib.import_module("ddp_generator_tpu.ops.boxqp")


# ---- (a) the plain loop against lax.while_loop under vmap -----------------

def _trips(seed, B=12):
    """Per-lane trip counts: lane 0 never runs, lane 1 runs once, lane 2
    many times, the rest random."""
    n = np.random.default_rng(seed).integers(0, 25, B)
    n[:3] = (0, 1, 40)
    return n.astype(np.int32)


def _x0(seed, B=12):
    return np.random.default_rng(seed + 100).uniform(-1, 1, (B, 3))


def _step(x):
    # an exact product and one rounded sum: fused into an FMA or not, both
    # frameworks round it the same way
    return x * 0.5 + 0.375


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_while_loop_matches_vmapped_lax(seed):
    n, x0 = _trips(seed), _x0(seed)

    def lane(x, k):
        return jax.lax.while_loop(lambda c: c[1] < k,
                                  lambda c: (_step(c[0]), c[1] + 1),
                                  (x, jnp.int32(0)))

    ref = jax.jit(jax.vmap(lane))(jnp.asarray(x0), jnp.asarray(n))
    k = torch.as_tensor(n)
    trips = [0]

    def body(c):
        trips[0] += 1
        run = c[1] < k
        return (torch.where(run[:, None], _step(c[0]), c[0]),
                torch.where(run, c[1] + 1, c[1]))

    zero = torch.zeros(12, dtype=torch.int32)
    out = dl.while_loop(lambda c: (c[1] < k).any(), body,
                        (torch.as_tensor(x0), zero))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[1].numpy(), n)
    assert trips[0] == n.max()  # the batch loops while any lane runs


def test_plain_while_loop_lane_that_never_runs():
    """A batch in which no lane runs makes no trip and returns its carry."""
    x = torch.ones(4, 3, dtype=torch.float64)
    out = dl.while_loop(lambda c: torch.zeros((), dtype=torch.bool),
                        lambda c: pytest.fail("body called"), (x,))
    assert out[0] is x


@pytest.mark.parametrize("seed", [3, 4])
def test_nested_plain_loops_match_nested_lax(seed):
    """An inner loop whose trip count is the outer loop's counter times a
    per-lane factor, as the retry loop sits inside the solve's loop."""
    n, x0 = _trips(seed, 8) % 6, _x0(seed, 8)
    f = (np.arange(8) % 3).astype(np.int32)

    def lane(x, k, m):
        def outer(c):
            def inner(d):
                return (_step(d[0]), d[1] + 1)
            y, _ = jax.lax.while_loop(lambda d: d[1] < c[1] * m, inner,
                                      (c[0], jnp.int32(0)))
            return (y, c[1] + 1)
        return jax.lax.while_loop(lambda c: c[1] < k, outer,
                                  (x, jnp.int32(0)))

    ref = jax.jit(jax.vmap(lane))(*map(jnp.asarray, (x0, n, f)))
    k, m = torch.as_tensor(n), torch.as_tensor(f)

    def outer(c):
        run = c[1] < k

        def inner(d):
            go = run & (d[1] < c[1] * m)
            return (torch.where(go[:, None], _step(d[0]), d[0]),
                    torch.where(go, d[1] + 1, d[1]))

        y, _ = dl.while_loop(lambda d: (run & (d[1] < c[1] * m)).any(),
                             inner, (c[0], torch.zeros_like(c[1])))
        return (torch.where(run[:, None], y, c[0]),
                torch.where(run, c[1] + 1, c[1]))

    zero = torch.zeros(8, dtype=torch.int32)
    out = dl.while_loop(lambda c: (c[1] < k).any(), outer,
                        (torch.as_tensor(x0), zero))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))


# ---- (b) no cond_fn or body_fn reads the host ----------------------------

class _RefuseHostReads(TorchDispatchMode):
    """Raise at every op that brings a device value to the host."""

    REFUSED = ("_local_scalar_dense", "is_nonzero", "nonzero")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in self.REFUSED:
            raise AssertionError(f"host read: aten.{func.__name__}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def refuse_host_reads():
    with _RefuseHostReads(), host_reads():
        yield


# the loop each body function belongs to, by its qualified name
LOOPS = {"_solve_loop.<locals>.body": "solve",
         "_lam_retry_loop.<locals>.body": "lam_retry",
         "boxqp_newton.<locals>.step": "newton",
         "boxqp_newton.<locals>.body.<locals>.a_body": "armijo"}


@pytest.fixture
def checked_loops(monkeypatch):
    """Patch ``device_loop.while_loop``: its first call of each loop runs
    one ``cond_fn`` and one ``body_fn`` call with host reads refused (the
    loops nested in that body are checked the same way, one trip each,
    inside it), then the plain loop.  Returns the set of loops checked."""
    plain = dl.while_loop
    checked, inside = set(), [False]

    def patched(cond_fn, body_fn, carry):
        name = LOOPS[body_fn.__qualname__]
        if inside[0]:
            checked.add(name)
            cond_fn(carry)
            return body_fn(carry)
        if name not in checked:
            inside[0] = True
            try:
                with refuse_host_reads():
                    cond_fn(carry)
                    body_fn(carry)
            finally:
                inside[0] = False
            checked.add(name)
        return plain(cond_fn, body_fn, carry)

    monkeypatch.setattr(dl, "while_loop", patched)
    return checked


def _car(B=4, T=12, seed=3):
    p, x0, _ = tcar.default_setup(T=T)
    rng = np.random.default_rng(seed)
    x0s = np.tile(x0, (B, 1))
    u0s = 4.0 * rng.standard_normal((B, T, 2))  # FULL_DDP: lambda retries
    return tcar.car_parking(), p, x0s, u0s


# (backpass, linesearch, extra options) of each route, and the loops it
# must reach
LOOP_ROUTES = {
    "kernel": (("kernel", "kernel", {}), {"solve"}),
    "kernel_inline": (("kernel", "kernel", {"lam_retry": "inline"}),
                      {"solve", "lam_retry"}),
    "fused_inline": (("fused", "kernel", {"lam_retry": "inline"}),
                     {"solve", "lam_retry"}),
    "serial_newton_inline": (("serial", "serial",
                              {"lam_retry": "inline",
                               "boxqp_method": "newton"}),
                             {"solve", "lam_retry", "newton", "armijo"}),
    "parallel": (("parallel", "serial", {}), {"solve"}),
    "parallel_newton": (("parallel", "kernel", {"boxqp_method": "newton"}),
                        {"solve", "newton", "armijo"}),
}


@pytest.mark.parametrize("route", list(LOOP_ROUTES))
def test_loop_functions_read_nothing_on_the_host(route, checked_loops):
    (backpass, linesearch, kw), want = LOOP_ROUTES[route]
    if backpass == "parallel":
        problem = tbr.brachistochrone()
        p, x0, u0 = tbr.default_setup(12)
        x0s, u0s = np.tile(x0, (4, 1)), np.tile(u0, (4, 1, 1))
        o = td.SolverOptions(max_iter=3, w_pen_init_f=40.0, w_pen_fact2=2.0,
                             full_ddp=False, dtype="float64", debug_level=0,
                             backpass_method=backpass,
                             linesearch_method=linesearch, **kw)
    else:
        problem, p, x0s, u0s = _car()
        o = td.SolverOptions(max_iter=3, full_ddp=True, dtype="float64",
                             debug_level=0, backpass_method=backpass,
                             linesearch_method=linesearch, **kw)
    assert slv._graphable(problem, o)
    sol = td.make_batched_solver(problem, o, device="cpu")(x0s, u0s, p)
    assert checked_loops == want
    assert bool(torch.isfinite(sol.cost).any())


# ---- (c) boxqp_newton against the JAX package, every result code ---------

def _qp_candidates(count=240, n=3, seed=1):
    """Convex and indefinite QPs (a third shifted by -1.5 I) in boxes that
    hold 0, warm-started off the optimum; then a lane started at its exact
    optimum (its gradient is 0.0 in floating point) and a lane with a NaN
    in g."""
    rng = np.random.default_rng(seed)
    count -= 2
    A = rng.standard_normal((count, n, n))
    H = np.einsum("bij,bkj->bik", A, A) + 0.05 * np.eye(n)
    H[:count // 3] -= 1.5 * np.eye(n)
    g = 3.0 * rng.standard_normal((count, n))
    lo = -0.5 * np.abs(rng.standard_normal((count, n)))
    up = 0.5 * np.abs(rng.standard_normal((count, n)))
    x0 = rng.standard_normal((count, n))
    exact = (np.diag([2.0, 4.0, 1.0]), np.array([-0.5, 2.0, 0.25]),
             -np.ones(n), np.ones(n), np.array([0.25, -0.5, -0.25]))
    nan = (np.eye(n), np.array([1.0, np.nan, 0.0]), -np.ones(n), np.ones(n),
           np.zeros(n))
    return tuple(np.concatenate([a, np.stack([e, m])])
                 for a, e, m in zip((H, g, lo, up, x0), exact, nan))


# hyper-parameter sets whose lanes end, between them, in every code, and
# the lanes each runs: the random QPs' codes do not hang on the last bit
# of a sum, and the exact lane, with min_grad 0, returns -2 (a zero search
# direction is not a descent direction)
HYPERS = {
    "tight": (dict(max_iter=3, min_grad=1e-8, min_rel_improve=1e-8,
                   min_step=1e-3), slice(None), {-1, 1, 5, 6}),
    "armijo": (dict(max_iter=4, min_grad=1e-10, min_rel_improve=1e-3,
                    min_step=0.05), slice(None), {-1, 2, 4, 5, 6}),
    "exact": (dict(min_grad=0.0), slice(-2, None), {-2}),
}


@pytest.mark.parametrize("hyper", list(HYPERS))
def test_newton_matches_jax_in_every_result_code(hyper):
    kw, lanes, codes = HYPERS[hyper]
    arrs = tuple(a[lanes] for a in _qp_candidates())
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(
        lambda H, g, lo, up, x0: jqp.boxqp_newton(
            H, g, lo, up, x0, jqp.BoxQPHyper(**kw))))(
        *map(jnp.asarray, arrs)))
    out = tqp.boxqp_newton(*map(torch.as_tensor, arrs), tqp.BoxQPHyper(**kw))
    names = [str(b) for b in range(len(arrs[0]))]
    _assert_same(out, ref, names)  # x and inv_h within 1e-12 (NaN = NaN)
    assert codes <= set(out.res.tolist()), set(out.res.tolist())
    assert int(out.res[-1]) == int(ref.res[-1])  # the NaN lane


# ---- (d) the inline and Newton routes, graphable, against JAX -------------

COUNTS = ("status", "iterations", "body_calls", "stale_calls",
          "bp_retry_calls")


def _route_case(case):
    """``(jax problem, port problem, x0s, u0s, params, options)``: the
    inline solve of ``tests/test_torch_inline.py`` (CarParking, FULL_DDP,
    lambda retries), and the ``n_u = 4`` problem of
    ``tests/test_torch_serial.py``, whose boxQP is the Newton iteration."""
    if case == "inline":
        p, x0s, u0s = _workload()
        return (jcar.car_parking(), tcar.car_parking(), x0s, u0s, p,
                dict(max_iter=30, full_ddp=True, lam_retry="inline"))
    rng = np.random.default_rng(4)
    x0s = 0.3 * rng.standard_normal((3, 2))
    u0s = 0.5 * rng.standard_normal((3, 20, 4))
    return (_toy(jd), _toy(td), x0s, u0s, {"dt": 0.1},
            dict(max_iter=15, boxqp_method="newton"))


@pytest.fixture(scope="module")
def jax_routes():
    """The JAX package's ``make_batched_solver`` solve of each case."""
    out = {}
    for case in ("inline", "newton"):
        jprob, _, x0s, u0s, p, kw = _route_case(case)
        out[case] = jax.tree_util.tree_map(np.asarray, jd.make_batched_solver(
            jprob, jd.SolverOptions(debug_level=0, **kw))(x0s, u0s, p))
    return out


@pytest.mark.parametrize("case", ["inline", "newton"])
@pytest.mark.parametrize("entry", ["batched", "stepwise"])
def test_graphable_routes_match_jax(case, entry, jax_routes):
    """The inline-retry and the Newton-boxQP solves (serial path, float64)
    through ``make_batched_solver`` and through ``StepwiseSolver``'s static
    route, against the JAX package's
    ``make_batched_solver`` per lane: counts equal, cost to rtol 1e-8 (and
    ``us`` to ``tests/test_torch_serial.py``'s 1e-5 for the Newton QP,
    which stops at its tolerances)."""
    _, problem, x0s, u0s, p, kw = _route_case(case)
    o = td.SolverOptions(dtype="float64", debug_level=0, **kw)
    assert slv._graphable(problem, o)
    if entry == "batched":
        sol = td.make_batched_solver(problem, o, device="cpu")(x0s, u0s, p)
    else:
        s = td.StepwiseSolver(problem, o, chunk=3, compact_levels=2,
                              min_compact_batch=1, device="cpu")
        sol = s(x0s, u0s, p)
        assert all(s._on_static(w) for w in s.last_stats.eager)
    out, ref = td.to_numpy(sol), jax_routes[case]
    for f in COUNTS:
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f),
                                      err_msg=f)
    np.testing.assert_allclose(out.cost, ref.cost, rtol=1e-8)
    np.testing.assert_allclose(out.us, ref.us, rtol=0,
                               atol=1e-12 if case == "inline" else 1e-5)
    if case == "inline":
        assert int(out.bp_retry_calls.sum()) > 0


# ---- the version check and the context managers ---------------------------

@pytest.mark.parametrize("versions,ok", [
    ((12090, 12090, 13000), True), ((12040, 12040, 12040), True),
    ((12090, 12030, 13000), False), ((12090, 12090, 12020), False),
    ((12020, 12090, 12090), False)])
def test_cuda_version_check(versions, ok):
    if ok:
        dl.check_versions(versions)
        return
    with pytest.raises(RuntimeError, match="CUDA >= 12.4") as e:
        dl.check_versions(versions)
    for v in versions[1:]:  # the runtime's and the driver's numbers
        assert f"{v // 1000}.{v % 1000 // 10}" in str(e.value)


def test_eager_loops_nests_and_restores():
    assert not dl.loops_eager()
    with dl.eager_loops():
        with dl.eager_loops():
            assert dl.loops_eager()
        assert dl.loops_eager()
    assert not dl.loops_eager()
    with pytest.raises(KeyError):
        with dl.eager_loops():
            raise KeyError
    assert not dl.loops_eager()


def test_batched_solver_is_cached_and_loops_on_the_host_on_cpu():
    """``make_batched_solver`` returns one solver per (problem, options,
    batch_params, device), as JAX caches its jitted solver; on the CPU the
    solve is the host loop, equal under ``eager_loops()``."""
    problem, p, x0s, u0s = _car(B=3, T=10)
    o = td.SolverOptions(max_iter=5, dtype="float64", debug_level=0)
    a = td.make_batched_solver(problem, o, device="cpu")
    assert td.make_batched_solver(problem, o, device="cpu") is a
    assert td.make_batched_solver(problem, o, True, device="cpu") is not a
    sol = a(x0s, u0s, p)
    assert not a.graphed() and not a.last_stats.graphed
    with dl.eager_loops():
        ref = a(x0s, u0s, p)
    for name, x, y in zip(sol._fields, sol, ref):
        assert torch.equal(x, y), name
