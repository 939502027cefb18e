"""What a CUDA graph of ``StepwiseSolver``'s body call needs, checked on the
CPU: the body call of every graphed route (each backward pass and line
search, shared and per-lane params) reads nothing on the host and copies
nothing to the device from Python data, the staged line search decides
its stages on the device and equals the host-branch schedule it replaced,
the loop reads the host at most once every ``chunk`` body calls, and
``precompile`` changes no result.  CarParking (the parallel route: the
Brachistochrone), float64, B <= 16, T <= 40, through the kernels' plain
versions."""

import contextlib
import math

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch import solver as slv
from ddp_generator_tpu_torch.models import brachistochrone as tbr
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.ops import cuda_rollout as cr
from ddp_generator_tpu_torch.ops.forward import forward_pass
from ddp_generator_tpu_torch.ops.linesearch import LineSearchResult

HOST_READS = ("__bool__", "item", "tolist", "__int__", "__float__")


@contextlib.contextmanager
def host_reads(count=None):
    """Patch the ways a tensor reaches the host: raise, or count into
    ``count`` (a one-element list) and read."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def patched(name):
        def f(self, *a, **kw):
            if count is None:
                raise AssertionError(f"host read: Tensor.{name}")
            count[0] += 1
            return saved[name](self, *a, **kw)
        return f

    for name in HOST_READS:
        setattr(torch.Tensor, name, patched(name))
    try:
        yield
    finally:
        for name, f in saved.items():
            setattr(torch.Tensor, name, f)


class _NoHostCopies(TorchFunctionMode):
    """Raise at an index a capture refuses: a Python list (copied from host
    memory) or a boolean mask (its size is read on the host)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            for i in idx:
                if isinstance(i, list) or (isinstance(i, torch.Tensor)
                                           and i.dtype == torch.bool):
                    raise AssertionError(f"index by {type(i).__name__} "
                                         f"{getattr(i, 'dtype', '')}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_host_copies():
    """Raise at a copy from Python data to a tensor (``torch.tensor``, or
    ``torch.as_tensor`` of anything but a tensor) and at the indices of
    :class:`_NoHostCopies`: a CUDA graph capture refuses both."""
    saved = torch.tensor, torch.as_tensor

    def refuse(name, f):
        def g(data, *a, **kw):
            if name == "tensor" or not isinstance(data, torch.Tensor):
                raise AssertionError(f"torch.{name} of {type(data).__name__}")
            return f(data, *a, **kw)
        return g

    torch.tensor, torch.as_tensor = (refuse("tensor", saved[0]),
                                     refuse("as_tensor", saved[1]))
    try:
        with _NoHostCopies():
            yield
    finally:
        torch.tensor, torch.as_tensor = saved


def _workload(B=16, T=30, seed=7):
    """tests/test_mesh_stepwise.py's workload, in float64."""
    problem = tcar.car_parking()
    p, x0, _ = tcar.default_setup(T=T, seed=0)
    rng = np.random.default_rng(seed)
    x0s = np.tile(np.asarray(x0), (B, 1))
    u0s = 0.1 * rng.standard_normal((B, T, 2))
    return problem, p, x0s, u0s


def _options(backpass="kernel", linesearch="kernel", **kw):
    return td.SolverOptions(max_iter=25, dtype="float64", debug_level=0,
                            backpass_method=backpass,
                            linesearch_method=linesearch, **kw)


def per_lane(p, B):
    """``batch_params=True`` params: every leaf with a leading lane axis."""
    return {k: np.tile(np.asarray(v, np.float64), (B,) + (1,) * np.ndim(v))
            for k, v in p.items()}


def route_case(route, B, T):
    """``(problem, options, x0s, u0s, params, batch_params)`` of a graphed
    route: ``(backpass, linesearch, per_lane)``.  Per-lane CarParking params
    vary ``limW`` from +-0.2 to +-0.5 over the lanes; the parallel
    backward pass (unconstrained, ``full_ddp=False``) runs the
    Brachistochrone of tests/test_parallel_riccati.py, its terminal
    height ``yf`` per lane."""
    backpass, linesearch, lanes = route
    if backpass == "parallel":
        problem = tbr.brachistochrone()
        p, x0, u0 = tbr.default_setup(T)
        rng = np.random.default_rng(2)
        x0s = np.tile(x0, (B, 1)) - rng.random((B, 1))
        u0s = np.minimum(u0[None] * (0.2 + 3 * rng.random((B, 1, 1)))
                         + 0.3 * rng.standard_normal((B, T, 1)), -0.05)
        opts = td.SolverOptions(max_iter=50, w_pen_init_f=40.0,
                                w_pen_fact2=2.0, full_ddp=False,
                                dtype="float64", debug_level=0,
                                backpass_method=backpass,
                                linesearch_method=linesearch)
        if lanes:
            p = per_lane(p, B)
            p["yf"] = np.linspace(-3.0, -5.0, B)
        return problem, opts, x0s, u0s, p, lanes
    problem, p, x0s, u0s = _workload(B=B, T=T)
    if lanes:
        p = per_lane(p, B)
        lim = np.linspace(0.2, 0.5, B)
        p["limW"] = np.stack([-lim, lim], axis=1)
    return problem, _options(backpass, linesearch), x0s, u0s, p, lanes


# (backpass_method, linesearch_method, batch_params) of each graphed route
ROUTES = {"kernel": ("kernel", "kernel", False),
          "fused": ("fused", "kernel", False),
          "serial": ("serial", "serial", False),
          "serial_kernel_ls": ("serial", "kernel", False),
          "parallel_serial_ls": ("parallel", "serial", False),
          "parallel_kernel_ls": ("parallel", "kernel", False),
          "per_lane_serial": ("serial", "serial", True),
          "per_lane_kernel": ("kernel", "kernel", True),
          "per_lane_fused": ("fused", "kernel", True),
          "per_lane_parallel": ("parallel", "serial", True)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_body_call_reads_nothing_on_the_host(route):
    """The body call a graph captures -- the masked step on the static
    carry -- runs with every host read patched to raise and with every copy
    from Python data refused, twice (the second call sees lanes that
    accepted and a lambda that moved), after the one eager call that a
    capture's warm-up makes first (it builds the per-device index tables
    of ``ops/boxqp.py`` and ``ops/cuda_backpass.py``)."""
    problem, o, x0s, u0s, p, lanes = route_case(ROUTES[route], 8, 20)
    assert slv._graphable(problem, o)
    init, body, _, cast = slv._make_parts(problem, o, "cpu", lanes)
    params = cast(p, 8)
    c = init(x0s, u0s, params)
    w = slv._WidthBody(slv._masked(body, o.max_iter), c, params,
                       o.max_iter, graph=False)
    w.run()  # the warm-up
    with host_reads(), no_host_copies():
        w.run()
        w.run()
    assert int(w.active) > 0
    assert int(w.carry.body_calls.max()) == 3


def _host_branch_staged(problem, alphas, x0, xs_nom, us_nom, l, L_gain, dV,
                        cost, z_min, params, mu_le, mu_li, mu_fe, mu_fi,
                        w_pen_l, w_pen_f, alive):
    """The staged line search as the port ran it before its stages were
    decided on the device: three Python branches on host booleans (the
    reference the device-side schedule must equal on live lanes)."""
    A = len(alphas)
    ctx = cr._LSCtx(problem, x0, xs_nom, us_nom, l, L_gain, dV, cost,
                    mu_le, mu_li, mu_fe, mu_fi, w_pen_l, w_pen_f, alphas)
    B, dtype = ctx.B, ctx.dtype
    if not bool(alive.any()):
        zeros = torch.zeros((B,), dtype=dtype)
        return LineSearchResult(
            success=torch.zeros((B,), dtype=torch.bool), xs=ctx.xs_nom,
            us=ctx.us_nom, new_cost=ctx.cost, dcost=zeros, expected=zeros,
            z=zeros, alpha_index=torch.full((B,), A, dtype=torch.int32))
    a0 = float(alphas[0])
    xs0, xf0, us0, cost0, ok0 = ctx.call(
        problem, params, torch.full((1, B), a0, dtype=dtype), multi=False,
        want_cost=True)
    cost0, ok0 = cost0[0], ok0[0]
    dcost0 = ctx.cost - cost0
    expected0 = -a0 * (ctx.dV[:, 0] + a0 * ctx.dV[:, 1])
    pos0 = expected0 > 0.0
    z0 = torch.where(pos0, dcost0 / torch.where(pos0, expected0, 1.0), 0.0)
    acc0 = ok0 & (z0 > z_min)
    if not bool((alive & ~acc0).any()):
        xs_out, us_out = cr._traj_out(xs0, xf0, us0)
        return LineSearchResult(
            success=acc0, xs=xs_out, us=us_out, new_cost=cost0,
            dcost=dcost0, expected=expected0, z=z0,
            alpha_index=torch.where(acc0, 0, A).to(torch.int32))
    costs, okf = ctx.call(problem, params, None, multi=True)
    idx, any_ok, dcost, expected, z, take = ctx.select_first_accept(
        costs, okf, z_min)
    if bool((alive & any_ok & (idx > 0)).any()):
        alpha_vec = take(ctx.alphas[:, None].expand(A, B))
        traj = ctx.call(problem, params, alpha_vec[None, :].contiguous(),
                        multi=False)
    else:
        traj = (xs0, xf0, us0)
    xs_out, us_out = cr._traj_out(*traj)
    return LineSearchResult(
        success=any_ok, xs=xs_out, us=us_out, new_cost=take(costs),
        dcost=take(dcost), expected=take(expected), z=take(z),
        alpha_index=torch.where(any_ok, idx, A).to(torch.int32))


NAN_LANE = 5


def same(a, b, name):
    """Equal bit for bit, NaN where NaN."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                               msg=name)


def _ls_case(B=12, T=24):
    """Line-search operands: a nominal rollout, random gains, dV with a
    positive expected reduction, and per-lane costs between the sweep's
    costs of that lane, so that lanes accept at different alphas (the last
    two at alpha[0]); lane NAN_LANE's rollouts turn NaN (it rejects every
    alpha)."""
    problem = tcar.car_parking()
    p_np, x0, _ = tcar.default_setup(T=T, seed=0)
    p = td.params_from_jax(p_np, torch.float64, "cpu")
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    x0s = np.tile(x0, (B, 1)) + 0.05 * rng.standard_normal((B, 4))
    u0s = 0.1 * rng.standard_normal((B, T, 2))
    x0s[NAN_LANE, 3], u0s[NAN_LANE, :, 0] = 1e4, 0.3
    m = td.init_multipliers(problem, B, T, torch.float64, "cpu")
    w = torch.ones(B, dtype=torch.float64)
    nom = forward_pass(problem, t(x0s), None, t(u0s), None, None, 0.0, p,
                       m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w, w)
    l = t(0.3 * rng.standard_normal((B, T, 2)))
    L = t(0.05 * rng.standard_normal((B, T, 2, 4)))
    dV = torch.stack([-torch.ones(B, dtype=torch.float64),
                      torch.zeros(B, dtype=torch.float64)], 1)
    alphas = tuple(td.SolverOptions().alpha)
    args = [problem, alphas, nom.xs[:, 0], nom.xs, nom.us, l, L, dV,
            nom.cost, 0.0, p, m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w, w]
    ctx = cr._LSCtx(args[0], *args[2:9], *args[11:], alphas)
    costs, ok = ctx.call(problem, p, None, multi=True)  # (A, B)
    costs = torch.where(ok, costs, float("nan"))
    # lane b accepts the first alpha whose cost is below the q_b-quantile
    # of its costs (expected reduction = alpha, z_min = 0)
    q = torch.linspace(0.1, 0.9, B, dtype=torch.float64)
    cost = torch.stack([torch.nanquantile(costs[:, b], q[b])
                        for b in range(B)])
    # the last two lanes accept alpha[0]: above every cost of theirs
    cost[-2:] = torch.nan_to_num(costs[:, -2:], nan=-1e300).amax(0) + 1.0
    args[8] = cost
    return args


@pytest.mark.parametrize("case", ["no_live_lane", "all_take_alpha0",
                                  "sweep_all_alpha0", "some_past_alpha0"])
def test_device_side_staged_search_equals_host_branches(case):
    """Bit for bit on every live lane, with no host read, in each of the
    schedule's four outcomes."""
    args = _ls_case()
    B = args[2].shape[0]
    alive = torch.ones(B, dtype=torch.bool)
    if case == "no_live_lane":
        alive[:] = False
    elif case in ("all_take_alpha0", "sweep_all_alpha0"):
        args[9] = -1e300  # every finite rollout is accepted at alpha[0]
        if case == "all_take_alpha0":
            alive[NAN_LANE] = False
    ref = _host_branch_staged(*args, alive=alive)
    at = torch.as_tensor(args[1], dtype=torch.float64)
    with host_reads():
        out = cr.kernel_line_search_staged(*args[:1], at, *args[2:],
                                           alive=alive)
    live_idx = ref.alpha_index[alive]
    if case == "all_take_alpha0":
        assert (live_idx == 0).all()
    elif case == "sweep_all_alpha0":
        assert (live_idx == 0).sum() == B - 1 and not ref.success[NAN_LANE]
    elif case == "some_past_alpha0":
        assert ((live_idx > 0) & (live_idx < len(args[1]))).any()
        assert (live_idx == 0).any()
    for name in LineSearchResult._fields:
        a, b = getattr(out, name), getattr(ref, name)
        if name in ("xs", "us"):  # consumed only where a live lane accepts
            m = alive & ref.success
        else:
            m = alive
        same(a[m], b[m], name)
    if case == "no_live_lane":
        same(out.xs, args[3], "xs")
        assert not out.success.any()


def test_host_reads_per_chunk():
    """StepwiseSolver reads the host at most ceil(chunk_len / chunk) + 1
    times a chunk (counted by patching every host read), in every chunk of
    a solve that compacts (every other lane fails its initial rollout, so
    the working set halves after the first chunk and the chunks lengthen);
    ``last_stats`` counts the same reads."""
    problem, p, x0s, u0s = _workload(B=16, T=30)
    x0s[::2, 0] = np.nan  # status 6 at init: retired from the start
    solver = td.StepwiseSolver(problem, _options(), chunk=3,
                               compact_levels=2, min_compact_batch=4,
                               device="cpu")
    count, per_chunk = [0], []
    inner = solver._static_chunk

    def counted(w, n):
        before = count[0]
        out = inner(w, n)
        per_chunk.append((n, count[0] - before))
        return out

    solver._static_chunk = counted
    with host_reads(count):
        sol = solver(x0s, u0s, p)
    st = solver.last_stats
    assert st.graphed == () and st.replays == 0  # no card: eager calls
    assert (sol.status[::2] == 6).all() and sol.success[1::2].all()
    assert st.eager[:2] == (16, 8) and len(per_chunk) >= 2
    assert max(n for n, _ in per_chunk) > solver.chunk
    for n, reads in per_chunk:
        assert reads <= math.ceil(n / solver.chunk) + 1, (n, reads)
    assert st.host_reads == count[0] == sum(r for _, r in per_chunk)


@pytest.mark.parametrize("backpass", ["kernel", "fused"])
def test_precompile_then_solve(backpass):
    """tests/test_mesh_stepwise.py:99-106 in the port: precompile returns
    a positive time, and the solve after it equals a solve without it bit
    for bit (and the eager solver's), every lane solved."""
    problem, p, x0s, u0s = _workload()
    o = _options(backpass)
    s = td.StepwiseSolver(problem, o, chunk=5, compact_levels=1,
                          min_compact_batch=8, device="cpu")
    assert s.precompile(x0s, u0s, p) > 0.0
    assert sorted(w for w, _ in s._widths) == [8, 16]
    sol = s(x0s, u0s, p)
    plain = td.StepwiseSolver(problem, o, chunk=5, compact_levels=1,
                              min_compact_batch=8, device="cpu")(x0s, u0s, p)
    eager = td.make_batched_solver(problem, o, device="cpu")(x0s, u0s, p)
    assert bool(sol.success.all())
    for name, a, b, c in zip(sol._fields, sol, plain, eager):
        assert torch.equal(a, b), name
        assert torch.equal(a, c), name
