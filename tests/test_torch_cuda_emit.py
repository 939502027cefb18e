"""The kernel path's emission kernel (``ops/cuda_emit.py``, ``csrc/emit.cu``)
on a CUDA card.

* Against the torch emitter (``cm_derivs.cm_emit``) on the card: every key
  of the packed bundle, ``us_cm``, ``final_cx``/``final_cxx`` and ``ok``, at
  B=2048, N=500 on CarParking and at a ragged small shape on every CUDA model
  of ``codegen.KERNEL_MODELS`` and a generated one, FULL_DDP on and off, to
  B3's tolerances (relative to the largest value of each output: float32
  1e-1, float64 5e-12).  One work item a thread and all of a point's items
  on one thread give the same bits.
* A CarParking ``StepwiseSolver`` solve through the kernel against the same
  solve through the torch emitter: the solved share within 1 point, the
  median iterations within 5%.
* In a graphed solve the emission counts one launch per B1 launch.
* Per-lane params (``LaneParams``, lanes on four rows; the
  Brachistochrone's ``[k]``-indexed floor per lane) at widths 1, 2, 128 and
  2,048: each lane bit for bit a shared launch on its row, both thread
  mappings alike, against ``cm_emit`` to the tolerances above, counted as
  ``emit_lane_params``.
* A generated model with more fixed params than 48 KB of static shared
  memory holds for a block's rows (51 float64 entries): its library builds,
  and its shared and per-lane launches match ``cm_emit``.
* A problem with no CUDA model that the generator cannot write raises,
  naming the op: the kernel path on a card does not fall back to the torch
  emitter.

Needs a CUDA device and ``nvcc``; skips elsewhere.  The file imports no JAX,
so on a machine without it run it past ``tests/conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider \\
        -o "markers=cuda: needs a CUDA device" -m cuda -q \\
        tests/test_torch_cuda_emit.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import ddp_generator_tpu_torch as ddp
import test_torch_dual_host as dh
from ddp_generator_tpu_torch import codegen, launches
from ddp_generator_tpu_torch.models import car_parking
from ddp_generator_tpu_torch.ops import cuda_emit as ce
from ddp_generator_tpu_torch.ops.cm_derivs import cm_emit
from ddp_generator_tpu_torch.ops.cuda_backpass import _BUNDLE_KEYS
from ddp_generator_tpu_torch.problem import LaneParams, lanes_last
from test_torch_graphs import fleet

pytestmark = pytest.mark.cuda

# B3's tolerances (tests/test_torch_cuda_kernels.py, PERF.md's kernel
# table): forward-mode rounding against autograd's, relative to the
# largest value of an output
TOL = {torch.float32: 1e-1, torch.float64: 5e-12}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the emission kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def _operands(name, dtype, dev, N, B, seed=3, strip=False):
    """``test_torch_dual_host._case``'s operands on the card: ``(problem,
    args of emit/cm_emit but full_ddp)``."""
    c = dh._case(name, seed, N=N, B=B)
    prob = c["prob"]
    if strip:  # the model generated from the torch functions
        prob = dataclasses.replace(prob, cuda_model=None)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=dev)
    p = ddp.params_from_jax(c["p"], dtype, dev)
    return prob, (prob, t(c["xs"]), t(c["us"]), t(c["mu_le"]),
                  t(c["mu_li"]), t(c["mu_fe"]), t(c["mu_fi"]), t(c["wpl"]),
                  t(c["wpf"]), p)


def _close(out, ref, tol, name):
    assert out.shape == ref.shape and out.dtype == ref.dtype, name
    if out.dtype == torch.bool:
        assert torch.equal(out, ref), name
        return
    fin = torch.isfinite(ref)
    assert torch.equal(fin, torch.isfinite(out)), name
    assert torch.equal(out[~fin], ref[~fin]), name  # the same infinities
    scale = max(1.0, float(ref[fin].abs().max())) if fin.any() else 1.0
    err = float((out[fin] - ref[fin]).abs().max()) if fin.any() else 0.0
    assert err <= tol * scale, (name, err, scale)


def _check(args, full_ddp, dtype, nan_lane=None):
    """Both thread mappings against cm_emit (values but at ``nan_lane``,
    whose NaNs may land on other terms in forward and reverse mode; ok at
    every lane) and against each other, bit for bit."""
    items = ce.items_per_point(args[0].n_x, args[0].n_u, full_ddp)
    ref = cm_emit(*args, full_ddp)
    outs = [ce.emit(*args, full_ddp, per=per) for per in (1, items)]
    B = args[2].shape[0]
    lanes = torch.arange(B, device=args[2].device) != (
        -1 if nan_lane is None else nan_lane)
    for out in outs:
        for key in _BUNDLE_KEYS:
            _close(out[0][key][..., lanes], ref[0][key][..., lanes],
                   TOL[dtype], key)
        for a, b, key in zip(out[1:4], ref[1:4],
                             ("final_cx", "final_cxx", "us_cm")):
            _close(a[..., lanes], b[..., lanes], TOL[dtype], key)
        assert torch.equal(out[3], ref[3])  # u is copied, not computed
        assert torch.equal(out[4], ref[4])  # ok
    one, whole = outs
    for key in _BUNDLE_KEYS:
        torch.testing.assert_close(one[0][key], whole[0][key], rtol=0,
                                   atol=0, equal_nan=True, msg=key)
    for a, b in zip(one[1:], whole[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("full_ddp", [True, False], ids=["full", "gn"])
def test_emit_kernel_matches_cm_emit_full_width(cuda, full_ddp, dtype):
    _, args = _operands("car_parking", dtype, cuda, N=500, B=2048)
    _check(args, full_ddp, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("full_ddp", [True, False], ids=["full", "gn"])
@pytest.mark.parametrize("model",
                         codegen.KERNEL_MODELS + ("generated",))
def test_emit_kernel_matches_cm_emit(cuda, model, full_ddp, dtype):
    """Every hand-written model and CarParking's generated one, N and B
    ragged; a lane whose f goes NaN at a step clears only its own ok."""
    name = "car_parking" if model == "generated" else model
    _, args = _operands(name, dtype, cuda, N=13, B=37,
                        strip=model == "generated")
    nan_lane = None
    if name == "car_parking":
        xs, us = args[1].clone(), args[2].clone()
        xs[1, 3, 3], us[1, 3, 0] = 1e4, 0.4  # the sqrt in f goes NaN
        args, nan_lane = (args[0], xs, us) + args[3:], 1
    _check(args, full_ddp, dtype, nan_lane)
    if name == "car_parking":
        ok = ce.emit(*args, full_ddp)[4]
        assert not bool(ok[1]) and bool(ok[0]) and bool(ok[2:].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 2, 128, 2048])
@pytest.mark.parametrize("model", ["car_parking", "brachistochrone_hli"])
def test_emit_kernel_per_lane_params(cuda, model, B, dtype):
    N = 20
    _, args = _operands(model, dtype, cuda, N=N, B=B)
    full_ddp = model == "car_parking"
    lanes_np, rows_np = fleet({k: v.cpu().double().numpy()
                               for k, v in args[-1].items()}, B, model)
    lanes = lanes_last(ddp.to_torch(lanes_np, dtype, cuda), B)
    items = ce.items_per_point(args[0].n_x, args[0].n_u, full_ddp)
    before = launches.read_launches()
    outs = [ce.emit(*args[:-1], lanes, full_ddp, per=per)
            for per in (1, items)]
    after = launches.read_launches()
    assert after["emit_lane_params"] - before["emit_lane_params"] == 2
    assert after["emit"] - before["emit"] == 2
    flat = lambda o: list(o[0].values()) + list(o[1:])  # lanes last
    for a, b in zip(flat(outs[0]), flat(outs[1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    out = flat(outs[0])
    for r in range(min(4, B)):
        ref = flat(ce.emit(*args[:-1], ddp.to_torch(rows_np[r], dtype, cuda),
                           full_ddp))
        sel = torch.arange(r, B, 4, device=cuda)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a.index_select(-1, sel),
                                       b.index_select(-1, sel), rtol=0,
                                       atol=0, equal_nan=True)
    plain = cm_emit(*args[:-1], lanes, full_ddp)
    for key in _BUNDLE_KEYS:
        _close(outs[0][0][key], plain[0][key], TOL[dtype], key)
    for a, b, key in zip(outs[0][1:], plain[1:],
                         ("final_cx", "final_cxx", "us_cm", "ok")):
        _close(a, b, TOL[dtype], key)


def _many_params_problem():
    """A generated model with 51 fixed params (a 7x7 cost matrix ``Q``,
    ``dt`` and ``r``): more float64 entries than 128 threads' rows fit in
    48 KB of static shared memory, and more than the generator copies to
    registers (its header reads them where they lie, ``TAIL``)."""

    def f(x, u, p, k):
        return torch.stack([
            x[i] + p["dt"] * (x[(i + 1) % 7] + u[i % 2] - p["Q"][i, i] * x[i])
            for i in range(7)])

    def xqx(x, p):
        return sum(p["Q"][i, j] * x[i] * x[j]
                   for i in range(7) for j in range(7))

    def L(x, u, p, k):
        return xqx(x, p) + p["r"] * (u * u).sum(0)

    def F(x, p, k):
        return 10.0 * xqx(x, p)

    a = np.random.default_rng(0).standard_normal((7, 7))
    p = dict(dt=0.05, r=0.1, Q=a @ a.T / 7 + np.eye(7))
    return ddp.make_problem(n_x=7, n_u=2, f=f, L=L, F=F,
                            name="many_params", example_params=p), p


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_emit_generated_model_with_many_params(cuda, dtype):
    """Its library builds; the shared launch and a per-lane one (four rows,
    ``Q`` scaled per row) against ``cm_emit``, and each lane of the
    per-lane launch bit for bit a shared launch on its row."""
    prob, p = _many_params_problem()
    assert codegen.model_for(prob, p).n_params == 51
    B, N = 37, 13
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    xs, us = t(rng.standard_normal((B, N + 1, 7))), t(
        rng.standard_normal((B, N, 2)))
    empty = t(np.zeros((B, N, 0)))
    none = t(np.zeros((B, 0)))
    w = t(rng.uniform(0.5, 40.0, B))
    ops = (prob, xs, us, empty, empty, none, none, w, w)
    rows = [dict(p, Q=p["Q"] * (1.0 + 0.25 * r)) for r in range(4)]
    shared = [ddp.to_torch(q, dtype, cuda) for q in rows]
    lanes = lanes_last(ddp.to_torch(
        {k: np.stack([rows[b % 4][k] for b in range(B)]) for k in p},
        dtype, cuda), B)
    flat = lambda o: list(o[0].values()) + list(o[1:])  # lanes last
    for params in (shared[0], lanes):
        out, ref = ce.emit(*ops, params, True), cm_emit(*ops, params, True)
        for key in _BUNDLE_KEYS:
            _close(out[0][key], ref[0][key], TOL[dtype], key)
        for a, b, key in zip(out[1:], ref[1:],
                             ("final_cx", "final_cxx", "us_cm", "ok")):
            _close(a, b, TOL[dtype], key)
    out = flat(ce.emit(*ops, lanes, True))
    for r in range(4):
        ref = flat(ce.emit(*ops, shared[r], True))
        sel = torch.arange(r, B, 4, device=cuda)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a.index_select(-1, sel),
                                       b.index_select(-1, sel), rtol=0,
                                       atol=0, equal_nan=True)


def test_emit_wrapper_raises(cuda):
    prob, args = _operands("car_parking", torch.float32, cuda, N=5, B=4)
    # per-lane params of another width than the operands'
    lane = LaneParams({k: v[..., None].expand(*v.shape, 3)
                       for k, v in args[-1].items()})
    with pytest.raises(ValueError, match="per-lane"):
        ce.emit(*args[:-1], lane, True)
    with pytest.raises(ValueError, match="per="):
        ce.emit(*args, True, per=0)
    with pytest.raises(ValueError, match="shape"):
        ce.emit(prob, args[1][:, :3], *args[2:], True)
    half = [a.half() if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(TypeError):
        ce.emit(*half, True)


def test_emit_raises_where_no_kernel_exists(cuda):
    """On a card the kernel path needs a CUDA model, hand-written or
    generated, as B2 and B3 do: for a problem the generator cannot write
    (``erf``) the wrapper and a kernel-path solve with the serial line
    search raise, naming the op; nothing falls back to the torch
    emitter."""
    prob, args = _operands("car_parking", torch.float64, cuda, N=5, B=4)
    L = prob.L
    unsupported = dataclasses.replace(
        prob, cuda_model=None,
        L=lambda x, u, p, k: L(x, u, p, k) + 0.0 * torch.erf(u[0]))
    with pytest.raises(NotImplementedError, match="erf"):
        ce.emit(unsupported, *args[1:], True)
    _, opts, x0s, u0s, p = _car(4, T=5)
    opts = dataclasses.replace(opts, dtype="float64",
                               linesearch_method="serial")
    solver = ddp.StepwiseSolver(unsupported, opts, device=cuda)
    with pytest.raises(NotImplementedError, match="erf"):
        solver(x0s, u0s, p)


def _car(B, T=500, seed=5):
    p, x0, _ = car_parking.default_setup(T=T)
    rng = np.random.default_rng(seed)
    x0s = np.tile(x0, (B, 1)) + 0.05 * rng.standard_normal((B, 4))
    u0s = 0.1 * rng.standard_normal((B, T, 2))
    opts = ddp.SolverOptions(max_iter=200, dtype="float32", tolFun=1e-5,
                             debug_level=0, backpass_method="kernel",
                             linesearch_method="kernel")
    return car_parking.car_parking(), opts, x0s, u0s, p


def _solve(cuda, B):
    problem, opts, x0s, u0s, p = _car(B)
    solver = ddp.StepwiseSolver(problem, opts, chunk=10, compact_levels=4,
                                min_compact_batch=128, device=cuda)
    solver.precompile(x0s, u0s, p)
    launches.reset_launches()
    sol = solver(x0s, u0s, p)
    return sol, launches.read_launches()


def test_stepwise_solve_through_the_kernel_matches_torch_emitter(
        cuda, monkeypatch):
    """CarParking, B=1024, T=500, float32: the solved share within 1 point
    and the median iterations within 5% of the torch emitter's solve, and
    the graphed solve counts one emission launch per B1 launch."""
    sol, counts = _solve(cuda, 1024)
    assert counts["emit"] == counts["backpass"] > 0
    monkeypatch.setattr(ce, "emit",
                        lambda *a, when=None, per=None: cm_emit(*a))
    ref, ref_counts = _solve(cuda, 1024)
    assert ref_counts["emit"] == 0
    solved = lambda s: 100.0 * float(((s.status == 1) | (s.status == 2))
                                     .double().mean())
    assert abs(solved(sol) - solved(ref)) <= 1.0, (solved(sol), solved(ref))
    its = lambda s: float(s.iterations.double().median())
    assert abs(its(sol) - its(ref)) <= 0.05 * its(ref), (its(sol), its(ref))
