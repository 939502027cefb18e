"""Kernels B1, B2 and B3 on a CUDA card against their plain PyTorch versions.

Covers every instantiation the solve at full width does not reach: B1 at
each (n_x, n_u) pair of ``KERNEL_SHAPES`` with regType 1/2 and FULL_DDP
on/off in float32 and float64, B2 in both modes with alpha 0 lanes and a
lane whose rollout turns NaN (CarParking and Cartpole), and B3 for every
CUDA model of ``codegen.KERNEL_MODELS`` with regType 1/2 and FULL_DDP on/off
in both dtypes, with a lane that fails and a lane whose derivatives are not
finite.  A problem without a CUDA model runs its generated one (bit for bit
the hand-written model's outputs on CarParking), B1 at a shape outside
``KERNEL_SHAPES`` is built, and what cannot be built raises.  ``B`` is not
a multiple of the lanes per block, so the ragged last block is
exercised; the ``*_ragged`` cases of B1, B2 and B3 also take ``B = G+3``,
``N = 2S+1`` (a last time tile of one step) and ``B = 128``, the smallest
compaction width, with ``G`` and ``S`` read from the built kernel.  B2's
stage flag: a stage whose flag is 0 writes nothing.  ``StepwiseSolver``'s
CUDA graphs: the graphed solve equals the eager one bit for bit on the
kernel and fused paths (B=64), and on the serial, parallel and per-lane
routes (``tests/test_torch_graphs.py``'s ``ROUTES``), and a capture error
raises.  Device loops (``ops/device_loop.py``): the whole
``make_batched_solver`` solve as one graph with a WHILE node equals the
``eager_loops()`` solve bit for bit on the kernel, fused, serial/Newton
and inline routes (B=64, ragged lanes), ``StepwiseSolver`` graphs the
inline and Newton routes, a WHILE nested two deep equals its host loop,
and a CUDA older than 12.4 raises.  The initial rollout on B2:
``init_fn``'s carry equals the carry through ``forward_pass`` within B2's
limits (both benchmark configurations, B=1 and 2,048), and a whole-solve
graph counts one ``init_rollout`` a replay.  Needs
a CUDA device and ``nvcc``;
skips elsewhere.  The file imports no JAX, so on a machine without it run
it past ``tests/conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider \\
        -o "markers=cuda: needs a CUDA device" -m cuda -q \\
        tests/test_torch_cuda_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import ddp_generator_tpu_torch as ddp
from ddp_generator_tpu_torch import codegen
from ddp_generator_tpu_torch.launches import read_launches
from ddp_generator_tpu_torch.models import (
    brachistochrone,
    car_parking,
    cartpole,
)
from ddp_generator_tpu_torch.ops import cuda_backpass as cb
from ddp_generator_tpu_torch.ops import cuda_fused as cf
from ddp_generator_tpu_torch.ops import cuda_rollout as cr
from ddp_generator_tpu_torch.ops import device_loop as dl
from ddp_generator_tpu_torch.ops.device_loop import eager_loops
from ddp_generator_tpu_torch.ops.forward import forward_pass
from test_torch_graphs import ROUTES, route_case

pytestmark = pytest.mark.cuda

B, N = 300, 20
# Kernel and plain version run the same IEEE operations in the same order
# (the kernels are built without FMA contraction); what is left is the
# rounding of transcendentals, relative to the largest reference value.
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B1/B2/B3 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, tol, name):
    assert out.shape == ref.shape, name
    if out.dtype == torch.bool:
        assert torch.equal(out, ref), name
        return
    scale = max(1.0, float(ref[torch.isfinite(ref)].abs().max()))
    torch.testing.assert_close(out, ref, rtol=0, atol=tol * scale,
                               equal_nan=True, msg=name)


def _bundle(rng, n_x, n_u, full_ddp, dtype, dev, N=N, B=B):
    """A random packed CM bundle ``{field: (C, N, B)}``; lane 3 has a
    strongly indefinite cuu at step 2, so its pass fails there, and input
    0 of lane 1 has no bounds (where the width holds those lanes)."""
    def r(c, scale=1.0):
        return scale * rng.standard_normal((c, N, B))

    def spd_packed(n):
        a = rng.standard_normal((N, B, n, n))
        m = np.einsum("...ij,...kj->...ik", a, a) + 3.0 * np.eye(n)
        return np.stack([m[..., i, j] for i in range(n) for j in range(i, n)])

    fx = r(n_x * n_x, 0.4)
    for i in range(n_x):
        fx[i * n_x + i] += 1.0
    lower = r(n_u, 0.5) - 1.0
    upper = lower + 0.3 + np.abs(r(n_u))
    if B > 1:
        lower[0, :, 1], upper[0, :, 1] = -np.inf, np.inf
    tx, tu = cb.tri_size(n_x), cb.tri_size(n_u)
    sd = dict(
        fx=fx, fu=r(n_x * n_u, 0.4), cx=r(n_x), cu=r(n_u),
        cxx=spd_packed(n_x), cuu=spd_packed(n_u), cxu=r(n_x * n_u, 0.2),
        fxx=r(n_x * tx, 0.05) if full_ddp else r(0),
        fuu=r(n_x * tu, 0.05) if full_ddp else r(0),
        fxu=r(n_x * n_x * n_u, 0.05) if full_ddp else r(0),
        lower=lower, upper=upper, lower_hx=r(n_u * n_x, 0.3),
        upper_hx=r(n_u * n_x, 0.3), lower_sign=-np.ones((n_u, N, B)),
        upper_sign=np.ones((n_u, N, B)))
    for i in range(n_u if B > 3 else 0):
        sd["cuu"][cb.tri_index(i, i, n_u), 2, 3] = -1e4
    a = rng.standard_normal((B, n_x, n_x))
    fcxx = (np.einsum("bij,bkj->bik", a, a) + 3 * np.eye(n_x)).reshape(B, -1).T
    lam = np.abs(rng.standard_normal((1, B))) * 0.1
    t = lambda v: torch.as_tensor(np.ascontiguousarray(v), dtype=dtype,
                                  device=dev)
    return ({k: t(v) for k, v in sd.items()}, t(r(n_x)[:, 0]), t(fcxx),
            t(r(n_u)), t(lam))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("full_ddp", [True, False], ids=["full", "gn"])
@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("n_x,n_u", cb.KERNEL_SHAPES + ((6, 3),))
def test_backpass_kernel_matches_plain(cuda, n_x, n_u, reg_type, full_ddp,
                                       dtype):
    rng = np.random.default_rng(100 * n_x + 10 * n_u + reg_type)
    sd, fcx, fcxx, us, lam = _bundle(rng, n_x, n_u, full_ddp, dtype, cuda)
    args = (sd, fcx, fcxx, us, lam, n_x, reg_type, full_ddp)
    before = read_launches()
    out = cb.back_pass_cm(*args)
    torch.cuda.synchronize()
    assert read_launches() == {**before, "backpass": before["backpass"] + 1}
    ref = cb.back_pass_cm_plain(*args)
    assert bool(ref[4][0, 3]) and not bool(ref[4].all())
    for name, o, r in zip(("l", "L", "dV", "g_norm", "failed"), out, ref):
        _close(o, r, TOL[dtype], name)


# Ragged edges of the staged kernels (csrc/staged.cuh): the last block
# holds 3 lanes, the last time tile one step, the width is the smallest
# the compaction reaches, or one problem or two (one block, its other
# lanes idle).
EDGES = ("lanes_G+3", "steps_2S+1", "width_128", "width_1", "width_2")


def _edge_shape(edge, info):
    """(B, N) of an edge case for a kernel of tile shape ``info``."""
    return {"lanes_G+3": (info["G"] + 3, N),
            "steps_2S+1": (B, 2 * info["S"] + 1),
            "width_128": (128, N), "width_1": (1, N),
            "width_2": (2, N)}[edge]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("edge", EDGES)
def test_backpass_kernel_ragged(cuda, edge, dtype):
    Bv, Nv = _edge_shape(edge, cb.kernel_info(4, 2, 1, True, dtype))
    rng = np.random.default_rng(5)
    sd, fcx, fcxx, us, lam = _bundle(rng, 4, 2, True, dtype, cuda, N=Nv,
                                     B=Bv)
    args = (sd, fcx, fcxx, us, lam, 4, 1, True)
    out = cb.back_pass_cm(*args)
    torch.cuda.synchronize()
    ref = cb.back_pass_cm_plain(*args)
    assert Bv < 4 or (bool(ref[4][0, 3]) and not bool(ref[4].all()))
    for name, o, r in zip(("l", "L", "dV", "g_norm", "failed"), out, ref):
        _close(o, r, TOL[dtype], name)


@pytest.mark.parametrize("n_x,n_u,P", [(4, 2, 4), (4, 1, 4), (1, 1, 4),
                                       (6, 3, 4)])
def test_backpass_kernel_info_reports_group_size(cuda, n_x, n_u, P):
    """Threads per lane: the consumer warp's 32 over its 8 lanes.  Local
    memory: at the built-in shapes no more than the stack frame of the
    division slow path's call (64 B; ptxas reports no spill), and at (6, 3)
    no more than the 1,016 B that one thread a lane took."""
    for dtype in (torch.float32, torch.float64):
        for reg_type, full_ddp in ((1, True), (2, False)):
            info = cb.kernel_info(n_x, n_u, reg_type, full_ddp, dtype)
            assert info["P"] == P and info["G"] == 8, info
            limit = 64 if (n_x, n_u) in cb.KERNEL_SHAPES else 1016
            assert info["local_bytes"] <= limit, info


def _rollout_operands(dtype, dev, N=N, B=B, model="car_parking"):
    rng = np.random.default_rng(7)
    if model == "car_parking":
        problem = car_parking.car_parking()
        p_np, x0, _ = car_parking.default_setup(T=N, seed=0)
        x0s = np.tile(x0, (B, 1)) + 0.05 * rng.standard_normal((B, 4))
        u0s = 0.1 * rng.standard_normal((B, N, 2))
        if B > 5:  # lane 5: the rollout turns NaN
            x0s[5, 3], u0s[5, :, 0] = 1e4, 0.3
    else:
        problem = cartpole.cartpole()
        p_np, x0, _ = cartpole.default_setup(T=N, seed=0)
        x0s = np.tile(x0, (B, 1)) + 0.05 * rng.standard_normal((B, 4))
        u0s = 10.0 * rng.standard_normal((B, N, 1))  # some past +-15
        if B > 5:
            x0s[5, 1] = np.inf  # lane 5: sin(inf), the rollout turns NaN
    n_u = problem.n_u
    p = ddp.params_from_jax(p_np, dtype, dev)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)
    m = ddp.init_multipliers(problem, B, N, dtype, dev)
    w = torch.ones(B, dtype=dtype, device=dev)
    nom = forward_pass(problem, t(x0s), None, t(u0s), None, None, 0.0, p,
                       m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w, w)
    l = t(0.1 * rng.standard_normal((B, N, n_u)))
    L = t(0.05 * rng.standard_normal((B, N, n_u, 4)))
    ctx = cr._LSCtx(problem, nom.xs[:, 0], nom.xs, nom.us, l, L, None, None,
                    m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w, w)
    alphas = tuple(ddp.SolverOptions().alpha)
    alpha_vec = rng.choice(alphas + (0.0,), B)
    alpha_vec[:2] = 0.0
    ops = (problem, alphas, ctx.xnom_cm, ctx.unom_cm, ctx.l_cm, ctx.L_cm,
           ctx.mu_le_cm, ctx.mu_li_cm, ctx.x0_cm, ctx.wpl, ctx.wpf,
           ctx.mu_fe_cm, ctx.mu_fi_cm)
    return ops, t(alpha_vec)[None].contiguous(), p


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["multi", "selected", "selected_cost"])
def test_rollout_kernel_matches_plain(cuda, mode, dtype):
    _check_rollout(cuda, mode, dtype, "car_parking")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["multi", "selected", "selected_cost"])
def test_rollout_kernel_matches_plain_cartpole(cuda, mode, dtype):
    """Cartpole's instantiation of B2 (n_u = 1, sin/cos in f)."""
    _check_rollout(cuda, mode, dtype, "cartpole")


def _check_rollout(cuda, mode, dtype, model):
    ops, alpha_vec, p = _rollout_operands(dtype, cuda, model=model)
    kw = dict(multi=mode == "multi", want_cost=mode == "selected_cost")
    av = None if mode == "multi" else alpha_vec
    before = read_launches()
    out = cr.rollout_call(*ops, av, p, **kw)
    torch.cuda.synchronize()
    key = "rollout_multi" if mode == "multi" else "rollout_selected"
    assert read_launches() == {**before, key: before[key] + 1}
    ref = cr.rollout_plain(*ops, av, p, **kw)
    assert len(out) == len(ref)
    for i, (o, r) in enumerate(zip(out, ref)):
        _close(o, r, TOL[dtype], f"{mode} output {i}")
    if mode != "selected":
        ok = out[-1]
        assert not bool(ok[:, 5].any()) and bool(ok[:, :5].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["multi", "selected", "selected_cost"])
@pytest.mark.parametrize("edge", EDGES)
def test_rollout_kernel_ragged(cuda, edge, mode, dtype):
    """B2's ragged edges (csrc/rollout.cuh): a last block of 3 lanes, a
    last time tile of one step, the smallest compaction width; in the
    sweep one alpha more than a block rolls."""
    kw = dict(multi=mode == "multi", want_cost=mode == "selected_cost")
    Bv, Nv = _edge_shape(edge, cr.kernel_info("car_parking", dtype=dtype,
                                              **kw))
    ops, alpha_vec, p = _rollout_operands(dtype, cuda, N=Nv, B=Bv)
    alphas = tuple(np.logspace(0, -3, 9))
    ops = (ops[0], alphas) + ops[2:]
    av = None if mode == "multi" else alpha_vec
    out = cr.rollout_call(*ops, av, p, **kw)
    torch.cuda.synchronize()
    ref = cr.rollout_plain(*ops, av, p, **kw)
    assert len(out) == len(ref)
    for i, (o, r) in enumerate(zip(out, ref)):
        _close(o, r, TOL[dtype], f"{edge} {mode} output {i}")
    if mode != "selected" and Bv > 5:
        ok = out[-1]
        assert not bool(ok[:, 5].any()) and bool(ok[:, :5].all())


def _same(a, b):
    """Equal bit for bit, NaN where the other is NaN (a lane of these
    operands turns NaN)."""
    if a.dtype.is_floating_point:
        return a.shape == b.shape and bool(
            ((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


def _unsupported(problem):
    """``problem`` with no CUDA model and a running cost the generator
    cannot write (``erf``)."""
    L = problem.L
    return dataclasses.replace(
        problem, cuda_model=None,
        L=lambda x, u, p, k: L(x, u, p, k) + 0.0 * torch.erf(u[0]))


def test_wrappers_raise_where_no_kernel_exists(cuda):
    """B1 builds any shape with n_u <= 3 and raises above; B2 runs the
    generated model of a problem without one (bit for bit the hand-written
    model's outputs on CarParking) and raises, naming the op, where the
    generator cannot write the problem."""
    rng = np.random.default_rng(1)
    sd, fcx, fcxx, us, lam = _bundle(rng, 3, 2, True, torch.float64, cuda)
    out = cb.back_pass_cm(sd, fcx, fcxx, us, lam, 3, 1, True)  # (3, 2)
    torch.cuda.synchronize()
    ref = cb.back_pass_cm_plain(sd, fcx, fcxx, us, lam, 3, 1, True)
    assert torch.equal(out[4], ref[4])
    with pytest.raises(ValueError, match="n_u <= 3"):
        cb.library(3, 4)
    ops, alpha_vec, p = _rollout_operands(torch.float64, cuda)
    no_model = dataclasses.replace(ops[0], cuda_model=None)
    gen = cr.rollout_call(no_model, *ops[1:], alpha_vec, p, multi=False)
    hand = cr.rollout_call(*ops, alpha_vec, p, multi=False)
    assert all(_same(a, b) for a, b in zip(gen, hand))
    with pytest.raises(NotImplementedError, match="erf"):
        cr.rollout_call(_unsupported(ops[0]), *ops[1:], alpha_vec, p,
                        multi=False)


def _fused_operands(model, dtype, dev, N=N, B=B):
    """A nominal rollout of B lanes over N steps with random AL inputs.
    Lane 3 fails (lambda far below zero makes Quu indefinite); lane 5's
    derivatives are not finite (where the width holds those lanes)."""
    rng = np.random.default_rng(21)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)
    if model == "car_parking":
        problem = car_parking.car_parking()
        p_np, x0, _ = car_parking.default_setup(T=N, seed=0)
        x0s = np.tile(x0, (B, 1)) + 0.05 * rng.standard_normal((B, 4))
        x0s[:, 3] += rng.uniform(0.5, 2.0, B)
        u0s = 0.3 * rng.standard_normal((B, N, 2))
        if B > 5:
            x0s[5, 3], u0s[5, :, 0] = 1e4, 0.3  # NaN rollout
    elif model == "cartpole":
        problem = cartpole.cartpole()
        p_np, x0, _ = cartpole.default_setup(T=N, seed=0)
        x0s = np.tile(x0, (B, 1)) + 0.3 * rng.standard_normal((B, 4))
        u0s = 10.0 * rng.standard_normal((B, N, 1))  # some past +-15
        if B > 5:
            x0s[5, 1] = np.inf  # sin(inf): NaN rollout
    else:
        problem = getattr(brachistochrone, model)()
        setup = (brachistochrone.default_setup if model == "brachistochrone"
                 else brachistochrone.default_setup_hli)
        p_np, x0, _ = setup(N)
        x0s = np.tile(x0, (B, 1)) - rng.uniform(0.0, 0.5, (B, 1))
        u0s = -np.abs(rng.uniform(0.5, 1.5, (B, N, 1)))
        if B > 5:
            x0s[5, 0] = 0.5  # y > 0: sqrt(-y) is NaN in L
    p = ddp.params_from_jax(p_np, dtype, dev)
    m = ddp.init_multipliers(problem, B, N, dtype, dev)
    w = torch.ones(B, dtype=dtype, device=dev)
    nom = forward_pass(problem, t(x0s), None, t(u0s), None, None, 0.0, p,
                       m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w, w)
    mu = lambda *s: t(rng.uniform(0.2, 2.0, s))
    lam = np.abs(rng.standard_normal(B)) * 0.1
    if B > 3:
        lam[3] = -1e3
    return (problem, nom.xs, nom.us, mu(B, N, problem.n_hle),
            mu(B, N, problem.n_hli), t(rng.standard_normal((B, problem.n_hfe))),
            mu(B, problem.n_hfi), t(rng.uniform(1.0, 40.0, B)),
            t(rng.uniform(1e-3, 1.0, B)), t(lam), p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("full_ddp", [True, False], ids=["full", "gn"])
@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("model", codegen.KERNEL_MODELS)
def test_fused_kernel_matches_plain(cuda, model, reg_type, full_ddp, dtype):
    args = _fused_operands(model, dtype, cuda) + (reg_type, full_ddp)
    before = read_launches()
    bp, ok = cf.fused_derivs_back_pass(*args)
    torch.cuda.synchronize()
    assert read_launches() == {**before, "fused": before["fused"] + 1}
    ref, ref_ok = cf.fused_derivs_back_pass_plain(*args)
    assert torch.equal(ok, ref_ok)
    assert not bool(ok[5]) and int(ok.sum()) == B - 1
    assert torch.equal(bp.failed, ref.failed)
    assert bool(ref.failed[3])
    live = ok  # the solver reads no other output of a lane whose
    #            derivatives are not finite
    for name in ("l", "L", "dV", "g_norm"):
        _close(getattr(bp, name)[live], getattr(ref, name)[live],
               TOL[dtype], name)


def test_fused_wrapper_raises_where_no_kernel_exists(cuda):
    """B3 on a problem without a CUDA model runs its generated model (bit
    for bit the hand-written one's outputs on CarParking); an op the
    generator cannot write and a bad regType raise."""
    args = list(_fused_operands("car_parking", torch.float64, cuda))
    no_model = dataclasses.replace(args[0], cuda_model=None)
    gen, gen_ok = cf.fused_derivs_back_pass(no_model, *args[1:], 1, True)
    hand, hand_ok = cf.fused_derivs_back_pass(*args, 1, True)
    assert torch.equal(gen_ok, hand_ok)
    for name in ("l", "L", "dV", "g_norm", "failed"):
        assert _same(getattr(gen, name), getattr(hand, name)), name
    with pytest.raises(NotImplementedError, match="erf"):
        cf.fused_derivs_back_pass(_unsupported(args[0]), *args[1:], 1, True)
    with pytest.raises(ValueError, match="reg_type"):
        cf.fused_derivs_back_pass(*args, 3, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("edge", EDGES)
def test_fused_kernel_ragged(cuda, edge, dtype):
    Bv, Nv = _edge_shape(edge, cf.kernel_info("car_parking", 1, True, dtype))
    args = _fused_operands("car_parking", dtype, cuda, N=Nv, B=Bv) + (1, True)
    bp, ok = cf.fused_derivs_back_pass(*args)
    torch.cuda.synchronize()
    ref, ref_ok = cf.fused_derivs_back_pass_plain(*args)
    assert torch.equal(ok, ref_ok) and int(ok.sum()) == Bv - (Bv > 5)
    assert torch.equal(bp.failed, ref.failed)
    assert Bv < 4 or bool(ref.failed[3])
    for name in ("l", "L", "dV", "g_norm"):
        _close(getattr(bp, name)[ok], getattr(ref, name)[ok], TOL[dtype],
               name)


@pytest.mark.parametrize("multi", [True, False], ids=["multi", "selected"])
def test_rollout_stage_flag_skips_the_kernel(cuda, multi):
    """B2 with its stage flag at 0 writes none of its NaN-filled outputs;
    at 1 it writes what the unflagged wrapper returns.  The wrapper counts
    the flag's value as its launch."""
    import ctypes

    from ddp_generator_tpu_torch import _build, launches

    ops, alpha_vec, p = _rollout_operands(torch.float64, cuda)
    problem, alphas = ops[0], ops[1]
    kw = dict(multi=True) if multi else dict(multi=False, want_cost=True)
    av = None if multi else alpha_vec
    ref = cr.rollout_call(*ops, av, p, **kw)
    xnom = ops[2]
    N_, n_x, B_ = xnom.shape
    A = len(alphas)
    rows = A if multi else 1
    nan = lambda *sh: torch.full(sh, float("nan"), dtype=xnom.dtype,
                                 device=cuda)
    outs = [nan(rows, B_), torch.zeros((rows, B_), dtype=torch.bool,
                                       device=cuda)]
    outs += [None] * 3 if multi else [nan(N_, n_x, B_), nan(n_x, B_),
                                      nan(N_, problem.n_u, B_)]
    al = (torch.tensor(alphas, dtype=xnom.dtype, device=cuda) if multi
          else alpha_vec)
    lib = _build.load_library()
    for flag in (0, 1):
        run = torch.full((1,), flag, dtype=torch.int32, device=cuda)
        ptrs = _build.pointer_array(
            list(ops[2:6]) + [None, None] + list(ops[8:11]) + [None, None, al,
            problem.cuda_model.flat_params(p, xnom.dtype, cuda, N_)]
            + outs + [run])
        rc = lib.ddp_rollout(1, b"car_parking", int(multi), 1, N_, B_, A,
                             cr.BLOCK, ptrs,
                             ctypes.c_void_p(torch.cuda.current_stream()
                                             .cuda_stream))
        _build.check(lib, rc, "rollout")
        torch.cuda.synchronize()
        written = [t for t in outs if t is not None]
        if flag == 0:
            assert all(bool(t.isnan().all()) for t in written
                       if t.dtype != torch.bool)
            assert not bool(outs[1].any())
        else:
            want = ref if multi else (ref[3], ref[4], *ref[:3])
            for a, b in zip(written, want):  # lane 5 is NaN on both
                torch.testing.assert_close(a, b, rtol=0, atol=0,
                                           equal_nan=True)
    launches.reset_launches()
    for flag in (0, 1, 1):
        run = torch.full((1,), flag, dtype=torch.int32, device=cuda)
        cr.rollout_call(*ops, av, p, run=run, **kw)
    key = "rollout_multi" if multi else "rollout_selected"
    assert launches.read_launches()[key] == 2


def _graph_case(backpass, B=64, T=60):
    p, x0, _ = car_parking.default_setup(T=T)
    rng = np.random.default_rng(2)
    x0s = np.tile(x0, (B, 1)) + 0.05 * rng.standard_normal((B, 4))
    u0s = 0.1 * rng.standard_normal((B, T, 2))
    opts = ddp.SolverOptions(max_iter=40, dtype="float32", tolFun=1e-5,
                             debug_level=0, backpass_method=backpass,
                             linesearch_method="kernel")
    return car_parking.car_parking(), opts, x0s, u0s, p


@pytest.mark.parametrize("backpass", ["kernel", "fused"])
def test_graphed_stepwise_equals_eager(cuda, backpass):
    """The precompiled graphed StepwiseSolver (widths 64, 32, 16) gives
    every Solution field of make_batched_solver bit for bit, ran every
    width graphed, and a second call neither changes the first result
    (no aliasing of the static carries) nor its own."""
    problem, opts, x0s, u0s, p = _graph_case(backpass)
    with eager_loops():
        ref = ddp.make_batched_solver(problem, opts, device=cuda)(x0s, u0s, p)
    solver = ddp.StepwiseSolver(problem, opts, chunk=4, compact_levels=2,
                                min_compact_batch=16, device=cuda)
    assert solver.precompile(x0s, u0s, p) > 0
    sol = solver(x0s, u0s, p)
    first = [t.clone() for t in sol]
    st = solver.last_stats
    assert st.eager == () and st.replays == st.body_calls > 0
    assert set(st.graphed) <= {64, 32, 16} and 64 in st.graphed
    again = solver(x0s, u0s, p)
    for name, a, b, c, d in zip(sol._fields, sol, ref, first, again):
        assert torch.equal(a, b), name
        assert torch.equal(a, c), name
        assert torch.equal(d, b), name


@pytest.mark.parametrize("route", [r for r in ROUTES
                                   if r not in ("kernel", "fused")])
def test_graphed_routes_equal_eager(cuda, route):
    """Each route graphed beside the kernel and fused paths, precompiled
    (widths 64, 32, 16), gives every Solution field of make_batched_solver
    bit for bit, every width graphed."""
    problem, opts, x0s, u0s, p, lanes = route_case(ROUTES[route], 64, 40)
    with eager_loops():
        ref = ddp.make_batched_solver(problem, opts, lanes, device=cuda)(
            x0s, u0s, p)
    solver = ddp.StepwiseSolver(problem, opts, chunk=3, batch_params=lanes,
                                compact_levels=2, min_compact_batch=16,
                                device=cuda)
    assert solver.precompile(x0s, u0s, p) > 0
    sol = solver(x0s, u0s, p)
    st = solver.last_stats
    assert st.eager == () and st.replays == st.body_calls > 0
    for name, a, b in zip(sol._fields, sol, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=name)


def _loop_case(route, B=64, T=40):
    """A B=64 CarParking workload with ragged lanes (perturbed starts,
    controls of per-lane scale, three lanes retired at init) on a device
    loop route: ``(problem, options, x0s, u0s, params)``."""
    p, x0, _ = car_parking.default_setup(T=T)
    rng = np.random.default_rng(5)
    x0s = np.tile(x0, (B, 1)) + 0.3 * rng.standard_normal((B, 4))
    x0s[[1, 6, 11], 0] = np.nan
    u0s = ((0.05 + 0.5 * rng.random((B, 1, 1)))
           * rng.standard_normal((B, T, 2)))
    kw = {"kernel": dict(backpass_method="kernel", linesearch_method="kernel",
                         dtype="float32", tolFun=1e-5),
          "fused": dict(backpass_method="fused", linesearch_method="kernel",
                        dtype="float32", tolFun=1e-5),
          "serial_newton": dict(boxqp_method="newton", dtype="float64"),
          "inline": dict(backpass_method="kernel", linesearch_method="kernel",
                         lam_retry="inline", full_ddp=True,
                         dtype="float64")}[route]
    if route == "inline":  # FULL_DDP from large controls: lambda retries
        u0s = 4.0 * rng.standard_normal((B, T, 2))
    opts = ddp.SolverOptions(max_iter=30, debug_level=0, **kw)
    return car_parking.car_parking(), opts, x0s, u0s, p


@pytest.mark.parametrize("route", ["kernel", "fused", "serial_newton",
                                   "inline"])
def test_device_loop_solve_equals_eager(cuda, route):
    """``make_batched_solver`` on the card: the first call captures the
    solve (a WHILE node), every call is one replay; every Solution field
    equals the ``eager_loops()`` solve bit for bit, twice (a second replay
    does not alias the first result), and the graphed ``StepwiseSolver``
    (its Newton and inline routes now graphed too) equals it as well."""
    problem, opts, x0s, u0s, p = _loop_case(route)
    with eager_loops():
        ref = ddp.make_batched_solver(problem, opts, device=cuda)(
            x0s, u0s, p)
    solve = ddp.make_batched_solver(problem, opts, device=cuda)
    sol = solve(x0s, u0s, p)
    st = solve.last_stats
    assert st.graphed and st.captured
    g = next(iter(solve.graphs.values()))
    assert g.nodes["while_nodes"] >= 1
    if route in ("serial_newton", "inline"):  # nested loops
        assert g.nodes["while_nodes"] >= 2
    first = [t.clone() for t in sol]
    again = solve(x0s, u0s, p)
    assert not solve.last_stats.captured
    stepwise = ddp.StepwiseSolver(problem, opts, chunk=4, compact_levels=2,
                                  min_compact_batch=16, device=cuda)
    sw = stepwise(x0s, u0s, p)
    assert stepwise.last_stats.eager == ()
    assert stepwise.last_stats.replays == stepwise.last_stats.body_calls
    if route == "inline":
        assert int(ref.bp_retry_calls.sum()) > 0
    for name, a, b, c, d, e in zip(sol._fields, sol, ref, first, again, sw):
        for x, what in ((a, "graph"), (d, "second replay"),
                        (e, "StepwiseSolver")):
            torch.testing.assert_close(x, b, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{name} ({what})")
        torch.testing.assert_close(a, c, rtol=0, atol=0, equal_nan=True,
                                   msg=name)


def test_while_nested_two_deep_equals_host_loop(cuda):
    """A WHILE inside a WHILE body, the inner trip count read from a device
    table at the outer counter, replayed at several outer counts against
    the same loops run on the host."""
    dev = torch.device(cuda)
    m = torch.tensor(3, device=dev, dtype=torch.int32)
    lens = torch.tensor([2, 0, 4, 1, 7], device=dev, dtype=torch.int32)

    def outer(c):
        acc, j = c
        nj = lens.gather(0, j.long().reshape(1))[0]

        def inner(d):
            a, i = d
            return (a + torch.zeros_like(a)
                    + (j + 1).to(a.dtype) * (i + 1).to(a.dtype), i + 1)

        acc, _ = dl.while_loop(lambda d: d[1] < nj, inner,
                               (acc, torch.zeros_like(j)))
        return (acc, j + 1)

    def loop():
        return dl.while_loop(
            lambda c: c[1] < m, outer,
            (torch.zeros(3, device=dev, dtype=torch.float64),
             torch.zeros((), device=dev, dtype=torch.int32)))

    loop()  # warm-up, on the host
    pool, g = dl.BodyPool(dev), torch.cuda.CUDAGraph()
    # the bodies' streams are their own: torch's pool hands out 32 a
    # device round robin, so two of its streams may be one
    pooled = {torch.cuda.Stream(dev).cuda_stream for _ in range(64)}
    bodies = {s.cuda_stream for (i, _), s in dl._streams.items()
              if i == torch.cuda.current_device()}
    assert len(bodies) == dl.MAX_NESTING and not bodies & pooled
    before = dict(dl.NODE_COUNTS)
    with dl.body_pool(pool), torch.cuda.graph(g):
        out = loop()
    assert dl.NODE_COUNTS["while"] - before["while"] == 2
    for k in (0, 1, 3, 5):
        m.fill_(k)
        g.replay()
        ref = loop()
        assert torch.equal(out[0], ref[0]) and int(out[1]) == k, k


def test_old_cuda_raises(cuda, monkeypatch):
    """A runtime or driver older than 12.4 raises with both numbers, before
    any node is added (the version read mocked)."""
    monkeypatch.setattr(dl, "_checked", [])
    monkeypatch.setattr(dl, "cuda_versions", lambda: (12090, 12020, 12080))
    x = torch.zeros((), device=cuda)
    pool, g = dl.BodyPool(cuda), torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match=r"runtime 12\.2, driver 12\.8"):
        with dl.body_pool(pool), torch.cuda.graph(g):
            dl.while_loop(lambda c: c < 3, lambda c: c + 1, x)
    torch.cuda.synchronize()
    assert pool.captured == 0


def test_capture_error_raises(cuda):
    """A host read inside the body call makes the capture fail, and the
    solver raises instead of running the body eagerly (the kernel
    backward pass with the serial line search, whose rollouts call the
    model's Python ``f``; with the emission kernel and B2 the body calls
    none, and neither does the fused path's)."""
    problem, opts, x0s, u0s, p = _graph_case("kernel", B=16, T=20)
    opts = dataclasses.replace(opts, linesearch_method="serial")
    f = problem.f

    def f_reads_host(x, u, p_, k):
        float(x[0].sum())  # a synchronize: illegal inside a capture
        return f(x, u, p_, k)

    bad = dataclasses.replace(problem, f=f_reads_host)
    solver = ddp.StepwiseSolver(bad, opts, min_compact_batch=16,
                                device=cuda)
    with pytest.raises(RuntimeError):
        solver(x0s, u0s, p)
    torch.cuda.synchronize()


def _emitter(name, dtype, device):
    """``emit(shared)``: the FULL_DDP bundle of the initial rollout of
    the Brachistochrone (``testBrachi.m``, B=2048, n=500, u0 =
    -|uniform(0.5, 1.5)| from seed 11) or CarParking (B=2048, T=500,
    0.1 normal u0 from seed 0), as ``chip_smoke.history_emitter``."""
    from ddp_generator_tpu_torch.ops.cm_derivs import cm_emit

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    Bh, T = 2048, 500
    if name == "brachistochrone":
        problem = brachistochrone.brachistochrone()
        p_np, x0, _ = brachistochrone.default_setup(T)
        u0s = -np.abs(np.random.default_rng(11).uniform(0.5, 1.5,
                                                        (Bh, T, 1)))
    else:
        problem = car_parking.car_parking()
        p_np, x0, _ = car_parking.default_setup(T=T, seed=0)
        u0s = 0.1 * np.random.default_rng(0).standard_normal((Bh, T, 2))
    p = ddp.params_from_jax(p_np, dtype, device)
    x0s = torch.as_tensor(np.tile(x0, (Bh, 1)).astype(np_dtype),
                          device=device)
    u0 = torch.as_tensor(u0s.astype(np_dtype), device=device)
    m = ddp.init_multipliers(problem, Bh, T, dtype, device)
    w = torch.ones(Bh, dtype=dtype, device=device)
    r = forward_pass(problem, x0s, None, u0, None, None, 0.0, p, m.mu_le,
                     m.mu_li, m.mu_fe, m.mu_fi, w, w)

    def emit(shared):
        sd, fcx, fcxx, _, ok = cm_emit(problem, r.xs, r.us, m.mu_le,
                                       m.mu_li, m.mu_fe, m.mu_fi, w, w, p,
                                       True, shared)
        return dict(sd, final_cx=fcx, final_cxx=fcxx, ok=ok)
    return emit


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("shared", [False, True], ids=["per_family",
                                                       "shared"])
@pytest.mark.parametrize("target", ["brachistochrone", "car_parking"])
def test_emission_independent_of_history(cuda, target, shared, dtype):
    """Emit, emit the other problem, emit again: every component equal bit
    for bit (the second order by forward-over-reverse; reverse-over-reverse
    ordered its accumulation by the autograd threads' sequence numbers)."""
    other = ("car_parking" if target == "brachistochrone"
             else "brachistochrone")
    emit = _emitter(target, dtype, cuda)
    first = emit(shared)
    _emitter(other, dtype, cuda)(shared)
    again = emit(shared)
    for key, v in first.items():
        assert torch.equal(v, again[key]), key


@pytest.mark.parametrize("seed", [3600000023, 3600000025])
def test_saved_brachi_lanes_solve_on_the_fused_path(cuda, seed):
    """The two saved brachistochrone_hli lanes that B3 once ended in
    status 5 (``tests/test_torch_dual_host.py``) end through ``solve`` and
    ``StepwiseSolver`` on the fused path as the plain version's CPU solve
    does: a success exit at its cost."""
    from test_torch_dual_host import SAVED_J, SAVED_LANES

    u0 = np.load(SAVED_LANES)[f"u0_{seed}"]
    p, x0, _ = brachistochrone.default_setup_hli(500)
    problem = brachistochrone.brachistochrone_hli()
    opts = ddp.SolverOptions(max_iter=200, w_pen_init_l=40.0,
                             w_pen_init_f=1e-5, w_pen_max_f=1.0,
                             w_pen_fact2=1.0, full_ddp=False,
                             dtype="float64", backpass_method="fused",
                             linesearch_method="kernel")
    sol = ddp.solve(problem, x0, u0, p, opts, device=cuda)
    step = ddp.StepwiseSolver(problem, opts, device=cuda)(
        x0[None], u0[None], p)
    for status, cost in ((sol.status, sol.cost), (step.status[0],
                                                   step.cost[0])):
        assert int(status) in (1, 2)
        assert abs(float(cost) - SAVED_J[seed]) < 1e-9


def _init_case(model, B):
    """The benchmark's two configurations at ``B`` lanes: CarParking on the
    kernel path in float32 (T=500, ``u0 = 0.1 N(0, 1)``, two lanes whose
    start turns the rollout non-finite where ``B > 2``), brachistochrone_hli on the fused
    path in float64 (N=500, ``u0 = -U(0.5, 1.5)``)."""
    rng = np.random.default_rng(19)
    if model == "car_parking":
        p, x0, _ = car_parking.default_setup(T=500)
        x0s = np.tile(x0, (B, 1)) + 0.05 * rng.standard_normal((B, 4))
        if B > 2:
            x0s[B // 2:B // 2 + 2, 3] = 300.0  # |h v sin w| > d: NaN
        u0s = 0.1 * rng.standard_normal((B, 500, 2))
        opts = ddp.SolverOptions(max_iter=200, dtype="float32", tolFun=1e-5,
                                 debug_level=0, backpass_method="kernel",
                                 linesearch_method="kernel")
        return car_parking.car_parking(), opts, x0s, u0s, p
    p, x0, _ = brachistochrone.default_setup_hli(500)
    u0s = -rng.uniform(0.5, 1.5, (B, 500, 1))
    opts = ddp.SolverOptions(max_iter=200, w_pen_init_l=40.0,
                             w_pen_init_f=1e-5, w_pen_max_f=1.0,
                             w_pen_fact2=1.0, full_ddp=False,
                             dtype="float64", backpass_method="fused",
                             linesearch_method="kernel")
    return (brachistochrone.brachistochrone_hli(), opts, np.tile(x0, (B, 1)),
            u0s, p)


# B2 against its plain version (PERF.md's kernel table)
B2_LIMIT = {torch.float32: 1e-6, torch.float64: 1e-14}


@pytest.mark.parametrize("B", [1, 2048])
@pytest.mark.parametrize("model", ["car_parking", "brachistochrone_hli"])
def test_init_fn_on_b2_equals_forward_pass(cuda, monkeypatch, model, B):
    """``init_fn`` on the card rolls the first trajectory as one launch of
    B2 (counted ``init_rollout`` and ``rollout_selected``); its carry
    equals the carry through ``forward_pass`` within B2's limits against
    its plain version, ``status`` (so each lane's ``STATUS_INIT_FAILED``)
    exactly."""
    from ddp_generator_tpu_torch import launches
    from ddp_generator_tpu_torch import solver as slv

    problem, opts, x0s, u0s, p = _init_case(model, B)
    dtype = torch.float32 if opts.dtype == "float32" else torch.float64
    x0 = torch.as_tensor(x0s, device=cuda)
    u0 = torch.as_tensor(u0s, device=cuda)
    carries = {}
    for on_b2 in (True, False):
        monkeypatch.setattr(slv, "_init_on_b2",
                            lambda *a, _v=on_b2: _v)
        init, _, _, cast = slv._make_parts(problem, opts, cuda)
        pc = cast(p, B)
        init(x0, u0, pc)  # builds the kernels
        launches.reset_launches()
        carries[on_b2] = init(x0, u0, pc)
        counts = launches.read_launches()
        assert counts["init_rollout"] == int(on_b2)
        assert counts["rollout_selected"] == int(on_b2)
    out, ref = carries[True], carries[False]
    assert torch.equal(out.status, ref.status)
    assert torch.equal(out.done, ref.done)
    if model == "car_parking" and B > 2:
        assert int((out.status == ddp.STATUS_INIT_FAILED).sum()) == 2
    for name in ("xs", "us", "cost"):
        a, b = getattr(out, name), getattr(ref, name)
        assert a.dtype == dtype
        _close(a, b, B2_LIMIT[dtype], name)
    for a, b in zip(out.mult, ref.mult):
        if b.numel():  # CarParking has no AL family
            _close(a, b, B2_LIMIT[dtype], "mult")


@pytest.mark.parametrize("model", ["car_parking", "brachistochrone_hli"])
def test_captured_solve_rolls_its_first_trajectory_on_b2(cuda, monkeypatch,
                                                         model):
    """A whole-solve graph replays one ``init_rollout`` a solve, as does
    ``StepwiseSolver``'s eager init; the Solution is the one of the
    ``forward_pass`` route: the same status, the cost within 1e-4
    (float32) or 1e-9 (float64) of it."""
    from ddp_generator_tpu_torch import launches
    from ddp_generator_tpu_torch import solver as slv

    problem, opts, x0s, u0s, p = _init_case(model, 1)
    solve = ddp.make_batched_solver(problem, opts, device=cuda)
    sol = solve(x0s, u0s, p)  # captures
    launches.reset_launches()
    for _ in range(2):
        sol = solve(x0s, u0s, p)
    assert solve.last_stats.graphed and not solve.last_stats.captured
    assert launches.read_launches()["init_rollout"] == 2
    step = ddp.StepwiseSolver(problem, opts, device=cuda)
    launches.reset_launches()
    step(x0s, u0s, p)
    assert launches.read_launches()["init_rollout"] == 1
    monkeypatch.setattr(slv, "_init_on_b2", lambda *a: False)
    ref_solve = slv._BatchedSolver(problem, opts, False, cuda)
    launches.reset_launches()
    ref = ref_solve(x0s, u0s, p)
    assert launches.read_launches()["init_rollout"] == 0
    assert torch.equal(sol.status, ref.status)
    assert int(sol.status[0]) in (1, 2)
    tol = 1e-4 if opts.dtype == "float32" else 1e-9
    assert abs(float(sol.cost[0]) - float(ref.cost[0])) <= tol * max(
        1.0, abs(float(ref.cost[0])))
