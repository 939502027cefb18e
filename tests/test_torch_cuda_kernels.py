"""Kernels B1 and B2 on a CUDA card against their plain PyTorch versions.

Covers every instantiation the solve at full width does not reach: B1 at
each (n_x, n_u) pair of ``KERNEL_SHAPES`` with regType 1/2 and FULL_DDP
on/off in float32 and float64, B2 in both modes with alpha 0 lanes and a
lane whose rollout turns NaN.  ``B`` is not a multiple of the block size,
so the ragged last block is exercised.  Needs a CUDA device and ``nvcc``;
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
from ddp_generator_tpu_torch.models import car_parking
from ddp_generator_tpu_torch.ops import cuda_backpass as cb
from ddp_generator_tpu_torch.ops import cuda_rollout as cr
from ddp_generator_tpu_torch.ops.forward import forward_pass

pytestmark = pytest.mark.cuda

B, N = 300, 20
# Kernel and plain version run the same IEEE operations in the same order
# (the kernels are built without FMA contraction); what is left is the
# rounding of transcendentals, relative to the largest reference value.
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels B1/B2 have no CPU mode")
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


def _bundle(rng, n_x, n_u, full_ddp, dtype, dev):
    """A random packed CM bundle ``{field: (C, N, B)}``; lane 3 has a
    strongly indefinite cuu at step 2, so its pass fails there."""
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
    for i in range(n_u):
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
@pytest.mark.parametrize("n_x,n_u", cb.KERNEL_SHAPES)
def test_backpass_kernel_matches_plain(cuda, n_x, n_u, reg_type, full_ddp,
                                       dtype):
    rng = np.random.default_rng(100 * n_x + 10 * n_u + reg_type)
    sd, fcx, fcxx, us, lam = _bundle(rng, n_x, n_u, full_ddp, dtype, cuda)
    args = (sd, fcx, fcxx, us, lam, n_x, reg_type, full_ddp)
    before = cb.back_pass_cm.launches
    out = cb.back_pass_cm(*args)
    torch.cuda.synchronize()
    assert cb.back_pass_cm.launches == before + 1
    ref = cb.back_pass_cm_plain(*args)
    assert bool(ref[4][0, 3]) and not bool(ref[4].all())
    for name, o, r in zip(("l", "L", "dV", "g_norm", "failed"), out, ref):
        _close(o, r, TOL[dtype], name)


def _rollout_operands(dtype, dev):
    problem = car_parking.car_parking()
    rng = np.random.default_rng(7)
    p_np, x0, _ = car_parking.default_setup(T=N, seed=0)
    p = ddp.params_from_jax(p_np, dtype, dev)
    x0s = np.tile(x0, (B, 1)) + 0.05 * rng.standard_normal((B, 4))
    u0s = 0.1 * rng.standard_normal((B, N, 2))
    x0s[5, 3], u0s[5, :, 0] = 1e4, 0.3  # lane 5: the rollout turns NaN
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)
    m = ddp.init_multipliers(problem, B, N, dtype, dev)
    w = torch.ones(B, dtype=dtype, device=dev)
    nom = forward_pass(problem, t(x0s), None, t(u0s), None, None, 0.0, p,
                       m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w, w)
    l = t(0.1 * rng.standard_normal((B, N, 2)))
    L = t(0.05 * rng.standard_normal((B, N, 2, 4)))
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
    ops, alpha_vec, p = _rollout_operands(dtype, cuda)
    kw = dict(multi=mode == "multi", want_cost=mode == "selected_cost")
    av = None if mode == "multi" else alpha_vec
    before = dict(cr.rollout_call.launches)
    out = cr.rollout_call(*ops, av, p, **kw)
    torch.cuda.synchronize()
    key = "multi" if mode == "multi" else "selected"
    assert cr.rollout_call.launches[key] == before[key] + 1
    ref = cr.rollout_plain(*ops, av, p, **kw)
    assert len(out) == len(ref)
    for i, (o, r) in enumerate(zip(out, ref)):
        _close(o, r, TOL[dtype], f"{mode} output {i}")
    if mode != "selected":
        ok = out[-1]
        assert not bool(ok[:, 5].any()) and bool(ok[:, :5].all())


def test_wrappers_raise_where_no_kernel_exists(cuda):
    rng = np.random.default_rng(1)
    sd, fcx, fcxx, us, lam = _bundle(rng, 4, 2, True, torch.float64, cuda)
    with pytest.raises(NotImplementedError, match="instantiated"):
        cb.back_pass_cm(sd, fcx, fcxx, us, lam, 3, 1, True)  # (3, 2)
    ops, alpha_vec, p = _rollout_operands(torch.float64, cuda)
    no_model = dataclasses.replace(ops[0], cuda_model=None)
    with pytest.raises(NotImplementedError, match="CUDA model"):
        cr.rollout_call(no_model, *ops[1:], alpha_vec, p, multi=False)
