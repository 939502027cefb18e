"""Kernel B1's plain version against the JAX Pallas backward pass.

The port's ``back_pass_cm`` on CPU tensors runs ``back_pass_cm_plain``;
the reference is ``pallas_back_pass_cm(interpret=True)`` on the same packed
component-major bundle, float64.  Covers regType 1/2, FULL_DDP on/off,
constrained and unconstrained inputs, the kernel's three (n_x, n_u) pairs,
and lanes whose backward pass fails.  n_u = 3 (the 3x3 closed-form solves)
is held against the serial JAX ``back_pass`` with the enumeration boxQP,
whose interpret-mode kernel would take far longer to compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_generator_tpu.derivs import DerivBundle, FinalDerivs, StepDerivs
from ddp_generator_tpu.ops.backpass import back_pass
from ddp_generator_tpu.ops.boxqp import BoxQPHyper
from ddp_generator_tpu.ops.pallas_backpass import pallas_back_pass_cm
from ddp_generator_tpu_torch.ops import cuda_backpass as cb

TOL = dict(rtol=1e-9, atol=1e-9)
B, N = 6, 6  # one shape for every interpret call: jit reuses its compile


def _bundle(rng, B, N, n_x, n_u, full_ddp):
    """A random packed CM bundle ``{field: (C, N, B)}``, float64 numpy."""
    tx, tu = cb.tri_size(n_x), cb.tri_size(n_u)

    def r(c, scale=1.0):
        return scale * rng.standard_normal((c, N, B))

    def spd_packed(n, shift=3.0):
        a = rng.standard_normal((N, B, n, n))
        m = np.einsum("...ij,...kj->...ik", a, a) + shift * np.eye(n)
        return np.stack([m[..., i, j] for i in range(n) for j in range(i, n)])

    def sym_packed(n, scale):
        return np.concatenate([r(cb.tri_size(n), scale) for _ in range(n_x)])

    fx = r(n_x * n_x, 0.4)
    for i in range(n_x):
        fx[i * n_x + i] += 1.0
    lower = r(n_u, 0.5) - 1.0
    upper = lower + 0.3 + np.abs(r(n_u))
    lower[0, :, 1] = -np.inf  # lane 1: input 0 unconstrained
    upper[0, :, 1] = np.inf
    empty = np.zeros((0, N, B))
    sd = dict(
        fx=fx, fu=r(n_x * n_u, 0.4), cx=r(n_x), cu=r(n_u),
        cxx=spd_packed(n_x), cuu=spd_packed(n_u), cxu=r(n_x * n_u, 0.2),
        fxx=sym_packed(n_x, 0.05) if full_ddp else empty,
        fuu=sym_packed(n_u, 0.05) if full_ddp else empty,
        fxu=r(n_x * n_x * n_u, 0.05) if full_ddp else empty,
        lower=lower, upper=upper, lower_hx=r(n_u * n_x, 0.3),
        upper_hx=r(n_u * n_x, 0.3), lower_sign=-np.ones((n_u, N, B)),
        upper_sign=np.ones((n_u, N, B)),
    )
    assert sd["cxx"].shape[0] == tx and sd["cuu"].shape[0] == tu
    a = rng.standard_normal((B, n_x, n_x))
    fcxx = (np.einsum("bij,bkj->bik", a, a) + 3 * np.eye(n_x)).reshape(B, -1).T
    return sd, r(n_x)[:, 0], np.ascontiguousarray(fcxx), r(n_u)


def _run_both(sd, fcx, fcxx, us, lam, n_x, reg_type, full_ddp):
    ref = pallas_back_pass_cm(
        StepDerivs(**{k: jnp.asarray(v) for k, v in sd.items()}),
        jnp.asarray(fcx), jnp.asarray(fcxx), jnp.asarray(us),
        jnp.asarray(lam), n_x, reg_type=reg_type, full_ddp=full_ddp,
        interpret=True)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    out = cb.back_pass_cm({k: t(v) for k, v in sd.items()}, t(fcx), t(fcxx),
                          t(us), t(lam), n_x, reg_type, full_ddp)
    return [np.asarray(a) for a in ref], [a.numpy() for a in out]


def _case(n_x, n_u, full_ddp, seed):
    rng = np.random.default_rng(seed)
    sd, fcx, fcxx, us = _bundle(rng, B, N, n_x, n_u, full_ddp)
    # lane 3: strongly indefinite cuu at step 2 -> that pass fails
    for i in range(n_u):
        sd["cuu"][cb.tri_index(i, i, n_u), 2, 3] = -1e4
    lam = np.abs(rng.standard_normal((1, B))) * 0.1
    lam[0, 4] = 1e-9
    return sd, fcx, fcxx, us, lam


@pytest.mark.parametrize("n_x,n_u,reg_type,full_ddp", [
    (4, 2, 1, True),  # the main path: CarParking, regType 1, FULL_DDP
    (4, 2, 2, False),
    (4, 1, 2, True),
    (1, 1, 1, False),
])
def test_plain_matches_pallas_interpret(n_x, n_u, reg_type, full_ddp):
    sd, fcx, fcxx, us, lam = _case(n_x, n_u, full_ddp,
                                   10 * n_x + n_u + reg_type)
    before = cb.back_pass_cm.launches
    ref, out = _run_both(sd, fcx, fcxx, us, lam, n_x, reg_type, full_ddp)
    assert cb.back_pass_cm.launches == before  # the plain path is no launch
    np.testing.assert_array_equal(out[4], ref[4])
    assert out[4][0, 3]
    shapes = [(N, n_u, B), (N, n_u * n_x, B), (2, B), (1, B), (1, B)]
    for name, o, r, s in zip(("l", "L", "dV", "g_norm"), out, ref, shapes):
        assert o.shape == s, name
        np.testing.assert_allclose(o, r, err_msg=name, **TOL)
    # a failed lane writes zeros from its failing step down to t=0
    assert np.all(out[0][:3, :, 3] == 0.0) and np.all(out[1][:3, :, 3] == 0.0)


def _batch_major(sd, fcx, fcxx, us, n_x, n_u):
    """Packed CM bundle -> JAX's batch-major DerivBundle and us."""
    def unpack(p, n):
        idx = [cb.tri_index(min(a, b), max(a, b), n)
               for a in range(n) for b in range(n)]
        return p[idx].reshape((n, n) + p.shape[1:])

    def bm(a, shape):
        return np.moveaxis(a.reshape(shape + (N, B)), (-1, -2), (0, 1))

    if sd["fxx"].size:
        fxx = np.stack([unpack(v, n_x)
                        for v in sd["fxx"].reshape(n_x, -1, N, B)])
        fuu = np.stack([unpack(v, n_u)
                        for v in sd["fuu"].reshape(n_x, -1, N, B)])
        fxx, fuu = bm(fxx, (n_x, n_x, n_x)), bm(fuu, (n_x, n_u, n_u))
        fxu = bm(sd["fxu"], (n_x, n_x, n_u))
    else:
        fxx = fuu = fxu = np.zeros((B, N, 0, 0, 0))
    step = StepDerivs(
        fx=bm(sd["fx"], (n_x, n_x)), fu=bm(sd["fu"], (n_x, n_u)),
        cx=bm(sd["cx"], (n_x,)), cu=bm(sd["cu"], (n_u,)),
        cxx=bm(unpack(sd["cxx"], n_x), (n_x, n_x)),
        cuu=bm(unpack(sd["cuu"], n_u), (n_u, n_u)),
        cxu=bm(sd["cxu"], (n_x, n_u)), fxx=fxx, fuu=fuu, fxu=fxu,
        lower=bm(sd["lower"], (n_u,)), upper=bm(sd["upper"], (n_u,)),
        lower_hx=bm(sd["lower_hx"], (n_u, n_x)),
        upper_hx=bm(sd["upper_hx"], (n_u, n_x)),
        lower_sign=bm(sd["lower_sign"], (n_u,)),
        upper_sign=bm(sd["upper_sign"], (n_u,)))
    final = FinalDerivs(cx=fcx.T, cxx=fcxx.T.reshape(B, n_x, n_x))
    return DerivBundle(step=step, final=final, ok=np.ones(B, bool)), bm(
        us, (n_u,))


def test_n_u_3_matches_serial_back_pass():
    # regType 2 without FULL_DDP at n_u=3: the combination the interpret
    # cases above leave out
    n_x = n_u = 3
    sd, fcx, fcxx, us, lam = _case(n_x, n_u, False, 33)
    d, us_bm = _batch_major(sd, fcx, fcxx, us, n_x, n_u)
    ref = jax.jit(jax.vmap(lambda d_, u_, l_: back_pass(
        d_, u_, l_, 2, False, BoxQPHyper(method="enumerate"))))(
            d, us_bm, lam[0])
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    out = cb.back_pass_cm({k: t(v) for k, v in sd.items()}, t(fcx), t(fcxx),
                          t(us), t(lam), n_x, 2, False)
    np.testing.assert_array_equal(out[4].numpy()[0], np.asarray(ref.failed))
    assert bool(out[4][0, 3])
    np.testing.assert_allclose(out[0].numpy().transpose(2, 0, 1),
                               np.asarray(ref.l), **TOL)
    np.testing.assert_allclose(
        out[1].numpy().transpose(2, 0, 1).reshape(B, N, n_u, n_x),
        np.asarray(ref.L), **TOL)
    np.testing.assert_allclose(out[2].numpy().T, np.asarray(ref.dV), **TOL)
    np.testing.assert_allclose(out[3].numpy()[0], np.asarray(ref.g_norm),
                               **TOL)


def test_all_lanes_fail_and_none_fail():
    rng = np.random.default_rng(5)
    sd, fcx, fcxx, us = _bundle(rng, B, N, 4, 2, True)
    for lam_v, expect in ((-100.0, True), (10.0, False)):
        lam = np.full((1, B), lam_v)
        ref, out = _run_both(sd, fcx, fcxx, us, lam, 4, 1, True)
        assert np.all(out[4] == expect) and np.all(ref[4] == expect)
        for o, r in zip(out[:4], ref[:4]):
            np.testing.assert_allclose(o, r, **TOL)


def test_wrapper_rejects_other_devices():
    rng = np.random.default_rng(6)
    sd, fcx, fcxx, us = _bundle(rng, 2, 3, 4, 2, True)
    m = lambda a: torch.empty(np.shape(a), device="meta")
    with pytest.raises(ValueError, match="device"):
        cb.back_pass_cm({k: m(v) for k, v in sd.items()}, m(fcx), m(fcxx),
                        m(us), m(np.ones((1, 2))), 4, 1, True)


def test_patterns_order_matches_jax():
    from ddp_generator_tpu.ops.pallas_backpass import _patterns

    for n in (1, 2, 3):
        assert cb._patterns(n) == _patterns(n)
        assert cb.tri_size(n) == n * (n + 1) // 2
