"""The port's boxQP (``ops/boxqp.py``) against the JAX package's.

Every case of ``tests/test_boxqp.py`` -- interior, clamped, all clamped,
indefinite, infinite bounds, the random convex QPs of the brute-force and
the enumerate-vs-Newton tests, the masked 3x3 inverse and the vmapped
batch -- through JAX's ``boxqp_enumerate``, ``boxqp_newton`` and ``boxqp``
(jit + vmap, float64) and the port's, on the same inputs: the result code,
clamp pattern and free count equal, ``x`` and the masked inverse within
1e-12.  The port runs each group of cases as one batch, and a batch equals
its lanes solved one at a time.  Also ``n > 3`` (the Newton iteration and
the Cholesky branch of the masked inverse), MOD_CHOL, and the dtype rule
of the ``"auto"`` tolerances.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.ops import boxqp as tqp
from ddp_generator_tpu_torch.solver import _boxqp_hyper

# the JAX package's ops/__init__ exports the function boxqp under the
# module's name
jqp = importlib.import_module("ddp_generator_tpu.ops.boxqp")
TOL = dict(rtol=0, atol=1e-12)
INF = np.inf


def _cases_of_test_boxqp():
    """(name, H, g, lower, upper, x0) of every case in tests/test_boxqp.py."""
    z2 = np.zeros(2)
    cases = [
        ("unconstrained_interior", [[2.0, 0.3], [0.3, 1.5]], [1.0, -2.0],
         [-10, -10], [10, 10], z2),
        ("clamped_at_bound", [[2.0, 0.0], [0.0, 2.0]], [-10.0, 1.0],
         [-1, -1], [1, 1], z2),
        ("all_clamped", np.eye(2), [-10.0, -10.0], [-1, -1], [1, 1],
         [1.0, 1.0]),
        ("non_pd", [[1.0, 0.0], [0.0, -1.0]], [1.0, 1.0], [-10, -10],
         [10, 10], z2),
        ("infinite_bounds", [[3.0, 0.5], [0.5, 2.0]], [0.7, -1.3],
         [-INF, -INF], [INF, INF], z2),
    ]
    for seed in range(8):  # test_random_vs_brute_force
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((2, 2))
        H = A @ A.T + 0.5 * np.eye(2)
        g = rng.standard_normal(2) * 2
        cases.append((f"random_{seed}", H, g, [-0.8, -0.6], [0.5, 0.9],
                      rng.standard_normal(2)))
    rng = np.random.default_rng(3)  # test_masked_inverse_matches_submatrix
    A = rng.standard_normal((3, 3))
    cases.append(("masked_inverse", A @ A.T + np.eye(3), [0.1, -50.0, 0.2],
                  [-1, -1, -1], [1, 1, 1], np.zeros(3)))
    rng = np.random.default_rng(0)  # test_vmap_batch
    As = rng.standard_normal((16, 2, 2))
    Hs = np.einsum("bij,bkj->bik", As, As) + np.eye(2)
    gs = rng.standard_normal((16, 2))
    for b in range(16):
        cases.append((f"vmap_{b}", Hs[b], gs[b], [-1.0, -1.0], [1.0, 1.0],
                      z2))
    rng = np.random.default_rng(7)  # test_enumerate_matches_newton
    for n in (1, 2, 3):
        for trial in range(20):
            A = rng.standard_normal((n, n))
            H = A @ A.T + 0.3 * np.eye(n)
            g = rng.standard_normal(n)
            lo = np.sort(rng.standard_normal(n) - 0.5)
            up = lo + np.abs(rng.standard_normal(n)) + 0.1
            cases.append((f"enum_newton_{n}_{trial}", H, g, lo, up,
                          rng.standard_normal(n)))
    cases.append(("enum_nonpd_inf", [[1.0, 0.0], [0.0, -1.0]], [0.7, -1.3],
                  [-INF, -INF], [INF, INF], z2))
    return [(nm,) + tuple(np.asarray(a, np.float64) for a in c)
            for nm, *c in cases]


def _groups(cases):
    """Cases grouped by n, stacked: {n: (names, H, g, lo, up, x0)}."""
    out = {}
    for c in cases:
        out.setdefault(c[1].shape[0], []).append(c)
    return {n: (tuple(c[0] for c in cs),) + tuple(
        np.stack([c[i] for c in cs]) for i in range(1, 6))
        for n, cs in out.items()}


GROUPS = _groups(_cases_of_test_boxqp())


def _jax(fn, H, g, lo, up, x0, hyper):
    if fn == "enumerate":
        f = lambda H_, g_, l_, u_, x_: jqp.boxqp_enumerate(H_, g_, l_, u_,
                                                           hyper)
    elif fn == "newton":
        f = lambda H_, g_, l_, u_, x_: jqp.boxqp_newton(H_, g_, l_, u_, x_,
                                                        hyper)
    else:
        f = lambda H_, g_, l_, u_, x_: jqp.boxqp(H_, g_, l_, u_, x_, hyper)
    out = jax.jit(jax.vmap(f))(*map(jnp.asarray, (H, g, lo, up, x0)))
    return jax.tree_util.tree_map(np.asarray, out)


def _torch(fn, H, g, lo, up, x0, hyper):
    args = [torch.as_tensor(a) for a in (H, g, lo, up, x0)]
    if fn == "enumerate":
        return tqp.boxqp_enumerate(*args[:4], hyper)
    if fn == "newton":
        return tqp.boxqp_newton(*args, hyper)
    return tqp.boxqp(*args, hyper)


def _assert_same(out, ref, names):
    for f in ("res", "clamped", "free", "n_free"):
        got, want = getattr(out, f).numpy(), getattr(ref, f)
        bad = np.nonzero(np.any(np.reshape(got != want, (len(names), -1)),
                                -1))[0]
        assert not len(bad), (f, [names[i] for i in bad])
    np.testing.assert_allclose(out.x.numpy(), ref.x, **TOL)
    np.testing.assert_allclose(out.inv_h_free.numpy(), ref.inv_h_free, **TOL)


@pytest.mark.parametrize("fn", ["enumerate", "newton", "boxqp"])
@pytest.mark.parametrize("n", sorted(GROUPS))
def test_cases_of_test_boxqp_match_jax(n, fn):
    names, *arrs = GROUPS[n]
    hyper_j, hyper_t = jqp.BoxQPHyper(), tqp.BoxQPHyper()
    ref = _jax(fn, *arrs, hyper_j)
    out = _torch(fn, *arrs, hyper_t)
    _assert_same(out, ref, names)
    if n == 2 and fn != "newton":  # the enumeration codes of named cases
        res = dict(zip(names, out.res.tolist()))
        assert res["all_clamped"] == 6 and res["non_pd"] == -1
        assert res["enum_nonpd_inf"] == -1 and res["clamped_at_bound"] == 5


@pytest.mark.parametrize("fn", ["enumerate", "newton"])
def test_batch_equals_lanes_one_at_a_time(fn):
    names, *arrs = GROUPS[2]
    hyper = tqp.BoxQPHyper()
    out = _torch(fn, *arrs, hyper)
    for b in range(len(names)):
        one = _torch(fn, *(a[b] for a in arrs), hyper)
        for f in one._fields:
            np.testing.assert_array_equal(getattr(one, f).numpy(),
                                          getattr(out, f)[b].numpy(),
                                          err_msg=f"{names[b]} {f}")


def _wide_cases(n, count, seed):
    """Convex and indefinite n x n QPs with finite boxes, for n > 3."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((count, n, n))
    H = np.einsum("bij,bkj->bik", A, A) + 0.3 * np.eye(n)
    H[count // 2:] -= 2.0 * np.eye(n)  # some indefinite
    g = 2.0 * rng.standard_normal((count, n))
    lo = -np.abs(rng.standard_normal((count, n))) - 0.1
    up = np.abs(rng.standard_normal((count, n))) + 0.1
    lo[0, 1], up[1, n - 1] = -INF, INF
    x0 = rng.standard_normal((count, n))
    return H, g, lo, up, x0


@pytest.mark.parametrize("n,fn", [(4, "enumerate"), (4, "newton"),
                                  (4, "boxqp"), (5, "newton")])
def test_wide_qps_match_jax(n, fn):
    """n > 3: Cholesky in the masked inverse, "auto" takes the Newton
    iteration."""
    arrs = _wide_cases(n, 12, seed=n)
    hyper = dict(max_iter=100)
    ref = _jax(fn, *arrs, jqp.BoxQPHyper(**hyper))
    out = _torch(fn, *arrs, tqp.BoxQPHyper(**hyper))
    _assert_same(out, ref, [str(i) for i in range(12)])
    codes = set(out.res.tolist())
    assert -1 in codes and codes - {-1}, codes


@pytest.mark.parametrize("n", [2, 4])
def test_mod_chol_boxqp_matches_jax(n):
    arrs = _wide_cases(n, 12, seed=10 + n)
    ref = _jax("boxqp", *arrs, jqp.BoxQPHyper(use_mod_chol=True))
    out = _torch("boxqp", *arrs, tqp.BoxQPHyper(use_mod_chol=True))
    _assert_same(out, ref, [str(i) for i in range(12)])
    # MOD_CHOL makes the indefinite QPs solvable
    assert (out.res[6:] >= 1).all()


def test_boxqp_hyper_auto_follows_dtype():
    h64 = _boxqp_hyper(td.SolverOptions(dtype="float64"))
    assert h64.min_grad == 1e-8 and h64.min_rel_improve == 1e-8
    h32 = _boxqp_hyper(td.SolverOptions(dtype="float32"))
    assert h32.min_grad == 1e-5 and h32.min_rel_improve == 1e-6
    h32x = _boxqp_hyper(td.SolverOptions(dtype="float32", boxqp_min_grad=1e-8,
                                         boxqp_min_rel_improve=1e-8))
    assert h32x.min_grad == 1e-8 and h32x.min_rel_improve == 1e-8
    o = td.SolverOptions(boxqp_method="newton", use_mod_chol=True,
                         boxqp_max_iter=7)
    assert _boxqp_hyper(o) == tqp.BoxQPHyper(
        max_iter=7, min_grad=1e-8, min_rel_improve=1e-8, method="newton",
        use_mod_chol=True)
