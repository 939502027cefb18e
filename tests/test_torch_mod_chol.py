"""The port's modified Cholesky (``ops/chol.py``) against the JAX package's.

Schnabel-Eskow (``cholesky.c:129-287``) for n = 1 to 6 on positive
definite, indefinite and nearly definite symmetric matrices, float64, the
same inputs through ``ddp_generator_tpu.ops.chol`` (jit + vmap) and the
port (one batched call): the pivot order ``perm`` equal, the scattered
perturbation ``e_scattered``, ``e_work`` and ``delta_prev`` within 1e-12;
``mod_chol_perturb`` likewise.  A batch equals its lanes solved one at a
time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_generator_tpu.ops import chol as jchol
from ddp_generator_tpu_torch.ops import chol as tchol

TOL = dict(rtol=0, atol=1e-12)
KINDS = ("pd", "indef", "neardef")


def _random_sym(rng, n, kind):
    A = rng.standard_normal((n, n))
    A = 0.5 * (A + A.T)
    if kind == "pd":
        A = A @ A.T + n * np.eye(n)
    elif kind == "neardef":
        w, V = np.linalg.eigh(A)
        w[0] = -abs(w[0]) * 0.01
        A = (V * w) @ V.T
        A = 0.5 * (A + A.T)
    return A


def _batch(n, seed=0, per_kind=8):
    rng = np.random.default_rng(100 + n + seed)
    mats = [_random_sym(rng, n, k) for k in KINDS for _ in range(per_kind)]
    if n > 1:  # a zero and a negative diagonal entry (phase 2 from j = 0)
        z = _random_sym(rng, n, "indef")
        z[0, 0] = 0.0
        neg = _random_sym(rng, n, "pd")
        neg[-1, -1] = -3.0
        mats += [z, neg]
    else:
        mats += [np.zeros((1, 1)), -np.ones((1, 1))]
    return np.stack(mats)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_mod_chol_matches_jax(n):
    A = _batch(n)
    ref = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.vmap(jchol.mod_chol))(jnp.asarray(A)))
    out = tchol.mod_chol(torch.as_tensor(A))
    np.testing.assert_array_equal(out.perm.numpy(), ref.perm)
    np.testing.assert_allclose(out.e_scattered.numpy(), ref.e_scattered,
                               **TOL)
    np.testing.assert_allclose(out.e_work.numpy(), ref.e_work, **TOL)
    np.testing.assert_allclose(out.delta_prev.numpy(), ref.delta_prev, **TOL)
    # the PD matrices are not perturbed, some of the others are
    assert (ref.delta_prev[:8] == 0).all() and (ref.delta_prev[8:] > 0).any()


@pytest.mark.parametrize("n", [2, 3, 4, 6])
def test_mod_chol_perturb_matches_jax(n):
    A = _batch(n, seed=1)
    H, changed = jax.jit(jax.vmap(jchol.mod_chol_perturb))(jnp.asarray(A))
    H_t, changed_t = tchol.mod_chol_perturb(torch.as_tensor(A))
    np.testing.assert_array_equal(changed_t.numpy(), np.asarray(changed))
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H), **TOL)
    # unchanged lanes keep H exactly
    keep = ~changed_t.numpy()
    np.testing.assert_array_equal(H_t.numpy()[keep], A[keep])


def test_batch_equals_lanes_one_at_a_time():
    A = _batch(4, seed=2)
    out = tchol.mod_chol(torch.as_tensor(A))
    for b in range(A.shape[0]):
        one = tchol.mod_chol(torch.as_tensor(A[b]))
        for f in one._fields:
            np.testing.assert_array_equal(getattr(one, f).numpy(),
                                          getattr(out, f)[b].numpy(),
                                          err_msg=f)
