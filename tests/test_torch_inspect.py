"""The port's inspection API (``inspect_api.py``, the MMex-style table)
against the JAX package's, float64 on the CPU (``tests/test_inspect.py``
in the port): every mode, ``limits_u`` and the AL-augmented variants at
the same points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_generator_tpu.inspect_api import inspect as j_inspect
from ddp_generator_tpu.models import brachistochrone as jbr
from ddp_generator_tpu.models import car_parking as jcar
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import brachistochrone as tbr
from ddp_generator_tpu_torch.models import car_parking as tcar

X = np.array([0.3, -0.2, 0.5, 0.1])
U = np.array([0.1, -0.4])
X_MODES = (2, 3, 4)  # (x, p, k)
MODES = tuple(range(15)) + (16,)


@pytest.fixture(scope="module")
def inspectors():
    return j_inspect(jcar.car_parking()), td.inspect(tcar.car_parking())


def _close(a, b, what):
    a, b = a.numpy(), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15, err_msg=what)


@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_jax(inspectors, mode):
    ji, ti = inspectors
    p = jcar.default_params()
    for k, (x, u) in enumerate([(X, U), (2 * X, np.array([2.0, -9.0]))]):
        args = (x, p, k) if mode in X_MODES else (x, u, p, k)
        _close(ti.by_mode(mode)(*args), ji.by_mode(mode)(*args),
               f"mode {mode}")


def test_clamp_mode_16_and_unsupported(inspectors):
    _, ti = inspectors
    p = jcar.default_params()
    uc = ti.by_mode(16)(torch.zeros(4, dtype=torch.float64),
                        np.array([2.0, -9.0]), p, 0)
    np.testing.assert_allclose(uc.numpy(), [0.5, -2.0])
    with pytest.raises(ValueError, match="mode 15"):
        ti.by_mode(15)


def test_hessian_symmetry_and_limits(inspectors):
    ji, ti = inspectors
    p = jcar.default_params()
    x = torch.tensor([0.5, 0.1, -0.3, 0.8], dtype=torch.float64)
    u = np.array([0.2, 0.1])
    Lxx, Fxx = ti.Lxx(x, u, p, 0), ti.Fxx(x, p, 0)
    torch.testing.assert_close(Lxx, Lxx.T, rtol=0, atol=1e-12)
    torch.testing.assert_close(Fxx, Fxx.T, rtol=0, atol=1e-12)
    for a, b in zip(ti.limits_u(x, u, p, 0),
                    ji.limits_u(jnp.asarray(x.numpy()), u, p, 0)):
        _close(a, b, "limits_u")


def test_al_variants_match_jax():
    """brachistochrone_hli: a [k]-indexed floor (hli) and a terminal
    equality (hfe), with nonzero multipliers."""
    ji = j_inspect(jbr.brachistochrone_hli())
    ti = td.inspect(tbr.brachistochrone_hli())
    p, _, _ = jbr.default_setup_hli(20)
    x, u = np.array([-1.7]), np.array([-0.8])
    mu_le, mu_li, w_l = np.zeros(0), np.array([0.7]), 3.0
    mu_fe, mu_fi, w_f = np.array([0.4]), np.zeros(0), 5.0
    for k in (0, 7):
        for name in ("al_L", "al_Lx", "al_Lu"):
            args = (x, u, p, k, mu_le, mu_li, w_l)
            _close(getattr(ti, name)(*args), getattr(ji, name)(*args), name)
        for name in ("al_F", "al_Fx"):
            args = (x, p, k, mu_fe, mu_fi, w_f)
            _close(getattr(ti, name)(*args), getattr(ji, name)(*args), name)
