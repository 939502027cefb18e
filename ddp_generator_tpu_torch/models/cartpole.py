"""Cart-pole swing-up (``ddp_generator_tpu.models.cartpole``).

4 states ``[z, th, dz, dth]`` (cart position, pole angle from upright,
their rates), 1 input ``fc`` (cart force), semi-implicit Euler dynamics,
quadratic costs and the box-constraint grammar ``h[i] < 0`` of
``optDefCar.mac:17-19``: ``h1 = -fc + limF[0]`` is a lower bound,
``h2 = fc - limF[1]`` an upper bound on ``fc``.  The functions are
component-first torch functions (see ``problem.py``).  The kernels run
their hand-written twin ``csrc/models/cartpole.cuh``, which reads the
parameters flat in the order of :data:`CUDA_MODEL`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..problem import CudaModel, Problem, make_problem

# Flat parameter order of Cartpole in csrc/models/cartpole.cuh.
CUDA_MODEL = CudaModel(
    name="cartpole",
    param_order=(("mc", 1), ("mp", 1), ("l", 1), ("g", 1), ("dt", 1),
                 ("cu", 1), ("cz", 1), ("cf", 4), ("limF", 2)),
)


def f(x, u, p, k):
    z, th, dz, dth = x[0], x[1], x[2], x[3]
    fc = u[0]
    mc, mp, lp, g, dt = p["mc"], p["mp"], p["l"], p["g"], p["dt"]
    sin, cos = torch.sin(th), torch.cos(th)
    # Cart-pole manipulator equations, pole angle measured from the upright
    # (th = 0 <=> pole up).
    denom = mc + mp * sin * sin
    ddz = (fc + mp * sin * (lp * dth * dth + g * cos)) / denom
    ddth = (-fc * cos - mp * lp * dth * dth * cos * sin
            - (mc + mp) * g * sin) / (lp * denom)
    # Semi-implicit Euler: rates first, then positions with the new rates.
    dz_n = dz + dt * ddz
    dth_n = dth + dt * ddth
    return torch.stack([z + dt * dz_n, th + dt * dth_n, dz_n, dth_n])


def L(x, u, p, k):
    return p["cu"] * (u[0] * u[0]) + p["cz"] * (x[0] * x[0])


def F(x, p, k):
    # Strong terminal shaping toward the upright at the origin.
    cf = p["cf"]
    return (cf[0] * (x[0] * x[0]) + cf[1] * (1.0 - torch.cos(x[1]))
            + cf[2] * (x[2] * x[2]) + cf[3] * (x[3] * x[3]))


def h1(x, u, p, k):  # -fc + limF[0] < 0  => lower bound
    return -u[0] + p["limF"][0]


def h2(x, u, p, k):  # fc - limF[1] < 0   => upper bound
    return u[0] - p["limF"][1]


def cartpole() -> Problem:
    return make_problem(
        n_x=4, n_u=1, f=f, L=L, F=F, h=[h1, h2],
        name="CartPole", example_params=default_params(),
        box_meta=[(0, -1.0), (0, 1.0)], cuda_model=CUDA_MODEL,
    )


def default_params():
    return {
        "mc": 1.0,
        "mp": 0.3,
        "l": 0.5,
        "g": 9.81,
        "dt": 0.02,
        "cu": 1e-4,
        "cz": 1e-3,
        "cf": np.array([1.0, 20.0, 0.1, 0.1]),
        "limF": np.array([-15.0, 15.0]),
    }


def default_setup(T: int = 150, seed: int = 0):
    """Swing-up from hanging (th = pi) to upright (th = 0) at the origin."""
    rng = np.random.default_rng(seed)
    p = default_params()
    x0 = np.array([0.0, np.pi, 0.0, 0.0])
    u0 = 0.1 * rng.standard_normal((T, 1))
    return p, x0, u0
