"""CarParking example problem (``ddp_generator_tpu.models.car_parking``).

4 states ``[x_, y_, t, v]``, 2 inputs ``[w, a]``, front-axle kinematics
with the rolling distance auxiliary

    s = d + h*v*cos(w) - sqrt(d^2 - (h*v*sin(w))^2)      (optDefCar.mac:4)

smooth-abs costs and 4 box constraints on ``w`` and ``a``.  The functions
are component-first torch functions (see ``problem.py``).  The rollout
kernel runs their hand-written twin ``csrc/models/car_parking.cuh``, which
reads the parameters flat in the order of :data:`CUDA_MODEL`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..problem import CudaModel, Problem, make_problem

# Flat parameter order of CarParking in csrc/models/car_parking.cuh.
CUDA_MODEL = CudaModel(
    name="car_parking",
    param_order=(("d", 1), ("h", 1), ("pf", 4), ("cf", 4), ("cu", 2),
                 ("cx", 2), ("px", 2), ("limW", 2), ("limA", 2)),
)


def _sqrt_abs(x, e):
    # sqrtAbs(x, e) := sqrt(x^2 + e^2) - e  (optDefCar.mac:9)
    return torch.sqrt(x * x + e * e) - e


def f(x, u, p, k):
    x_, y_, t, v = x[0], x[1], x[2], x[3]
    w, a = u[0], u[1]
    d, h = p["d"], p["h"]
    # auxiliary s: front-axle rolling distance (optDefCar.mac:4)
    hvs = h * v * torch.sin(w)
    s = d + h * v * torch.cos(w) - torch.sqrt(d * d - hvs * hvs)
    return torch.stack([
        x_ + s * torch.cos(t),
        y_ + s * torch.sin(t),
        t + torch.asin(torch.sin(w) * h * v / d),
        v + h * a,
    ])


def L(x, u, p, k):
    cu, cx, px = p["cu"], p["cx"], p["px"]
    return (
        cu[0] * (u[0] * u[0])
        + cu[1] * (u[1] * u[1])
        + cx[0] * _sqrt_abs(x[0], px[0])
        + cx[1] * _sqrt_abs(x[1], px[1])
    )


def F(x, p, k):
    cf, pf, cx, px = p["cf"], p["pf"], p["cx"], p["px"]
    return (
        cf[0] * _sqrt_abs(x[0], pf[0])
        + cf[1] * _sqrt_abs(x[1], pf[1])
        + cf[2] * _sqrt_abs(x[2], pf[2])
        + cf[3] * _sqrt_abs(x[3], pf[3])
        + cx[0] * _sqrt_abs(x[0], px[0])
        + cx[1] * _sqrt_abs(x[1], px[1])
    )


# h[i] < 0 box constraints (optDefCar.mac:17-19)
def h1(x, u, p, k):
    return -u[0] + p["limW"][0]


def h2(x, u, p, k):
    return u[0] - p["limW"][1]


def h3(x, u, p, k):
    return -u[1] + p["limA"][0]


def h4(x, u, p, k):
    return u[1] - p["limA"][1]


def car_parking() -> Problem:
    return make_problem(
        n_x=4, n_u=2, f=f, L=L, F=F, h=[h1, h2, h3, h4],
        name="CarParking", example_params=default_params(),
        # (u_index, sign) per constraint: h1=-w+limW[0] is a lower bound on
        # u[0], h2=w-limW[1] an upper bound, and likewise for a.
        box_meta=[(0, -1.0), (0, 1.0), (1, -1.0), (1, 1.0)],
        cuda_model=CUDA_MODEL,
    )


def default_params():
    """Published parameters of ``testCar.m:2-11``."""
    return {
        "d": 2.0,
        "h": 0.03,
        "pf": np.array([0.01, 0.01, 0.01, 1.0]),
        "cf": np.array([0.1, 0.1, 1.0, 0.3]),
        "cu": 1e-2 * np.array([1.0, 0.01]),
        "cx": 1e-3 * np.array([1.0, 1.0]),
        "px": np.array([0.1, 0.1]),
        "limW": np.array([-0.5, 0.5]),
        "limA": np.array([-2.0, 2.0]),
    }


def default_setup(T: int = 500, seed: int = 0):
    """Workload of ``testCar.m:13-19``: x0=[1;1;3pi/2;0], u0 ~ 0.1*randn."""
    rng = np.random.default_rng(seed)
    p = default_params()
    x0 = np.array([1.0, 1.0, np.pi * 3.0 / 2.0, 0.0])
    u0 = 0.1 * rng.standard_normal((T, 2))
    return p, x0, u0
