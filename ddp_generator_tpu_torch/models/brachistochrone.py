"""Brachistochrone examples (``ddp_generator_tpu.models.brachistochrone``).

Re-derivation of ``examples/Brachistochrone/optDefBrachi.mac`` and
``optDefBrachi_hli.mac``: one state ``y`` (height, negative), one input
``dy`` (slope over a horizontal step ``dx``); the running cost is the
travel time of the segment, the reference's symbolic integral
``int_0^dx sqrt((1+dy^2)/(2g(-y - dy*s))) ds`` (``optDefBrachi.mac:10``) in
closed form:

    L = sqrt((1+dy^2)/(2g)) * 2*(sqrt(-y - dx*dy) - sqrt(-y)) / (-dy)
      = sqrt((1+dy^2)/(2g)) * 2*dx / (sqrt(-y - dx*dy) + sqrt(-y)),

valid where ``y < 0`` and ``y + dx*dy < 0``.  The port evaluates the
second form, the same function: the first subtracts two nearly equal
square roots where the slope is small (the cycloid's flat bottom, where
the horizon ends), which cost its derivatives up to 1.5% (``cxu``), enough
for kernel B3 and autograd to part at an ill-conditioned step; the second
keeps them within a few ulps and is finite at ``dy = 0``.

* :func:`brachistochrone`: terminal equality ``hfe = y - yf``
  (``optDefBrachi.mac:13``).
* :func:`brachistochrone_hli`: the time-varying running inequality
  ``hli = ymin[k] - y`` (a moving floor) and the terminal equality
  ``hfe = y - ymin[N]`` (``optDefBrachi_hli.mac:13-14``): a ``[k]``-indexed
  parameter, ``ymin`` with ``N + 1`` entries.

The functions are component-first torch functions (see ``problem.py``).
The kernels run their hand-written twins in
``csrc/models/brachistochrone.cuh``, which read the parameters flat in the
order of :data:`CUDA_MODEL` and :data:`CUDA_MODEL_HLI`.  The analytic
optimum is the cycloid ``x = a(phi - sin phi), y = a(cos phi - 1)``
(``testBrachi.m:29-35``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..problem import PER_STEP, CudaModel, Problem, make_problem

# Flat parameter orders in csrc/models/brachistochrone.cuh.
CUDA_MODEL = CudaModel(name="brachistochrone",
                       param_order=(("g", 1), ("yf", 1), ("dx", 1)))
CUDA_MODEL_HLI = CudaModel(name="brachistochrone_hli",
                           param_order=(("g", 1), ("dx", 1),
                                        ("ymin", PER_STEP)))


def _segment_time(y, dy, g, dx):
    # Closed form of the reference's symbolic integral (optDefBrachi.mac:10)
    # with its difference of square roots rationalized (see the docstring).
    s = torch.sqrt((1.0 + dy * dy) / (2.0 * g))
    return 2.0 * s * dx / (torch.sqrt(-y - dx * dy) + torch.sqrt(-y))


def f(x, u, p, k):
    return torch.stack([x[0] + u[0] * p["dx"]])


def L(x, u, p, k):
    return _segment_time(x[0], u[0], p["g"], p["dx"])


def F(x, p, k):
    # zero, with the lane axis of x so that F + penalties keeps its shape
    return torch.zeros_like(x[0])


def hfe(x, p, k):
    return x[0] - p["yf"]


def hli_floor(x, u, p, k):
    return p["ymin"][k] - x[0]


def hfe_floor(x, p, k):
    return x[0] - p["ymin"][k]


def brachistochrone() -> Problem:
    return make_problem(
        n_x=1, n_u=1, f=f, L=L, F=F, hfe=[hfe], name="Brachistochrone",
        example_params={"g": 9.81, "yf": -4.0, "dx": 0.1},
        cuda_model=CUDA_MODEL,
    )


def brachistochrone_hli() -> Problem:
    return make_problem(
        n_x=1, n_u=1, f=f, L=L, F=F, hli=[hli_floor], hfe=[hfe_floor],
        name="Brachistochrone_hli",
        example_params={"g": 9.81, "dx": 0.1,
                        "ymin": np.linspace(-1.0, -4.0, 11)},
        cuda_model=CUDA_MODEL_HLI,
    )


def default_setup(n: int = 500):
    """Workload of ``testBrachi.m:7-24``: p, x0, u0 for horizon n."""
    p = {"g": 9.81, "yf": -4.0, "dx": 2.0 * np.pi / n}
    x0 = np.array([-2.220446049250313e-16])  # x0 = [-eps] (testBrachi.m:10)
    u0 = -np.ones((n, 1))
    return p, x0, u0


def default_setup_hli(n: int = 500):
    """Workload of ``testBrachi_hli.m:7-26``."""
    p = {
        "g": 9.81,
        "dx": 2.0 * np.pi / n,
        "ymin": np.concatenate([np.linspace(-1.0, -5.0, n), [-4.0]]),
    }
    x0 = np.array([-2.220446049250313e-16])
    u0 = -np.ones((n, 1))
    return p, x0, u0


def cycloid(n_points: int = 1000, a: float = 2.0):
    """Analytic optimum overlay (``testBrachi.m:29-35``)."""
    phi = np.linspace(0.0, np.pi, n_points)
    return a * (phi - np.sin(phi)), a * (np.cos(phi) - 1.0)
