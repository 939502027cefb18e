"""Brachistochrone on the PyTorch/CUDA port (counterpart of
``scripts/try_brachi.py``, the reference's ``testBrachi.m``).

    python3 scripts/try_brachi_torch.py [n] [--device cuda|cpu]

Solves ``brachistochrone.default_setup(n)`` (default n=500) with
``try_brachi.py``'s options (max_iter 50, ``w_pen_init_f=40``,
``w_pen_fact2=2``, ``full_ddp=False``) in float64, twice, and prints its
summary under its labels, with the gap to the analytic cycloid at the
quarter points.  On ``cpu`` the serial path, as the JAX script; on
``cuda``, the default, the kernel path (emission + kernel B1, kernel B2):
the serial path on the card is bound by its launches, about 2 s a body
call.  The first run includes the kernel build.  Imports no JAX.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from try_car_torch import (  # noqa: E402
    check_device,
    path_options,
    print_result,
    timed_solves,
)

A_CYCLOID = 2.0  # x = a(phi - sin phi), y = a(cos phi - 1) through (2 pi, -4)


def brachi_options(device: str, max_iter: int = 50):
    import ddp_generator_tpu_torch as ddp

    return ddp.SolverOptions(max_iter=max_iter, w_pen_init_f=40.0,
                             w_pen_fact2=2.0, full_ddp=False,
                             **path_options(device))


def cycloid_errors(ys, n: int) -> list:
    """|y - y_cycloid| at the grid points n/4, n/2, 3n/4 and n."""
    from scipy.optimize import brentq

    xgrid = np.linspace(0, 2 * np.pi, n + 1)

    def y_true(xv):
        phi = brentq(lambda ph: A_CYCLOID * (ph - np.sin(ph)) - xv, 0,
                     np.pi + 1e-9)
        return A_CYCLOID * (np.cos(phi) - 1.0)

    return [float(abs(ys[i] - y_true(xgrid[i])))
            for i in (n // 4, n // 2, 3 * n // 4, n)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=500)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    check_device(args.device)
    from ddp_generator_tpu_torch.models import brachistochrone

    n = args.n
    p, x0, u0 = brachistochrone.default_setup(n)
    sol, walls = timed_solves(brachistochrone.brachistochrone(), x0, u0, p,
                              brachi_options(args.device), args.device)
    print(f"device: {args.device}")
    print(f"compile+run: {walls[0]:.1f}s")
    print(f"run: {walls[1]:.3f}s  "
          f"({walls[1] / max(int(sol.iterations), 1) * 1e3:.2f} ms/iter)")
    print_result(sol)
    print("y_final:", sol.xs[-1], "(target -4)")
    print("cycloid errors at quarter points:",
          cycloid_errors(sol.xs[:, 0], n))
    return 0


if __name__ == "__main__":
    sys.exit(main())
