"""CarParking on the PyTorch/CUDA port (counterpart of ``scripts/try_car.py``,
the reference's ``testCar.m``).

    python3 scripts/try_car_torch.py [T] [iters] [--device cuda|cpu]

Solves ``car_parking.default_setup(T, seed=0)`` (defaults T=500, 200
iterations) with ``SolverOptions(max_iter=iters)`` in float64, twice, and
prints ``try_car.py``'s summary under its labels.  On ``cpu`` the solve
takes the serial path (``SolverOptions``' own methods), as the JAX script
does.  On ``cuda``, the default, it takes the kernel path,
``backpass_method="kernel"`` (emission + kernel B1) and
``linesearch_method="kernel"`` (kernel B2): the serial path on the card is
bound by its launches, about 2 s a body call, so 200 iterations of it
would take minutes.  The first run includes the kernel build.  Imports no
JAX.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def path_options(device: str) -> dict:
    """The kernel path on the card, the serial path (the defaults) on the
    CPU."""
    return ({} if device == "cpu" else
            dict(backpass_method="kernel", linesearch_method="kernel"))


def check_device(device: str) -> None:
    """Exit 2 when the card is asked for and there is none."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu for the CPU",
              file=sys.stderr)
        sys.exit(2)


def timed_solves(problem, x0, u0, p, opts, device, runs=2):
    """``runs`` solves of one instance; the last Solution (numpy) and each
    run's seconds (the copy to the host ends each)."""
    import ddp_generator_tpu_torch as ddp

    walls = []
    for _ in range(runs):
        t0 = time.time()
        sol = ddp.to_numpy(ddp.solve(problem, x0, u0, p, opts,
                                     device=device))
        walls.append(time.time() - t0)
    return sol, walls


def solve_car(T: int, iters: int, device: str):
    """testCar.m's solve: (Solution as numpy, params, run seconds)."""
    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.models import car_parking

    p, x0, u0 = car_parking.default_setup(T, seed=0)
    opts = ddp.SolverOptions(max_iter=iters, **path_options(device))
    sol, walls = timed_solves(car_parking.car_parking(), x0, u0, p, opts,
                              device)
    return sol, p, walls


def print_result(sol) -> None:
    print("success:", bool(sol.success), "status:", int(sol.status),
          "iters:", int(sol.iterations))
    print("cost:", float(sol.cost), "g_norm:", float(sol.g_norm),
          "lam:", float(sol.lam))


def print_car(sol, walls) -> None:
    """try_car.py's summary lines."""
    print(f"compile+run: {walls[0]:.1f}s")
    dt = walls[1]
    print(f"run: {dt:.3f}s  "
          f"({dt / max(int(sol.iterations), 1) * 1e3:.2f} ms/iter)")
    print_result(sol)
    print("final state:", sol.xs[-1], "(target ~0)")
    print("u in bounds:", float(np.max(np.abs(sol.us[:, 0]))), "<=0.5;",
          float(np.max(np.abs(sol.us[:, 1]))), "<=2.0")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("T", type=int, nargs="?", default=500)
    ap.add_argument("iters", type=int, nargs="?", default=200)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    check_device(args.device)
    sol, _, walls = solve_car(args.T, args.iters, args.device)
    print(f"device: {args.device}")
    print_car(sol, walls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
