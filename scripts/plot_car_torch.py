"""Plot a CarParking solution of the PyTorch/CUDA port (counterpart of
``scripts/plot_car.py`` and the reference's ``plotOptCar.m``).

    python3 scripts/plot_car_torch.py [T] [max_iter] [out.png]
        [--device cuda|cpu]

Solves ``testCar.m``'s workload as ``scripts/try_car_torch.py`` does (the
serial path on ``cpu``, the kernel path on ``cuda``, the default), prints
its summary and renders ``plot_car.py``'s panels (trajectory in the plane,
steering angle, acceleration, orientation, speed) to a PNG.  Without
matplotlib it says that no PNG was written and exits 0.  Imports no JAX.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from try_car_torch import check_device, print_car, solve_car  # noqa: E402


def render(sol, p, T: int, out: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs, us = sol.xs, sol.us
    t = np.arange(T + 1) * float(p["h"])
    fig = plt.figure(figsize=(11, 7))
    ax = fig.add_subplot(1, 2, 2)
    ax.plot(xs[:, 0], xs[:, 1])
    ax.plot([xs[0, 0]], [xs[0, 1]], "go", label="start")
    ax.plot([0], [0], "rx", label="target")
    ax.grid(True); ax.set_title("x y"); ax.legend(); ax.axis("equal")
    panels = [
        ("steering angle", us[:, 0], t[:-1], [p["limW"][0], p["limW"][1]]),
        ("acceleration", us[:, 1], t[:-1], [p["limA"][0], p["limA"][1]]),
        ("car orientation [deg]", xs[:, 2] / np.pi * 180.0, t, None),
        ("car speed", xs[:, 3], t, None),
    ]
    for i, (title, y, tt, lims) in enumerate(panels):
        ax = fig.add_subplot(4, 2, 2 * i + 1)
        ax.plot(tt, y)
        for lv in lims or ():
            ax.axhline(float(lv), color="r", ls="--", lw=0.7)
        ax.grid(True); ax.set_title(title)
    fig.suptitle(f"CarParking T={T}: success={bool(sol.success)} "
                 f"cost={float(sol.cost):.6f} iters={int(sol.iterations)}")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("T", type=int, nargs="?", default=500)
    ap.add_argument("max_iter", type=int, nargs="?", default=200)
    ap.add_argument("out", nargs="?", default="car_parking.png")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    check_device(args.device)
    sol, p, walls = solve_car(args.T, args.max_iter, args.device)
    print(f"device: {args.device}")
    print_car(sol, walls)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"matplotlib is not installed: no PNG written ({args.out})")
        return 0
    render(sol, p, args.T, args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
