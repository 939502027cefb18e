"""Plot Brachistochrone solutions of the PyTorch/CUDA port against the
analytic cycloid (counterpart of ``scripts/plot_brachi.py``, the
``testBrachi.m`` / ``testBrachi_hli.m`` overlays, ``testBrachi.m:29-35``).

    python3 scripts/plot_brachi_torch.py [out.png] [--device cuda|cpu]

Solves ``plot_brachi.py``'s cases -- the Brachistochrone at n = 2, 3, 5 and
500 (max_iter 60) and the moving-floor variant (``brachistochrone_hli``,
n=100, max_iter 40) -- on the serial path on ``cpu`` and on the kernel
path (emission + kernel B1, kernel B2) on ``cuda``, the default; prints
each solve's result and renders both panels to a PNG.  Without matplotlib
it says that no PNG was written and exits 0.  Imports no JAX.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from try_brachi_torch import A_CYCLOID, brachi_options  # noqa: E402
from try_car_torch import check_device, path_options  # noqa: E402

NS = (2, 3, 5, 500)  # testBrachi.m:18
N_HLI = 100


def solves(device: str) -> dict:
    """``{label: (grid x, Solution as numpy, params)}`` of every case."""
    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.models import brachistochrone

    out = {}
    prob = brachistochrone.brachistochrone()
    opts = brachi_options(device, max_iter=60)
    for n in NS:
        p, x0, u0 = brachistochrone.default_setup(n)
        out[f"n={n}"] = (np.linspace(0, 2 * np.pi, n + 1), ddp.to_numpy(
            ddp.solve(prob, x0, u0, p, opts, device=device)), p)
    p, x0, u0 = brachistochrone.default_setup_hli(N_HLI)
    opts_h = ddp.SolverOptions(max_iter=40, w_pen_init_l=40.0,
                               w_pen_init_f=1e-5, w_pen_max_f=1.0,
                               full_ddp=False, **path_options(device))
    out[f"hli n={N_HLI}"] = (
        np.linspace(0, 2 * np.pi, N_HLI + 1), ddp.to_numpy(ddp.solve(
            brachistochrone.brachistochrone_hli(), x0, u0, p, opts_h,
            device=device)), p)
    return out


def render(cases: dict, out: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 5))
    phis = np.linspace(0.0, np.pi, 1000)
    cx = A_CYCLOID * (phis - np.sin(phis))
    cy = A_CYCLOID * (np.cos(phis) - 1.0)
    ax1.plot(cx, cy, "k--", lw=2, label="cycloid (analytic)")
    for label, (xg, sol, _) in cases.items():
        if label.startswith("n="):
            n = len(xg) - 1
            ax1.plot(xg, sol.xs[:, 0], marker="o" if n <= 5 else None, ms=3,
                     label=f"{label} (cost {float(sol.cost):.4f})")
    ax1.grid(True); ax1.legend(); ax1.set_title("Brachistochrone vs cycloid")
    ax1.set_xlabel("x"); ax1.set_ylabel("y")
    xg, sol, p = cases[f"hli n={N_HLI}"]
    ax2.plot(cx, cy, "k--", lw=1, label="cycloid (unconstrained)")
    ax2.plot(xg, np.asarray(p["ymin"]), "r-", lw=1, label="floor ymin[k]")
    ax2.plot(xg, sol.xs[:, 0], "b-", label="constrained optimum")
    ax2.grid(True); ax2.legend()
    ax2.set_title("hli: time-varying floor ([k]-indexed params)")
    ax2.set_xlabel("x")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="brachistochrone.png")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    check_device(args.device)
    cases = solves(args.device)
    print(f"device: {args.device}")
    for label, (_, sol, _) in cases.items():
        print(f"{label}: success: {bool(sol.success)} status: "
              f"{int(sol.status)} iters: {int(sol.iterations)} cost: "
              f"{float(sol.cost)}")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"matplotlib is not installed: no PNG written ({args.out})")
        return 0
    render(cases, args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
