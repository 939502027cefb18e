"""Wall time of ``chip_smoke.py``'s full-width CarParking solve (B=2048,
T=500, max_iter=200, float32), for this tree or another checkout, on one
CUDA card.

    python3 scripts/solve_wall.py [--root DIR] [--path fused] [--repeats 3]

``--root`` names the checkout whose ``chip_smoke.py`` and
``ddp_generator_tpu_torch`` are imported (default: this tree), so two
trees can be timed in turns inside one call.  Builds the kernels first
(set-up, not timed), then solves ``--repeats`` times through
``chip_smoke.main_path`` and prints one line per solve: wall seconds,
solves/s, solved %, exhausted %, mean iterations and body calls, and the
kernel launches.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--path", default="fused", choices=("fused", "kernel"))
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ddp_generator_tpu_torch import _build
    from ddp_generator_tpu_torch.models import car_parking

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.load_library()
    problem = car_parking.car_parking()
    for rep in range(args.repeats):
        stats = cs.main_path(problem, args.path)
        if isinstance(stats, tuple):  # newer trees: (numbers, solution)
            stats = stats[0]
        launches = stats.pop("launches")
        cs.line("solve_wall", root=args.root, path=args.path, repeat=rep,
                **stats, **{f"launches_{k}": v for k, v in launches.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
