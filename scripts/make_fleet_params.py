"""Write the benchmark's mixed-fleet CarParking configuration.

    python3 scripts/make_fleet_params.py [--out FILE]

``port_bench/configs/car_parking_fleet_f32_kernel.json``: the problem,
options and solver settings of ``car_parking_f32_kernel.json``, and params
with one row per vehicle of a batch of 2,048 (``StepwiseSolver(...,
batch_params=True, require_kernels=True)``).  Vehicle ``b`` sits on a
lattice of 16 wheelbases, 8 steering limits and 16 acceleration limits:
with ``i = b // 128``, ``j =
(b // 16) % 8`` and ``m = b % 16``, ``d = 1.5 + 1.5 i / 15`` (1.5 to 3.0;
published 2.0), ``limW = +-(0.3 + 0.3 j / 7)`` (0.3 to 0.6; published
0.5) and ``limA = +-(1 + 2 m / 15)`` (1 to 3; published 2).  The other
parameters are ``testCar.m``'s on every row.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "port_bench" / "configs"
LANES = 2048


def vehicle(b: int) -> tuple:
    """``(d, limW, limA)`` of vehicle ``b``."""
    i, j, m = b // 128, (b // 16) % 8, b % 16
    return 1.5 + 1.5 * i / 15, 0.3 + 0.3 * j / 7, 1.0 + 2.0 * m / 15


def config() -> dict:
    base = json.loads((CONFIGS / "car_parking_f32_kernel.json").read_text())
    rows = [vehicle(b) for b in range(LANES)]
    params = {k: [v] * LANES for k, v in base["params"].items()}
    params["d"] = [d for d, _, _ in rows]
    params["limW"] = [[-w, w] for _, w, _ in rows]
    params["limA"] = [[-a, a] for _, _, a in rows]
    return {
        "name": "car_parking_fleet_f32_kernel",
        "source": base["source"] + "; per-call params of iLQG_mex.c:32-33",
        "problem": base["problem"],
        "reference": "car_parking_fleet",
        "n_x": base["n_x"], "n_u": base["n_u"], "T": base["T"],
        "dtype": base["dtype"],
        "params": params,
        "x0": base["x0"], "u0": base["u0"],
        "box_constraints": base["box_constraints"],
        "al_families": base["al_families"],
        "options": base["options"],
        "stepwise": dict(base["stepwise"], batch_params=True,
                         require_kernels=True),
        "reduced": [],
        "assumed": [
            "a mixed fleet of 2048 vehicles, one row of params each "
            "(iLQG_mex.c:32-33 takes params per call): d = 1.5 + 1.5 i/15, "
            "limW = +-(0.3 + 0.3 j/7), limA = +-(1 + 2 m/15) with i = b//128, "
            "j = (b//16)%8, m = b%16; h, pf, cf, cu, cx, px as testCar.m's",
            "dtype float32 (testCar.m runs MATLAB's double): the port's "
            "main path",
            "backpass_method kernel (the emission kernel + kernel B1) and "
            "linesearch_method kernel (B2), reading each lane's params",
            "tolFun 1e-5 (bench.py's float32 setting; the reference's "
            "default is 1e-7 for double)",
            "StepwiseSolver chunk 10, compact_levels 4, min_compact_batch "
            "128 (bench.py's settings), batch_params, precompiled",
            "require_kernels: the planner is sized on the kernels' speed, so "
            "a solver that would run a torch route in their place (tens of "
            "times slower) refuses at construction",
        ],
        "why": "per-lane params through the emission kernel, B1 and B2",
        "control": base["control"],
    }


def dumps(cfg: dict) -> str:
    """JSON as the other configurations are written, a param's rows on one
    line."""
    rows = {k: json.dumps(v, separators=(",", ":"))
            for k, v in cfg["params"].items()}
    text = json.dumps(dict(cfg, params={k: f"@{k}@" for k in rows}),
                      indent=1)
    for k, v in rows.items():
        text = text.replace(f'"@{k}@"', v)
    return text + "\n"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(
        CONFIGS / "car_parking_fleet_f32_kernel.json"))
    args = ap.parse_args()
    Path(args.out).write_text(dumps(config()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
