"""Read the numbers that decide ``correct``, for setting their limits.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> --mode sound|control|<fault> \
        [--out FILE]

Runs the cell (set-up, a window of ``--seconds``, the check) once per seed,
each seed in a process of its own (in one process, a whole-solve graph
cached by a first run and replayed after its clean-up hit an illegal
memory access on the card: PERF.md, Open questions), and prints one JSON
line per seed: the mode, the seed, each number, ``correct`` under the
limits in ``limits/<cell>.json``, the solves and lanes judged.
``control`` puts the configuration's lower-precision control in the
program's place (``harness/control.py``); a fault's name (``unchanged``,
``stalled``, ``half``, ``altered``) plants that fault in the program
(``harness/faults.py``).  The benchmark's own runs never do either.
Needs a CUDA device, as ``run.py`` does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

from harness.faults import FAULTS  # noqa: E402


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", default="sound",
                    choices=("sound", "control") + FAULTS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = args.seeds.split(",")
    if len(seeds) > 1:
        import subprocess

        i = argv.index("--seeds") + 1
        rc = 0
        for seed in seeds:
            one = argv[:i] + [seed] + argv[i + 1:]
            rc |= subprocess.run([sys.executable, __file__, *one]).returncode
        return rc
    import torch

    from harness.cell import run_cell
    from harness.spec import Spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    t0 = time.time()
    res = run_cell(Spec(), args.workload, int(seeds[0]), args.seconds,
                   False, "cuda", t0, mode=args.mode)
    run = res["run"]
    rec = {"workload": args.workload, "mode": args.mode,
           "seed": int(seeds[0]), "correct": res["correct"],
           "failed": res["failed"],
           "numbers": {k: v["value"] for k, v in res["checks"].items()},
           "per_lane": res["lanes"], "solves": len(run.solves),
           "lanes": sum(r.lanes for r in run.solves),
           "wall_s": [r.wall_s for r in run.solves],
           "setup_s": run.setup_total, "run_s": time.time() - t0}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
