"""The benchmark of ``ddp_generator_tpu_torch`` on one NVIDIA GPU.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Finds the cell in ``BENCHMARK.json`` and its configuration, traffic,
metrics, counts and limits by name (``harness/spec.py``), runs it
(``harness/cell.py``), and prints one JSON line last on stdout: ``correct``,
``attempted``, ``failed``, ``metrics`` (end to end with ``--trace 0``, per
layer with ``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number that decided ``correct`` with its limit,
also the last lines on stderr.  Exits nonzero, printing no result, without
a CUDA device (or fewer than the cell asks for), and if JAX or the JAX
package was loaded.  The kernel library is built into ``build/`` inside
the checkout at a run's first use.
"""

import time

T_TOP = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ddp_generator_tpu")


def process_start() -> float:
    """The process's start on the host clock (``/proc``, 10 ms), or this
    file's first line where ``/proc`` is not there."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return min(T_TOP, time.time() - age)
    except (OSError, ValueError, IndexError):
        return T_TOP


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE.parent))
    from harness.cell import run_cell
    from harness.spec import Spec

    spec = Spec()
    cell = spec.workload(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark runs on a GPU only")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} GPUs, "
            f"{torch.cuda.device_count()} visible")
        return 2
    line = run_cell(spec, args.workload, args.seed, args.seconds,
                    bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        log(f"the process loaded {found}: the benchmark must not load JAX "
            "or the JAX package")
        return 3
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
