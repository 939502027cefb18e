"""Benchmark of the PyTorch/CUDA port: batched CarParking solves/s on one GPU.

    python3 bench_torch.py [--backpass kernel|fused|serial] [--batch 2048] ...

The workload of ``bench.py`` (``bench.py:143-191``: CarParking,
``default_setup(T, seed=0)``, ``u0s = 0.1 * standard_normal((B, T, 2))``
from ``default_rng(0)``, tolFun 1e-5 in float32 and 1e-7 in float64)
through the port's ``StepwiseSolver``.  The defaults are the port's main
path: ``backpass_method="kernel"`` (emission + kernel B1) and
``linesearch_method="kernel"`` (kernel B2), float32, on the CUDA device.
``--cpu`` runs on the CPU, the kernels' plain versions; without it and
without a CUDA device the script exits nonzero.

The kernel build, ``StepwiseSolver.precompile`` (every working width's
body call captured as a CUDA graph; ``--no-precompile`` leaves each width
to its first use, as ``bench.py``'s flag does) and one untimed solve come
first; the wall is the least of ``--repeats`` timed solves, each ended by
a synchronize.  ``vs_baseline``
divides solves/s by the reference C solver's 0.625 solves/s (200
iterations x 8 ms, ``bench.py``'s baseline).  Prints exactly ONE JSON line
on stdout; everything else goes to stderr.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

BASELINE_SOLVES_PER_S = 0.625  # 200 iterations x 8 ms (bench.py)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--T", type=int, default=500)
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--compact-levels", type=int, default=4)
    ap.add_argument("--min-compact", type=int, default=128)
    ap.add_argument("--inline-below", type=int, default=0)
    ap.add_argument("--lam-retry", default="deferred",
                    choices=["deferred", "inline"])
    ap.add_argument("--backpass", default="kernel",
                    choices=["serial", "kernel", "fused"])
    ap.add_argument("--linesearch", default="kernel",
                    choices=["serial", "kernel"])
    ap.add_argument("--no-staged-ls", action="store_true",
                    help="kernel line search without the alpha[0] fast path")
    ap.add_argument("--no-precompile", action="store_true",
                    help="skip StepwiseSolver.precompile before the first "
                    "solve (widths are captured at first use)")
    ap.add_argument("--debug", type=int, default=0,
                    help="solver debug_level (>= 1 syncs once per chunk "
                    "inside the timed solve)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        log("no CUDA device: bench_torch.py runs on a GPU (--cpu for the "
            "CPU)")
        return 2
    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch import _build
    from ddp_generator_tpu_torch.launches import read_launches, reset_launches
    from ddp_generator_tpu_torch.models import car_parking

    device = "cpu" if args.cpu else "cuda"
    name = "cpu" if args.cpu else torch.cuda.get_device_name(0)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    if device == "cuda":
        t0 = time.time()
        _build.build()
        _build.load_library()
        log(f"kernel build: {time.time() - t0:.1f}s")
    log(f"device={name} torch={torch.__version__} cuda={torch.version.cuda}"
        f" dtype={args.dtype} backpass={args.backpass}"
        f" linesearch={args.linesearch}")

    options = ddp.SolverOptions(
        max_iter=args.max_iter, dtype=args.dtype,
        tolFun=1e-7 if args.dtype == "float64" else 1e-5,
        backpass_method=args.backpass, linesearch_method=args.linesearch,
        linesearch_staged=not args.no_staged_ls, lam_retry=args.lam_retry,
        debug_level=args.debug)
    solver = ddp.StepwiseSolver(
        car_parking.car_parking(), options, chunk=args.chunk,
        compact_levels=args.compact_levels,
        min_compact_batch=args.min_compact, inline_below=args.inline_below,
        device=device)
    p, x0, _ = car_parking.default_setup(T=args.T, seed=0)
    rng = np.random.default_rng(0)
    B = args.batch
    np_dtype = np.dtype(args.dtype)
    x0s = np.tile(np.asarray(x0, np_dtype), (B, 1))
    u0s = (0.1 * rng.standard_normal((B, args.T, 2))).astype(np_dtype)
    p = {k: np.asarray(v, np_dtype) for k, v in p.items()}

    if not args.no_precompile:
        log(f"precompile: {solver.precompile(x0s, u0s, p):.2f}s")
    t0 = time.time()
    solver(x0s, u0s, p)
    sync()
    log(f"warm-up solve: {time.time() - t0:.1f}s")
    times = []
    for _ in range(args.repeats):
        reset_launches()
        sync()
        t0 = time.time()
        sol = solver(x0s, u0s, p)
        sync()
        times.append(time.time() - t0)
    launches = read_launches()
    dt = min(times)
    st = solver.last_stats
    log(f"loop: {st.body_calls} body calls, {st.replays} graph replays, "
        f"{st.host_reads} host reads; graphed widths {st.graphed}, eager "
        f"widths {st.eager}")

    s = ddp.to_numpy(sol)
    solved = np.isin(s.status, (1, 2))
    exhausted = s.status == 7
    body = int(s.body_calls.sum())
    log(f"batch={B} walls={[round(t, 3) for t in times]}s"
        f" solved={solved.mean() * 100:.2f}%"
        f" exhausted={exhausted.mean() * 100:.2f}%"
        f" iters: mean={s.iterations.mean():.2f} max={s.iterations.max()}"
        f" body calls: mean={s.body_calls.mean():.2f}"
        f" cost: mean={s.cost.mean():.6g} launches={launches}")
    solves_per_s = B / dt
    print(json.dumps({
        "metric": "carparking_batched_solves_per_s_per_chip",
        "value": round(solves_per_s, 3),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / BASELINE_SOLVES_PER_S, 2),
        "solved_pct": round(float(solved.mean()) * 100, 2),
        "exhausted_pct": round(float(exhausted.mean()) * 100, 2),
        "mean_iterations": round(float(s.iterations.mean()), 2),
        "mean_body_calls": round(float(s.body_calls.mean()), 2),
        "stale_pct": round(100 * float(s.stale_calls.sum()) / max(body, 1),
                           2),
        "device": name,
        "torch_cuda": torch.version.cuda,
        "launches_per_solve": launches,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
