"""Time kernels B1, B2 and B3 of the port under other tile constants, and
against another source tree, on one CUDA card.

    python3 scripts/tile_sweep.py [--lanes 16] [--warps 4]
        [--rollout 8x16,16x32] [--kernels B1,B2,B3] [--parent DIR]
        [--widths 2048,128] [--reps 10] [--out FILE]

Each variant is a copy of ``ddp_generator_tpu_torch/csrc`` with tile
constants replaced: for B1 and B3 the lanes per block (``kLanes``,
staged.cuh) and B3's producer warps (``kProducerWarps``,
fused_launch.cuh), one variant per ``--lanes`` x ``--warps``; for B2 the
lanes per block and the
steps per tile (``kRolloutLanes`` x ``kRolloutSteps``, rollout.cuh), one
variant per ``--rollout`` entry.  The tree as it stands is always a
variant (``tree``); ``--parent`` adds the kernels of other checkouts
(comma-separated; each its
``ddp_generator_tpu_torch/csrc``, built as they are; a tree from before the
staged kernels, whose C interface took a block size, is called through
that interface) and puts them first: ``parent``, ``parent2``, ...
All are built in parallel into ``build/torch_kernels/``, then timed in
turns (CUDA events, after a warm-up launch) on the operands of
``chip_smoke.py`` phases 3, 4 and 4b: CarParking, FULL_DDP, regType 1, the
initial rollout of ``bench.py``'s inputs, B2 on the gains of B1 (the sweep
of 8 alphas, and the selected rollout with cost), float32 at the given
widths and float64 at B=256, N=500.  Every variant's outputs are compared
with the first variant's, bit for bit (B2: cost, ok, xs, xf, us).  Prints
one line per variant and kernel, and the registers and spill that
``ptxas`` reported, and writes all of it as JSON to ``--out``.  Imports no
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from ddp_generator_tpu_torch import _build  # noqa: E402


def variant_sources(label: str, constants) -> Path:
    """A copy of the package's csrc with ``(file, constant, value)`` tile
    constants set."""
    dst = _build.BUILD_ROOT.parent / "tile_sweep" / label
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(_build.CSRC, dst)
    for name, const, val in constants:
        f = dst / name
        text, n = re.subn(rf"constexpr int {const} = \d+;",
                          f"constexpr int {const} = {val};", f.read_text())
        if n != 1:
            raise RuntimeError(f"{name}: tile constant {const} not found")
        f.write_text(text)
    return dst


class LegacyLib:
    """The C interface of a tree whose kernels took a block size, as the
    wrappers of this tree call it."""

    def __init__(self, path: Path, block: int = 32):
        raw = ctypes.CDLL(str(path))
        i, p = ctypes.c_int, ctypes.c_void_p
        raw.ddp_backpass.argtypes = [i] * 8 + [ctypes.POINTER(p), p]
        raw.ddp_fused.argtypes = ([i, ctypes.c_char_p] + [i] * 5
                                  + [ctypes.POINTER(p), p])
        raw.ddp_error_string.argtypes = [i]
        raw.ddp_error_string.restype = ctypes.c_char_p
        self.raw, self.block = raw, block
        self.ddp_error_string = raw.ddp_error_string

    def ddp_backpass(self, *a):
        return self.raw.ddp_backpass(*a[:7], self.block, *a[7:])

    def ddp_fused(self, *a):
        return self.raw.ddp_fused(*a[:6], self.block, *a[6:])


def open_any(path: Path):
    """A built library, through the C interface it has."""
    if hasattr(ctypes.CDLL(str(path)), "ddp_backpass_info"):
        return _build.open_library(path)
    return LegacyLib(path)


def ptxas_summary(path: Path) -> dict:
    """{kernel: (registers, spill store bytes)} of B1's, B2's and B3's
    kernels."""
    out, name = {}, None
    text = (path.parent / "ptxas.txt").read_text().splitlines()
    for ln in text:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name and any(k in name for k in (
                "backpass_kernel", "fused_kernel", "rollout_kernel")):
            out[demangle(name)] = (int(m.group(1)), spill)
            name = None
    return out


def demangle(name: str) -> str:
    try:
        return subprocess.run(["c++filt", name], capture_output=True,
                              text=True).stdout.strip() or name
    except FileNotFoundError:
        return name


def operands(B: int, dtype):
    """B1's and B3's arguments at phase 3's operands, width B, and what
    B2's need beside B1's gains."""
    import numpy as np
    import torch

    from ddp_generator_tpu_torch.models import car_parking

    problem = car_parking.car_parking()
    p, r, m, w, sd, fcx, fcxx, us_cm, _ = cs.nominal_bundle(
        problem, B, cs.T_MAIN, dtype, torch.device("cuda"))
    rng = np.random.default_rng(0)
    lam_np = 10.0 ** rng.uniform(-6, 2, size=B)
    lam_np[::4] = -1.0
    lam = torch.as_tensor(lam_np, dtype=dtype, device="cuda")[None]
    b1 = (sd, fcx, fcxx, us_cm, lam, problem.n_x, 1, True)
    b3 = (problem, r.xs, r.us, m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w, w,
          lam[0], p, 1, True)
    return b1, b3, (problem, p, r, m, w)


def rollout_calls(b2, gains):
    """B2's two timed calls as chip_smoke.py phase 4 makes them: the sweep
    and the selected rollout with cost, on B1's gains ``(l, L)``."""
    import numpy as np
    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.ops import cuda_rollout as cr

    problem, p, r, m, w = b2
    B, N = r.us.shape[:2]
    l_b = gains[0].permute(2, 0, 1)
    L_b = gains[1].permute(2, 0, 1).reshape(B, N, problem.n_u, problem.n_x)
    alphas = tuple(ddp.SolverOptions().alpha)
    ctx = cr._LSCtx(problem, r.xs[:, 0], r.xs, r.us, l_b, L_b, None, None,
                    m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w, w, alphas)
    alpha_vec = torch.as_tensor(
        np.random.default_rng(1).choice(alphas, B), dtype=r.us.dtype,
        device=r.us.device)[None].contiguous()
    return (("B2 sweep", lambda: ctx.call(problem, p, None, multi=True)),
            ("B2 selected", lambda: ctx.call(problem, p, alpha_vec,
                                             multi=False, want_cost=True)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", default="")
    ap.add_argument("--warps", default="5")
    ap.add_argument("--rollout", default="")
    ap.add_argument("--kernels", default="B1,B2,B3")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--widths", default="2048,128")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from ddp_generator_tpu_torch.ops import cuda_backpass as cb
    from ddp_generator_tpu_torch.ops import cuda_fused as cf

    srcs = {}
    for n, parent in enumerate(filter(None, (args.parent or "").split(","))):
        srcs["parent" + (str(n + 1) if n else "")] = (
            Path(parent) / "ddp_generator_tpu_torch" / "csrc")
    srcs["tree"] = _build.CSRC
    for g in filter(None, args.lanes.split(",")):
        for wp in args.warps.split(","):
            srcs[f"G{g}_W{wp}"] = variant_sources(
                f"G{g}_W{wp}", (("staged.cuh", "kLanes", g),
                                ("fused_launch.cuh", "kProducerWarps", wp)))
    for gs in filter(None, args.rollout.split(",")):
        g, st = gs.split("x")
        srcs[f"B2_{gs}"] = variant_sources(
            f"B2_{gs}", (("rollout.cuh", "kRolloutLanes", g),
                         ("rollout.cuh", "kRolloutSteps", st)))
    with ThreadPoolExecutor(len(srcs)) as ex:
        paths = dict(zip(srcs, ex.map(_build.build, srcs.values())))
    libs = {k: open_any(v) for k, v in paths.items()}
    ptx = {k: ptxas_summary(v) for k, v in paths.items()}

    cases = [(f"f32 B={b}", int(b), torch.float32)
             for b in args.widths.split(",")]
    cases.append(("f64 B=256", 256, torch.float64))
    results = {k: {} for k in libs}
    mismatch = {}
    wanted = args.kernels.split(",")
    for label, B, dtype in cases:
        b1, b3, b2 = operands(B, dtype)
        _build.load_library = lambda: libs["tree"]
        calls = [("B1", lambda: cb.back_pass_cm(*b1)),
                 ("B3", lambda: cf.fused_derivs_back_pass(*b3))]
        calls += rollout_calls(b2, cb.back_pass_cm(*b1))
        calls = [(k, fn) for k, fn in calls if k[:2] in wanted]
        ref = {}
        for rnd in range(2):  # in turns: every variant, twice
            for name, lib in libs.items():
                _build.load_library = lambda lib=lib: lib
                for kern, fn in calls:
                    # a variant of B2's constants times B2 only, one of
                    # B1's and B3's those two only
                    if (not name.startswith(("parent", "tree")) and
                            name.startswith("B2_") != kern.startswith("B2")):
                        continue
                    out = fn()
                    torch.cuda.synchronize()
                    flat = (list(out[0]) + [out[1]] if kern == "B3"
                            else list(out))
                    same = None
                    if kern in ref:
                        same = all(torch.equal(a, b) or (
                            a.dtype != torch.bool and torch.equal(
                                torch.isnan(a), torch.isnan(b)) and
                            torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))
                            for a, b in zip(flat, ref[kern]))
                    else:
                        ref[kern] = flat
                    if same is False:
                        mismatch.setdefault(name, set()).add(
                            f"{kern} {label}")
                    ms = cs.time_ms(fn, args.reps)
                    rec = results[name].setdefault(f"{kern} {label}", [])
                    rec.append(ms)
                    print(f"[sweep] {name} {kern} {label} round={rnd} "
                          f"ms={ms:.4f} same_as_first={same}", flush=True)
    for name, d in ptx.items():
        for k, (regs, spill) in sorted(d.items()):
            if "4, 2," in k or "CarParking" in k:  # the operands' shape
                print(f"[ptxas] {name} regs={regs} spill={spill} {k}")
    differ = [f"{n} {k}" for n, d in results.items() for k in d
              if k in mismatch.get(n, ())]
    if differ:
        print("[sweep] outputs differ from the first variant's:", differ)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"times_ms": results, "ptxas": {k: {n: list(v) for n, v in
                                                d.items()}
                                            for k, d in ptx.items()}},
            indent=1))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
