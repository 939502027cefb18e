"""Time kernels B1 and B3 of the port under other tile constants, and
against another source tree, on one CUDA card.

    python3 scripts/tile_sweep.py [--lanes 16] [--warps 4]
        [--parent DIR] [--widths 2048,128] [--reps 10] [--out FILE]

Each variant is a copy of ``ddp_generator_tpu_torch/csrc`` with the lanes
per block (``kLanes``, staged.cuh) and B3's producer warps
(``kProducerWarps``, fused.cu) replaced; ``--parent`` adds the kernels of
another checkout (its ``ddp_generator_tpu_torch/csrc``, built as they are;
a tree from before the staged kernels, whose C interface took a block
size, is called through that interface).
All are built in parallel into ``build/torch_kernels/``, then timed in
turns (CUDA events, after a warm-up launch) on the operands of
``chip_smoke.py`` phases 3 and 4b: CarParking, FULL_DDP, regType 1, the
initial rollout of ``bench.py``'s inputs, float32 at the given widths and
float64 at B=256, N=500.  Every variant's outputs are compared with the
first variant's, bit for bit.  Prints one line per variant and kernel, and
the registers and spill that ``ptxas`` reported, and writes all of it as
JSON to ``--out``.  Imports no JAX.
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


def variant_sources(lanes: int, warps: int) -> Path:
    """A copy of the package's csrc with the two tile constants set."""
    dst = _build.BUILD_ROOT.parent / "tile_sweep" / f"G{lanes}_W{warps}"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(_build.CSRC, dst)
    for name, pat, val in (("staged.cuh", r"constexpr int kLanes = \d+;",
                            f"constexpr int kLanes = {lanes};"),
                           ("fused.cu", r"constexpr int kProducerWarps = \d+;",
                            f"constexpr int kProducerWarps = {warps};")):
        f = dst / name
        text, n = re.subn(pat, val, f.read_text())
        if n != 1:
            raise RuntimeError(f"{name}: tile constant not found")
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
    """{kernel: (registers, spill store bytes)} of B1's and B3's kernels."""
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
        if m and name and ("backpass_kernel" in name or "fused_kernel" in name):
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
    """B1's and B3's arguments at phase 3's operands, width B."""
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
    return b1, b3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", default="16")
    ap.add_argument("--warps", default="4")
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
    if args.parent:
        srcs["parent"] = Path(args.parent) / "ddp_generator_tpu_torch" / "csrc"
    for g in map(int, args.lanes.split(",")):
        for wp in map(int, args.warps.split(",")):
            srcs[f"G{g}_W{wp}"] = variant_sources(g, wp)
    with ThreadPoolExecutor(len(srcs)) as ex:
        paths = dict(zip(srcs, ex.map(_build.build, srcs.values())))
    libs = {k: open_any(v) for k, v in paths.items()}
    ptx = {k: ptxas_summary(v) for k, v in paths.items()}

    cases = [(f"f32 B={b}", int(b), torch.float32)
             for b in args.widths.split(",")]
    cases.append(("f64 B=256", 256, torch.float64))
    results = {k: {} for k in libs}
    for label, B, dtype in cases:
        b1, b3 = operands(B, dtype)
        ref = {}
        for rnd in range(2):  # in turns: every variant, twice
            for name, lib in libs.items():
                _build.load_library = lambda lib=lib: lib
                for kern, fn in (("B1", lambda: cb.back_pass_cm(*b1)),
                                 ("B3", lambda: cf.fused_derivs_back_pass(
                                     *b3))):
                    out = fn()
                    torch.cuda.synchronize()
                    flat = (list(out) if kern == "B1"
                            else list(out[0]) + [out[1]])
                    same = None
                    if kern in ref:
                        same = all(torch.equal(a, b) or (
                            a.dtype != torch.bool and torch.equal(
                                torch.isnan(a), torch.isnan(b)) and
                            torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))
                            for a, b in zip(flat, ref[kern]))
                    else:
                        ref[kern] = flat
                    ms = cs.time_ms(fn, args.reps)
                    rec = results[name].setdefault(f"{kern} {label}", [])
                    rec.append(ms)
                    print(f"[sweep] {name} {kern} {label} round={rnd} "
                          f"ms={ms:.4f} same_as_first={same}", flush=True)
    for name, d in ptx.items():
        for k, (regs, spill) in sorted(d.items()):
            if "4, 2," in k or "CarParking" in k:
                print(f"[ptxas] {name} regs={regs} spill={spill} {k}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"times_ms": results, "ptxas": {k: {n: list(v) for n, v in
                                                d.items()}
                                            for k, d in ptx.items()}},
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
