"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``ddp_generator_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, checks a small
float64 solve lane by lane against the CPU, and drives the main path once:
the batched CarParking solve of ``bench.py`` (B=2048, T=500, max_iter=200,
float32) through ``StepwiseSolver`` with both kernels.  Every phase prints
one line; any failure exits nonzero.  The last two lines are a JSON line
with each kernel's launches on the main path, error and times, and the
contract line ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits nonzero and prints no result.  Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

B_MAIN, T_MAIN, MAX_ITER_MAIN = 2048, 500, 200
# Kernel-vs-plain tolerances, relative to the largest |reference| value of
# each output.  Both sides run the same IEEE operations in the same order
# (the kernels are built without FMA contraction), so any gap is rounding
# of transcendentals grown along the 500-step recursion.  Each limit sits
# about 100x above the largest gap of a sound run on an H100 (B1: 9.1e-8
# in float32, 1.1e-16 in float64; the rollouts: exactly 0 in both).
TOL_B1 = {"float32": 1e-5, "float64": 1e-14}
TOL_ROLLOUT = {"float32": 1e-6, "float64": 1e-14}
SOLVED_MIN = 0.90


def line(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def max_rel_err(a, ref) -> tuple[float, float]:
    """(max |a - ref|, that over max(1, max|ref|)) on the finite entries."""
    import torch

    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(a)):
        return float("inf"), float("inf")
    if not bool(fin.any()):
        return 0.0, 0.0
    err = float((a[fin].double() - ref[fin].double()).abs().max())
    scale = max(1.0, float(ref[fin].double().abs().max()))
    return err, err / scale


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, CUDA events, after a
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def bench_inputs(B: int, T: int, np_dtype, seed: int = 0):
    """bench.py's inputs (bench.py:185-191)."""
    from ddp_generator_tpu_torch.models import car_parking

    p, x0, _ = car_parking.default_setup(T=T, seed=seed)
    rng = np.random.default_rng(seed)
    x0s = np.tile(np.asarray(x0, np_dtype), (B, 1))
    u0s = (0.1 * rng.standard_normal((B, T, 2))).astype(np_dtype)
    p = {k: np.asarray(v, np_dtype) for k, v in p.items()}
    return p, x0s, u0s


def nominal_bundle(problem, B, T, dtype, device):
    """The port's emission (cm_emit) on the initial rollout of bench's
    inputs: the bundle the backward pass sees on its first body call."""
    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.ops.cm_derivs import cm_emit
    from ddp_generator_tpu_torch.ops.forward import forward_pass

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    p_np, x0s, u0s = bench_inputs(B, T, np_dtype)
    p = ddp.params_from_jax(p_np, dtype, device)
    x0 = torch.as_tensor(x0s, device=device)
    u0 = torch.as_tensor(u0s, device=device)
    m = ddp.init_multipliers(problem, B, T, dtype, device)
    w = torch.ones(B, dtype=dtype, device=device)
    r = forward_pass(problem, x0, None, u0, None, None, 0.0, p, m.mu_le,
                     m.mu_li, m.mu_fe, m.mu_fi, w, w)
    sd, fcx, fcxx, us_cm, ok = cm_emit(problem, r.xs, r.us, m.mu_le, m.mu_li,
                                       m.mu_fe, m.mu_fi, w, w, p, True)
    return p, r, m, w, sd, fcx, fcxx, us_cm, ok


def check_backpass(problem, B, T, dtype, tol, reps, rng, device="cuda"):
    """Phase 3: kernel B1 against its plain version on the emitted bundle,
    with lambdas that make a quarter of the lanes fail."""
    import torch

    from ddp_generator_tpu_torch.ops import cuda_backpass as cb

    dev = torch.device(device)
    p, r, m, w, sd, fcx, fcxx, us_cm, ok = nominal_bundle(
        problem, B, T, dtype, dev)
    lam_np = 10.0 ** rng.uniform(-6, 2, size=B)
    lam_np[::4] = -1.0  # Quu - I is indefinite: these lanes fail
    lam = torch.as_tensor(lam_np, dtype=dtype, device=dev)[None]
    args = (sd, fcx, fcxx, us_cm, lam, problem.n_x, 1, True)
    out = cb.back_pass_cm(*args)
    torch.cuda.synchronize()
    ref = cb.back_pass_cm_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(out[4], ref[4]):
        fail(f"backpass {dtype}: failed flags differ in "
             f"{int((out[4] != ref[4]).sum())} lanes")
    n_failed = int(ref[4].sum())
    if not 0 < n_failed < B:
        fail(f"backpass {dtype}: {n_failed} of {B} lanes failed; the check "
             "needs both kinds")
    worst_abs, worst_rel = 0.0, 0.0
    for name, a, b in zip(("l", "L", "dV", "g_norm"), out[:4], ref[:4]):
        e_abs, e_rel = max_rel_err(a, b)
        worst_abs, worst_rel = max(worst_abs, e_abs), max(worst_rel, e_rel)
        if not e_rel <= tol:
            fail(f"backpass {dtype}: {name} differs, rel err {e_rel:.3g} > "
                 f"{tol}")
    ms = time_ms(lambda: cb.back_pass_cm(*args), reps)
    plain_ms = time_ms(lambda: cb.back_pass_cm_plain(*args), 1)
    return dict(B=B, N=T, dtype=str(dtype).replace("torch.", ""),
                failed_lanes=n_failed, max_abs_err=worst_abs,
                max_rel_err=worst_rel, tol=tol, ms=ms, plain_ms=plain_ms,
                derivs_ok=int(ok.sum())), (p, r, m, w, out)


def check_rollout(problem, alphas, p, r, m, w, bp, tol, reps):
    """Phase 4: kernel B2 (sweep, selected rollout with and without cost)
    against its plain version, on the gains of phase 3."""
    import torch

    from ddp_generator_tpu_torch.ops import cuda_rollout as cr

    B, N = r.us.shape[0], r.us.shape[1]
    n_u, n_x = problem.n_u, problem.n_x
    l_b = bp[0].permute(2, 0, 1)
    L_b = bp[1].permute(2, 0, 1).reshape(B, N, n_u, n_x)
    ctx = cr._LSCtx(problem, r.xs[:, 0], r.xs, r.us, l_b, L_b, None, None,
                    m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w, w)
    dtype, dev = r.us.dtype, r.us.device
    rng = np.random.default_rng(1)
    alpha_vec = torch.as_tensor(rng.choice(alphas, B), dtype=dtype,
                                device=dev)[None].contiguous()

    def operands(av):
        return (problem, alphas, ctx.xnom_cm, ctx.unom_cm, ctx.l_cm,
                ctx.L_cm, ctx.mu_le_cm, ctx.mu_li_cm, ctx.x0_cm, ctx.wpl,
                ctx.wpf, ctx.mu_fe_cm, ctx.mu_fi_cm, av, p)

    res = {}
    for mode, av, kw in (("multi", None, dict(multi=True)),
                         ("selected", alpha_vec,
                          dict(multi=False, want_cost=True))):
        out = cr.rollout_call(*operands(av), **kw)
        torch.cuda.synchronize()
        ref = cr.rollout_plain(*operands(av), **kw)
        torch.cuda.synchronize()
        oks = [(a, b) for a, b in zip(out, ref) if a.dtype == torch.bool]
        vals = [(a, b) for a, b in zip(out, ref) if a.dtype != torch.bool]
        for a, b in oks:
            if not torch.equal(a, b):
                fail(f"rollout {mode}: ok flags differ")
        worst_abs, worst_rel = 0.0, 0.0
        for a, b in vals:
            e_abs, e_rel = max_rel_err(a, b)
            worst_abs, worst_rel = max(worst_abs, e_abs), max(worst_rel, e_rel)
        if not worst_rel <= tol:
            fail(f"rollout {mode}: rel err {worst_rel:.3g} > {tol}")
        ms = time_ms(lambda: cr.rollout_call(*operands(av), **kw), reps)
        plain_ms = time_ms(lambda: cr.rollout_plain(*operands(av), **kw), 1)
        res[mode] = dict(max_abs_err=worst_abs, max_rel_err=worst_rel,
                         tol=tol, ms=ms, plain_ms=plain_ms,
                         not_ok=int((~oks[0][1]).sum()))
    # the selected rollout without cost (main path: after the sweep)
    out = cr.rollout_call(*operands(alpha_vec), multi=False)
    ref = cr.rollout_plain(*operands(alpha_vec), multi=False)
    for a, b in zip(out, ref):
        e_abs, e_rel = max_rel_err(a, b)
        if not e_rel <= tol:
            fail(f"rollout selected (no cost): rel err {e_rel:.3g} > {tol}")
    return res


def per_lane_check(problem):
    """Phase 5: a small float64 solve through the kernels on the GPU equals
    the same solve through the plain versions on the CPU, lane by lane."""
    import torch

    import ddp_generator_tpu_torch as ddp

    p, x0s, u0s = bench_inputs(16, 100, np.float64, seed=3)
    x0s = x0s + 0.05 * np.random.default_rng(4).standard_normal(x0s.shape)
    opts = ddp.SolverOptions(max_iter=100, dtype="float64", debug_level=0,
                             backpass_method="kernel",
                             linesearch_method="kernel")
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.time()
        sol = ddp.StepwiseSolver(problem, opts, min_compact_batch=4,
                                 device=dev)(x0s, u0s, p)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (ddp.to_numpy(sol), time.time() - t0)
    g, c = out["cuda"][0], out["cpu"][0]
    for f in ("status", "iterations", "body_calls", "stale_calls"):
        if not np.array_equal(getattr(g, f), getattr(c, f)):
            fail(f"per-lane check: {f} differs: gpu {getattr(g, f)} "
                 f"cpu {getattr(c, f)}")
    cost_rel = float(np.max(np.abs(g.cost - c.cost) / np.abs(c.cost)))
    if not cost_rel <= 1e-8:
        fail(f"per-lane check: cost rel err {cost_rel:.3g} > 1e-8")
    return dict(lanes=16, T=100, status=np.bincount(g.status).tolist(),
                cost_rel_err=cost_rel, gpu_s=round(out["cuda"][1], 2),
                cpu_s=round(out["cpu"][1], 2))


def main_path(problem):
    """Phase 6: bench.py's batched CarParking solve through both kernels."""
    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.ops import cuda_backpass as cb
    from ddp_generator_tpu_torch.ops import cuda_rollout as cr

    p, x0s, u0s = bench_inputs(B_MAIN, T_MAIN, np.float32)
    opts = ddp.SolverOptions(max_iter=MAX_ITER_MAIN, dtype="float32",
                             tolFun=1e-5, debug_level=0,
                             backpass_method="kernel",
                             linesearch_method="kernel")
    solver = ddp.StepwiseSolver(problem, opts, chunk=10, compact_levels=4,
                                min_compact_batch=128, device="cuda")
    cb.back_pass_cm.launches = 0
    cr.rollout_call.launches = {"multi": 0, "selected": 0}
    torch.cuda.synchronize()
    t0 = time.time()
    sol = solver(x0s, u0s, p)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"backpass": cb.back_pass_cm.launches,
                "rollout_multi": cr.rollout_call.launches["multi"],
                "rollout_selected": cr.rollout_call.launches["selected"]}
    s = ddp.to_numpy(sol)
    for name, n in launches.items():
        if n <= 0:
            fail(f"main path: kernel {name} was never launched")
    if s.xs.shape != (B_MAIN, T_MAIN + 1, 4) or s.us.shape != (
            B_MAIN, T_MAIN, 2):
        fail(f"main path: shapes {s.xs.shape} {s.us.shape}")
    if not np.all(np.isfinite(s.cost)):
        fail(f"main path: {int((~np.isfinite(s.cost)).sum())} costs are "
             "not finite")
    solved = float(np.isin(s.status, (1, 2)).mean())
    exhausted = float((s.status == 7).mean())
    if solved < SOLVED_MIN:
        fail(f"main path: solved share {solved:.4f} < {SOLVED_MIN}")
    stats = dict(B=B_MAIN, T=T_MAIN, max_iter=MAX_ITER_MAIN, wall_s=wall,
                 solves_per_s=B_MAIN / wall, solved_pct=100 * solved,
                 exhausted_pct=100 * exhausted,
                 mean_iters=float(s.iterations.mean()),
                 max_iters=int(s.iterations.max()),
                 mean_body_calls=float(s.body_calls.mean()),
                 stale_pct=100 * float(s.stale_calls.sum())
                 / max(1, int(s.body_calls.sum())),
                 mean_cost=float(s.cost.mean()),
                 launches=launches)
    return stats


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 2
    try:
        import ddp_generator_tpu_torch as ddp
        from ddp_generator_tpu_torch import _build
        from ddp_generator_tpu_torch.models import car_parking
    except ImportError as e:
        print(f"the port is not importable from here: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout
    except FileNotFoundError:
        smi = ""
    smi_line = smi.strip().splitlines()[0] if smi.strip() else "n/a"
    try:
        nv = subprocess.run([_build.nvcc_path(), "--version"],
                            capture_output=True, text=True).stdout
        nvcc = [ln for ln in nv.splitlines() if "release" in ln][0].strip()
    except (_build.KernelCompileError, IndexError) as e:
        nvcc = f"unavailable ({e})"
    print(smi_line, flush=True)
    line("device", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=repr(nvcc), gpu=repr(torch.cuda.get_device_name(0)),
         count=torch.cuda.device_count())

    # 2. build
    t0 = time.time()
    lib_path = _build.build()
    _build.load_library()
    ptxas = (lib_path.parent / "ptxas.txt").read_text()
    regs = [int(w) for ln in ptxas.splitlines() if "registers" in ln
            for w in [ln.split("Used ")[1].split(" registers")[0]]]
    spills = sum(int(ln.split(" bytes spill stores")[0].split()[-1])
                 for ln in ptxas.splitlines() if "spill stores" in ln)
    line("build", seconds=round(time.time() - t0, 1), lib=lib_path.name,
         kernels=len(regs), max_registers=max(regs, default=0),
         spill_store_bytes=spills)

    problem = car_parking.car_parking()
    alphas = tuple(ddp.SolverOptions().alpha)
    rng = np.random.default_rng(0)

    # 3. B1 against its plain version
    bp32, (p32, r32, m32, w32, out32) = check_backpass(
        problem, B_MAIN, T_MAIN, torch.float32, TOL_B1["float32"], 20, rng)
    line("backpass_f32", **bp32)
    bp64, (p64, r64, m64, w64, out64) = check_backpass(
        problem, 256, T_MAIN, torch.float64, TOL_B1["float64"], 5, rng)
    line("backpass_f64", **bp64)

    # 4. B2 against its plain version
    ro32 = check_rollout(problem, alphas, p32, r32, m32, w32, out32,
                         TOL_ROLLOUT["float32"], 20)
    for mode, d in ro32.items():
        line(f"rollout_{mode}_f32", B=B_MAIN, N=T_MAIN, **d)
    ro64 = check_rollout(problem, alphas, p64, r64, m64, w64, out64,
                         TOL_ROLLOUT["float64"], 5)
    for mode, d in ro64.items():
        line(f"rollout_{mode}_f64", B=256, N=T_MAIN, **d)
    del out32, out64, r32, r64

    # 5. per-lane check, kernels on the GPU vs plain on the CPU
    line("per_lane", **per_lane_check(problem))

    # 6. the main path
    stats = main_path(problem)
    launches = stats.pop("launches")
    line("main_path", **stats, **{f"launches_{k}": v
                                  for k, v in launches.items()})

    kernels = [
        dict(name="backpass", route="cuda",
             source="ddp_generator_tpu_torch/csrc/backpass.cu",
             replaces="ddp_generator_tpu/ops/pallas_backpass.py:682",
             launches=launches["backpass"],
             max_abs_err=bp32["max_abs_err"], ms=bp32["ms"],
             plain_ms=bp32["plain_ms"]),
    ]
    for mode in ("multi", "selected"):
        kernels.append(dict(
            name=f"rollout_{mode}", route="cuda",
            source="ddp_generator_tpu_torch/csrc/rollout.cu",
            replaces="ddp_generator_tpu/ops/pallas_rollout.py:424",
            launches=launches[f"rollout_{mode}"],
            max_abs_err=ro32[mode]["max_abs_err"], ms=ro32[mode]["ms"],
            plain_ms=ro32[mode]["plain_ms"]))
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
