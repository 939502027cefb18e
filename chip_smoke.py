"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``ddp_generator_tpu_torch/csrc``
(with those on the generated models and new B1 shapes, all at once),
holds each against its plain PyTorch version on the card, checks small
float64 solves lane by lane against the CPU, and drives each path once at
full width:

* the main path, the batched CarParking solve of ``bench.py`` (B=2048,
  T=500, max_iter=200, float32) through ``StepwiseSolver`` with kernels B1
  (backward pass) and B2 (line-search rollouts), precompiled: every
  working width's body call is a CUDA graph replay;
* that solve on the kernel and the fused path, graphed against the eager
  route (``make_batched_solver`` under ``eager_loops()``, every loop on
  the host): every Solution field bit for bit, the
  same launches, precompile seconds, peak memory, replays and host reads;
  and derivative emission by the emission kernel and with each
  ``derivs_emitter``; then the same
  comparison for the routes graphed beside them (phase 6d): the serial
  path on that CarParking solve in float64 (max_iter 3), per-lane params
  on the kernel path (max_iter 10) and the parallel backward pass on the
  Brachistochrone (n=500, float64);
* the same solve with ``backpass_method="fused"``: kernel B3 (derivatives
  and backward pass in one kernel) in place of emission + B1;
* the device loops (phase 6e, ``ops/device_loop.py``): that solve on both
  paths through ``make_batched_solver``, the whole solve one CUDA graph
  whose loop is a WHILE node, every Solution field and launch count
  against the ``StepwiseSolver`` solves above, one graph launch and one
  host read a solve, capture seconds, peak memory and node counts;
  ``solve`` on testCar (T=500, float64) graphed and under
  ``eager_loops()``; the inline-retry route (kernel path, B=2048, cut to
  max_iter 20) and the Newton-boxQP route (serial, float64, B=256,
  max_iter 3) graphed by ``StepwiseSolver`` against ``eager_loops()``;
* the Brachistochrone with its moving floor (``brachistochrone_hli``,
  n=500, B=2048, float64) through B3 and B2, the path of the AL families;
* the serial path (``SolverOptions()``'s own methods: PyTorch, no
  kernel) against the kernel path on CarParking at full width, three
  iterations deep;
* the Cartpole swing-up (B=2048, T=150) twice: with the default options
  (serial, float64), cut to max_iter=20 and its first lanes held against
  the CPU, and through B3 and B2 in float32 (max_iter=150, tolFun 1e-5,
  as the main path);
* per-lane params at full width (phase 11): the emission kernel's and
  B2's per-lane launches (sweep, selected rollouts, initial rollout) on
  the benchmark's mixed fleet against their plain versions, then the main
  path's solve with per-lane params (``batch_params=True``, ``limW`` from
  +-0.2 to +-0.5 over the lanes): the emission kernel, B1 and B2 (line
  search and initial rollout) reading each lane's params;
* generated models (phase 12): CarParking and ``brachistochrone_hli``
  with their hand-written CUDA models stripped, so B2 and B3 run the
  models ``codegen.py`` generates from their torch functions -- their
  kernels bit for bit against the hand-written ones, and the main path's,
  the fused path's and the Brachistochrone's solves field by field and
  launch by launch -- and two user problems written here in torch with no
  CUDA model and no ``box_meta`` (``user_problems``: a double integrator
  with AL families, shape (2, 1), and a 3-input point mass, (6, 3)) at
  B=2048 on the kernel and fused paths, their first 16 lanes against the
  CPU, and their B1, B2 and B3 against the plain versions.

* the pipelined solve: the main path's and the fused path's solves again
  with ``pipeline_depth=4`` (the active count read three chunks late),
  every Solution field and launch count equal to the depth-1 solves;
* the parallel path (phase 13): the associative-scan backward pass
  (``backpass_method="parallel"``) against the serial pass on a B=2048
  float64 nominal bundle of the Brachistochrone (n=500) and of the user
  point mass without its input boxes, timed beside B1; both at full width
  through StepwiseSolver with B2, against the kernel path and their first
  16 lanes against the CPU; and the single long horizon (B=1, N = 500,
  2,000, 8,000) timed against B1;
* the auxiliary API on the card (phase 14: ``backpass_trace``, the
  inspector, a carry checkpointed and resumed) and the main path's
  CarParking solve in float64 on the kernel and fused paths (phase 15);
* emission history (phase 0, first): the emission kernel's and each
  torch emitter's bundle of the
  Brachistochrone and of CarParking (B=2048, T/n=500, float32 and
  float64) emitted, then the other problem's, then again, bit for bit,
  with its device kernels and ms before and after;
* the batch mesh (phase 16): the main path's and the fused path's solves
  as two ranks sharing the card (``torch.multiprocessing``, ``gloo``,
  ``StepwiseSolver(mesh=make_mesh())``, 1,024 lanes a rank), every
  Solution field of the reassembled rows bit for bit against the
  single-process solves, one ``int64`` all-reduce per chunk and no other
  collective, the global BatchStats; then testBrachi (n=500, B=2048,
  float64, cut to max_iter 15) through ``make_sharded_solver`` against
  ``make_batched_solver`` under ``eager_loops()`` lane by lane;
* AOT (phase 17): both paths' configurations (B=2048, T=500, float32,
  cut to max_iter 20) exported, restored in a process that imports no
  problem module and solved (the restored solve one graph, its loop a
  WHILE node), bit for bit against the direct solve under
  ``eager_loops()``; the
  restored first solve split into program deserialization, first calls
  and the kernel library's load, and a second restored solve timed;
* the example scripts (phase 19): ``scripts/try_car_torch.py`` (T=500,
  200 iterations) and ``scripts/try_brachi_torch.py`` (n=500) on the
  card, the car's controls inside their boxes and the Brachistochrone's
  gaps to the cycloid within 10x the JAX script's on the CPU.

The emission kernel (``ops/cuda_emit.py``) is held against the torch
emitter (``cm_emit``) on CarParking's initial rollout at B=2048 in float32
and float64 (phase 3b), and its two thread mappings against each other and
timed at B = 1, 128 and 2048 (3c).  The Cartpole instantiations of B1
(4, 1), B2 and B3 are held against their plain versions like
CarParking's, and small float64 solves of the serial path, of the inline
lambda retries and of per-lane params (CarParking and
brachistochrone_hli, kernel and fused path) are checked lane by lane.

Beside the checks it times B1, B2 and B3 at the widths the solver's
compaction reaches (2048 down to 128 lanes), and puts each kernel's time
beside its
lower bound: the larger of its bytes (each input read once, each output
written once, from this run's tensors) over the card's memory rate and
its operations (per (step, lane), counted by ``scripts/count_ops.py``)
over its rate for the type.

Every phase prints one line or more, and a ``phase_seconds`` line; the
serial, Cartpole, per-lane and parallel solves at full width run graphed
(``check_graphed``).  Any failure exits nonzero.  The last two
lines are a JSON line with each kernel's launches on its path, error,
times and bound, and the contract line ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits nonzero and prints no result.  Imports no
JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import types
from pathlib import Path

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
# B3 against its plain version (emission + B1's plain version): the two
# sides differ in how they round the derivatives (forward-mode hyper-duals
# against reverse-mode autograd), so the gap is not 0; the 500-step
# recursion at small lambda amplifies it.  Each limit sits about 100x above
# the largest gap of the first sound run on an H100 (CarParking 9.4e-4 in
# float32, 4.6e-14 in float64; brachistochrone_hli 2.9e-15 in float64;
# Cartpole, N=150, 2.9e-3 in float32, 1.8e-12 in float64; on the user
# problems' generated models, float64, the double integrator 1.6e-16 and
# the point mass 6.9e-13).
TOL_B3 = {"car_parking float32": 1e-1, "car_parking float64": 5e-12,
          "brachistochrone_hli float64": 3e-13,
          "double_integrator float64": 1e-14, "point_mass3 float64": 7e-11,
          "cartpole float32": 3e-1, "cartpole float64": 2e-10}
# The emission kernel against the torch emitter: B3's CarParking limits,
# for the same reason (forward-mode rounding against autograd's); the first
# sound runs on an H100 gave 9.6e-8 in float32.
TOL_EMIT = {"float32": TOL_B3["car_parking float32"],
            "float64": TOL_B3["car_parking float64"]}
SOLVED_MIN = 0.90
N_BRACHI = 500
# The parallel solves are held to the kernel path's cost on every lane
# both solve but those either path leaves at a final lambda above
# LAM_HIGH (the options' lambdaInit: the lane took the tolFun exit while
# regularized more than at its start); at most HIGH_LAMBDA_MAX_LANES of
# 2048 (0.2%) may be so excluded.  On an H100 every lane of both cases
# ended at lambda <= 1.05e-5 in one run; one other run had one such lane;
# with emission free of the process's history, two Brachistochrone lanes
# still did so in a later run (PERF.md), so the bound stays.
LAM_HIGH = 1.0
HIGH_LAMBDA_MAX_LANES = 4
T_POLE, MAX_ITER_POLE = 150, 150  # cartpole.default_setup's horizon
# The serial Cartpole solve at full width is cut to the depth of the
# per-lane serial check (SolverOptions' default max_iter 20): the whole
# eager solve took 164-252 s on an H100; its first lanes are held against
# the CPU's solve of per_lane_serial.
MAX_ITER_POLE_SERIAL = 20
# Per-lane params on the kernel path, graphed against the eager route
# (graphs_routes_phase): the eager reference is cut to max_iter 10.
MAX_ITER_GRAPHS_PER_LANE = 10
# The Cartpole swing-up from x0 = [0, pi, 0, 0] + 0.05 normal: the JAX
# package (float64, serial, on the CPU, max_iter 150) solves 98.4% of the
# first 64 lanes of cartpole_inputs and 98.2% of the first 512, so the 90%
# floor holds there too; but only 80.5% of its solved lanes of the 512 end
# in the upright basin, cos(th_N) > 0.98: the others converge (tolFun) to a
# local minimum a turn further, cos(th_N) ~ 0.977, cost ~1.42 against
# ~0.32.  The floor on that share is the JAX share less 5 points.
UPRIGHT_MIN = 0.805 - 0.05
# Operations per (step, lane) and per lane of each kernel (FULL_DDP,
# regType 1), CarParking's under plain names, the others' with a prefix:
# Cartpole's, CarParking's generated model's and the two user problems'
# (B1 at their shapes (2, 1) and (6, 3)), and B2's on the parallel path's
# two models (the Brachistochrone's hand-written one and the point mass
# without its input boxes), and brachistochrone_hli's B3 and B1 without
# FULL_DDP (``_gn``) and B2 with and without the cost, counted by
# scripts/count_ops.py
# on the kernels' own headers (tests/test_torch_count_ops.py holds these to
# that count; the Riccati step's clamp search depends on the data, so a
# model's count moves with its random operands).
OPS = {"backpass_per_step": 1470, "backpass_per_lane": 1,
       "fused_per_step": 7756, "fused_per_lane": 2065,
       "rollout_per_step": 84,
       "cartpole_backpass_per_step": 822, "cartpole_backpass_per_lane": 1,
       "cartpole_fused_per_step": 4727, "cartpole_fused_per_lane": 799,
       "cartpole_rollout_per_step": 61,
       "gen_car_parking_backpass_per_step": 1470,
       "gen_car_parking_backpass_per_lane": 1,
       "gen_car_parking_fused_per_step": 7757,
       "gen_car_parking_fused_per_lane": 2061,
       "gen_car_parking_rollout_per_step": 84,
       "double_integrator_backpass_per_step": 222,
       "double_integrator_backpass_per_lane": 1,
       "double_integrator_fused_per_step": 629,
       "double_integrator_fused_per_lane": 166,
       "double_integrator_rollout_per_step": 29,
       "point_mass3_backpass_per_step": 5504,
       "point_mass3_backpass_per_lane": 1,
       "point_mass3_fused_per_step": 16532,
       "point_mass3_fused_per_lane": 2374,
       "point_mass3_rollout_per_step": 108,
       "brachistochrone_rollout_per_step": 20,
       "brachistochrone_hli_fused_gn_per_step": 511,
       "brachistochrone_hli_fused_gn_per_lane": 33,
       "brachistochrone_hli_backpass_gn_per_step": 96,
       "brachistochrone_hli_backpass_gn_per_lane": 1,
       "brachistochrone_hli_rollout_per_step": 30,
       "brachistochrone_hli_rollout_nocost_per_step": 6,
       "point_mass3_free_rollout_per_step": 84}
# NVIDIA H100 SXM data sheet: HBM3 rate and the float32/float64 rates
# outside the tensor cores, all at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
WIDTHS = (2048, 1024, 512, 256, 128, 1)
# The user problems of phase 12 (user_problems(), made in main()).
USER_PROBLEMS: dict = {}


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


def nbytes(*tensors) -> int:
    """Bytes of the tensors (None, dicts and non-tensors skipped)."""
    import torch

    total = 0
    for t in tensors:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def ops(model: str, key: str) -> int:
    """``OPS[key]`` of a model (CarParking's have no prefix)."""
    return OPS[key if model == "car_parking" else f"{model}_{key}"]


def model_name(problem, p) -> str:
    """The CUDA model the kernels run for ``problem``: its hand-written
    model, or the one generated from its functions."""
    from ddp_generator_tpu_torch import codegen

    return codegen.kernel_model(problem, p)[0].name


def bound(n_bytes: int, n_ops: int, dtype) -> tuple[float, str]:
    """The least time the card could take (ms) and what sets it."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[str(dtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, CUDA events, after a
    warm-up call (``warm=False``: the caller has just made the same call,
    as before a plain version's timing its reference call)."""
    import torch

    if warm:
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


def graph_ms(fn, reps: int) -> float:
    """Device ms of one ``fn()``: a CUDA graph of ``reps`` calls replayed 3
    times (CUDA events around a replay, the least of the 3), so the gaps
    between replayed nodes count and the host's eager overhead does not."""
    import torch

    from ddp_generator_tpu_torch import launches

    launches.before_capture(torch.device("cuda"))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    best = float("inf")
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) / reps)
    del g
    return best


def same_bits(a, b) -> bool:
    """Equal bit for bit, NaN where NaN."""
    import torch

    if torch.equal(a, b):
        return True
    return (a.is_floating_point() and a.shape == b.shape
            and bool(((a == b) | (a.isnan() & b.isnan())).all()))


def bench_inputs(B: int, T: int, np_dtype, seed: int = 0):
    """bench.py's inputs (bench.py:185-191)."""
    from ddp_generator_tpu_torch.models import car_parking

    p, x0, _ = car_parking.default_setup(T=T, seed=seed)
    rng = np.random.default_rng(seed)
    x0s = np.tile(np.asarray(x0, np_dtype), (B, 1))
    u0s = (0.1 * rng.standard_normal((B, T, 2))).astype(np_dtype)
    p = {k: np.asarray(v, np_dtype) for k, v in p.items()}
    return p, x0s, u0s


def cartpole_inputs(B: int, T: int, np_dtype=np.float64):
    """The swing-up from hanging: x0 = [0, pi, 0, 0] + 0.05 normal and
    u0 = 0.1 normal, each from its own fixed seed, so that the first lanes
    of a batch do not depend on its width."""
    from ddp_generator_tpu_torch.models import cartpole

    p, x0, _ = cartpole.default_setup(T=T)
    noise = np.random.default_rng(5).standard_normal((B, 4))
    x0s = np.tile(x0, (B, 1)) + 0.05 * noise
    u0s = 0.1 * np.random.default_rng(6).standard_normal((B, T, 1))
    p = {k: np.asarray(v, np_dtype) for k, v in p.items()}
    return p, x0s.astype(np_dtype), u0s.astype(np_dtype)


def user_problems():
    """Two problems a user brings, written in torch with their input boxes
    given as ``h`` constraints and no ``box_meta`` (``make_problem`` probes
    them): the double integrator of tests/test_solver_al_families.py:19-38
    with its ``hle`` and ``hfi`` families and a bound on its input (shape
    (2, 1)), and a point mass in three axes with drag and a box on each of
    its three inputs (shape (6, 3)).  Neither names a CUDA model, so the
    kernels run the models generated from these functions.  Returns
    ``{name: (problem, params, options, inputs(B, seed))}``."""
    import torch

    import ddp_generator_tpu_torch as ddp

    def di_f(x, u, p, k):
        dt = p["dt"]
        return torch.stack([x[0] + dt * x[1], x[1] + dt * u[0]])

    def di_L(x, u, p, k):
        return p["r"] * u[0] ** 2

    def di_F(x, p, k):
        return 0.0 * x[0]

    def di_hle(x, u, p, k):  # v(k) = vref
        return x[1] - p["vref"]

    def di_hfi(x, p, k):  # reach position 1
        return 1.0 - x[0]

    def di_lower(x, u, p, k):  # -umax <= u
        return -u[0] - p["umax"]

    def di_upper(x, u, p, k):  # u <= umax
        return u[0] - p["umax"]

    di_p = dict(dt=0.1, r=0.1, vref=0.5, umax=1.0)
    di = ddp.make_problem(
        n_x=2, n_u=1, f=di_f, L=di_L, F=di_F, h=[di_lower, di_upper],
        hle=[di_hle], hfi=[di_hfi], name="double_integrator",
        example_params=di_p)

    def di_inputs(B, seed):  # x0 and u0 from seeds of their own
        return (0.1 * np.random.default_rng(seed).standard_normal((B, 2)),
                0.1 * np.random.default_rng(seed + 1).standard_normal(
                    (B, 40, 1)))

    def pm_f(x, u, p, k):
        dt, cd = p["dt"], p["cd"]
        vel = [x[3 + i] + dt * (u[i] - cd * x[3 + i] * torch.abs(x[3 + i]))
               for i in range(3)]
        return torch.stack([x[i] + dt * vel[i] for i in range(3)] + vel)

    def pm_miss(x, p):
        return sum((x[i] - p["target"][i]) ** 2 for i in range(3))

    def pm_L(x, u, p, k):
        return p["r"] * (u * u).sum(0) + p["q"] * pm_miss(x, p)

    def pm_F(x, p, k):
        speed = sum(x[3 + i] ** 2 for i in range(3))
        return p["qf"] * (pm_miss(x, p) + speed)

    def pm_box(i, sign):  # sign * u[i] - umax[i] < 0
        if sign > 0:
            return lambda x, u, p, k: u[i] - p["umax"][i]
        return lambda x, u, p, k: -u[i] - p["umax"][i]

    pm_p = dict(dt=0.05, cd=1.0, r=0.01, q=0.1, qf=10.0,
                target=np.array([1.0, -1.0, 0.5]),
                umax=np.array([1.0, 1.5, 2.0]))
    pm = ddp.make_problem(
        n_x=6, n_u=3, f=pm_f, L=pm_L, F=pm_F,
        h=[pm_box(i, s) for i in range(3) for s in (-1, 1)],
        name="point_mass3", example_params=pm_p)

    def pm_inputs(B, seed):
        return (0.1 * np.random.default_rng(seed).standard_normal((B, 6)),
                0.1 * np.random.default_rng(seed + 1).standard_normal(
                    (B, 100, 3)))

    return {
        "double_integrator": (di, di_p, dict(
            max_iter=60, w_pen_init_l=10.0, w_pen_fact2=2.0, full_ddp=False,
            tolFun=1e-9), di_inputs),
        "point_mass3": (pm, pm_p, dict(max_iter=100), pm_inputs),
    }


def nominal_rollout(problem, B, T, dtype, device, inputs=bench_inputs):
    """The initial rollout of ``inputs`` (bench's by default) on
    ``device``: ``(params, rollout, multipliers, w_pen)``."""
    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.ops.forward import forward_pass

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    p_np, x0s, u0s = inputs(B, T, np_dtype)
    p = ddp.params_from_jax(p_np, dtype, device)
    x0 = torch.as_tensor(x0s, device=device)
    u0 = torch.as_tensor(u0s, device=device)
    m = ddp.init_multipliers(problem, B, T, dtype, device)
    w = torch.ones(B, dtype=dtype, device=device)
    r = forward_pass(problem, x0, None, u0, None, None, 0.0, p, m.mu_le,
                     m.mu_li, m.mu_fe, m.mu_fi, w, w)
    return p, r, m, w


def emit_args(problem, p, r, m, w):
    """The operands of ``cm_emit`` and ``cuda_emit.emit`` on a nominal
    rollout, FULL_DDP."""
    return (problem, r.xs, r.us, m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w, w,
            p, True)


def nominal_bundle(problem, B, T, dtype, device, inputs=bench_inputs):
    """The port's torch emission (cm_emit) on the initial rollout of
    ``inputs``: the bundle the backward pass sees on its first body call
    (the emission kernel's is held against it in phase 3b)."""
    from ddp_generator_tpu_torch.ops.cm_derivs import cm_emit

    p, r, m, w = nominal_rollout(problem, B, T, dtype, device, inputs)
    sd, fcx, fcxx, us_cm, ok = cm_emit(*emit_args(problem, p, r, m, w))
    return p, r, m, w, sd, fcx, fcxx, us_cm, ok


def emit_outputs(out) -> dict:
    """An emission's outputs by name: every bundle key, ``final_cx``,
    ``final_cxx``, ``us_cm`` and ``ok``."""
    sd, fcx, fcxx, us_cm, ok = out
    return dict(sd, final_cx=fcx, final_cxx=fcxx, us_cm=us_cm, ok=ok)


def emit_gap(what, out, ref, tol) -> tuple[float, float]:
    """Fail unless ``ok`` is equal and every other output of ``out`` lies
    within ``tol`` of ``ref``'s, relative to its largest finite value, with
    the same infinities; returns the largest (absolute, relative) gap."""
    import torch

    a, b = emit_outputs(out), emit_outputs(ref)
    if not torch.equal(a["ok"], b["ok"]):
        fail(f"{what}: ok differs in {int((a['ok'] != b['ok']).sum())} "
             "lanes")
    worst_abs, worst_rel = 0.0, 0.0
    for key, r in b.items():
        if key == "ok":
            continue
        if a[key].shape != r.shape or a[key].dtype != r.dtype:
            fail(f"{what}: {key} is {tuple(a[key].shape)} {a[key].dtype}, "
                 f"want {tuple(r.shape)} {r.dtype}")
        if not (torch.equal(a[key].isposinf(), r.isposinf())
                and torch.equal(a[key].isneginf(), r.isneginf())):
            fail(f"{what}: {key} has other infinities")
        e_abs, e_rel = max_rel_err(a[key], r)
        if not e_rel <= tol:
            fail(f"{what}: {key} differs, rel err {e_rel:.3g} > {tol}")
        worst_abs, worst_rel = max(worst_abs, e_abs), max(worst_rel, e_rel)
    return worst_abs, worst_rel


def check_emit(problem, B, T, dtype, tol, reps):
    """Phase 3b: the emission kernel (``ops/cuda_emit.py``) against the
    torch emitter (``cm_emit``, its plain version) on the initial rollout
    of phase 3: every key of the bundle, ``final_cx``/``final_cxx``,
    ``us_cm`` and ``ok``; the kernel's ms (CUDA events, eager) beside the
    torch emitter's and its bound."""
    import torch

    from ddp_generator_tpu_torch.ops import cuda_emit as ce
    from ddp_generator_tpu_torch.ops.cm_derivs import cm_emit

    key = str(dtype).replace("torch.", "")
    p, r, m, w = nominal_rollout(problem, B, T, dtype, torch.device("cuda"))
    args = emit_args(problem, p, r, m, w)
    ref = cm_emit(*args)
    out = ce.emit(*args)
    torch.cuda.synchronize()
    worst_abs, worst_rel = emit_gap(f"emit {key}", out, ref, tol)
    ms = time_ms(lambda: ce.emit(*args), reps)
    plain_ms = time_ms(lambda: cm_emit(*args), 1)
    model = problem.cuda_model.name
    # B3's operations less B1's: B3 computes these terms, then runs B1's
    # Riccati step on them
    n_ops = ((ops(model, "fused_per_step") - ops(model, "backpass_per_step"))
             * T * B + (ops(model, "fused_per_lane")
                        - ops(model, "backpass_per_lane")) * B)
    bound_ms, bound_by = bound(nbytes(args[1:], out), n_ops, dtype)
    info = ce.kernel_info(model, True, dtype)
    return dict(B=B, N=T, dtype=key, max_abs_err=worst_abs,
                max_rel_err=worst_rel, tol=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                derivs_ok=int(out[4].sum()),
                per=ce.items_per_thread(T, B, info["items"]),
                registers=info["steps_registers"],
                local_bytes=info["steps_local"], **info)


def emit_mappings(problem, reps) -> dict:
    """Phase 3c: the emission kernel's two thread mappings -- one work item
    a thread (``per`` 1) and all of a point's on one thread (``per`` the
    items of a point) -- at B = 1, 128 and 2048 (CarParking, N=500,
    float32, FULL_DDP): the two bit for bit, each within ``TOL_EMIT`` of
    the torch emitter; each timed by ``graph_ms`` over ``reps`` calls
    (the torch emitter over one), beside the wrapper's own choice and
    the bytes bound."""
    import torch

    from ddp_generator_tpu_torch.ops import cuda_emit as ce
    from ddp_generator_tpu_torch.ops.cm_derivs import cm_emit

    items = ce.items_per_point(problem.n_x, problem.n_u, True)
    out = {}
    for B in (1, 128, B_MAIN):
        p, r, m, w = nominal_rollout(problem, B, T_MAIN, torch.float32,
                                     torch.device("cuda"))
        args = emit_args(problem, p, r, m, w)
        ref = cm_emit(*args)
        got = {per: ce.emit(*args, per=per) for per in (1, items)}
        d = dict(B=B, N=T_MAIN, items=items,
                 auto_per=ce.items_per_thread(T_MAIN, B, items))
        for per, o in got.items():
            d[f"per{per}_rel_err"] = emit_gap(
                f"emit B={B} per={per}", o, ref, TOL_EMIT["float32"])[1]
        one, whole = (emit_outputs(o) for o in got.values())
        differ = [k for k in one if not same_bits(one[k], whole[k])]
        if differ:
            fail(f"emit B={B}: the two mappings differ in {differ}")
        d["plain_ms"] = graph_ms(lambda: cm_emit(*args), 1)
        for per in (1, items):
            d[f"per{per}_ms"] = graph_ms(lambda: ce.emit(*args, per=per),
                                         reps)
        d["bound_ms"] = bound(nbytes(args[1:], got[items]), 0,
                              torch.float32)[0]
        out[B] = d
    return out


def check_backpass(problem, B, T, dtype, tol, reps, rng, device="cuda",
                   inputs=bench_inputs, label=None):
    """Phase 3: kernel B1 against its plain version on the emitted bundle,
    with lambdas that make a quarter of the lanes fail."""
    import torch

    from ddp_generator_tpu_torch.ops import cuda_backpass as cb

    dev = torch.device(device)
    model = label or problem.cuda_model.name
    p, r, m, w, sd, fcx, fcxx, us_cm, ok = nominal_bundle(
        problem, B, T, dtype, dev, inputs)
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
    plain_ms = time_ms(lambda: cb.back_pass_cm_plain(*args), 1, warm=False)
    bound_ms, bound_by = bound(
        nbytes(args, out),
        ops(model, "backpass_per_step") * T * B
        + ops(model, "backpass_per_lane") * B, dtype)
    return dict(B=B, N=T, dtype=str(dtype).replace("torch.", ""),
                failed_lanes=n_failed, max_abs_err=worst_abs,
                max_rel_err=worst_rel, tol=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                derivs_ok=int(ok.sum()),
                **cb.kernel_info(problem.n_x, problem.n_u, 1, True, dtype)), (
                    p, r, m, w, out, lam[0], args)


def compare_fused(name, args, tol, reps, label=None):
    """Kernel B3 against its plain version on the same operands: equal
    failed and derivs_ok flags, values within ``tol`` of the largest
    reference value, both timed; ``label`` names the model's operation
    counts (its CUDA model's name by default)."""
    import torch

    from ddp_generator_tpu_torch.ops import cuda_fused as cf

    bp, ok = cf.fused_derivs_back_pass(*args)
    torch.cuda.synchronize()
    ref, ref_ok = cf.fused_derivs_back_pass_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(ok, ref_ok):
        fail(f"fused {name}: derivs_ok differs in "
             f"{int((ok != ref_ok).sum())} lanes")
    if not torch.equal(bp.failed, ref.failed):
        fail(f"fused {name}: failed flags differ in "
             f"{int((bp.failed != ref.failed).sum())} lanes")
    B = ok.shape[0]
    n_failed = int(ref.failed.sum())
    if not 0 < n_failed < B:
        fail(f"fused {name}: {n_failed} of {B} lanes failed; the check "
             "needs both kinds")
    worst_abs, worst_rel = 0.0, 0.0
    for field in ("l", "L", "dV", "g_norm"):
        e_abs, e_rel = max_rel_err(getattr(bp, field), getattr(ref, field))
        worst_abs, worst_rel = max(worst_abs, e_abs), max(worst_rel, e_rel)
        if not e_rel <= tol:
            fail(f"fused {name}: {field} differs, rel err {e_rel:.3g} > "
                 f"{tol}")
    ms = time_ms(lambda: cf.fused_derivs_back_pass(*args), reps)
    plain_ms = time_ms(lambda: cf.fused_derivs_back_pass_plain(*args), 1,
                       warm=False)
    problem, us, reg_type, full_ddp = args[0], args[2], args[11], args[12]
    res = dict(B=B, failed_lanes=n_failed, derivs_ok=int(ok.sum()),
               max_abs_err=worst_abs, max_rel_err=worst_rel, tol=tol,
               ms=ms, plain_ms=plain_ms)
    model = label or problem.cuda_model.name
    if model != "brachistochrone_hli":
        N = us.shape[1]
        res["bound_ms"], res["bound_by"] = bound(
            nbytes(args, bp, ok),
            ops(model, "fused_per_step") * N * B
            + ops(model, "fused_per_lane") * B, us.dtype)
    return dict(res, **cf.kernel_info(model_name(problem, args[10]),
                                      reg_type, full_ddp, us.dtype))


def check_fused_model(problem, p, r, m, w, lam, reps):
    """Phase 4b: B3 on CarParking (or Cartpole) at the operands of phase 3
    (the initial rollout of its inputs, phase 3's lambdas), regType 1,
    FULL_DDP."""
    name = (problem.cuda_model.name + " "
            + str(r.us.dtype).replace("torch.", ""))
    args = (problem, r.xs, r.us, m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w, w,
            lam, p, 1, True)
    return compare_fused(name, args, TOL_B3[name], reps), args


def widths_phase(b1_args, b3_args, b2_args, reps):
    """Phase 4d: B1, B3 and B2 (the sweep; the selected rollout with cost)
    at each compaction width and at one lane, the ``single`` cells' width
    (the first w lanes of phases 3, 4b and 4's operands), CUDA events.  Per-lane work is a dependent chain over N, so
    below ~132 SMs' worth of blocks the time should stay flat: the chain's
    latency is the floor."""
    from ddp_generator_tpu_torch.ops import cuda_backpass as cb
    from ddp_generator_tpu_torch.ops import cuda_fused as cf
    from ddp_generator_tpu_torch.ops import cuda_rollout as cr

    def lanes(a, w):  # the first w lanes of a B1 (..., B) operand
        if isinstance(a, dict):
            return {k: lanes(v, w) for k, v in a.items()}
        if hasattr(a, "shape"):
            return a[..., :w].contiguous()
        return a

    def rows(a, w):  # the first w lanes of a B3 (B, ...) operand
        return a[:w].contiguous() if hasattr(a, "shape") else a

    def b2_lanes(ops, w):  # (problem, alphas, 12 (..., B) operands, params)
        return ops[:2] + tuple(lanes(a, w) for a in ops[2:14]) + ops[14:]

    out = {}
    for w in WIDTHS:
        a1 = tuple(lanes(a, w) for a in b1_args)
        a3 = tuple(rows(a, w) for a in b3_args)
        multi, selected = (b2_lanes(ops, w) for ops in b2_args)
        out[w] = dict(
            backpass_ms=time_ms(lambda: cb.back_pass_cm(*a1), reps),
            fused_ms=time_ms(lambda: cf.fused_derivs_back_pass(*a3), reps),
            rollout_multi_ms=time_ms(
                lambda: cr.rollout_call(*multi, multi=True), reps),
            rollout_selected_ms=time_ms(
                lambda: cr.rollout_call(*selected, multi=False,
                                        want_cost=True), reps))
    return out


def brachi_inputs(B, n, seed):
    """testBrachi_hli.m's setup with u0 = -|uniform(0.5, 1.5)| per lane."""
    from ddp_generator_tpu_torch.models import brachistochrone

    p, x0, _ = brachistochrone.default_setup_hli(n)
    rng = np.random.default_rng(seed)
    x0s = np.tile(x0, (B, 1))
    u0s = -np.abs(rng.uniform(0.5, 1.5, (B, n, 1)))
    return p, x0s, u0s


def check_fused_brachi(reps):
    """Phase 4c: B3 on brachistochrone_hli, B=2048, n=500, float64, with
    random multipliers and penalty weights (every AL term live) and a
    quarter of the lanes failing."""
    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.models import brachistochrone
    from ddp_generator_tpu_torch.ops.forward import forward_pass

    problem = brachistochrone.brachistochrone_hli()
    dev, dt = torch.device("cuda"), torch.float64
    p_np, x0s, u0s = brachi_inputs(B_MAIN, N_BRACHI, seed=11)
    p = ddp.params_from_jax(p_np, dt, dev)
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    m = ddp.init_multipliers(problem, B_MAIN, N_BRACHI, dt, dev)
    ones = torch.ones(B_MAIN, dtype=dt, device=dev)
    r = forward_pass(problem, t(x0s), None, t(u0s), None, None, 0.0, p,
                     m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, ones, ones)
    rng = np.random.default_rng(12)
    lam = 10.0 ** rng.uniform(-6, 0, B_MAIN)
    lam[::4] = -1.0  # Quu - 1 is indefinite: these lanes fail
    args = (problem, r.xs, r.us, m.mu_le,
            t(rng.uniform(0.2, 2.0, (B_MAIN, N_BRACHI, 1))),
            t(rng.standard_normal((B_MAIN, 1))), m.mu_fi,
            t(rng.uniform(1.0, 40.0, B_MAIN)),
            t(rng.uniform(1e-3, 1.0, B_MAIN)), t(lam), p, 1, False)
    name = "brachistochrone_hli float64"
    return compare_fused(name, args, TOL_B3[name], reps)


def check_rollout(problem, alphas, p, r, m, w, bp, tol, reps, label=None,
                  wf=None):
    """Phase 4: kernel B2 (sweep, selected rollout with and without cost)
    against its plain version, on the gains of phase 3; ``label`` as in
    :func:`compare_fused`; ``w`` the per-lane penalty weights, ``wf`` the
    final ones where they differ."""
    import torch

    from ddp_generator_tpu_torch.ops import cuda_rollout as cr

    B, N = r.us.shape[0], r.us.shape[1]
    n_u, n_x = problem.n_u, problem.n_x
    l_b = bp[0].permute(2, 0, 1)
    L_b = bp[1].permute(2, 0, 1).reshape(B, N, n_u, n_x)
    ctx = cr._LSCtx(problem, r.xs[:, 0], r.xs, r.us, l_b, L_b, None, None,
                    m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w,
                    w if wf is None else wf)
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
        plain_ms = time_ms(lambda: cr.rollout_plain(*operands(av), **kw), 1,
                           warm=False)
        trajectories = len(alphas) * B if mode == "multi" else B
        bound_ms, bound_by = bound(
            nbytes(operands(av), out),
            ops(label or problem.cuda_model.name, "rollout_per_step") * N
            * trajectories, dtype)
        res[mode] = dict(max_abs_err=worst_abs, max_rel_err=worst_rel,
                         tol=tol, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         not_ok=int((~oks[0][1]).sum()),
                         **cr.kernel_info(model_name(problem, p),
                                          dtype=dtype, **kw))
    # the selected rollout without cost (main path: after the sweep)
    out = cr.rollout_call(*operands(alpha_vec), multi=False)
    ref = cr.rollout_plain(*operands(alpha_vec), multi=False)
    for a, b in zip(out, ref):
        e_abs, e_rel = max_rel_err(a, b)
        if not e_rel <= tol:
            fail(f"rollout selected (no cost): rel err {e_rel:.3g} > {tol}")
    return res, (operands(None), operands(alpha_vec))


def brachi_options(**kw):
    """tests/test_solver_brachi.py:64-71, max_iter=200."""
    import ddp_generator_tpu_torch as ddp

    return ddp.SolverOptions(max_iter=200, w_pen_init_l=40.0,
                             w_pen_init_f=1e-5, w_pen_max_f=1.0,
                             w_pen_fact2=1.0, full_ddp=False, debug_level=0,
                             linesearch_method="kernel", **kw)


def per_lane_check(problem, backpass="kernel"):
    """Phase 5: a small float64 CarParking solve (16 lanes, T=100) through
    the kernels of a path on the GPU equals the same solve through the
    plain versions on the CPU, lane by lane."""
    import ddp_generator_tpu_torch as ddp

    p, x0s, u0s = bench_inputs(16, 100, np.float64, seed=3)
    x0s = x0s + 0.05 * np.random.default_rng(4).standard_normal(x0s.shape)
    opts = ddp.SolverOptions(max_iter=100, dtype="float64", debug_level=0,
                             backpass_method=backpass,
                             linesearch_method="kernel")
    return same_on_cpu(problem, opts, x0s, u0s, p)


def per_lane_brachi():
    """Phase 5c: the same for brachistochrone_hli (16 lanes, n=100) through
    B3 and B2.  This AL solve amplifies last-bit differences between B3's
    forward-mode derivatives and the plain version's reverse-mode ones: a
    lane whose backward pass sits on the positive-definiteness boundary can
    fail on one side only and then take another path (PERF.md traces seed
    13's lane 10 doing so).  Seed 14's lanes stay clear of such ties."""
    from ddp_generator_tpu_torch.models import brachistochrone

    p, x0s, u0s = brachi_inputs(16, 100, seed=14)
    return same_on_cpu(brachistochrone.brachistochrone_hli(),
                       brachi_options(dtype="float64",
                                      backpass_method="fused"),
                       x0s, u0s, p)


def same_on_cpu(problem, opts, x0s, u0s, p, cost_rtol=1e-8,
                batch_params=False, with_cpu=False):
    """The solve on the GPU and on the CPU: equal status, iterations, body
    and stale calls per lane, cost to a relative ``cost_rtol``.  With
    ``with_cpu`` also returns the CPU solution."""
    import torch

    import ddp_generator_tpu_torch as ddp

    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.time()
        sol = ddp.StepwiseSolver(problem, opts, min_compact_batch=4,
                                 batch_params=batch_params,
                                 device=dev)(x0s, u0s, p)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (ddp.to_numpy(sol), time.time() - t0)
    g, c = out["cuda"][0], out["cpu"][0]
    res = dict(lanes=x0s.shape[0], T=u0s.shape[1],
               status=np.bincount(g.status).tolist(),
               cost_rel_err=check_lanes("per-lane check", g, c, cost_rtol),
               gpu_s=round(out["cuda"][1], 2), cpu_s=round(out["cpu"][1], 2))
    return (res, c) if with_cpu else res


def check_lanes(what, g, c, cost_rtol):
    """Equal status, iterations, body and stale calls per lane of two
    solutions (numpy), cost to a relative ``cost_rtol``."""
    for f in ("status", "iterations", "body_calls", "stale_calls"):
        if not np.array_equal(getattr(g, f), getattr(c, f)):
            fail(f"{what}: {f} differs: gpu {getattr(g, f)} "
                 f"cpu {getattr(c, f)}")
    cost_rel = float(np.max(np.abs(g.cost - c.cost) / np.abs(c.cost)))
    if not cost_rel <= cost_rtol:
        fail(f"{what}: cost rel err {cost_rel:.3g} > {cost_rtol}")
    return cost_rel


def per_lane_params(p, B):
    """``batch_params=True`` params: every leaf with a leading lane axis."""
    return {k: np.tile(np.asarray(v), (B,) + (1,) * np.ndim(v))
            for k, v in p.items()}


def car_limw_per_lane(p, B):
    """CarParking params with the wheel-angle limit ``limW`` from +-0.2 to
    +-0.5 over the lanes; returns ``(params, lim (B,))``."""
    pb = per_lane_params(p, B)
    lim = np.linspace(0.2, 0.5, B).astype(pb["limW"].dtype)
    pb["limW"] = np.stack([-lim, lim], axis=1)
    return pb, lim


def batch_params_per_lane():
    """Phase 5d: per-lane params (``batch_params=True``), 16 lanes, float64,
    GPU against CPU: CarParking (T=100) with ``limW`` per lane and
    brachistochrone_hli (n=100, seed 14 as per_lane_brachi) with its floor
    ``ymin`` shifted per lane, each through the kernel path (the emission
    kernel, B1 and B2 reading each lane's params) and the fused path
    (which per-lane params send down the serial path)."""
    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.models import brachistochrone, car_parking

    p, x0s, u0s = bench_inputs(16, 100, np.float64, seed=3)
    x0s = x0s + 0.05 * np.random.default_rng(4).standard_normal(x0s.shape)
    car_p, _ = car_limw_per_lane(p, 16)
    p, bx0s, bu0s = brachi_inputs(16, 100, seed=14)
    brachi_p = per_lane_params(p, 16)
    brachi_p["ymin"] = brachi_p["ymin"] + np.linspace(-0.3, 0.3, 16)[:, None]
    out = {}
    for backpass in ("kernel", "fused"):
        opts = ddp.SolverOptions(max_iter=100, dtype="float64", debug_level=0,
                                 backpass_method=backpass,
                                 linesearch_method="kernel")
        out[f"car_parking_{backpass}"] = same_on_cpu(
            car_parking.car_parking(), opts, x0s, u0s, car_p,
            batch_params=True)
        out[f"brachistochrone_hli_{backpass}"] = same_on_cpu(
            brachistochrone.brachistochrone_hli(),
            brachi_options(dtype="float64", backpass_method=backpass),
            bx0s, bu0s, brachi_p, batch_params=True)
    return out


def fleet_inputs(B):
    """bench_inputs' CarParking inputs (T_MAIN, float32) with the
    benchmark's mixed fleet as per-lane params
    (scripts/make_fleet_params.py): vehicle ``b``'s ``d``, ``limW`` and
    ``limA`` on lane ``b``; returns ``(params, x0s, u0s)``."""
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / "make_fleet_params.py"
    spec = importlib.util.spec_from_file_location("make_fleet_params", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    p, x0s, u0s = bench_inputs(B, T_MAIN, np.float32)
    pb = per_lane_params(p, B)
    d, w, a = np.asarray([mod.vehicle(b) for b in range(B)],
                         pb["d"].dtype).T
    pb["d"] = d
    pb["limW"] = np.stack([-w, w], axis=1)
    pb["limA"] = np.stack([-a, a], axis=1)
    return pb, x0s, u0s


def batch_params_kernels(problem, alphas):
    """Phase 11, first: the per-lane instantiations of the emission kernel
    and of B2 at the shapes the fleet's solve gives them (B=2048, T=500,
    float32, the benchmark's fleet as ``LaneParams`` with the ``rows`` a
    solver makes), against their plain versions on the same inputs:
    B2's initial rollout against ``rollout_plain`` (``initial_rollout``
    with its launch swapped for the plain version), the emission kernel
    on that rollout against ``cm_emit`` (``TOL_EMIT``), then B2's sweep and
    selected rollouts on B1's gains of that bundle against
    ``rollout_plain`` (``check_rollout``, ``TOL_ROLLOUT``)."""
    import unittest.mock

    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.ops import cuda_backpass as cb
    from ddp_generator_tpu_torch.ops import cuda_emit as ce
    from ddp_generator_tpu_torch.ops import cuda_rollout as cr
    from ddp_generator_tpu_torch.ops.cm_derivs import cm_emit

    dev = torch.device("cuda")
    pb, x0s, u0s = fleet_inputs(B_MAIN)
    solver = ddp.StepwiseSolver(problem, main_options(), chunk=10,
                                batch_params=True, device="cuda")
    P = solver._cast_params(pb, B_MAIN, T_MAIN)
    if P.rows is None or tuple(P.rows.shape[:1]) != (B_MAIN,):
        fail("batch_params_kernels: the solver made no lane-major rows")
    x0 = torch.as_tensor(x0s, device=dev)
    u0 = torch.as_tensor(u0s, device=dev)
    m = ddp.init_multipliers(problem, B_MAIN, T_MAIN, torch.float32, dev)
    w = torch.ones(B_MAIN, dtype=torch.float32, device=dev)
    tol = TOL_ROLLOUT["float32"]
    r = cr.initial_rollout(problem, x0, u0, P, m, w, w)
    with unittest.mock.patch.object(cr, "rollout_call", cr.rollout_plain):
        r_plain = cr.initial_rollout(problem, x0, u0, P, m, w, w)
    torch.cuda.synchronize()
    if not torch.equal(r.ok, r_plain.ok):
        fail("batch_params_kernels: initial rollout ok flags differ")
    init_abs, init_rel = 0.0, 0.0
    for name in ("xs", "us", "cost"):
        e_abs, e_rel = max_rel_err(getattr(r, name), getattr(r_plain, name))
        if not e_rel <= tol:
            fail(f"batch_params_kernels: initial rollout {name} differs, "
                 f"rel err {e_rel:.3g} > {tol}")
        init_abs, init_rel = max(init_abs, e_abs), max(init_rel, e_rel)
    args = emit_args(problem, P, r, m, w)
    out = ce.emit(*args)
    torch.cuda.synchronize()
    emit_abs, emit_rel = emit_gap("batch_params_kernels: emit", out,
                                  cm_emit(*args), TOL_EMIT["float32"])
    sd, fcx, fcxx, us_cm, _ = out
    lam = torch.as_tensor(
        10.0 ** np.random.default_rng(2).uniform(-6, 2, size=B_MAIN),
        dtype=torch.float32, device=dev)[None]
    bp = cb.back_pass_cm(sd, fcx, fcxx, us_cm, lam, problem.n_x, 1, True)
    ro, _ = check_rollout(problem, alphas, P, r, m, w, bp, tol, 3)
    res = {"initial_rollout": dict(max_abs_err=init_abs,
                                   max_rel_err=init_rel, tol=tol,
                                   not_ok=int((~r_plain.ok).sum())),
           "emit": dict(max_abs_err=emit_abs, max_rel_err=emit_rel,
                        tol=TOL_EMIT["float32"],
                        derivs_ok=int(out[4].sum()))}
    for mode, d in ro.items():
        res[f"rollout_{mode}"] = {k: d[k] for k in (
            "max_abs_err", "max_rel_err", "tol", "ms", "not_ok")}
    return {k: dict(B=B_MAIN, N=T_MAIN, dtype="float32", **d)
            for k, d in res.items()}


def batch_params_path(problem):
    """Phase 11: per-lane params at full width.  bench.py's CarParking
    solve (B=2048, T=500, float32, StepwiseSolver with chunk 10,
    compact_levels 4, min_compact_batch 128), with ``limW`` per lane from
    +-0.2 to +-0.5, ``backpass_method="kernel"`` and
    ``linesearch_method="kernel"``: the emission kernel, B1 and B2 (line
    search and initial rollout), every emission and B2 launch reading the
    lanes' own params, every body call a graph replay (each width captured
    at first use).  Every lane keeps its own box limits; B3 does not
    run."""
    import ddp_generator_tpu_torch as ddp

    p, x0s, u0s = bench_inputs(B_MAIN, T_MAIN, np.float32)
    pb, lim = car_limw_per_lane(p, B_MAIN)
    opts = ddp.SolverOptions(max_iter=MAX_ITER_MAIN, dtype="float32",
                             tolFun=1e-5, debug_level=0,
                             backpass_method="kernel",
                             linesearch_method="kernel")
    solver = ddp.StepwiseSolver(problem, opts, chunk=10, batch_params=True,
                                compact_levels=4, min_compact_batch=128,
                                device="cuda")
    s, wall, launches = timed_solve(solver, x0s, u0s, pb)
    loop = check_graphed("batch_params_path", solver)
    for name in ("backpass", "emit", "rollout_selected", "init_rollout"):
        if launches[name] <= 0:
            fail(f"batch_params_path: kernel {name} was never launched")
    if launches["fused"] != 0:
        fail(f"batch_params_path: B3 was launched {launches['fused']} times")
    b2 = launches["rollout_multi"] + launches["rollout_selected"]
    if (launches["emit_lane_params"] != launches["emit"]
            or launches["rollout_lane_params"] != b2):
        fail(f"batch_params_path: launches without the lanes' params: "
             f"{launches}")
    if s.xs.shape != (B_MAIN, T_MAIN + 1, 4) or s.us.shape != (
            B_MAIN, T_MAIN, 2):
        fail(f"batch_params_path: shapes {s.xs.shape} {s.us.shape}")
    if not np.all(np.isfinite(s.cost)):
        fail("batch_params_path: non-finite costs")
    w_over = float((np.abs(s.us[..., 0]).max(axis=1) - lim).max())
    a_over = float(np.abs(s.us[..., 1]).max() - p["limA"][1])
    if not (w_over <= 1e-6 and a_over <= 1e-6):
        fail(f"batch_params_path: a lane leaves its box: max |w| - limW "
             f"{w_over:.3g}, max |a| - limA {a_over:.3g}")
    solved = np.isin(s.status, (1, 2))
    return dict(B=B_MAIN, T=T_MAIN, max_iter=MAX_ITER_MAIN,
                limW="linspace(0.2,0.5)", wall_s=wall,
                s_per_body_call=wall / int(s.body_calls.max()),
                solved_pct=100 * float(solved.mean()),
                exhausted_pct=100 * float((s.status == 7).mean()),
                solved_pct_tightest_quarter=100 * float(
                    solved[:B_MAIN // 4].mean()),
                mean_iters=float(s.iterations.mean()),
                max_iters=int(s.iterations.max()),
                mean_body_calls=float(s.body_calls.mean()),
                max_body_calls=int(s.body_calls.max()),
                max_w_minus_limW=w_over, max_a_minus_limA=a_over,
                mean_cost=float(s.cost.mean()), **loop, launches=launches)


def timed_solve(solver, x0s, u0s, p):
    """One solve with the launch counts set to 0 just before it; returns
    (solution as numpy, wall seconds, launches)."""
    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.launches import read_launches, reset_launches

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    sol = solver(x0s, u0s, p)
    torch.cuda.synchronize()
    wall = time.time() - t0
    return ddp.to_numpy(sol), wall, read_launches()


def main_options(backpass="kernel", dtype="float32"):
    """bench.py's solve options (float32, tolFun 1e-5) on a path."""
    import ddp_generator_tpu_torch as ddp

    return ddp.SolverOptions(max_iter=MAX_ITER_MAIN, dtype=dtype,
                             tolFun=1e-5, debug_level=0,
                             backpass_method=backpass,
                             linesearch_method="kernel")


def main_solver(problem, backpass="kernel", dtype="float32", depth=1):
    """bench.py's StepwiseSolver (chunk 10, compact_levels 4,
    min_compact_batch 128, pipeline_depth 1 unless ``depth``) on a path."""
    import ddp_generator_tpu_torch as ddp

    return ddp.StepwiseSolver(problem, main_options(backpass, dtype),
                              chunk=10, compact_levels=4,
                              min_compact_batch=128, pipeline_depth=depth,
                              device="cuda")


def check_graphed(what, solver):
    """Fail unless the solver's last call replayed a graph at every width
    and read the host at most once every ``chunk`` replays; returns its
    loop stats as a dict."""
    st = solver.last_stats
    if not st.graphed or st.eager or st.replays != st.body_calls:
        fail(f"{what}: body calls did not all run graphed: {st}")
    if st.host_reads > st.replays // solver.chunk + 1:
        fail(f"{what}: {st.host_reads} host reads for {st.replays} "
             f"replays at chunk {solver.chunk}")
    return dict(replays=st.replays, host_reads=st.host_reads,
                graphed_widths="/".join(map(str, st.graphed)))


def main_path(problem, backpass="kernel", dtype="float32", depth=1):
    """Phase 6 (and 7 with ``backpass="fused"``): bench.py's batched
    CarParking solve through the kernels of that path, precompiled (every
    width's body call captured as a CUDA graph before the timed solve);
    ``dtype`` and the solver's ``pipeline_depth`` as given.  Returns its
    line's numbers and the solution (numpy)."""
    what = "main path" if backpass == "kernel" else "fused path"
    what += "" if (dtype, depth) == ("float32", 1) else f" {dtype} {depth}"
    p, x0s, u0s = bench_inputs(B_MAIN, T_MAIN, getattr(np, dtype))
    solver = main_solver(problem, backpass, dtype, depth)
    precompile_s = solver.precompile(x0s, u0s, p)
    s, wall, launches = timed_solve(solver, x0s, u0s, p)
    loop = check_graphed(what, solver)
    used = (("backpass", "emit") if backpass == "kernel" else ("fused",)
            ) + ("rollout_multi", "rollout_selected")
    for name in used:
        if launches[name] <= 0:
            fail(f"{what}: kernel {name} was never launched")
    unused = ("fused",) if backpass == "kernel" else ("backpass", "emit")
    for name in unused:
        if launches[name] != 0:
            fail(f"{what}: kernel {name} was launched {launches[name]} "
                 "times; this path must not run it")
    if backpass == "kernel" and launches["emit"] != launches["backpass"]:
        fail(f"{what}: {launches['emit']} emission launches for "
             f"{launches['backpass']} of B1; each body call emits once")
    if s.xs.shape != (B_MAIN, T_MAIN + 1, 4) or s.us.shape != (
            B_MAIN, T_MAIN, 2):
        fail(f"{what}: shapes {s.xs.shape} {s.us.shape}")
    if not np.all(np.isfinite(s.cost)):
        fail(f"{what}: {int((~np.isfinite(s.cost)).sum())} costs are "
             "not finite")
    solved = float(np.isin(s.status, (1, 2)).mean())
    exhausted = float((s.status == 7).mean())
    if solved < SOLVED_MIN:
        fail(f"{what}: solved share {solved:.4f} < {SOLVED_MIN}")
    stats = dict(B=B_MAIN, T=T_MAIN, max_iter=MAX_ITER_MAIN, wall_s=wall,
                 solves_per_s=B_MAIN / wall, solved_pct=100 * solved,
                 exhausted_pct=100 * exhausted,
                 mean_iters=float(s.iterations.mean()),
                 max_iters=int(s.iterations.max()),
                 mean_body_calls=float(s.body_calls.mean()),
                 stale_pct=100 * float(s.stale_calls.sum())
                 / max(1, int(s.body_calls.sum())),
                 mean_cost=float(s.cost.mean()),
                 precompile_s=precompile_s, **loop, launches=launches)
    return stats, s


def graphed_busy_share(solver, x0s, u0s, p, calls=3) -> float:
    """The card's busy share (%) over ``calls`` graph replays of the
    precompiled solver's full width on the initial carry of ``x0s``,
    ``u0s``, after one replay (``torch.profiler``: kernel time over host
    wall).  The timed solve after it copies its own carry and params in."""
    import torch

    from ddp_generator_tpu_torch.solver import _copy_into, _params_map

    P = solver._cast_params(p, len(u0s), u0s.shape[1])
    c = solver._init(x0s, u0s, P)
    w = solver._widths[(len(u0s), u0s.shape[1])]
    _copy_into(w.carry, c)
    if solver.batch_params:
        _params_map(lambda d, v: d.copy_(v), w.params, P)
    else:
        solver._static_params(P)
    w.run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            w.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.device_time_total for e in prof.events()
               if e.device_type.name == "CUDA") / 1e6
    return 100 * busy / wall


def graphed_against_eager(what, problem, opts, x0s, u0s, p,
                          batch_params=False, busy=False,
                          min_compact_batch=128) -> dict:
    """The precompiled graphed StepwiseSolver (bench.py's chunk 10,
    compact_levels 4, ``min_compact_batch`` 128) against the eager route,
    ``make_batched_solver`` under ``eager_loops()`` (one host read per
    body call, no compaction, every loop on the host):
    every Solution field bit for bit and the same launch counts.  Returns
    precompile seconds, the peak device memory of precompile + solve,
    replays and host reads per solve, each route's wall and seconds per
    body call (the graphed route's per replay, masked replays included;
    the eager route's per loop call, the most body calls of a lane), and
    with ``busy`` the card's busy share over 3 graphed replays and over 3
    eager body calls of the full width."""
    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.ops.device_loop import eager_loops

    solver = ddp.StepwiseSolver(problem, opts, chunk=10,
                                batch_params=batch_params, compact_levels=4,
                                min_compact_batch=min_compact_batch,
                                device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    precompile_s = solver.precompile(x0s, u0s, p)
    shares = {}
    if busy:
        shares["graphed_busy_pct"] = graphed_busy_share(solver, x0s, u0s, p)
    g, g_wall, g_launches = timed_solve(solver, x0s, u0s, p)
    peak = torch.cuda.max_memory_allocated()
    loop = check_graphed(what, solver)
    eager = ddp.make_batched_solver(problem, opts, batch_params,
                                    device="cuda")
    with eager_loops():
        e, e_wall, e_launches = timed_solve(eager, x0s, u0s, p)
    n = same_solution(what, g, e, g_launches, e_launches, ref="eager route")
    if busy:
        shares["eager_busy_pct"] = busy_share(solver, x0s, u0s, p)
    eager_calls = int(e.body_calls.max())
    return dict(
        B=len(u0s), T=u0s.shape[1], dtype=opts.dtype,
        precompile_s=precompile_s, peak_mem_gib=peak / 2**30,
        graphed_wall_s=g_wall, eager_wall_s=e_wall,
        eager_over_graphed=e_wall / g_wall,
        graphed_s_per_replay=g_wall / max(1, loop["replays"]),
        eager_body_calls=eager_calls,
        eager_s_per_body_call=e_wall / max(1, eager_calls), **shares,
        **loop, solved_pct=100 * float(np.isin(g.status, (1, 2)).mean()),
        fields_equal=n, **{f"launches_{k}": v for k, v in g_launches.items()})


def graphs_phase(problem):
    """Phase 6b: the graphed route against the eager one
    (:func:`graphed_against_eager`) at bench.py's CarParking solve (B=2048,
    T=500, float32) on the kernel and the fused path."""
    p, x0s, u0s = bench_inputs(B_MAIN, T_MAIN, np.float32)
    return {backpass: graphed_against_eager(
        f"graphs {backpass}", problem, main_options(backpass), x0s, u0s, p)
        for backpass in ("kernel", "fused")}


def graphs_routes_phase(problem):
    """Phase 6d: the routes graphed beside the kernel and fused paths,
    each against the eager route (:func:`graphed_against_eager`) at full
    width: the serial path (``SolverOptions()``'s methods, float64) on
    bench.py's CarParking solve, cut to max_iter 3 as serial_vs_kernel;
    per-lane params (``limW`` per lane) on the kernel path, emission, B1
    and B2, float32, cut to max_iter 10 for the eager
    reference; and the parallel backward pass with B2 on the
    Brachistochrone (n=500, float64) of parallel_solves, nothing cut (its
    solve takes about 14 body calls), with its busy shares.  The serial
    and per-lane busy shares come from scripts/body_call_profile.py:
    tracing ~143k device events a body call takes the profiler minutes.
    The serial and per-lane solves retire no lane at their cut depths, so
    only their full width is precompiled (``min_compact_batch`` B): the
    serial route's four narrower captures took 45-60 s and were never
    replayed."""
    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.models import brachistochrone

    out = {}
    p, x0s, u0s = bench_inputs(B_MAIN, T_MAIN, np.float64)
    opts = ddp.SolverOptions(max_iter=3, dtype="float64", debug_level=0)
    out["serial"] = dict(
        depth_cut=f"max_iter {MAX_ITER_MAIN}->3",
        **graphed_against_eager("graphs serial", problem, opts, x0s, u0s,
                                p, min_compact_batch=B_MAIN))
    p, x0s, u0s = bench_inputs(B_MAIN, T_MAIN, np.float32)
    pb, _ = car_limw_per_lane(p, B_MAIN)
    opts = main_options().replace(max_iter=MAX_ITER_GRAPHS_PER_LANE)
    out["per_lane_kernel"] = dict(
        depth_cut=f"max_iter {MAX_ITER_MAIN}->{MAX_ITER_GRAPHS_PER_LANE}",
        limW="linspace(0.2,0.5)",
        **graphed_against_eager("graphs per-lane kernel", problem, opts,
                                x0s, u0s, pb, batch_params=True,
                                min_compact_batch=B_MAIN))
    p, x0s, u0s = brachi_plain_inputs(B_MAIN, N_BRACHI, seed=11)
    out["parallel"] = dict(
        depth_cut="none", **graphed_against_eager(
            "graphs parallel", brachistochrone.brachistochrone(),
            parallel_options(), x0s, u0s, p, busy=True))
    return out


@contextlib.contextmanager
def counted_host_reads(count):
    """Count into ``count`` (a dict) every host read of a tensor
    (``Tensor.__bool__``/``item``/``tolist``/``__int__``/``__float__``) and
    every CUDA graph replay made inside."""
    import torch

    names = ("__bool__", "item", "tolist", "__int__", "__float__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    replay = torch.cuda.CUDAGraph.replay
    count.update(host_reads=0, graph_launches=0)

    def patched(name):
        def f(self, *a, **kw):
            count["host_reads"] += 1
            return saved[name](self, *a, **kw)
        return f

    def counted_replay(self):
        count["graph_launches"] += 1
        return replay(self)

    for n in names:
        setattr(torch.Tensor, n, patched(n))
    torch.cuda.CUDAGraph.replay = counted_replay
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
        torch.cuda.CUDAGraph.replay = replay


def loop_solve(what, solver, args):
    """A :func:`make_batched_solver` solver's first call (its capture),
    then a second call with its launches, host reads and graph launches
    counted: ``(numpy Solution, wall of the second call, its launches, a
    dict of the capture and counts)``.  Fails unless the second call was
    one graph launch and one host read."""
    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.launches import read_launches, reset_launches

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    solver(*args)
    torch.cuda.synchronize()
    first_wall = time.time() - t0
    st = solver.last_stats
    if not (st.graphed and st.captured):
        fail(f"{what}: the first call did not capture a graph: {st}")
    count = {}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    with counted_host_reads(count):
        sol = solver(*args)
    torch.cuda.synchronize()
    wall = time.time() - t0
    sol, launches = ddp.to_numpy(sol), read_launches()
    if count != {"host_reads": 1, "graph_launches": 1}:
        fail(f"{what}: a solve made {count}, not one graph launch and one "
             "host read")
    g = next(iter(solver.graphs.values()))
    return sol, wall, launches, dict(
        capture_s=st.capture_s, first_call_s=first_wall,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        **count, **{f"nodes_{k}": v for k, v in g.nodes.items()})


# Phase 6e's reduced cells: the inline route's max_iter cut, the Newton
# route's width and depth
MAX_ITER_LOOP_INLINE = 20
B_LOOP_NEWTON, MAX_ITER_LOOP_NEWTON = 256, 3


def device_loops_phase(problem, refs) -> dict:
    """Phase 6e: the device loops (``ops/device_loop.py``, WHILE nodes).

    * ``make_batched_solver`` on the main path's cell (B=2048, T=500,
      float32, max_iter 200), kernel and fused paths: the whole solve one
      graph; every Solution field and launch count against the main
      path's ``StepwiseSolver`` solve (``refs``); one graph launch and one
      host read a solve; capture seconds, wall, peak memory, WHILE and
      total node counts.
    * ``solve`` on ``testCar`` (T=500, float64, max_iter 200, the kernel
      path as ``scripts/try_car_torch.py``): ms per trip, graphed and
      under ``eager_loops()``, every field bit for bit.
    * The inline route (kernel path, float32, B=2048, max_iter cut to
      :data:`MAX_ITER_LOOP_INLINE`) and the Newton route (serial, float64,
      ``boxqp_method="newton"``, B=:data:`B_LOOP_NEWTON`, max_iter
      :data:`MAX_ITER_LOOP_NEWTON`, one width) graphed by
      ``StepwiseSolver`` (no eager width), each against the
      ``eager_loops()`` solve (:func:`graphed_against_eager`)."""
    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.models import car_parking
    from ddp_generator_tpu_torch.ops.device_loop import eager_loops

    out = {}
    p, x0s, u0s = bench_inputs(B_MAIN, T_MAIN, np.float32)
    for backpass in ("kernel", "fused"):
        what = f"device loops {backpass} path"
        ref_sol, ref_launches = refs[backpass]
        solver = ddp.make_batched_solver(problem, main_options(backpass),
                                         device="cuda")
        sol, wall, launches, d = loop_solve(what, solver, (x0s, u0s, p))
        n = same_solution(what, sol, ref_sol, launches, ref_launches,
                          ref="graphed StepwiseSolver's")
        out[backpass] = dict(
            B=B_MAIN, T=T_MAIN, max_iter=MAX_ITER_MAIN, dtype="float32",
            wall_s=wall, **d, fields_equal=n,
            solved_pct=100 * float(np.isin(sol.status, (1, 2)).mean()),
            max_body_calls=int(sol.body_calls.max()),
            **{f"launches_{k}": v for k, v in launches.items()})
        del solver
        torch.cuda.empty_cache()

    # testCar through solve(): one instance, B=1
    pc, x0, u0 = car_parking.default_setup(T_MAIN, seed=0)
    o = ddp.SolverOptions(max_iter=MAX_ITER_MAIN, backpass_method="kernel",
                          linesearch_method="kernel")
    args = (x0[None], u0[None], pc)
    one = ddp.make_batched_solver(problem, o, device="cuda")
    g, g_wall, g_launches, d = loop_solve("device loops testCar", one, args)
    with eager_loops():
        e, e_wall, e_launches = timed_solve(one, *args)
    n = same_solution("device loops testCar", g, e, g_launches, e_launches,
                      ref="eager_loops() solve's")
    trips = int(g.body_calls[0])
    sol = ddp.to_numpy(ddp.solve(problem, x0, u0, pc, o, device="cuda"))
    if not ddp.make_batched_solver(problem, o, device="cuda").last_stats \
            .graphed or not np.array_equal(sol.us, g.us[0]):
        fail("device loops testCar: solve() is not the cached graph's")
    out["testCar"] = dict(
        T=T_MAIN, dtype="float64", status=int(g.status[0]),
        iterations=int(g.iterations[0]), trips=trips, wall_s=g_wall,
        eager_wall_s=e_wall, ms_per_trip=1e3 * g_wall / trips,
        eager_ms_per_trip=1e3 * e_wall / trips, **d, fields_equal=n)

    # the inline and Newton routes, graphed by StepwiseSolver at one width
    # each: neither cut solve retires a lane, and each width's precompile
    # is three eager warm-up calls (~5 s each on Newton's)
    o = main_options("kernel").replace(lam_retry="inline",
                                       max_iter=MAX_ITER_LOOP_INLINE)
    r = graphed_against_eager("device loops inline", problem, o, x0s, u0s,
                              p, min_compact_batch=B_MAIN)
    out["inline"] = dict(r, max_iter=MAX_ITER_LOOP_INLINE)
    pn, x0n, u0n = bench_inputs(B_LOOP_NEWTON, T_MAIN, np.float64)
    o = ddp.SolverOptions(max_iter=MAX_ITER_LOOP_NEWTON, debug_level=0,
                          boxqp_method="newton")
    r = graphed_against_eager("device loops newton", problem, o, x0n, u0n,
                              pn, min_compact_batch=B_LOOP_NEWTON)
    out["newton"] = dict(r, max_iter=MAX_ITER_LOOP_NEWTON)
    return out


def emitter_launches(problem):
    """Phase 6c: derivative emission at the main path's first body call
    (B=2048, T=500, float32) by the emission kernel and by each
    ``derivs_emitter`` of the torch emitter: device kernels and their
    device ms per emission (``torch.profiler``), its wall (host clock
    between two synchronizes, after a warm-up call), and the largest gap
    of the kernel's and the shared emitter's bundle to the per-family
    one's, relative to each component's largest value."""
    import torch

    from ddp_generator_tpu_torch.ops import cuda_emit as ce
    from ddp_generator_tpu_torch.ops.cm_derivs import cm_emit

    p, r, m, w = nominal_rollout(problem, B_MAIN, T_MAIN, torch.float32,
                                 torch.device("cuda"))
    args = emit_args(problem, p, r, m, w)
    emitters = {"per_family": lambda: cm_emit(*args, False),
                "shared": lambda: cm_emit(*args, True),
                "kernel": lambda: ce.emit(*args)}
    out, bundles = {}, {}
    for name, emit in emitters.items():
        emit()
        torch.cuda.synchronize()
        t0 = time.time()
        bundles[name] = emit()
        torch.cuda.synchronize()
        wall = time.time() - t0
        _, events, device_ms = profiled(emit)
        out[f"{name}_device_events"] = events
        out[f"{name}_device_ms"] = device_ms
        out[f"{name}_ms"] = 1e3 * wall
    for name in ("shared", "kernel"):
        out[f"{name}_max_rel_gap"] = emit_gap(
            f"emitters {name}", bundles[name], bundles["per_family"],
            TOL_EMIT["float32"])[1]
    return out


def brachi_path(problem):
    """Phase 8: brachistochrone_hli at full width (testBrachi_hli.m, n=500,
    B=2048, float64) through B3 and B2.  Solved lanes must meet the floor
    (hli) and the terminal equality (hfe) as the JAX package's own test
    holds a solve to them (tests/test_solver_brachi.py:58-78).  Returns its
    line's numbers and the solution (numpy)."""
    import ddp_generator_tpu_torch as ddp

    p, x0s, u0s = brachi_inputs(B_MAIN, N_BRACHI, seed=7)
    solver = ddp.StepwiseSolver(
        problem, brachi_options(dtype="float64", backpass_method="fused"),
        device="cuda")
    s, wall, launches = timed_solve(solver, x0s, u0s, p)
    for name in ("fused", "rollout_multi", "rollout_selected"):
        if launches[name] <= 0:
            fail(f"brachistochrone: kernel {name} was never launched")
    if launches["backpass"] != 0:
        fail("brachistochrone: kernel backpass ran on the fused path")
    if s.xs.shape != (B_MAIN, N_BRACHI + 1, 1) or not np.all(
            np.isfinite(s.cost)):
        fail(f"brachistochrone: shape {s.xs.shape} or non-finite costs")
    ok = np.isin(s.status, (1, 2))
    if not ok.any():
        fail("brachistochrone: no lane solved")
    ymin = np.asarray(p["ymin"])
    y = s.xs[ok, :, 0]
    terminal = float(np.abs(y[:, -1] - ymin[-1]).max())
    floor = float((ymin[None, :N_BRACHI] - y[:, :N_BRACHI]).max())
    if not (terminal < 1e-3 and floor < 5e-2):
        fail(f"brachistochrone: solved lanes miss the constraints: "
             f"|y_N - ymin[N]| {terminal:.3g}, floor {floor:.3g}")
    return dict(B=B_MAIN, n=N_BRACHI, wall_s=wall,
                solves_per_s=B_MAIN / wall, solved_pct=100 * float(ok.mean()),
                exhausted_pct=100 * float((s.status == 7).mean()),
                mean_iters=float(s.iterations.mean()),
                mean_body_calls=float(s.body_calls.mean()),
                max_terminal_err=terminal, max_floor_violation=floor,
                mean_cost=float(s.cost[ok].mean()), launches=launches), s


def per_lane_serial():
    """Phase 5b: the default options (serial backward pass and line search,
    float64, max_iter 20) on 16 lanes, GPU against CPU: CarParking T=100
    and Cartpole T=150.  Returns the lines and the Cartpole CPU solution
    (cartpole_path holds its full-width serial solve's first lanes to
    it)."""
    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.models import car_parking, cartpole

    opts = ddp.SolverOptions(debug_level=0)
    p, x0s, u0s = bench_inputs(16, 100, np.float64, seed=3)
    x0s = x0s + 0.05 * np.random.default_rng(4).standard_normal(x0s.shape)
    car = same_on_cpu(car_parking.car_parking(), opts, x0s, u0s, p)
    p, x0s, u0s = cartpole_inputs(16, T_POLE)
    # max_iter 20 stops every lane mid swing-up (status 7), where the solve
    # amplifies a last-bit difference (the card's sin/cos against the
    # CPU's): a one-ulp change of lane 9's th0 moves its cost by 3.6e-8 on
    # the CPU (the other lanes' by at most 5e-12), and the card's largest
    # gap was 1.4e-8 on an H100; the counts are held equal all the same.
    pole, pole_cpu = same_on_cpu(cartpole.cartpole(), opts, x0s, u0s, p,
                                 cost_rtol=1e-6, with_cpu=True)
    return car, pole, pole_cpu


def per_lane_inline():
    """Phase 5c: inline lambda retries on the kernel path.  A retry-heavy
    CarParking workload (tests/test_batched.py:102-127: 16 lanes, T=60,
    u0 = 4 normal, FULL_DDP) through StepwiseSolver with inline_below=8 and
    16 against inline_below=0 on the card: equal status and iterations,
    cost and us as that test holds them, retries on the deferred side and
    fewer body calls where they ran inline."""
    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.models import car_parking

    problem = car_parking.car_parking()
    p, x0, _ = car_parking.default_setup(T=60)
    x0s = np.tile(x0, (16, 1))
    u0s = 4.0 * np.random.default_rng(11).standard_normal((16, 60, 2))
    opts = ddp.SolverOptions(max_iter=30, full_ddp=True, debug_level=0,
                             backpass_method="kernel",
                             linesearch_method="kernel")
    out = {}
    # 8: the tail after one halving; 16: every width (here every retry
    # falls before the first halving, so only 16 moves the retries inline)
    for below in (0, 8, 16):
        solver = ddp.StepwiseSolver(problem, opts, chunk=4, compact_levels=2,
                                    min_compact_batch=4, inline_below=below,
                                    device="cuda")
        out[below] = timed_solve(solver, x0s, u0s, p)
    plain = out[0][0]
    retries = int(plain.bp_retry_calls.sum())
    if retries <= 0:
        fail("per-lane inline: the deferred solve made no lambda retry")
    res = dict(lanes=16, T=60, deferred_retries=retries,
               body_calls_deferred=int(plain.body_calls.sum()),
               backpass_launches_deferred=out[0][2]["backpass"])
    for below in (8, 16):
        mixed, _, launches = out[below]
        for f in ("status", "iterations"):
            if not np.array_equal(getattr(plain, f), getattr(mixed, f)):
                fail(f"per-lane inline_below={below}: {f} differs")
        cost_rel = float(np.max(np.abs(mixed.cost - plain.cost)
                                / np.abs(plain.cost)))
        us_abs = float(np.max(np.abs(mixed.us - plain.us)))
        if not (cost_rel <= 1e-12 and us_abs <= 1e-12):
            fail(f"per-lane inline_below={below}: cost rel {cost_rel:.3g}, "
                 f"us {us_abs:.3g}")
        res.update({f"below{below}_attempts": int(mixed.bp_retry_calls.sum()),
                    f"below{below}_body_calls": int(mixed.body_calls.sum()),
                    f"below{below}_backpass_launches": launches["backpass"],
                    f"below{below}_cost_rel_err": cost_rel,
                    f"below{below}_us_abs_err": us_abs})
    if res["below16_body_calls"] >= res["body_calls_deferred"]:
        fail("per-lane inline: inline retries saved no body call")
    return res


def serial_vs_kernel(problem):
    """Phase 9: the serial path against the kernel path on CarParking at
    full width (B=2048, T=500, float64), cut to max_iter=3 (a whole eager
    serial solve at T=500 took minutes), each graphed (its width captured
    at first use, inside the wall): per lane equal status, iterations,
    body and stale calls, cost to a relative 1e-8; seconds per body call
    of each (wall over the most body calls of a lane)."""
    import ddp_generator_tpu_torch as ddp

    p, x0s, u0s = bench_inputs(B_MAIN, T_MAIN, np.float64)
    res, sols = {}, {}
    for path in ("serial", "kernel"):
        opts = ddp.SolverOptions(max_iter=3, dtype="float64", debug_level=0,
                                 backpass_method=path,
                                 linesearch_method=path)
        solver = ddp.StepwiseSolver(problem, opts, device="cuda")
        s, wall, launches = timed_solve(solver, x0s, u0s, p)
        loop = check_graphed(f"serial_vs_kernel {path}", solver)
        used = sum(launches.values())
        if (path == "serial") != (used == 0):
            fail(f"serial_vs_kernel: the {path} path launched {launches}")
        sols[path] = s
        calls = int(s.body_calls.max())
        res[f"{path}_wall_s"] = wall
        res[f"{path}_body_calls"] = calls
        res[f"{path}_s_per_body_call"] = wall / calls
        res[f"{path}_replays"] = loop["replays"]
    a, b = sols["serial"], sols["kernel"]
    for f in ("status", "iterations", "body_calls", "stale_calls"):
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            n = int((getattr(a, f) != getattr(b, f)).sum())
            fail(f"serial_vs_kernel: {f} differs in {n} lanes")
    cost_rel = float(np.max(np.abs(a.cost - b.cost) / np.abs(b.cost)))
    if not cost_rel <= 1e-8:
        fail(f"serial_vs_kernel: cost rel err {cost_rel:.3g} > 1e-8")
    return dict(B=B_MAIN, T=T_MAIN, max_iter=3, depth_cut="max_iter 200->3",
                cost_rel_err=cost_rel,
                status=np.bincount(a.status).tolist(), **res)


def cartpole_path(serial: bool, cpu_lanes=None):
    """Phase 10: the Cartpole swing-up at full width (B=2048, T=150),
    through B3 and B2 in float32 (tolFun 1e-5, max_iter=150): solved lanes
    must end in the upright basin at the reference's share and within the
    force limits.  Or with the default options (serial, float64), cut to
    max_iter=20: every lane within the force limits, and the first lanes
    equal to ``cpu_lanes``, per_lane_serial's CPU solve of the same lanes
    (cartpole_inputs makes a lane's inputs independent of the width)."""
    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.models import cartpole

    what = "cartpole serial" if serial else "cartpole fused"
    # float32 takes tolFun=1e-5, as the main path does: a float32 cost of
    # ~0.3 moves by ~3e-8 a rounding, below the 1e-7 of float64's default
    kw = (dict(max_iter=MAX_ITER_POLE_SERIAL) if serial else
          dict(max_iter=MAX_ITER_POLE, dtype="float32", tolFun=1e-5,
               backpass_method="fused", linesearch_method="kernel"))
    opts = ddp.SolverOptions(debug_level=0, **kw)
    np_dtype = np.float64 if serial else np.float32
    p, x0s, u0s = cartpole_inputs(B_MAIN, T_POLE, np_dtype)
    solver = ddp.StepwiseSolver(cartpole.cartpole(), opts, device="cuda")
    s, wall, launches = timed_solve(solver, x0s, u0s, p)
    loop = check_graphed(what, solver)
    want = set() if serial else {"fused", "rollout_multi",
                                 "rollout_selected", "init_rollout"}
    for name, n in launches.items():
        if (n > 0) != (name in want):
            fail(f"{what}: kernel {name} was launched {n} times")
    if s.xs.shape != (B_MAIN, T_POLE + 1, 4) or not np.all(
            np.isfinite(s.cost)):
        fail(f"{what}: shape {s.xs.shape} or non-finite costs")
    ok = np.isin(s.status, (1, 2))
    solved = float(ok.mean())
    upright = np.cos(s.xs[:, -1, 1]) > 0.98
    upright_share = float(upright[ok].mean()) if ok.any() else 0.0
    u_max = float(np.abs(s.us).max())
    extra = {}
    if serial:
        n = len(cpu_lanes.cost)
        head = type(s)(*(f[:n] for f in s))
        # the CPU tolerance of per_lane_serial: lane 9 moves 3.6e-8 an ulp
        extra["first_lanes_cost_rel_err"] = check_lanes(
            f"{what}: first {n} lanes against the CPU", head, cpu_lanes,
            1e-6)
    else:
        if solved < SOLVED_MIN:
            fail(f"{what}: solved share {solved:.4f} < {SOLVED_MIN}")
        if upright_share < UPRIGHT_MIN:
            fail(f"{what}: upright share of solved lanes "
                 f"{upright_share:.4f} < {UPRIGHT_MIN}")
    if u_max > 15.0 * (1 + 1e-6):
        fail(f"{what}: |u| reaches {u_max} > 15")
    body = int(s.body_calls.max())
    return dict(B=B_MAIN, T=T_POLE, max_iter=opts.max_iter, **extra,
                dtype=opts.dtype, wall_s=wall, solves_per_s=B_MAIN / wall,
                solved_pct=100 * solved,
                exhausted_pct=100 * float((s.status == 7).mean()),
                status=np.bincount(s.status, minlength=8).tolist(),
                upright_pct_of_solved=100 * upright_share,
                max_abs_u=u_max, mean_iters=float(s.iterations.mean()),
                mean_body_calls=float(s.body_calls.mean()),
                max_body_calls=body, s_per_body_call=wall / body,
                mean_cost=float(s.cost[ok].mean()), **loop,
                launches=launches)


def ptxas_summary(lib_path) -> dict:
    """Kernels, most registers and spill-store bytes of a built library,
    from the ``ptxas.txt`` beside it."""
    ptxas = (lib_path.parent / "ptxas.txt").read_text()
    regs = [int(w) for ln in ptxas.splitlines() if "registers" in ln
            for w in [ln.split("Used ")[1].split(" registers")[0]]]
    spills = sum(int(ln.split(" bytes spill stores")[0].split()[-1])
                 for ln in ptxas.splitlines() if "spill stores" in ln)
    return dict(kernels=len(regs), max_registers=max(regs, default=0),
                spill_store_bytes=spills)


def generated_cases():
    """Every problem whose CUDA model this run generates, with the params
    of its solve: CarParking and brachistochrone_hli with their
    hand-written models stripped, and the two user problems."""
    from ddp_generator_tpu_torch.models import brachistochrone, car_parking

    strip = lambda pr: dataclasses.replace(pr, cuda_model=None)
    cases = {
        "gen_car_parking": (strip(car_parking.car_parking()),
                            bench_inputs(1, T_MAIN, np.float32)[0]),
        "gen_brachistochrone_hli": (
            strip(brachistochrone.brachistochrone_hli()),
            brachi_inputs(1, N_BRACHI, seed=7)[0]),
    }
    for name, (problem, p, _, _) in USER_PROBLEMS.items():
        cases[name] = (problem, p)
    cases["point_mass3_free"] = (free_point_mass(),
                                 USER_PROBLEMS["point_mass3"][1])
    return cases


def build_phase():
    """Phase 2: every kernel library of this run, built at once (one nvcc
    per source, all started together): the hand-written kernels, B2 and B3
    on each generated model and B1 at the user problems' shapes (2, 1) and
    (6, 3).  Returns the build line's numbers, one line per generated
    library, and the generated models by case."""
    from ddp_generator_tpu_torch import _build, codegen

    t0 = time.time()
    models = {name: codegen.model_for(problem, p)
              for name, (problem, p) in generated_cases().items()}
    gen_s = time.time() - t0
    shapes = ((2, 1), (6, 3))
    jobs = [_build.build] + [
        (lambda gm=gm: _build.build_model(gm)) for gm in models.values()] + [
        (lambda s=s: _build.build_backpass_shape(*s)) for s in shapes]
    paths = _build.build_all(jobs)
    wall = time.time() - t0
    _build.load_library()
    main = dict(seconds=round(wall, 1), generate_s=round(gen_s, 2),
                lib=paths[0].name, **ptxas_summary(paths[0]))
    libs = {}
    for what, path in zip(["main"] + list(models)
                          + [f"backpass_{a}x{b}" for a, b in shapes], paths):
        libs[what] = dict(
            lib=path.parent.name,
            build_s=round(_build.BUILD_SECONDS.get(str(path), 0.0), 1),
            **ptxas_summary(path))
    return main, libs, models


def same_solution(what, a, b, launches_a, launches_b,
                  ref="hand-written model's") -> int:
    """Fail unless two solutions (numpy) equal field by field, bit for bit,
    and their launch counts equal; returns the number of fields."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.shape != y.shape or not np.array_equal(
                x, y, equal_nan=x.dtype.kind == "f"):
            fail(f"{what}: Solution.{f} differs from the {ref} in "
                 f"{int((x != y).sum())} entries")
    if launches_a != launches_b:
        fail(f"{what}: launches {launches_a}, the {ref} {launches_b}")
    return len(a._fields)


def generated_kernels_car(gen, b2_ops, b3_args, alphas):
    """Phase 12d on generated CarParking: B2 (both modes) and B3 on the
    operands of phases 4 and 4b, against their plain versions, and their
    outputs against the hand-written model's kernels bit for bit."""
    import torch

    from ddp_generator_tpu_torch.ops import cuda_fused as cf
    from ddp_generator_tpu_torch.ops import cuda_rollout as cr

    p, r, m, w, bp = b2_ops
    ro, ops2 = check_rollout(gen, alphas, p, r, m, w, bp,
                             TOL_ROLLOUT["float32"], 20,
                             label="gen_car_parking")
    for (mode, kw), ops_hand in zip(
            (("multi", dict(multi=True)),
             ("selected", dict(multi=False, want_cost=True))), ops2):
        hand = cr.rollout_call(*ops_hand, **kw)
        out = cr.rollout_call(gen, *ops_hand[1:], **kw)
        if not all(torch.equal(a, b) for a, b in zip(out, hand)):
            fail(f"generated car_parking rollout {mode}: outputs differ "
                 "from the hand-written model's")
        ro[mode]["equal_to_hand_written"] = True
    args = (gen,) + tuple(b3_args[1:])
    fu = compare_fused("gen_car_parking float32", args,
                       TOL_B3["car_parking float32"], 10,
                       label="gen_car_parking")
    out, ok = cf.fused_derivs_back_pass(*args)
    hand, hand_ok = cf.fused_derivs_back_pass(*b3_args)
    if not (torch.equal(ok, hand_ok) and all(
            torch.equal(getattr(out, f), getattr(hand, f))
            for f in ("l", "L", "dV", "g_norm", "failed"))):
        fail("generated car_parking fused: outputs differ from the "
             "hand-written model's")
    fu["equal_to_hand_written"] = True
    return ro, fu


def user_inputs(name, B, np_dtype=np.float64):
    """``(params, x0s, u0s)`` of a user problem's solve (its first lanes
    do not depend on B)."""
    _, p, _, inputs = USER_PROBLEMS[name]
    x0s, u0s = inputs(B, 21)
    return ({k: np.asarray(v, np_dtype) for k, v in p.items()},
            x0s.astype(np_dtype), u0s.astype(np_dtype))


def user_kernels(name, alphas, rng):
    """Phase 12d on a user problem: B1 at its shape, B2 (both modes) and B3
    on its generated model, float64 at B=2048, on the operands of its
    solve's first body call, against their plain versions."""
    import torch

    problem = USER_PROBLEMS[name][0]
    T = user_inputs(name, 1)[2].shape[1]
    b1, (p, r, m, w, out, lam, _) = check_backpass(
        problem, B_MAIN, T, torch.float64, TOL_B1["float64"], 3, rng,
        inputs=lambda B, T_, npd: user_inputs(name, B, npd), label=name)
    ro, _ = check_rollout(problem, alphas, p, r, m, w, out,
                          TOL_ROLLOUT["float64"], 3, label=name)
    args = (problem, r.xs, r.us, m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w, w,
            lam, p, 1, True)
    key = f"{name} float64"
    fu = compare_fused(key, args, TOL_B3[key], 3, label=name)
    return b1, ro, fu


def user_solves(name):
    """Phase 12c: a user problem at B=2048, float64, on the kernel path
    (emission + B1 at its shape, B2 on its generated model) and the fused
    path (B3 and B2 on its generated model), graphed; the first 16 lanes
    against the CPU's solve of those lanes (plain versions): equal status,
    iterations, body and stale calls, cost to 1e-8."""
    import ddp_generator_tpu_torch as ddp

    problem, _, kw, _ = USER_PROBLEMS[name]
    p, x0s, u0s = user_inputs(name, B_MAIN)
    out = {}
    for backpass in ("kernel", "fused"):
        what = f"{name} {backpass}"
        opts = ddp.SolverOptions(dtype="float64", debug_level=0,
                                 backpass_method=backpass,
                                 linesearch_method="kernel", **kw)
        solver = ddp.StepwiseSolver(problem, opts, device="cuda")
        s, wall, launches = timed_solve(solver, x0s, u0s, p)
        used = (("backpass", "emit") if backpass == "kernel"
                else ("fused",)) + ("rollout_multi", "rollout_selected",
                                    "init_rollout")
        for k, n in launches.items():
            if (n > 0) != (k in used):
                fail(f"{what}: kernel {k} was launched {n} times")
        if not np.all(np.isfinite(s.cost)):
            fail(f"{what}: non-finite costs")
        t0 = time.time()
        cpu = ddp.to_numpy(ddp.StepwiseSolver(
            problem, opts, min_compact_batch=4, device="cpu")(
                x0s[:16], u0s[:16], p))
        cpu_s = time.time() - t0
        head = type(s)(*(f[:16] for f in s))
        cost_rel = check_lanes(f"{what}: first 16 lanes against the CPU",
                               head, cpu, 1e-8)
        out[backpass] = dict(
            B=B_MAIN, T=u0s.shape[1], wall_s=wall,
            solved_pct=100 * float(np.isin(s.status, (1, 2)).mean()),
            mean_iters=float(s.iterations.mean()),
            mean_body_calls=float(s.body_calls.mean()),
            first16_cost_rel_err=cost_rel, cpu16_s=round(cpu_s, 2),
            mean_cost=float(s.cost.mean()), launches=launches)
    return out


def history_emitter(name: str, dtype):
    """``emit(how)``: the bundle (every component, the final-stage
    derivatives and ``ok``) of the initial rollout of CarParking (bench's
    inputs, B=2048, T=500) or of the Brachistochrone (``testBrachi.m``,
    ``brachi_plain_inputs(2048, 500, 11)``), FULL_DDP, on the card, by the
    emission kernel (``how="kernel"``) or by the torch emitter
    (``"per_family"``, ``"shared"``)."""
    import torch

    from ddp_generator_tpu_torch.models import brachistochrone, car_parking
    from ddp_generator_tpu_torch.ops import cuda_emit as ce
    from ddp_generator_tpu_torch.ops.cm_derivs import cm_emit

    if name == "brachistochrone":
        problem = brachistochrone.brachistochrone()

        def inputs(B, T, np_dtype):
            p_np, x0s, u0s = brachi_plain_inputs(B, T, 11)
            return ({k: np.asarray(v, np_dtype) for k, v in p_np.items()},
                    x0s.astype(np_dtype), u0s.astype(np_dtype))
        T = N_BRACHI
    else:
        problem, inputs, T = car_parking.car_parking(), bench_inputs, T_MAIN
    args = emit_args(problem, *nominal_rollout(
        problem, B_MAIN, T, dtype, torch.device("cuda"), inputs))

    def emit(how: str) -> dict:
        if how == "kernel":
            sd, fcx, fcxx, _, ok = ce.emit(*args)
        else:
            sd, fcx, fcxx, _, ok = cm_emit(*args, how == "shared")
        return dict(sd, final_cx=fcx, final_cxx=fcxx, ok=ok)
    return emit


def profiled(fn):
    """``fn()`` under ``torch.profiler``: ``(result, device kernels, their
    device ms)``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    return out, len(dev), sum(e.device_time_total for e in dev) / 1e3


def emission_history(strict: bool = True) -> dict:
    """Phase 0: emission must not depend on what the process did before.
    For each dtype, each problem's bundle is emitted, then the other
    problem's, then the first again, by the emission kernel and with each
    ``derivs_emitter`` of the torch emitter; every component of the two
    emissions must be equal bit for bit.  Also the device kernels and ms
    of the first and the repeated emission.
    ``strict=False`` reports a difference instead of failing (to show
    the fault on an older tree)."""
    import torch

    out = {}
    for dtype in (torch.float32, torch.float64):
        key = str(dtype).replace("torch.", "")
        emitters = {n: history_emitter(n, dtype)
                    for n in ("brachistochrone", "car_parking")}
        for target, other in (("brachistochrone", "car_parking"),
                              ("car_parking", "brachistochrone")):
            for name in ("kernel", "per_family", "shared"):
                first, ev0, ms0 = profiled(lambda: emitters[target](name))
                emitters[other](name)
                again, ev1, ms1 = profiled(lambda: emitters[target](name))
                differ = [k for k, v in first.items()
                          if not torch.equal(v, again[k])]
                if differ and strict:
                    fail(f"emission history: {target} {key} {name}: "
                         f"{differ} changed after a {other} emission")
                out[f"{target}_{key}_{name}"] = dict(
                    bit_equal=not differ, differing=",".join(differ) or "-",
                    components=len(first), device_events=ev0,
                    device_ms=round(ms0, 3), device_events_after=ev1,
                    device_ms_after=round(ms1, 3))
        del emitters
    return out


def brachi_plain_inputs(B, n, seed):
    """testBrachi.m's setup (terminal equality, no floor) with
    u0 = -|uniform(0.5, 1.5)| per lane."""
    from ddp_generator_tpu_torch.models import brachistochrone

    p, x0, _ = brachistochrone.default_setup(n)
    rng = np.random.default_rng(seed)
    return (p, np.tile(x0, (B, 1)),
            -np.abs(rng.uniform(0.5, 1.5, (B, n, 1))))


def free_point_mass():
    """The user point mass of ``user_problems`` without its input boxes
    (no ``h``): an unconstrained (6, 3) problem the parallel pass takes,
    on its own generated CUDA model."""
    pm = USER_PROBLEMS["point_mass3"][0]
    return dataclasses.replace(pm, h=(), box_constraints=(),
                               name="point_mass3_free")


def parallel_cases(B):
    """``{name: (problem, params, x0s, u0s, w_pen_f)}`` of the parallel
    path: the published Brachistochrone (n=500, terminal equality,
    tests/test_parallel_riccati.py:77-95) and the free point mass (T=100),
    float64 inputs, each with the solves' w_pen_init_f of 40."""
    from ddp_generator_tpu_torch.models import brachistochrone

    p, x0s, u0s = brachi_plain_inputs(B, N_BRACHI, seed=11)
    pm_p, pm_x0s, pm_u0s = user_inputs("point_mass3", B)
    return {"brachistochrone": (brachistochrone.brachistochrone(), p, x0s,
                                u0s, 40.0),
            "point_mass3_free": (free_point_mass(), pm_p, pm_x0s, pm_u0s,
                                 40.0)}


def parallel_options(backpass="parallel"):
    """tests/test_parallel_riccati.py:98-110's options, float64, with the
    kernel line search (B2)."""
    import ddp_generator_tpu_torch as ddp

    return ddp.SolverOptions(max_iter=50, w_pen_init_f=40.0, w_pen_fact2=2.0,
                             full_ddp=False, dtype="float64", debug_level=0,
                             backpass_method=backpass,
                             linesearch_method="kernel")


def parallel_bundle(problem, p_np, x0s, u0s, w_pen_f):
    """The initial rollout of ``x0s``, ``u0s`` on the card and its bundle,
    step-major (the parallel and serial passes') and packed (B1's):
    ``(params, rollout, multipliers, w_pen_l, w_pen_f, bundle, packed)``,
    the operands of a solve's first body call."""
    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.ops.cm_derivs import cm_emit
    from ddp_generator_tpu_torch.ops.forward import forward_pass

    f64 = torch.float64
    p = ddp.params_from_jax(p_np, f64, "cuda")
    x0 = torch.as_tensor(x0s, dtype=f64, device="cuda")
    u0 = torch.as_tensor(u0s, dtype=f64, device="cuda")
    B, N = u0.shape[:2]
    m = ddp.init_multipliers(problem, B, N, f64, "cuda")
    one = torch.ones(B, dtype=f64, device="cuda")
    wf = torch.full((B,), w_pen_f, dtype=f64, device="cuda")
    mus = (m.mu_le, m.mu_li, m.mu_fe, m.mu_fi)
    r = forward_pass(problem, x0, None, u0, None, None, 0.0, p, *mus, one, wf)
    d = ddp.batched_calc_derivs(problem, r.xs, r.us, p, *mus, one, wf, False)
    cm = cm_emit(problem, r.xs, r.us, *mus, one, wf, p, False)[:4]
    return p, r, m, one, wf, d, cm


def allclose_or_fail(what, a, b, rtol, atol) -> float:
    """Fail unless ``|a - b| <= atol + rtol |b|`` everywhere; returns the
    largest ``|a - b| / (atol + rtol |b|)``."""
    worst = float(((a - b).abs() / (atol + rtol * b.abs())).max())
    if not worst <= 1.0:
        fail(f"{what}: {worst:.3g} x the tolerance (rtol {rtol}, atol "
             f"{atol})")
    return worst


def parallel_nominal(alphas):
    """Phase 13a: the parallel pass against the serial pass on one nominal
    bundle on the card (B=2048, float64) of each parallel case, at lambda 0
    (JAX's tolerances: l and L rtol 1e-7 / atol 1e-9, g_norm rtol 1e-8,
    the same failed lanes) and 0.3 (every lane descends: dV[0] < 0).  The
    ms of the parallel pass, the serial pass and B1 on the same bundle,
    CUDA events.  Then B2 (both modes) against its plain version on the
    gains of the parallel pass at the solve's lambdaInit: the operands of
    the parallel solve's first line search.  Returns ``{case: pass
    numbers}`` and ``{case: B2 numbers by mode}``."""
    import torch

    from ddp_generator_tpu_torch.ops.backpass import back_pass
    from ddp_generator_tpu_torch.ops.cm_derivs import cm_back_pass_from_bundle
    from ddp_generator_tpu_torch.ops.parallel_riccati import (
        parallel_back_pass,
    )

    out, b2 = {}, {}
    for name, (problem, p, x0s, u0s, wf) in parallel_cases(B_MAIN).items():
        P, r, m, w_l, w_f, d, cm = parallel_bundle(problem, p, x0s, u0s, wf)
        us = r.us
        B, N = us.shape[:2]
        res = dict(B=B, N=N)
        for lam_v in (0.0, 0.3):
            lam = torch.full((B,), lam_v, dtype=torch.float64, device="cuda")
            par = parallel_back_pass(d, us, lam, 1)
            if lam_v == 0.0:
                ser = back_pass(d, us, lam, 1, False)
                if not torch.equal(par.failed, ser.failed):
                    fail(f"parallel {name}: failed lanes differ from the "
                         "serial pass's")
                ok = ~ser.failed
                res["failed_lanes"] = int(ser.failed.sum())
                for f in ("l", "L"):
                    res[f"{f}_tol_used"] = allclose_or_fail(
                        f"parallel {name} lambda 0 {f}",
                        getattr(par, f)[ok], getattr(ser, f)[ok], 1e-7, 1e-9)
                res["g_norm_tol_used"] = allclose_or_fail(
                    f"parallel {name} lambda 0 g_norm", par.g_norm[ok],
                    ser.g_norm[ok], 1e-8, 0.0)
                lam0 = lam
            elif not bool((par.dV[:, 0] < 0).all()) or par.failed.any():
                fail(f"parallel {name} lambda 0.3: "
                     f"{int((par.dV[:, 0] >= 0).sum())} lanes do not "
                     f"descend, {int(par.failed.sum())} failed")
        res["parallel_ms"] = time_ms(
            lambda: parallel_back_pass(d, us, lam0, 1), 3)
        res["serial_ms"] = time_ms(lambda: back_pass(d, us, lam0, 1, False),
                                   1)
        res["b1_ms"] = time_ms(lambda: cm_back_pass_from_bundle(
            *cm, lam0, problem.n_x, 1, False), 10)
        out[name] = res
        lam_init = torch.full((B,), parallel_options().lambdaInit,
                              dtype=torch.float64, device="cuda")
        par = parallel_back_pass(d, us, lam_init, 1)
        n_u, n_x = problem.n_u, problem.n_x
        gains = (par.l.permute(1, 2, 0),
                 par.L.reshape(B, N, n_u * n_x).permute(1, 2, 0))
        b2[name], _ = check_rollout(problem, alphas, P, r, m, w_l, gains,
                                    TOL_ROLLOUT["float64"], 3, label=name,
                                    wf=w_f)
    return out, b2


def busy_share(solver, x0s, u0s, p, calls=3) -> float:
    """The card's busy share (%) over ``calls`` eager body calls of the
    solver's width after one warm-up call (``torch.profiler``: kernel time
    over host wall)."""
    import torch

    from ddp_generator_tpu_torch.solver import _masked_steps

    o = solver.options
    P = solver._cast_params(p, len(u0s), u0s.shape[1])
    c = solver._init(x0s, u0s, P)
    c, _ = _masked_steps(solver._body, c, P, o.max_iter, 1)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _masked_steps(solver._body, c, P, o.max_iter, calls)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.device_time_total for e in prof.events()
               if e.device_type.name == "CUDA") / 1e6
    return 100 * busy / wall


def off_terminal(name, p, s) -> int:
    """Solved lanes of a solve (numpy) that miss the Brachistochrone's
    terminal equality y_N = yf by more than 1e-5 (the JAX package's test
    of the parallel pass asserts it, tests/test_parallel_riccati.py:108)."""
    if name != "brachistochrone":
        return 0
    solved = np.isin(s.status, (1, 2))
    return int((solved & (np.abs(s.xs[:, -1, 0] - p["yf"]) > 1e-5)).sum())


def parallel_solves():
    """Phase 13b: each parallel case at full width (B=2048, float64)
    through StepwiseSolver with ``backpass_method="parallel"`` and B2,
    against the same solve on the kernel path (emission + B1): cost to a
    relative 1e-6 (the JAX package's test of the parallel pass against the
    serial one) on every lane both solve, whatever exit each takes, but
    those that either path leaves at a final lambda above ``LAM_HIGH``.
    Such a lane took the tolFun exit while heavily regularized, short of
    the optimum, and the two passes regularize differently: in one card
    run kernel-path Brachistochrone lane 1846 did so at lambda 8.7, cost
    2e-4 above the parallel path's gradient exit.  Emission does not
    depend on the process's history, yet such lanes remain: a property of
    the two passes' rounding on lanes that end regularized.
    Those lanes are counted and listed (lane:lambda parallel/kernel) with
    their largest gap.  The first 16 lanes against the CPU's parallel
    solve (plain B2): equal counts, cost to 1e-8."""
    import ddp_generator_tpu_torch as ddp

    out = {}
    for name, (problem, p, x0s, u0s, _) in parallel_cases(B_MAIN).items():
        what = f"parallel {name}"
        solver = ddp.StepwiseSolver(problem, parallel_options(),
                                    device="cuda")
        s, wall, launches = timed_solve(solver, x0s, u0s, p)
        loop = check_graphed(what, solver)
        # B2's alpha[0] stage (a selected rollout) runs in every body call
        # with a live lane, its sweep only where a lane rejects alpha[0]
        if (launches["rollout_selected"] <= 0 or launches["backpass"]
                or launches["fused"]):
            fail(f"{what}: launches {launches}: B2 must run, B1 and B3 not")
        if not np.all(np.isfinite(s.cost)):
            fail(f"{what}: non-finite costs")
        solved = np.isin(s.status, (1, 2))
        if solved.mean() < SOLVED_MIN:
            fail(f"{what}: solved share {solved.mean():.4f} < {SOLVED_MIN}")
        kern = ddp.StepwiseSolver(problem, parallel_options("kernel"),
                                  device="cuda")
        k_sol, k_wall, k_launches = timed_solve(kern, x0s, u0s, p)
        check_graphed(f"{what}: kernel path", kern)
        both = np.isin(s.status, (1, 2)) & np.isin(k_sol.status, (1, 2))
        high = both & ((s.lam > LAM_HIGH) | (k_sol.lam > LAM_HIGH))
        gated = both & ~high
        if high.sum() > HIGH_LAMBDA_MAX_LANES:
            fail(f"{what}: {int(high.sum())} lanes end above lambda "
                 f"{LAM_HIGH}, more than {HIGH_LAMBDA_MAX_LANES}")
        rel = np.abs(s.cost - k_sol.cost) / np.abs(k_sol.cost)
        worst = int(np.argmax(np.where(gated, rel, -1.0)))
        cost_rel = float(rel[worst])
        if not cost_rel <= 1e-6:
            fail(f"{what}: cost rel err {cost_rel:.3g} > 1e-6 against the "
                 f"kernel path at lane {worst} (status {s.status[worst]} / "
                 f"{k_sol.status[worst]}, iterations {s.iterations[worst]} /"
                 f" {k_sol.iterations[worst]}, y_N {s.xs[worst, -1, 0]} / "
                 f"{k_sol.xs[worst, -1, 0]})")
        t0 = time.time()
        cpu = ddp.to_numpy(ddp.StepwiseSolver(
            problem, parallel_options(), min_compact_batch=4, device="cpu")(
                x0s[:16], u0s[:16], p))
        cpu_s = time.time() - t0
        head = type(s)(*(f[:16] for f in s))
        cpu_rel = check_lanes(f"{what}: first 16 lanes against the CPU",
                              head, cpu, 1e-8)
        out[name] = dict(
            B=B_MAIN, T=u0s.shape[1], max_iter=50, wall_s=wall,
            solved_pct=100 * float(solved.mean()),
            mean_iters=float(s.iterations.mean()),
            max_iters=int(s.iterations.max()),
            mean_body_calls=float(s.body_calls.mean()),
            loop_body_calls=solver.last_stats.body_calls, **loop,
            busy_pct=busy_share(solver, x0s, u0s, p),
            kernel_path_wall_s=k_wall,
            kernel_path_solved_pct=100 * float(
                np.isin(k_sol.status, (1, 2)).mean()),
            lanes_status_differ=int((s.status != k_sol.status).sum()),
            lanes_compared=int(gated.sum()),
            compared_status_differ=int(
                (gated & (s.status != k_sol.status)).sum()),
            cost_rel_err_vs_kernel=cost_rel,
            high_lambda_lanes=int(high.sum()),
            high_lambda_at=",".join(
                f"{i}:{s.lam[i]:.3g}/{k_sol.lam[i]:.3g}"
                for i in np.flatnonzero(high)) or "none",
            high_lambda_max_cost_rel=float(rel[high].max(initial=0.0)),
            off_terminal=off_terminal(name, p, s),
            kernel_path_off_terminal=off_terminal(name, p, k_sol),
            first16_cost_rel_err=cpu_rel,
            cpu16_s=round(cpu_s, 2),
            **{f"launches_{k}": v for k, v in launches.items()},
            kernel_path_launches_backpass=k_launches["backpass"])
    return out


def parallel_long_horizon():
    """Phase 13c: the single long-horizon solve the README's TPU table is
    about: the Brachistochrone at B=1 with N = 500, 2000 and 8000.  The ms
    of the parallel pass and of B1 on the same bundle (and of the serial
    eager pass at N=500 only: seconds beyond), the largest gap of their
    ``l`` relative to B1's, and the wall of one ``make_solver`` solve at
    N=8000 with each.  Recorded, not gated (beyond finite values)."""
    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.models import brachistochrone
    from ddp_generator_tpu_torch.ops.backpass import back_pass
    from ddp_generator_tpu_torch.ops.cm_derivs import cm_back_pass_from_bundle
    from ddp_generator_tpu_torch.ops.parallel_riccati import (
        parallel_back_pass,
    )

    problem = brachistochrone.brachistochrone()
    lam = torch.zeros(1, dtype=torch.float64, device="cuda")
    out = {}
    for N in (500, 2000, 8000):
        p, x0, u0 = brachistochrone.default_setup(N)
        _, r, _, _, _, d, cm = parallel_bundle(problem, p, x0[None],
                                               u0[None], 40.0)
        us = r.us
        par = parallel_back_pass(d, us, lam, 1)
        b1 = cm_back_pass_from_bundle(*cm, lam, problem.n_x, 1, False)
        if not bool(torch.isfinite(par.l).all()) or par.failed.any():
            fail(f"parallel long horizon N={N}: the pass failed")
        res = dict(parallel_ms=time_ms(
            lambda: parallel_back_pass(d, us, lam, 1), 5),
            b1_ms=time_ms(lambda: cm_back_pass_from_bundle(
                *cm, lam, problem.n_x, 1, False), 5),
            l_rel_gap_vs_b1=max_rel_err(par.l, b1.l)[1])
        if N == 500:
            res["serial_ms"] = time_ms(
                lambda: back_pass(d, us, lam, 1, False), 1)
        out[N] = res
    for backpass in ("parallel", "kernel"):
        solve = ddp.make_solver(problem, parallel_options(backpass),
                                device="cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        sol = ddp.to_numpy(solve(x0, u0, p))
        wall = time.time() - t0
        if not np.isfinite(sol.cost):
            fail(f"parallel long horizon: {backpass} solve not finite")
        out[8000][f"{backpass}_solve_wall_s"] = wall
        out[8000][f"{backpass}_solve"] = (
            f"status={int(sol.status)},iters={int(sol.iterations)},"
            f"cost={float(sol.cost):.10g}")
    return out


def fused_vs_kernel_f64(problem, f32):
    """Phase 15: the main path's CarParking solve (B=2048, T=500,
    precompiled) in float64 on the kernel and the fused path: each path's
    solved count and the lanes whose status or iterations differ between
    them, beside the same counts of the float32 solves ``f32``
    (``{path: solution}``)."""
    sols = {}
    res = {}
    for backpass in ("kernel", "fused"):
        stats, sols[backpass] = main_path(problem, backpass, "float64")
        res[f"{backpass}_wall_s"] = stats["wall_s"]
    for label, pair in (("f64", sols), ("f32", f32)):
        a, b = pair["kernel"], pair["fused"]
        for backpass, sol in pair.items():
            res[f"{label}_{backpass}_solved"] = int(
                np.isin(sol.status, (1, 2)).sum())
            res[f"{label}_{backpass}_status"] = "/".join(
                map(str, np.bincount(sol.status, minlength=8)))
        status = np.flatnonzero(a.status != b.status)
        res[f"{label}_lanes_status_differ"] = len(status)
        res[f"{label}_status_lanes"] = ",".join(
            f"{i}:{a.status[i]}/{b.status[i]}" for i in status[:40]) or "none"
        res[f"{label}_lanes_iterations_differ"] = int(
            (a.iterations != b.iterations).sum())
    return res


def aux_api(problem):
    """Phase 14: the auxiliary API on the card.  ``backpass_trace`` of lane
    0 of a small float64 CarParking nominal, cuda against cpu (every field
    to 1e-10 of its largest value), its l and L equal to the serial
    ``back_pass`` of that lane on the card; ``ProblemInspector`` modes 0-14
    and 16 on cuda tensors against cpu (1e-12); and a StepwiseSolver carry
    checkpointed from the card mid-solve (``save_pytree``), restored
    (``load_pytree``, onto the card) and resumed: its Solution equals the
    uninterrupted solve's bit for bit."""
    from pathlib import Path

    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch import native
    from ddp_generator_tpu_torch.debugging import backpass_trace
    from ddp_generator_tpu_torch.ops.forward import forward_pass
    from ddp_generator_tpu_torch.solver import (
        _boxqp_hyper,
        _masked_steps,
        _running,
    )

    out = {}
    # backpass_trace
    opts = ddp.SolverOptions(max_iter=5, dtype="float64", debug_level=0)
    p, x0s, u0s = bench_inputs(1, 100, np.float64, seed=3)
    P = ddp.params_from_jax(p, torch.float64, "cpu")
    m = ddp.init_multipliers(problem, 1, 100, torch.float64, "cpu")
    one = torch.ones(1, dtype=torch.float64)
    r = forward_pass(problem, torch.as_tensor(x0s), None,
                     torch.as_tensor(u0s), None, None, 0.0, P, m.mu_le,
                     m.mu_li, m.mu_fe, m.mu_fi, one, one)
    trs = {dev: backpass_trace(problem, opts, r.xs[0].to(dev),
                               r.us[0].to(dev), 0.1, p, device=dev)
           for dev in ("cuda", "cpu")}
    worst = 0.0
    for f, a, b in zip(trs["cpu"]._fields, trs["cuda"], trs["cpu"]):
        worst = max(worst, max_rel_err(a.cpu(), b)[1])
    if not worst <= 1e-10:
        fail(f"backpass_trace: cuda against cpu rel err {worst:.3g}")
    xs, us = r.xs.cuda(), r.us.cuda()
    Pc = ddp.params_from_jax(p, torch.float64, "cuda")
    mc = ddp.init_multipliers(problem, 1, 100, torch.float64, "cuda")
    onec = one.cuda()
    d = ddp.batched_calc_derivs(problem, xs, us, Pc, mc.mu_le, mc.mu_li,
                                mc.mu_fe, mc.mu_fi, onec, onec,
                                opts.full_ddp)
    bp = ddp.back_pass(d, us, torch.full_like(onec, 0.1), opts.regType,
                       opts.full_ddp, _boxqp_hyper(opts))
    tr = trs["cuda"]
    if not (torch.equal(tr.l, bp.l[0]) and torch.equal(tr.L, bp.L[0])):
        fail("backpass_trace: l/L differ from back_pass's lane on the card")
    out["trace_rel_err_cuda_cpu"] = worst
    # inspector
    insp = ddp.inspect(problem)
    x = np.array([0.3, -0.2, 0.5, 0.1])
    u = np.array([0.1, -0.4])
    worst = 0.0
    for mode in tuple(range(15)) + (16,):
        vals = {}
        for dev in ("cuda", "cpu"):
            xt = torch.as_tensor(x, device=dev)
            args = (xt, p, 0) if mode in (2, 3, 4) else (xt, u, p, 0)
            vals[dev] = insp.by_mode(mode)(*args)
        if vals["cuda"].device.type != "cuda":
            fail(f"inspector mode {mode} did not compute on the card")
        worst = max(worst, max_rel_err(vals["cuda"].cpu(), vals["cpu"])[1])
    if not worst <= 1e-12:
        fail(f"inspector: cuda against cpu rel err {worst:.3g}")
    out["inspector_modes"] = 16
    out["inspector_rel_err_cuda_cpu"] = worst
    # checkpoint and resume
    copts = ddp.SolverOptions(max_iter=100, dtype="float64", debug_level=0,
                              backpass_method="kernel",
                              linesearch_method="kernel")
    B = 64
    p, x0s, u0s = bench_inputs(B, 100, np.float64, seed=3)
    x0s = x0s + 0.05 * np.random.default_rng(4).standard_normal(x0s.shape)
    s = ddp.StepwiseSolver(problem, copts, chunk=5, device="cuda")
    Ps = s._cast_params(p, B, u0s.shape[1])
    c = s._init(x0s, u0s, Ps)
    c, _ = _masked_steps(s._body, c, Ps, copts.max_iter, 5)
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke"
    ckpt.mkdir(parents=True, exist_ok=True)
    path = str(ckpt / "carry.ddpt")
    native.save_pytree(path, c)
    c2 = native.load_pytree(path, c)
    if c2.xs.device.type != "cuda":
        fail("load_pytree did not restore onto the card")
    c2, _ = _masked_steps(s._body, c2, Ps, copts.max_iter, 10_000)
    if bool(_running(c2, copts.max_iter).any()):
        fail("checkpoint resume: lanes still running")
    resumed = ddp.to_numpy(s._finalize(c2))
    direct = ddp.to_numpy(s(x0s, u0s, p))
    out["checkpoint_fields_equal"] = same_solution(
        "checkpoint resume", resumed, direct, {}, {},
        ref="uninterrupted solve's")
    out["native_engine"] = native.native_available()
    return out



MESH_RANKS = 2
MESH_TIMEOUT_S = 420
BRACHI_MESH_ITER = 15


def mesh_brachi_options():
    """testBrachi.m's options on the kernel path, cut to max_iter 15."""
    import ddp_generator_tpu_torch as ddp

    return ddp.SolverOptions(max_iter=BRACHI_MESH_ITER, w_pen_init_f=40.0,
                             w_pen_fact2=2.0, full_ddp=False, debug_level=0,
                             backpass_method="kernel",
                             linesearch_method="kernel")


def mesh_rank(rank: int, port: int, out_dir: str) -> None:
    """One rank of phase 16 (spawned): joins a ``gloo`` world of
    ``MESH_RANKS`` through ``multihost_initialize``, makes the mesh and
    solves the main path's global batch with ``StepwiseSolver(mesh=m)`` on
    the kernel and the fused path (precompiled, every all-reduce
    recorded), then testBrachi's batch with ``make_sharded_solver``.
    Writes its rows, walls, launches and loop stats to
    ``out_dir/rank<r>.npz``."""
    import torch
    import torch.distributed as dist

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch import _build
    from ddp_generator_tpu_torch.launches import read_launches, reset_launches
    from ddp_generator_tpu_torch.models import brachistochrone, car_parking
    from ddp_generator_tpu_torch.parallel import mesh as pmesh

    torch.cuda.set_device(0)
    pmesh.multihost_initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=MESH_RANKS, process_id=rank)
    mesh = pmesh.make_mesh()
    _build.load_library()
    calls = []
    reduce = dist.all_reduce
    others = ("broadcast", "all_gather", "all_gather_into_tensor",
              "reduce_scatter_tensor", "all_to_all_single", "barrier")

    def counted(t, *a, **kw):
        calls.append((t.numel(), str(t.dtype)))
        return reduce(t, *a, **kw)

    out = {}
    problem = car_parking.car_parking()
    p, x0s, u0s = bench_inputs(B_MAIN, T_MAIN, np.float32)
    for backpass in ("kernel", "fused"):
        solver = ddp.StepwiseSolver(problem, main_options(backpass),
                                    chunk=10, compact_levels=4,
                                    min_compact_batch=128, mesh=mesh,
                                    device="cuda")
        out[f"{backpass}_precompile_s"] = solver.precompile(x0s, u0s, p)
        dist.barrier(group=pmesh.host_group(mesh))
        reset_launches()
        del calls[:]
        dist.all_reduce = counted
        forbidden = {n: getattr(dist, n) for n in others}
        for n in others:
            setattr(dist, n, lambda *a, _n=n, **kw: calls.append((-1, _n)))
        torch.cuda.synchronize()
        t0 = time.time()
        sol = solver(x0s, u0s, p)
        torch.cuda.synchronize()
        out[f"{backpass}_wall_s"] = time.time() - t0
        dist.all_reduce = reduce
        for n, fn in forbidden.items():
            setattr(dist, n, fn)
        st = solver.last_stats
        out[f"{backpass}_collectives"] = np.asarray(
            [f"{k}:{d}" for k, d in calls])
        out[f"{backpass}_chunks"] = st.chunks
        out[f"{backpass}_allreduces"] = st.allreduces
        out[f"{backpass}_global_counts"] = np.asarray(st.global_counts)
        out[f"{backpass}_graphed"] = np.asarray(st.graphed)
        out[f"{backpass}_eager"] = np.asarray(st.eager)
        for k, v in read_launches().items():
            out[f"{backpass}_launches_{k}"] = v
        stats = pmesh.batch_stats(sol, mesh)
        for k, v in stats._asdict().items():
            out[f"{backpass}_stats_{k}"] = float(v)
        for k, v in ddp.to_numpy(sol)._asdict().items():
            out[f"{backpass}_sol_{k}"] = v
        del solver, sol
        torch.cuda.empty_cache()
    bp, bx0s, bu0s = brachi_plain_inputs(B_MAIN, N_BRACHI, 11)
    sharded = pmesh.make_sharded_solver(
        brachistochrone.brachistochrone(), mesh_brachi_options(), mesh=mesh,
        device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    sol, stats = sharded(bx0s, bu0s, bp)
    torch.cuda.synchronize()
    out["brachi_wall_s"] = time.time() - t0
    for k, v in ddp.to_numpy(sol)._asdict().items():
        out[f"brachi_sol_{k}"] = v
    for k, v in stats._asdict().items():
        out[f"brachi_stats_{k}"] = float(v)
    start, stop = pmesh.shard_range(mesh, B_MAIN)
    np.savez(f"{out_dir}/rank{rank}.npz", start=start, stop=stop, **out)
    dist.destroy_process_group()


def _global_rows(ranks, key):
    parts = sorted(ranks, key=lambda r: int(r["start"]))
    return np.concatenate([r[key] for r in parts])


def mesh_phase(problem, refs) -> dict:
    """Phase 16: the main path as ``MESH_RANKS`` ranks sharing the card
    (``torch.multiprocessing``, ``gloo`` for the count), on the kernel
    path (emission + B1, B2) and the fused path (B3, B2), every Solution
    field of the reassembled rows bit for bit against the single-process
    solve (``refs[path] = (solution, stats)``), exactly one ``int64``
    scalar all-reduce per chunk and no other collective, the same global
    count on every rank, the mesh's BatchStats against the single-process
    Solution's; then testBrachi (n=500, B=2048, float64, max_iter 15)
    through ``make_sharded_solver`` (each rank's solve one graph with a
    WHILE node) against ``make_batched_solver`` under ``eager_loops()``
    lane by lane (counts exact, cost 1e-10)."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.models import brachistochrone
    from ddp_generator_tpu_torch.ops.device_loop import eager_loops
    from ddp_generator_tpu_torch.parallel import mesh as pmesh

    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        ctx = mp.start_processes(mesh_rank, args=(port, tmp),
                                 nprocs=MESH_RANKS, join=False,
                                 start_method="spawn")
        deadline = time.time() + MESH_TIMEOUT_S
        while not ctx.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.kill()
                fail(f"mesh: the ranks did not finish in {MESH_TIMEOUT_S} s")
        ranks_s = time.time() - t0
        ranks = [dict(np.load(f"{tmp}/rank{r}.npz"))
                 for r in range(MESH_RANKS)]
    for path, (ref, ref_stats) in refs.items():
        what = f"mesh {path} path"
        fields = 0
        for f in ref._fields:
            a, b = _global_rows(ranks, f"{path}_sol_{f}"), getattr(ref, f)
            if a.shape != b.shape or not np.array_equal(
                    a, b, equal_nan=a.dtype.kind == "f"):
                fail(f"{what}: Solution.{f} differs from the single-process "
                     f"solve in {int((a != b).sum())} entries")
            fields += 1
        counts = [r[f"{path}_global_counts"].tolist() for r in ranks]
        if any(c != counts[0] for c in counts) or counts[0][-1] != 0:
            fail(f"{what}: global counts differ across ranks: {counts}")
        for r in ranks:
            calls = r[f"{path}_collectives"].tolist()
            n = int(r[f"{path}_chunks"])
            if calls != ["1:torch.int64"] * n or int(
                    r[f"{path}_allreduces"]) != n:
                fail(f"{what}: {n} chunks, collectives {calls[:5]}...")
            if r[f"{path}_eager"].size:
                fail(f"{what}: widths {r[f'{path}_eager']} ran eagerly")
            used = ("backpass" if path == "kernel" else "fused",
                    "rollout_multi", "rollout_selected")
            for k in used:
                if int(r[f"{path}_launches_{k}"]) <= 0:
                    fail(f"{what}: rank {int(r['start']) // (B_MAIN // 2)} "
                         f"never launched {k}")
        want = pmesh.batch_stats(types.SimpleNamespace(**{
            f: torch.as_tensor(getattr(ref, f)) for f in ref._fields}))
        stats_ok = stats_equal(what, ranks, f"{path}_stats_", want)
        out[path] = dict(
            fields_equal=fields, chunks=int(ranks[0][f"{path}_chunks"]),
            allreduces_per_rank=[int(r[f"{path}_allreduces"])
                                 for r in ranks],
            wall_s=max(float(r[f"{path}_wall_s"]) for r in ranks),
            single_process_wall_s=ref_stats["wall_s"],
            precompile_s=max(float(r[f"{path}_precompile_s"])
                             for r in ranks),
            rank_widths=["/".join(map(str, r[f"{path}_graphed"].tolist()))
                         for r in ranks],
            stats_equal=stats_ok,
            **{f"rank{i}_launches_{k}": int(r[f"{path}_launches_{k}"])
               for i, r in enumerate(sorted(ranks,
                                            key=lambda r: int(r["start"])))
               for k in ("backpass", "fused", "rollout_multi",
                         "rollout_selected")})
    # testBrachi through make_sharded_solver against make_batched_solver
    bp, bx0s, bu0s = brachi_plain_inputs(B_MAIN, N_BRACHI, 11)
    t0 = time.time()
    with eager_loops():
        ref = ddp.make_batched_solver(brachistochrone.brachistochrone(),
                                      mesh_brachi_options(), device="cuda")(
            bx0s, bu0s, bp)
    torch.cuda.synchronize()
    single_wall = time.time() - t0
    r_np = ddp.to_numpy(ref)
    for f in ("iterations", "status", "success", "body_calls",
              "stale_calls", "bp_retry_calls"):
        a, b = _global_rows(ranks, f"brachi_sol_{f}"), getattr(r_np, f)
        if not np.array_equal(a, b):
            fail(f"mesh brachi: {f} differs in {int((a != b).sum())} lanes")
    cost = _global_rows(ranks, "brachi_sol_cost")
    rel = float(np.max(np.abs(cost - r_np.cost) / np.abs(r_np.cost)))
    if not rel <= 1e-10:
        fail(f"mesh brachi: cost differs by {rel:.3g} relative")
    stats_ok = stats_equal("mesh brachi", ranks, "brachi_stats_",
                           pmesh.batch_stats(ref))
    out["brachi"] = dict(
        B=B_MAIN, n=N_BRACHI, max_iter=BRACHI_MESH_ITER, cost_max_rel=rel,
        wall_s=max(float(r["brachi_wall_s"]) for r in ranks),
        single_process_wall_s=single_wall, stats_equal=stats_ok,
        solved_pct=100 * float(np.isin(r_np.status, (1, 2)).mean()),
        ranks_s=ranks_s)
    return out


AOT_MAX_ITER = 20
# Restores an artifact in a fresh process that imports only the port's aot
# (no problem module, no JAX), solves twice on the card (the first solve
# warms up and captures the graph, the second replays it), saves the first
# Solution and prints the load and solve seconds and each solve's launches
# (the second's alone are the solve's: the first's include the warm-up
# body calls) as one JSON line.
AOT_LOADER = """
import json, sys, time
import numpy as np
sys.path.insert(0, {root!r})
import torch
from ddp_generator_tpu_torch import aot, to_numpy
from ddp_generator_tpu_torch.launches import read_launches, reset_launches
from ddp_generator_tpu_torch import _build
d = np.load({inputs!r}, allow_pickle=True)
t0 = time.time()
solver = aot.load_solver_file({path!r}, device="cuda")
load_s = time.time() - t0
args = (d["x0s"], d["u0s"], d["params"].item())
reset_launches()
torch.cuda.synchronize()
t0 = time.time()
sol = solver(*args)
torch.cuda.synchronize()
solve_s = time.time() - t0
first_launches = read_launches()
stages = solver.stage_seconds()
first = to_numpy(sol)
np.savez({out!r}, **first._asdict())
reset_launches()
torch.cuda.synchronize()
t0 = time.time()
again = solver(*args)
torch.cuda.synchronize()
second_s = time.time() - t0
launches = read_launches()
again = to_numpy(again)
bad = sorted(m for m in sys.modules if m.startswith(
    ("ddp_generator_tpu_torch.models", "jax", "ddp_generator_tpu.")))
assert not bad, bad
print(json.dumps(dict(
    load_s=load_s, solve_s=solve_s, launches=launches,
    first_launches=first_launches, **stages,
    kernel_load_s=sum(_build.LOAD_SECONDS.values()), second_solve_s=second_s,
    second_equal=all(np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
                     for a, b in zip(first, again)))))
"""


def aot_phase(problem) -> dict:
    """Phase 17: the main path's configuration (CarParking, kernel path,
    float32, fixed batch 2048, T=500) and the fused one, cut to max_iter
    20, exported with ``aot.export_solver``, restored and solved in a
    subprocess that imports no problem module (the restored solver is
    ``make_batched_solver``'s: its first solve captures the whole solve as
    one graph with a WHILE node, around the exported programs), every
    Solution field and launch count against the direct
    ``make_batched_solver`` solve under ``eager_loops()`` bit for bit.  The
    restored first solve is split into the programs' deserialization,
    their first calls and the kernel library's load (its build, or the
    check that it is built, and the dlopen); a second restored solve is
    timed and must equal the first; its launches are the ones held
    against the direct solve's (the first solve's also count its eager
    warm-up body calls)."""
    import tempfile

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch import aot
    from ddp_generator_tpu_torch.ops.device_loop import eager_loops

    p, x0s, u0s = bench_inputs(B_MAIN, T_MAIN, np.float32)
    out = {}
    for backpass in ("kernel", "fused"):
        what = f"aot {backpass} path"
        o = main_options(backpass).replace(max_iter=AOT_MAX_ITER)
        t0 = time.time()
        blob = aot.export_solver(problem, o, horizon=T_MAIN, params=p,
                                 batch=B_MAIN)
        export_s = time.time() - t0
        with tempfile.TemporaryDirectory() as tmp:
            files = {n: f"{tmp}/{n}" for n in ("a.ddpexe", "in.npz",
                                                "out.npz")}
            Path(files["a.ddpexe"]).write_bytes(blob)
            np.savez(files["in.npz"], x0s=x0s, u0s=u0s,
                     params=np.array(dict(p), dtype=object))
            code = AOT_LOADER.format(
                root=str(Path(__file__).resolve().parent),
                inputs=files["in.npz"], path=files["a.ddpexe"],
                out=files["out.npz"])
            t0 = time.time()
            r = subprocess.run([sys.executable, "-c", code],
                               capture_output=True, text=True, timeout=400)
            process_s = time.time() - t0
            if r.returncode != 0:
                fail(f"{what}: the restoring process failed:\n"
                     f"{r.stderr[-3000:]}")
            info = json.loads(r.stdout.strip().splitlines()[-1])
            got = dict(np.load(files["out.npz"]))
        direct = ddp.make_batched_solver(problem, o, device="cuda")
        with eager_loops():
            want, wall, launches = timed_solve(direct, x0s, u0s, p)
        got = type(want)(**got)
        n = same_solution(what, got, want, info["launches"], launches,
                          ref="direct solve's")
        if not info["second_equal"]:
            fail(f"{what}: a second restored solve differs from the first")
        out[backpass] = dict(
            B=B_MAIN, T=T_MAIN, max_iter=AOT_MAX_ITER, dtype="float32",
            artifact_bytes=len(blob), export_s=export_s,
            load_s=info["load_s"], first_solve_s=info["solve_s"],
            deserialize_s=info["deserialize_s"],
            deserialize_max_s=info["deserialize_max_s"],
            first_calls_s=info["first_calls_s"], programs=info["programs"],
            kernel_load_s=info["kernel_load_s"],
            second_solve_s=info["second_solve_s"], process_s=process_s,
            first_solve_launches_backpass=info["first_launches"]["backpass"],
            direct_solve_s=wall, fields_equal=n,
            **{f"launches_{k}": v for k, v in launches.items()})
    return out


def torch_release() -> None:
    """Give the cached blocks of this process's allocator back to the card
    before a phase whose subprocesses use it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# Phase 19: scripts/try_brachi.py (the JAX package, float64, serial path,
# on the CPU), n=500, printed these gaps to the cycloid at the quarter
# points (x = pi/2, pi, 3 pi/2, 2 pi); the port's script on the card must
# stay within 10x each.
CYCLOID_ERR_JAX_CPU = (0.0016178355419902424, 0.0008701634418981641,
                       0.0003973690754675019, 1.3463790082823834e-09)
EXAMPLES_TIMEOUT_S = 300


def run_example(args) -> tuple[str, float]:
    """A port example script on the card: its stdout and seconds; fails
    unless it exits 0 and reports success."""
    root = Path(__file__).resolve().parent
    t0 = time.time()
    r = subprocess.run([sys.executable, str(root / "scripts" / args[0]),
                        *args[1:], "--device", "cuda"], capture_output=True,
                       text=True, cwd=root, timeout=EXAMPLES_TIMEOUT_S)
    wall = time.time() - t0
    if r.returncode != 0:
        fail(f"examples {args[0]}: exit {r.returncode}:\n"
             f"{r.stderr[-3000:]}")
    if "success: True" not in r.stdout:
        fail(f"examples {args[0]}: no success:\n{r.stdout[-2000:]}")
    return r.stdout, wall


def numbers(stdout: str, label: str) -> list:
    """The numbers on a summary line after its label."""
    import re

    m = re.search(rf"^{re.escape(label)}(.*)$", stdout, re.M)
    if not m:
        fail(f"examples: no {label!r} line:\n{stdout[-2000:]}")
    return [float(v) for v in re.findall(
        r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?", m.group(1))]


def examples() -> dict:
    """Phase 19: the example scripts on the card (the kernel path, float64,
    one instance through ``solve``): ``scripts/try_car_torch.py`` (T=500,
    200 iterations) with its controls inside the boxes |u0| <= 0.5, |u1| <=
    2.0, and ``scripts/try_brachi_torch.py`` (n=500) with its cycloid gaps
    within 10x the JAX script's on the CPU.  Both must exit 0 and report
    success; returns each one's walls and ms per iteration."""
    torch_release()
    out = {}
    car, wall = run_example(("try_car_torch.py", "500", "200"))
    w, _, a, _ = numbers(car, "u in bounds:")
    if not (w <= 0.5 and a <= 2.0):
        fail(f"examples try_car_torch: |u0| {w}, |u1| {a}: outside the box")
    status = numbers(car, "success: True status:")
    out["try_car"] = dict(T=500, max_iter=200, process_s=wall,
                          first_run_s=numbers(car, "compile+run:")[0],
                          run_s=numbers(car, "run:")[0],
                          ms_per_iter=numbers(car, "run:")[1],
                          status=int(status[0]), iterations=int(status[1]),
                          cost=numbers(car, "cost:")[0], u0_max=w, u1_max=a)
    brachi, wall = run_example(("try_brachi_torch.py", "500"))
    errs = numbers(brachi, "cycloid errors at quarter points:")
    if len(errs) != 4 or any(not e <= 10 * ref for e, ref in
                             zip(errs, CYCLOID_ERR_JAX_CPU)):
        fail(f"examples try_brachi_torch: cycloid errors {errs}, more than "
             f"10x {CYCLOID_ERR_JAX_CPU}")
    status = numbers(brachi, "success: True status:")
    out["try_brachi"] = dict(
        n=500, max_iter=50, process_s=wall,
        first_run_s=numbers(brachi, "compile+run:")[0],
        run_s=numbers(brachi, "run:")[0],
        ms_per_iter=numbers(brachi, "run:")[1], status=int(status[0]),
        iterations=int(status[1]), cost=numbers(brachi, "cost:")[0],
        cycloid_errors="/".join(f"{e:.3g}" for e in errs))
    return out


def stats_equal(what, ranks, prefix, want) -> bool:
    """Fail unless every rank's BatchStats equal ``want`` (counts exactly,
    the rest to 1e-6 relative)."""
    for r in ranks:
        for k, v in want._asdict().items():
            got, ref = float(r[f"{prefix}{k}"]), float(v)
            exact = k in ("n_success", "n_instances")
            if (got != ref) if exact else abs(got - ref) > 1e-6 * abs(ref):
                fail(f"{what}: BatchStats.{k} {got} != {ref}")
    return True


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
        from ddp_generator_tpu_torch.models import (
            brachistochrone,
            car_parking,
            cartpole,
        )
    except ImportError as e:
        print(f"the port is not importable from here: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_last = [time.time()]

    def seconds(phase):
        """A line with the seconds since the previous one (or the start)."""
        now = time.time()
        line("phase_seconds", name=phase, s=round(now - t_last[0], 1))
        t_last[0] = now

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

    # 2. build: the hand-written kernels, and those on generated models
    # and new shapes (their spills are reported, not failed)
    global USER_PROBLEMS
    USER_PROBLEMS = user_problems()
    built, libs, models = build_phase()
    line("build", **built)
    for what, d in libs.items():
        line("build_library", what=what, **d)
    if built["spill_store_bytes"]:
        fail(f"the kernels spill {built['spill_store_bytes']} bytes of "
             "registers (ptxas.txt beside the library)")
    seconds("build")

    # 0. emission does not depend on what the process emitted before
    for case, d in emission_history().items():
        line("emission_history", case=case, **d)
    seconds("emission_history")

    problem = car_parking.car_parking()
    alphas = tuple(ddp.SolverOptions().alpha)
    rng = np.random.default_rng(0)

    # 3. B1 against its plain version
    bp32, (p32, r32, m32, w32, out32, lam32, b1_args) = check_backpass(
        problem, B_MAIN, T_MAIN, torch.float32, TOL_B1["float32"], 20, rng)
    line("backpass_f32", **bp32)
    bp64, (p64, r64, m64, w64, out64, lam64, _) = check_backpass(
        problem, 256, T_MAIN, torch.float64, TOL_B1["float64"], 5, rng)
    line("backpass_f64", **bp64)
    # 3b. the emission kernel against the torch emitter on the same
    # rollout; 3c. its two thread mappings at three widths
    em32 = check_emit(problem, B_MAIN, T_MAIN, torch.float32,
                      TOL_EMIT["float32"], 20)
    line("emit_f32", **em32)
    line("emit_f64", **check_emit(problem, B_MAIN, T_MAIN, torch.float64,
                                  TOL_EMIT["float64"], 5))
    for B, d in emit_mappings(problem, 20).items():
        line("emit_mappings", **d)

    # 4. B2 against its plain version
    ro32, b2_args = check_rollout(problem, alphas, p32, r32, m32, w32, out32,
                                  TOL_ROLLOUT["float32"], 20)
    for mode, d in ro32.items():
        line(f"rollout_{mode}_f32", B=B_MAIN, N=T_MAIN, **d)
    ro64, _ = check_rollout(problem, alphas, p64, r64, m64, w64, out64,
                            TOL_ROLLOUT["float64"], 5)
    for mode, d in ro64.items():
        line(f"rollout_{mode}_f64", B=256, N=T_MAIN, **d)

    # 4b/4c. B3 against its plain version: CarParking on phase 3's
    # operands, brachistochrone_hli with every AL term live
    fu32, b3_args = check_fused_model(problem, p32, r32, m32, w32, lam32, 10)
    line("fused_f32", N=T_MAIN, **fu32)
    fu64, _ = check_fused_model(problem, p64, r64, m64, w64, lam64, 3)
    line("fused_f64", N=T_MAIN, **fu64)
    line("fused_brachi_f64", N=N_BRACHI, **check_fused_brachi(5))
    seconds("kernels")

    # 12d. B2 and B3 on CarParking's generated model, on the same operands:
    # against their plain versions and the hand-written model's kernels
    gen_car, gen_brachi_problem = (generated_cases()[k][0] for k in (
        "gen_car_parking", "gen_brachistochrone_hli"))
    gen_ro, gen_fu = generated_kernels_car(
        gen_car, (p32, r32, m32, w32, out32), b3_args, alphas)
    for mode, d in gen_ro.items():
        line("generated_models", kernel=f"rollout_{mode}",
             model="gen_car_parking", B=B_MAIN, N=T_MAIN, **d)
    line("generated_models", kernel="fused", model="gen_car_parking",
         N=T_MAIN, **gen_fu)

    # 12c. the user problems at full width on both paths, first lanes
    # against the CPU; 12d. their kernels against the plain versions
    user = {}
    for name in USER_PROBLEMS:
        for backpass, d in user_solves(name).items():
            ul = d.pop("launches")
            user[(name, backpass)] = ul
            line("generated_models", case=f"{name}_{backpass}_path", **d,
                 **{f"launches_{k}": v for k, v in ul.items()})
        b1, ro, fu = user_kernels(name, alphas, rng)
        user[name] = (b1, ro, fu)
        line("generated_models", kernel="backpass", model=name, **b1)
        for mode, d in ro.items():
            line("generated_models", kernel=f"rollout_{mode}", model=name,
                 **d)
        line("generated_models", kernel="fused", model=name, **fu)
    seconds("generated_kernels_and_user_solves")

    # 4d. B1, B3 and B2 at the compaction widths: the latency floor
    for w, d in widths_phase(b1_args, b3_args, b2_args, 10).items():
        line("widths_f32", B=w, N=T_MAIN, **d)
    del out32, out64, r32, r64, b1_args, b3_args, b2_args
    seconds("widths")

    # 4e. Cartpole's instantiations of B1 (4, 1), B2 and B3 against their
    # plain versions, on its swing-up's initial rollout
    pole = cartpole.cartpole()
    pole_kernels = {}
    for dtype, B, reps in ((torch.float32, B_MAIN, 10),
                           (torch.float64, 256, 3)):
        key = str(dtype).replace("torch.", "")
        b1, (p_, r_, m_, w_, out_, lam_, _) = check_backpass(
            pole, B, T_POLE, dtype, TOL_B1[key], reps, rng,
            inputs=cartpole_inputs)
        line("cartpole_kernels", kernel="backpass", **b1)
        ro, _ = check_rollout(pole, alphas, p_, r_, m_, w_, out_,
                              TOL_ROLLOUT[key], reps)
        for mode, d in ro.items():
            line("cartpole_kernels", kernel=f"rollout_{mode}", B=B,
                 N=T_POLE, dtype=key, **d)
        fu, _ = check_fused_model(pole, p_, r_, m_, w_, lam_, reps)
        line("cartpole_kernels", kernel="fused", N=T_POLE, dtype=key, **fu)
        pole_kernels[key] = dict(ro, fused=fu)
        del p_, r_, m_, w_, out_, lam_
    seconds("cartpole_kernels")

    # 5. per-lane checks, kernels on the GPU vs plain on the CPU
    line("per_lane", **per_lane_check(problem))
    line("per_lane_fused", **per_lane_check(problem, "fused"))
    line("per_lane_fused_brachi", **per_lane_brachi())
    # 5b. the serial path (default options), GPU vs CPU; inline retries
    car, pole_lanes, pole_cpu = per_lane_serial()
    line("per_lane_serial", model="car_parking", **car)
    line("per_lane_serial", model="cartpole", **pole_lanes)
    line("per_lane_serial", model="car_parking", path="kernel_inline",
         **per_lane_inline())
    # 5d. per-lane params (batch_params=True), GPU vs CPU
    for what, d in batch_params_per_lane().items():
        line("batch_params_per_lane", case=what, **d)
    seconds("per_lane")

    # 6. the main path: emission + B1, B2
    stats, main_sol = main_path(problem)
    launches = dict(stats["launches"])
    stats.pop("launches")
    line("main_path", **stats, **{f"launches_{k}": v
                                  for k, v in launches.items()})
    seconds("main_path")

    # 6b. graphed against eager, both paths; 6c. the two emitters
    for backpass, d in graphs_phase(problem).items():
        line("graphs", path=backpass, **d)
    line("emitters", **emitter_launches(problem))
    seconds("graphs_and_emitters")
    # 6d. the serial, per-lane and parallel routes, graphed against eager
    for route, d in graphs_routes_phase(problem).items():
        line("graphs", path=route, **d)
    seconds("graphs_routes")

    # 7. the fused path at full width: B3, B2
    fstats, fused_sol = main_path(problem, "fused")
    flaunches = dict(fstats["launches"])
    fstats.pop("launches")
    line("fused_path", **fstats, **{f"launches_{k}": v
                                    for k, v in flaunches.items()})
    seconds("fused_path")

    # 6e. the device loops: make_batched_solver as one graph with a WHILE
    # node, on both paths against the graphed StepwiseSolver solves above;
    # solve() on testCar; the inline and Newton routes graphed
    for case, d in device_loops_phase(
            problem, {"kernel": (main_sol, launches),
                      "fused": (fused_sol, flaunches)}).items():
        line("device_loops", case=case, **d)
    seconds("device_loops")

    # 7b. the pipelined solve: both paths with pipeline_depth=4 against
    # the depth-1 solves above, every Solution field and launch count
    for backpass, ref_sol, ref_stats, ref_launches in (
            ("kernel", main_sol, stats, launches),
            ("fused", fused_sol, fstats, flaunches)):
        dstats, dsol = main_path(problem, backpass, depth=4)
        n = same_solution(f"pipelined {backpass} path", dsol, ref_sol,
                          dstats.pop("launches"), ref_launches,
                          ref="depth-1 solve's")
        line("pipelined", path=backpass, depth=4, fields_equal=n,
             wall_s=dstats["wall_s"], depth1_wall_s=ref_stats["wall_s"],
             replays=dstats["replays"], depth1_replays=ref_stats["replays"],
             host_reads=dstats["host_reads"],
             depth1_host_reads=ref_stats["host_reads"])
    f32_counts = {k: types.SimpleNamespace(status=v.status,
                                           iterations=v.iterations)
                  for k, v in (("kernel", main_sol), ("fused", fused_sol))}
    seconds("pipelined")

    # 16. the main path as two ranks sharing the card (the batch mesh over
    # torch.distributed), both paths, against the single-process solves;
    # testBrachi through make_sharded_solver
    for path, d in mesh_phase(problem, {"kernel": (main_sol, stats),
                                        "fused": (fused_sol, fstats)}
                              ).items():
        line("mesh", path=path, **d)
    seconds("mesh")

    # 17. the main path's and the fused path's configurations exported,
    # restored in a process without the problem's module, and solved
    for path, d in aot_phase(problem).items():
        line("aot", path=path, **d)
    seconds("aot")

    # 8. brachistochrone_hli at full width: B3, B2 with the AL families
    bstats, brachi_sol = brachi_path(brachistochrone.brachistochrone_hli())
    blaunches = bstats.pop("launches")
    line("brachi_path", **bstats, **{f"launches_{k}": v
                                     for k, v in blaunches.items()})
    seconds("brachi_path")

    # 12a. generated models: the main path's and the fused path's
    # solves with CarParking's hand-written model stripped: B2 and B3 run
    # the model generated from its torch functions; every Solution field
    # and every launch count as the hand-written runs'
    gen_launches = {}
    for backpass, ref_sol, ref_launches in (
            ("kernel", main_sol, launches), ("fused", fused_sol, flaunches)):
        gstats, gsol = main_path(gen_car, backpass)
        glaunches = gstats.pop("launches")
        n = same_solution(f"generated car_parking {backpass} path", gsol,
                          ref_sol, glaunches, ref_launches)
        gen_launches[backpass] = glaunches
        line("generated_models", case=f"car_parking_{backpass}_path",
             fields_equal=n, **gstats,
             **{f"launches_{k}": v for k, v in glaunches.items()})
    del main_sol, fused_sol
    # 12b. brachistochrone_hli (n=500, B=2048, float64, fused path) on its
    # generated model: the [k]-indexed tail and the AL families
    gstats, gsol = brachi_path(gen_brachi_problem)
    glaunches = gstats.pop("launches")
    n = same_solution("generated brachistochrone_hli", gsol, brachi_sol,
                      glaunches, blaunches)
    line("generated_models", case="brachistochrone_hli_fused_path",
         fields_equal=n, **gstats,
         **{f"launches_{k}": v for k, v in glaunches.items()})
    del brachi_sol, gsol
    seconds("generated_solves")

    # 9. the serial path against the kernel path at full width, 3 deep
    line("serial_vs_kernel", **serial_vs_kernel(problem))
    seconds("serial_vs_kernel")

    # 10. the Cartpole swing-up at full width: serial float64 (cut to
    # max_iter 20, its first lanes against the CPU), then B3 + B2 in float32
    for serial in (True, False):
        cstats = cartpole_path(serial, pole_cpu)
        claunches = cstats.pop("launches")
        line("cartpole_path", path="serial" if serial else "fused",
             **cstats, **{f"launches_{k}": v for k, v in claunches.items()})
    seconds("cartpole_path")

    # 11. per-lane params at full width: the emission kernel's and B2's
    # per-lane launches against their plain versions, then the solve
    # (emission, B1 and B2, every launch with the lanes' params)
    for what, d in batch_params_kernels(problem, alphas).items():
        line("batch_params_kernels", part=what, **d)
    pstats = batch_params_path(problem)
    plaunches = pstats.pop("launches")
    line("batch_params_path", **pstats, **{f"launches_{k}": v
                                           for k, v in plaunches.items()})
    seconds("batch_params_path")

    # 13. the parallel path: the associative-scan backward pass against
    # the serial one on a nominal bundle, the full-width solves through it
    # and B2, and the long single horizon
    nominal, par_b2 = parallel_nominal(alphas)
    for name, d in nominal.items():
        line("parallel_path", part="nominal", case=name, **d)
        for mode, r in par_b2[name].items():
            line("parallel_path", part="kernels", case=name,
                 kernel=f"rollout_{mode}", B=B_MAIN, dtype="float64", **r)
    par_solves = parallel_solves()
    for name, d in par_solves.items():
        line("parallel_path", part="solve", case=name, **d)
    for N, d in parallel_long_horizon().items():
        line("parallel_path", part="long_horizon", B=1, N=N, **d)
    seconds("parallel_path")

    # 14. the auxiliary API on the card; 15. float64 fused against kernel
    line("aux_api", **aux_api(problem))
    line("fused_vs_kernel", B=B_MAIN, T=T_MAIN,
         **fused_vs_kernel_f64(problem, f32_counts))
    seconds("aux_api_and_fused_vs_kernel")

    # 19. the example scripts on the card
    for script, d in examples().items():
        line("examples", script=script, **d)
    seconds("examples")

    def entry(name, source, replaces, n, d, model="car_parking"):
        # no single PyTorch call computes any of these: library_ms is null
        return dict(name=name, model=model, route="cuda",
                    source=f"ddp_generator_tpu_torch/csrc/{source}",
                    replaces=f"ddp_generator_tpu/ops/{replaces}", launches=n,
                    max_abs_err=d["max_abs_err"], ms=d["ms"],
                    plain_ms=d["plain_ms"], bound_ms=d["bound_ms"],
                    bound_by=d["bound_by"], library_ms=None,
                    registers=d["registers"], local_bytes=d["local_bytes"])

    kernels = [entry("backpass", "backpass.cu", "pallas_backpass.py:682",
                     launches["backpass"], bp32)]
    # no Pallas kernel emits the bundle: the JAX package's emission is
    # plain XLA, the row's plain version the port's torch emitter
    kernels.append(dict(entry("emit", "emit.cu", "cm_derivs.py:65",
                              launches["emit"], em32),
                        plain="ddp_generator_tpu_torch/ops/cm_derivs.py"))
    for mode in ("multi", "selected"):
        kernels.append(entry(f"rollout_{mode}", "rollout.cu",
                             "pallas_rollout.py:424",
                             launches[f"rollout_{mode}"], ro32[mode]))
    kernels.append(entry("fused", "fused.cu", "pallas_fused.py:715",
                         flaunches["fused"], fu32))
    # Cartpole's instantiations, with their launches on the fused
    # cartpole_path (the last solve above)
    for mode in ("multi", "selected"):
        kernels.append(entry(f"rollout_{mode}", "rollout.cu",
                             "pallas_rollout.py:424",
                             claunches[f"rollout_{mode}"],
                             pole_kernels["float32"][mode], "cartpole"))
    kernels.append(entry("fused", "fused.cu", "pallas_fused.py:715",
                         claunches["fused"],
                         pole_kernels["float32"]["fused"], "cartpole"))
    # the instantiations on generated models and new shapes, with their
    # launches on their own solves (phase 12)
    for mode in ("multi", "selected"):
        kernels.append(entry(f"rollout_{mode}", "generated/rollout.cu",
                             "pallas_rollout.py:424",
                             gen_launches["kernel"][f"rollout_{mode}"],
                             gen_ro[mode], "gen_car_parking"))
    kernels.append(entry("fused", "generated/fused.cu", "pallas_fused.py:715",
                         gen_launches["fused"]["fused"], gen_fu,
                         "gen_car_parking"))
    for name in USER_PROBLEMS:
        b1, ro, fu = user[name]
        kernels.append(entry("backpass", "generated/backpass.cu",
                             "pallas_backpass.py:682",
                             user[(name, "kernel")]["backpass"], b1, name))
        for mode in ("multi", "selected"):
            kernels.append(entry(f"rollout_{mode}", "generated/rollout.cu",
                                 "pallas_rollout.py:424",
                                 user[(name, "kernel")][f"rollout_{mode}"],
                                 ro[mode], name))
        kernels.append(entry("fused", "generated/fused.cu",
                             "pallas_fused.py:715",
                             user[(name, "fused")]["fused"], fu, name))
    # B2 on the parallel path's models (float64, B=2048), with their
    # launches on its solves (phase 13b); a mode those solves never
    # launched (the sweep, where every lane accepts alpha[0]) is checked
    # above and has no row
    for name, source in (("brachistochrone", "rollout.cu"),
                         ("point_mass3_free", "generated/rollout.cu")):
        for mode in ("multi", "selected"):
            n = par_solves[name][f"launches_rollout_{mode}"]
            if n > 0:
                kernels.append(entry(f"rollout_{mode}", source,
                                     "pallas_rollout.py:424", n,
                                     par_b2[name][mode], name))
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
