"""One run of one cell: set-up, the measured window (or the traced one),
the check against the plain reference, and the result's line.

Traffic is a closed loop: one client sends its next solve when the last
has returned (ended in a device synchronize).  The window starts solves
until ``seconds`` have passed since its start; it ends with the last
solve's end, and every solve started in it counts.

Two entry points, named by the traffic file's ``"entry"``:

* ``"stepwise"``: ``StepwiseSolver(problem, options, **cfg["stepwise"])``
  called on a batch of ``"batch"`` lanes; set-up captures every width's
  graph (``precompile``);
* ``"solve"``: ``ddp_generator_tpu_torch.solve(problem, x0, u0, params,
  options, device=...)`` on one instance; set-up is the first call, which
  captures the whole solve's graph (and replays it once).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import math
import sys
import time
from dataclasses import dataclass, field

from . import control, faults, inputs, roofline
from .trace import SPAN, Profiler

# status codes that are errors: non-finite derivatives, non-finite
# initial rollout (a lane that used up max_iter, 7, is only not solved)
ERROR_STATUS = (5, 6)
KEEP = ("xs", "us", "cost", "status", "body_calls")  # outputs judged


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclass
class SolveRecord:
    wall_s: float
    lanes: int
    traced: bool  # the first solve of a --trace 1 run
    loop_body_calls: int = 0  # StepwiseSolver: body calls (replays)
    replays: int = 0
    host_reads: int = 0
    out: dict = field(default_factory=dict)  # the judged outputs, on the host
    counts: object = None  # (solved, failed) over all lanes, on the device


@dataclass
class Run:
    """What a metric's reader gets."""

    cfg: dict
    counts: dict
    shape: roofline.Shape
    batch: int
    setup_total: float
    solves: list
    window_s: float
    trace: object = None  # trace.Trace of the traced (first) solve
    launches: dict = None  # launches that did work in the traced solve
    solved: int = 0
    trips: list = field(default_factory=list)  # each solve's device trips


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(base.get(k, {}), v) if isinstance(v, dict) else v
    return out


class _Stepwise:
    def __init__(self, ddp, problem, options, cfg, p, device):
        self.solver = ddp.StepwiseSolver(problem, options, device=device,
                                         **cfg.get("stepwise", {}))
        self.p = p

    def setup(self, x0s, u0s) -> None:
        self.solver.precompile(x0s, u0s, self.p)

    def __call__(self, x0s, u0s):
        sol = self.solver(x0s, u0s, self.p)
        return sol, self.solver.last_stats


class _Solve:
    def __init__(self, ddp, problem, options, cfg, p, device):
        self.ddp, self.problem, self.options = ddp, problem, options
        self.p, self.device = p, device

    def setup(self, x0s, u0s) -> None:
        self(x0s, u0s)

    def __call__(self, x0s, u0s):
        sol = self.ddp.solve(self.problem, x0s[0], u0s[0], self.p,
                             self.options, device=self.device)
        return type(sol)(*(t[None] for t in sol)), None


ENTRIES = {"stepwise": _Stepwise, "solve": _Solve}


@dataclass
class _Setup:
    torch: object
    dev: object
    on_card: bool
    entry: object
    options: object
    params: dict  # float64 numpy, by name
    x0s: object
    pool: object
    batch: int

    def sync(self):
        if self.on_card:
            self.torch.cuda.synchronize(self.dev)


def _set_up(cfg, traffic, seed, device) -> _Setup:
    """Imports, CUDA start, the kernel library, the problem and the input
    pool, and the entry's own set-up; logs each one's seconds."""
    split = {}
    t = time.time()
    import torch

    import ddp_generator_tpu_torch as ddp
    split["imports"] = time.time() - t
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t = time.time()
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    split["cuda_start"] = time.time() - t
    t = time.time()
    library = "not used"
    if on_card:
        from ddp_generator_tpu_torch import _build

        lib = _build.BUILD_ROOT / _build.source_hash() / _build.LIB_NAME
        library = "found" if lib.exists() else "built now"
        _build.load_library()
    split["library"] = time.time() - t

    t = time.time()
    mod = importlib.import_module(
        f"ddp_generator_tpu_torch.models.{cfg['problem']['module']}")
    problem = getattr(mod, cfg["problem"]["factory"])()
    options = ddp.options_from_dict(cfg["options"])
    dtype = inputs.DTYPES[cfg["dtype"]]
    params = inputs.params(cfg)
    p = {k: torch.as_tensor(v, dtype=dtype, device=dev)
         for k, v in params.items()}
    batch = int(traffic["batch"])
    x0s, pool = inputs.pool(cfg, traffic, seed, dev, int(cfg["T"]), batch)
    s = _Setup(torch, dev, on_card, None, options, params, x0s, pool, batch)
    s.sync()
    split["inputs"] = time.time() - t

    t = time.time()
    s.entry = ENTRIES[traffic["entry"]](ddp, problem, options, cfg, p, dev)
    s.entry.setup(x0s, pool[0])
    s.sync()
    split["precompile"] = time.time() - t
    log("setup: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f" s (library {library})")
    return s


def _window(s: _Setup, seconds: float, trace: bool):
    """The solves of the window, its length, and with ``trace`` the trace of
    its first solve and the launches that did work in it."""
    from ddp_generator_tpu_torch import launches

    torch = s.torch
    prof = Profiler() if trace and s.on_card else None
    if trace:
        launches.reset_launches()
    solves, work = [], None
    t0 = time.perf_counter()
    while True:
        traced = trace and not solves
        if prof is not None and traced:
            prof.start()
        ts = time.perf_counter()
        with torch.profiler.record_function(SPAN):
            sol, stats = s.entry(s.x0s, s.pool[len(solves) % len(s.pool)])
            s.sync()
        te = time.perf_counter()
        rec = SolveRecord(wall_s=te - ts, lanes=s.batch, traced=traced,
                          out={k: getattr(sol, k).cpu() for k in KEEP},
                          counts=_counts(torch, sol))
        if stats is not None:
            rec.loop_body_calls = stats.body_calls
            rec.replays, rec.host_reads = stats.replays, stats.host_reads
        solves.append(rec)
        if traced:
            if prof is not None:
                prof.stop()
            work = launches.read_launches()
        if te - t0 >= seconds:
            break
    log(f"window: {len(solves)} solves in {te - t0:.3f} s; solve walls "
        + " ".join(f"{r.wall_s:.3f}" for r in solves))
    trace = None
    if prof is not None:
        t = time.time()
        trace = prof.read()
        log(f"trace: {len(trace.ops)} device operations read in "
            f"{time.time() - t:.3f} s")
    return solves, te - t0, trace, work


def _counts(torch, sol):
    """``[solved, failed]`` lanes of a solve, on the device: status 1 or 2;
    an error status or a non-finite output."""
    finite = (torch.isfinite(sol.xs).flatten(1).all(1)
              & torch.isfinite(sol.us).flatten(1).all(1)
              & torch.isfinite(sol.cost))
    st = sol.status
    error = (st == ERROR_STATUS[0]) | (st == ERROR_STATUS[1])
    return torch.stack([((st == 1) | (st == 2)).sum(),
                        (~finite | error).sum()])


def _check(ref, cfg, s: _Setup, out: dict, limits: dict, mode):
    """The reference's numbers of the window's lanes against their limits:
    ``(correct, checks, per-lane values)``."""
    torch = s.torch
    case = {"p": {k: torch.as_tensor(v, dtype=torch.float64, device=s.dev)
                  for k, v in s.params.items()},
            "x0": s.x0s[:1].double().expand(out["us"].shape[0], -1)}
    if mode == "control":
        out = control.transform(cfg, ref, case, out)
    lanes = ref.per_lane(case, out)
    numbers = ref.numbers(case, out, lanes)
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"limits name numbers the reference does not give: "
                       f"{sorted(missing)}")
    checks, correct = {}, True
    for name, value in numbers.items():
        limit = float(limits[name])
        correct = correct and math.isfinite(value) and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return correct, checks, lanes


def run_cell(spec, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, overrides: dict = None,
             mode: str = None) -> dict:
    """Run ``workload`` and return the result's line (a dict).
    ``overrides`` (tests) merge into the configuration (``"config"``) and
    the traffic (``"traffic"``).  With a ``mode`` (the check's own tests
    and ``calibrate.py``) it returns the check alone (``correct``,
    ``failed``, ``checks``, ``run``, ``lanes``: quantiles of each number's
    per-lane values): ``"sound"`` of the program as it is, ``"control"``
    of the configuration's lower-precision control in the program's
    place, a name of :data:`.faults.FAULTS` of the program with that fault
    planted."""
    overrides = overrides or {}
    cell = spec.workload(workload)
    cfg = merge(spec.config(cell["config"]), overrides.get("config"))
    traffic = merge(spec.traffic(cell["traffic"]), overrides.get("traffic"))
    planted = (faults.planted(mode) if mode in faults.FAULTS
               else contextlib.nullcontext())
    with planted:
        s = _set_up(cfg, traffic, seed, device)
        setup_total = time.time() - t_start
        solves, window_s, tr, work = _window(s, seconds, trace)
    torch = s.torch
    peak = torch.cuda.max_memory_allocated(s.dev) if s.on_card else 0
    s.entry = None  # the program's state goes before the reference runs
    gc.collect()
    if s.on_card:
        torch.cuda.empty_cache()

    t = time.time()
    out = {k: torch.cat([r.out[k] for r in solves]).to(s.dev) for k in KEEP}
    ref = spec.reference(cfg["reference"])
    correct, checks, lanes = _check(
        ref, cfg, s, out, spec.limits(workload)["limits"], mode)
    solved, failed = (int(v) for v in torch.stack(
        [r.counts for r in solves]).sum(0))
    correct = correct and failed == 0
    n_lanes = sum(r.lanes for r in solves)
    log(f"check: {time.time() - t:.3f} s over {n_lanes} lanes, "
        f"{failed} failed")
    run = Run(cfg=cfg, counts=spec.counts(cell["config"]),
              shape=roofline.Shape(cfg, len(s.options.alpha)),
              batch=s.batch, setup_total=setup_total, solves=solves,
              window_s=window_s, trace=tr, launches=work, solved=solved,
              trips=[int(r.out["body_calls"].max()) for r in solves])
    if mode is not None:
        from reference.common import quantiles

        return {"correct": correct, "failed": failed, "checks": checks,
                "run": run,
                "lanes": {k: quantiles(v) for k, v in lanes.items()}}

    metrics = {}
    for m in spec.metrics_for(workload, trace):
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(s.dev) if s.on_card else "cpu"
    device_rec = {"platform": "gpu" if s.on_card else "cpu", "kind": kind,
                  "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": n_lanes, "failed": failed,
            "metrics": metrics, "device": device_rec}
    if tr is not None:
        device_rec["busy_s"] = tr.busy_s()
        device_rec["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown()
    line["checks"] = checks
    return line
