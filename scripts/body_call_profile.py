"""Where a full-width body call of the port's CarParking solve spends its
time, on one CUDA card.

    python3 scripts/body_call_profile.py
        [--paths kernel,fused,serial,per_lane] [--calls 10]
        [--dtype float32] [--root DIR] [--history]

For each path (``"kernel"``: emission + kernel B1; ``"fused"``: kernel
B3; ``"serial"``: the step-major bundle and the backward pass of
``ops/backpass.py``, with the serial line search; ``"per_lane"``:
per-lane params, ``limW`` from +-0.2 to +-0.5 over the lanes as
``chip_smoke.py``'s, on the kernel path, so emission + B1 and the serial
line search) it builds the solver's parts for ``bench.py``'s workload
(CarParking, B=2048, T=500, ``chip_smoke.py``'s inputs and options,
float32 unless ``--dtype``), runs the initial rollout and 3 warm-up body
calls, then
``--calls`` body calls, each timed on the host clock between two
``torch.cuda.synchronize()``; on the same carries it times the stages of a
body call alone: the derivatives and backward pass, and the line search
(staged on kernels B2, or serial).  "Rest" is the body call less both.  Then
``torch.profiler`` traces ``--calls`` more body calls: device busy share
is the device time of all kernels over the wall time, and the device
events and the launches of each hand-written kernel per body call are
counted (B2: the sweep and the selected rollouts; a staged line search
launches three, of which those its stage flags skip count none).  Then it
captures the solver's body call (the masked step on a static carry,
``solver._WidthBody``) as a CUDA graph and times and traces ``--calls``
replays the same way (``graph_*`` keys), with the capture's seconds
(warm-up calls included) and the graph's node count (``graph_nodes``:
the same body call captured once more with the graph kept, its nodes
counted by ``libcuda``'s ``cuGraphGetNodes``).  On the
kernel path it also traces derivative emission alone, once with each
``derivs_emitter`` (``emit_*`` keys: device kernels and device ms of one
emission, and its host ms).  Prints one line per path; imports no JAX.

``--root`` names the checkout whose ``ddp_generator_tpu_torch`` is
imported (default: this tree; ``chip_smoke.py``'s helpers always come from
this tree), so an older tree can be profiled by the same code.
``--history`` first runs ``chip_smoke.emission_history`` on that package
and prints whether each emission came out bit for bit equal after another
problem's emission (one line, ``emission_history``), without failing.
"""

from __future__ import annotations

import argparse
import importlib.util
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profile_path(path: str, calls: int, dtype: str) -> dict:
    import numpy as np
    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch import solver as slv
    from ddp_generator_tpu_torch.launches import read_launches, reset_launches
    from ddp_generator_tpu_torch.models import car_parking
    from ddp_generator_tpu_torch.ops.cm_derivs import (
        cm_back_pass_from_bundle,
        cm_emit,
    )
    from ddp_generator_tpu_torch.ops.cuda_fused import fused_derivs_back_pass
    from ddp_generator_tpu_torch.ops.cuda_rollout import (
        kernel_line_search_staged,
    )
    from ddp_generator_tpu_torch.ops.linesearch import line_search

    problem = car_parking.car_parking()
    per_lane = path == "per_lane"
    backpass = "kernel" if per_lane else path
    serial = backpass == "serial"
    serial_ls = serial or per_lane
    o = ddp.SolverOptions(max_iter=cs.MAX_ITER_MAIN, dtype=dtype,
                          tolFun=1e-5 if dtype == "float32" else 1e-7,
                          debug_level=0, backpass_method=backpass,
                          linesearch_method="serial" if serial else "kernel")
    init_fn, body_fn, _, cast = slv._make_parts(problem, o, "cuda", per_lane)
    np_dtype = np.float32 if dtype == "float32" else np.float64
    p_np, x0s, u0s = cs.bench_inputs(cs.B_MAIN, cs.T_MAIN, np_dtype)
    if per_lane:
        p_np, _ = cs.car_limw_per_lane(p_np, cs.B_MAIN)
    p = cast(ddp.params_from_jax(p_np, getattr(torch, dtype), "cuda"),
             cs.B_MAIN)
    c = init_fn(torch.as_tensor(x0s, device="cuda"),
                torch.as_tensor(u0s, device="cuda"), p)
    alphas = tuple(float(a) for a in o.alpha)

    def bp_stage(c):
        m = c.mult
        if serial:
            d = ddp.batched_calc_derivs(
                problem, c.xs, c.us, p, m.mu_le, m.mu_li, m.mu_fe, m.mu_fi,
                c.w_pen_l, c.w_pen_f, o.full_ddp)
            return ddp.back_pass(d, c.us, c.lam, o.regType, o.full_ddp,
                                 slv._boxqp_hyper(o))
        if backpass == "fused":
            return fused_derivs_back_pass(
                problem, c.xs, c.us, m.mu_le, m.mu_li, m.mu_fe, m.mu_fi,
                c.w_pen_l, c.w_pen_f, c.lam, p, o.regType, o.full_ddp)[0]
        sd, fcx, fcxx, us_cm, _ = cm_emit(
            problem, c.xs, c.us, m.mu_le, m.mu_li, m.mu_fe, m.mu_fi,
            c.w_pen_l, c.w_pen_f, p, o.full_ddp)
        return cm_back_pass_from_bundle(sd, fcx, fcxx, us_cm, c.lam,
                                        problem.n_x, o.regType, o.full_ddp)

    def ls_stage(c, bp):
        m = c.mult
        if serial_ls:
            return line_search(
                problem, alphas, c.xs[:, 0], c.xs, c.us, bp.l, bp.L, bp.dV,
                c.cost, o.zMin, p, m.mu_le, m.mu_li, m.mu_fe, m.mu_fi,
                c.w_pen_l, c.w_pen_f)
        return kernel_line_search_staged(
            problem, alphas, c.xs[:, 0], c.xs, c.us, bp.l, bp.L, bp.dV,
            c.cost, o.zMin, p, m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, c.w_pen_l,
            c.w_pen_f, alive=~c.done)

    for _ in range(3):
        c = body_fn(c, p)
    body, bps, lss = [], [], []
    for _ in range(calls):
        bp, t_bp = timed(lambda: bp_stage(c))
        _, t_ls = timed(lambda: ls_stage(c, bp))
        c, t_body = timed(lambda: body_fn(c, p))
        body.append(t_body)
        bps.append(t_bp)
        lss.append(t_ls)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            c = body_fn(c, p)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {f"{k}_launches_per_call": v / calls
                for k, v in read_launches().items()}
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.device_time_total for e in dev) / 1e3
    med = statistics.median
    out = dict(path=path, dtype=dtype, calls=calls, body_ms=med(body),
               bp_ms=med(bps), ls_ms=med(lss),
               rest_ms=med(body) - med(bps) - med(lss),
               body_ms_all=[round(v, 3) for v in body],
               profiled_wall_ms=wall_ms, device_busy_pct=100 * busy_ms
               / wall_ms, device_events_per_call=len(dev) / calls,
               **launches)
    if backpass == "kernel":
        for shared in (False, True):
            name = "shared" if shared else "per_family"

            def emit():
                m = c.mult
                return cm_emit(problem, c.xs, c.us, m.mu_le, m.mu_li,
                               m.mu_fe, m.mu_fi, c.w_pen_l, c.w_pen_f, p,
                               o.full_ddp, shared)

            emit()
            host = statistics.median(timed(emit)[1] for _ in range(calls))
            _, events, dev_ms = cs.profiled(emit)
            out.update({f"emit_{name}_device_events": events,
                        f"emit_{name}_device_ms": dev_ms,
                        f"emit_{name}_host_ms": host})
    out.update(profile_graphed(slv, o, body_fn, c, p, calls, acts))
    return out


def profile_graphed(slv, o, body_fn, c, p, calls, acts) -> dict:
    """The body call as the solver replays it: captured once (after its
    warm-up calls), then ``calls`` replays timed alone and ``calls`` more
    under ``torch.profiler``."""
    import torch

    from ddp_generator_tpu_torch.launches import read_launches, reset_launches

    t0 = time.perf_counter()
    w = slv._WidthBody(slv._masked(body_fn, o.max_iter), c, p, o.max_iter,
                       graph=True)
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    nodes = graph_nodes(w)
    body = [timed(w.run)[1] for _ in range(calls)]
    reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            w.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.device_time_total for e in dev) / 1e3
    return dict(graph_capture_ms=capture_ms, graph_nodes=nodes,
                graph_body_ms=statistics.median(body),
                graph_body_ms_all=[round(v, 3) for v in body],
                graph_profiled_wall_ms=wall_ms,
                graph_device_busy_pct=100 * busy_ms / wall_ms,
                graph_device_events_per_call=len(dev) / calls,
                **{f"graph_{k}_launches_per_call": v / calls
                   for k, v in read_launches().items()})


def graph_nodes(w):
    """The node count of the width's body call captured once more into a
    graph that torch keeps (``CUDAGraph(keep_graph=True)``, never
    instantiated), from ``libcuda``'s ``cuGraphGetNodes``; "not
    measured" where this torch cannot keep the graph."""
    import ctypes

    import torch

    try:
        g = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError as e:
        return f"not measured ({e})"
    with torch.cuda.graph(g):
        w._call()
    torch.cuda.synchronize()
    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t)]
    get_nodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = get_nodes(g.raw_cuda_graph(), None, ctypes.byref(n))
    del g
    return int(n.value) if rc == 0 else f"not measured (CUresult {rc})"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", default="kernel,fused")
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--history", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import ddp_generator_tpu_torch

    cs.line("package", root=Path(ddp_generator_tpu_torch.__file__).parent)
    if args.history:
        for case, d in cs.emission_history(strict=False).items():
            cs.line("emission_history", case=case, **d)
    for path in args.paths.split(","):
        cs.line("body_call", **profile_path(path, args.calls, args.dtype))
    return 0


if __name__ == "__main__":
    sys.exit(main())
