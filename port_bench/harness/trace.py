"""The traced window: ``torch.profiler`` (CPU and CUDA activities) over a
few whole solves, read from its Chrome trace.

From the trace: every device operation (kernels, copies, sets) with its
start, length, name and, for kernels, its grid; the busy time, the union of
those intervals within the traced window; the longest idle gaps, each named
by the innermost host event running at its middle; and the device time per
kernel name.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


@dataclass
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    kernel: bool
    grid: tuple = ()


@dataclass
class Trace:
    window_s: float
    ops: list = field(default_factory=list)  # DeviceOp, in start order
    host: list = field(default_factory=list)  # (start_us, end_us, name)
    t0_us: float = 0.0  # the traced window, in the trace's clock
    t1_us: float = 0.0

    def kernels(self):
        return [o for o in self.ops if o.kernel]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran, in the window."""
        busy, end = 0.0, self.t0_us
        for o in self.ops:
            a = max(o.start_us, end, self.t0_us)
            b = min(o.start_us + o.dur_us, self.t1_us)
            if b > a:
                busy += b - a
            end = max(end, o.start_us + o.dur_us)
        return busy * 1e-6

    def gaps(self):
        """``[(start_us, length_us)]``: the device's idle intervals in the
        window."""
        out, end = [], self.t0_us
        for o in self.ops:
            if o.start_us > end:
                out.append((end, o.start_us - end))
            end = max(end, o.start_us + o.dur_us)
        if self.t1_us > end:
            out.append((end, self.t1_us - end))
        return out

    def host_at(self, t_us: float) -> str:
        """The innermost host event running at ``t_us`` (the latest to
        start), or ``host: none``."""
        best = None
        for a, b, name in self.host:
            if a <= t_us <= b and (best is None or a >= best[0]):
                best = (a, name)
        return "host: none" if best is None else f"host: {best[1]}"

    def breakdown(self, n: int = 10) -> dict:
        by_name: dict = {}
        for o in self.ops:
            key = short_name(o.name)
            by_name[key] = by_name.get(key, 0.0) + o.dur_us * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[self.host_at(a + d / 2), d * 1e-6]
                              for a, d in gaps]}


def short_name(name: str) -> str:
    """A kernel name without its return type, anonymous namespaces and
    argument list."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    depth, out = 0, []
    for ch in name:  # cut at the argument list's '(' outside templates
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        out.append(ch)
    return "".join(out)[:120]


def parse(events: list) -> Trace:
    """A :class:`Trace` from Chrome trace events, its window the span of
    the device operations."""
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            grid = tuple((e.get("args") or {}).get("grid", ()))
            ops.append(DeviceOp(e.get("name", ""), ts, dur, cat == "kernel",
                                grid))
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e.get("name", "")))
    ops.sort(key=lambda o: o.start_us)
    t0 = ops[0].start_us if ops else 0.0
    t1 = max((o.start_us + o.dur_us for o in ops), default=t0)
    return Trace(window_s=(t1 - t0) * 1e-6, ops=ops, host=host, t0_us=t0,
                 t1_us=t1)


class Profiler:
    """``start()`` / ``stop()`` around the traced solve; ``read()`` the
    :class:`Trace` (the Chrome trace goes through a temporary file)."""

    def __init__(self):
        import torch

        act = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])

    def start(self):
        self._prof.__enter__()

    def stop(self):
        self._prof.__exit__(None, None, None)

    def read(self) -> Trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as fh:
                data = json.load(fh)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return window_of(events)


SPAN = "port_bench.solve"  # the span the harness puts around each solve


def window_of(events: list) -> Trace:
    """The traced window: from the start of the first :data:`SPAN` to the
    end of the last (each solve ends in a synchronize, so its device work
    lies inside its span); ``window_s`` is that length."""
    tr = parse(events)
    spans = [(a, b) for a, b, name in tr.host if name == SPAN]
    if spans:
        tr.t0_us = min(a for a, _ in spans)
        tr.t1_us = max(b for _, b in spans)
        tr.window_s = (tr.t1_us - tr.t0_us) * 1e-6
    return tr
