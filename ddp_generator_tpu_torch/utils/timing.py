"""Timing and profiling helpers (``ddp_generator_tpu.utils.timing``).

The reference's only instrumentation is a ``clock()`` around the whole
solve ("Time for iLQG", ``iLQG_mex.c:123-126``).  Here:

* :func:`device_sync`: wait for the CUDA devices a tree of tensors lives
  on (``torch.cuda.synchronize``; a no-op for CPU tensors), since a CUDA
  call returns before the device finishes;
* :class:`Timer`: host wall clock around a block, synced on exit;
* :func:`trace`: a ``torch.profiler`` trace around a block;
* :func:`bench_fn`: min-of-N wall time of a callable, synced.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any

import torch


def _devices(tree: Any, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _devices(v, out)
    return out


def device_sync(tree: Any) -> None:
    """Wait until every CUDA device holding a tensor of ``tree`` (nested
    NamedTuples, tuples, lists, dicts) has finished its queued work."""
    for dev in _devices(tree, set()):
        torch.cuda.synchronize(dev)


class Timer:
    """``with Timer("solve", sync=out) as t: ... ; t.seconds``; ``sync``
    (a tree of tensors) is synced before the clock stops."""

    def __init__(self, name: str = "", sync: Any = None):
        self.name = name
        self._sync = sync
        self.seconds = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            device_sync(self._sync)
        self.seconds = time.perf_counter() - self._t0
        return False


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """A ``torch.profiler`` trace around a block, CPU and (where there is
    one) CUDA activity; yields the profiler (``key_averages()``).  With
    ``log_dir`` the Chrome trace is written to ``log_dir/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def bench_fn(fn, *args, repeats: int = 3, sync_out: bool = True):
    """``(min wall seconds over repeats, last output)`` of ``fn(*args)``
    after one warm-up call, each call synced on its output."""
    out = fn(*args)
    device_sync(out)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        if sync_out:
            device_sync(out)
        times.append(time.perf_counter() - t0)
    return min(times), out
