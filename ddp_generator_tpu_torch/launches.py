"""Launch counts of the hand-written kernels.

Each kernel wrapper calls :func:`count` where it launches its kernel on a
CUDA device, and nowhere else (its plain version on the CPU counts
nothing): ``cuda_backpass.back_pass_cm`` (B1),
``cuda_fused.fused_derivs_back_pass`` (B3), ``cuda_rollout.rollout_call``
(B2, the sweep and the selected rollout apart) and ``cuda_emit.emit`` (the
kernel path's emission, its two launches counted as one).
``cuda_rollout.initial_rollout`` counts ``init_rollout``, the solver's
initial rollout run as one of B2's selected rollouts (also counted there).
A launch of the emission kernel or of B2 that reads per-lane params
(:class:`~.problem.LaneParams`) counts once more, as ``emit_lane_params`` or
``rollout_lane_params``, under the same rule as its own count.
This module holds every count and imports no wrapper; :func:`read_launches`
is the one reader.

An eager launch with nothing to decide on the device counts on the host,
in this module's dict.  Two kinds count on the device, in one ``int64``
tensor per device:

* a launch inside a CUDA graph capture: the capture records the add beside
  the kernel, so each replay counts the launch and the capture itself
  counts nothing;
* a launch behind a device predicate ``when`` (a 0-d or one-element
  tensor): it adds the predicate, so a launch that does no work counts
  nothing.  B2's stage flag is one (a stage the line search does not need
  launches and exits at entry); the solver passes B1, B3 and the emission
  "some lane of this body call runs", so a graph replay after the working
  set's last lane retired counts no launch, as the eager loop makes no body
  call then.

So a solve counts the same launches whether its body calls were replayed or
run eagerly.  :func:`read_launches` synchronizes to read the device counts.

Three more records trace a solve; the stamp ring and the lane-steps follow
the counts' rules (made before any capture, emptied by
:func:`reset_launches`):

* host spans (:func:`span`): ``torch.profiler.record_function`` ranges
  named ``ddp.*``, entered only while a profiler records, so they land in
  its trace on the clock of the device operations;
* device stamps (:func:`stamp`): a one-thread kernel that appends ``(tag,
  %globaltimer ns)`` to a ring per device, a node of any graph it is
  captured in, WHILE bodies included, where the profiler sees no kernel;
  :func:`read_stamps` reads them back in order;
* lane-steps (:func:`add_lane_steps`): the working width summed over the
  body calls of every :class:`~.solver.StepwiseSolver` call, on the host
  (each call's own in ``LoopStats.lane_steps``);
* multiplier updates (:func:`count_al_updates`): the running lanes whose
  AL multipliers a body call updated, summed on the device (one ``int64``
  per device, an add of the lanes' count in the body call, a graph node
  where captured); :func:`read_al_updates` reads them.
"""

from __future__ import annotations

import contextlib

import torch

KERNELS = ("backpass", "fused", "rollout_multi", "rollout_selected", "emit",
           "init_rollout", "emit_lane_params", "rollout_lane_params")
_DEVICE: dict = {}  # torch.device -> int64 (len(KERNELS),) counts
_ON_HOST = dict.fromkeys(KERNELS, 0)  # eager unconditional launches


#: the tags a stamp takes, by their index in the ring
STAMP_TAGS = ("body", "derivs", "backpass", "linesearch", "body_end",
              "solve", "loop", "loop_end", "solve_end", "al", "init",
              "init_end")
STAMP_CAPACITY = 1 << 20  # stamps a device's ring holds before it wraps
_STAMPS: dict = {}  # torch.device -> int64 ring (see stamp_ring)
_AL: dict = {}  # torch.device -> int64 (1,) multiplier updates, in lanes
_HOST = {"lane_steps": 0}
_NO_SPAN = contextlib.nullcontext()


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    return device


def _made_before_capture(table: dict, device, make, what: str):
    device = _cuda_device(device)
    t = table.get(device)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{what} must exist before a CUDA graph "
                               "capture: call launches.before_capture(device)")
        t = table[device] = make(device)
    return t


def device_counts(device) -> torch.Tensor:
    """The device counts of ``device`` (a CUDA device), made at first use.
    Made outside a capture: a tensor made inside one would be zeroed by
    every replay."""
    return _made_before_capture(
        _DEVICE, device, lambda d: torch.zeros(len(KERNELS),
                                               dtype=torch.int64, device=d),
        "launch counts")


def _new_ring(device) -> torch.Tensor:
    ring = torch.zeros(2 + 2 * STAMP_CAPACITY, dtype=torch.int64,
                       device=device)
    ring[1] = STAMP_CAPACITY
    return ring


def stamp_ring(device) -> torch.Tensor:
    """The stamp ring of ``device`` (a CUDA device), made at first use,
    outside a capture: ``[cursor, capacity, tag_0, ns_0, tag_1, ns_1,
    ...]``, int64; stamp ``i`` (the cursor's value when it was taken) lies
    at slot ``i % capacity``."""
    return _made_before_capture(_STAMPS, device, _new_ring, "the stamp ring")


def al_updates(device) -> torch.Tensor:
    """The multiplier-update count of ``device``, int64 ``(1,)``, made at
    first use (on a CUDA device outside a capture)."""
    device = torch.device(device)
    if device.type != "cuda":
        return _AL.setdefault(device, torch.zeros(1, dtype=torch.int64))
    return _made_before_capture(
        _AL, device, lambda d: torch.zeros(1, dtype=torch.int64, device=d),
        "the multiplier-update count")


def before_capture(device) -> None:
    """Make the launch counts, the stamp ring and the multiplier-update
    count of ``device``: a graph captured afterwards adds to them on every
    replay."""
    device_counts(device)
    stamp_ring(device)
    al_updates(device)


def span(name: str, solve_id: int):
    """A host span: ``torch.profiler.record_function(name)`` with
    ``solve_id`` (the caller's count of its calls, shared by the spans of
    one call) as its argument while a profiler records, else a context
    that does nothing; the cost off is one bool check.  The profiler's
    Chrome trace keeps the name and interval; an execution trace
    (``torch.profiler.ExecutionTraceObserver``) keeps the argument too."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name, args=str(solve_id))


def stamp(tag: str, device) -> None:
    """Append ``(tag, ns)`` to ``device``'s stamp ring: a one-thread kernel
    (``csrc/stamps.cu``) on the current stream reads the device's
    ``%globaltimer`` when it runs.  Captured, it is a node of the graph and
    stamps every replay.  Nothing on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    from . import _build

    lib = _build.load_library()
    ring = stamp_ring(device)
    stream = torch.cuda.current_stream(ring.device).cuda_stream
    _build.check(lib, lib.ddp_stamp(ring.data_ptr(), STAMP_TAGS.index(tag),
                                    stream), "ddp_stamp")


def decode_stamps(ring: torch.Tensor):
    """``(entries, lost)`` of a ring as :func:`stamp_ring` lays it out (on
    any device): ``entries`` the stamps still held, oldest first, each
    ``(tag, ns)``; ``lost`` those overwritten by wrap-around."""
    ring = ring.cpu()
    n, cap = int(ring[0]), int(ring[1])
    slots = ring[2:2 + 2 * cap].view(cap, 2)
    if n <= cap:
        rows = slots[:n]
    else:
        start = n % cap
        rows = torch.cat([slots[start:], slots[:start]])
    return ([(STAMP_TAGS[t], ns) for t, ns in rows.tolist()],
            max(0, n - cap))


def read_stamps(device=None):
    """``(entries, lost)`` (:func:`decode_stamps`) of ``device``'s ring
    (the current CUDA device by default) since the last
    :func:`reset_launches`, after a synchronize; ``([], 0)`` where no
    stamp ring was made."""
    if not _STAMPS:  # none made (the CPU has none)
        return [], 0
    device = _cuda_device(device or "cuda")
    ring = _STAMPS.get(device)
    if ring is None:
        return [], 0
    torch.cuda.synchronize(device)
    return decode_stamps(ring)


def add_lane_steps(n: int) -> None:
    """Count ``n`` lane-steps (lanes of a body call's working width)."""
    _HOST["lane_steps"] += n


def read_lane_steps() -> int:
    """Lane-steps counted since the last :func:`reset_launches`."""
    return _HOST["lane_steps"]


def count_al_updates(updated: torch.Tensor) -> None:
    """Add the lanes set in ``updated`` (bool, one per lane: the lanes
    whose multipliers a body call updated) to their device's count."""
    al_updates(updated.device).add_(updated.sum())


def read_al_updates() -> int:
    """Multiplier updates, in lanes, counted on every device since the
    last :func:`reset_launches` (a read of each device's count)."""
    return sum(int(t.sum()) for t in _AL.values())


def count(kernel: str, device, when=None) -> None:
    """Count one launch of ``kernel`` (a name of :data:`KERNELS`) on
    ``device``: on the device inside a capture, or behind the predicate
    ``when`` (it adds ``when``); else on the host."""
    if when is None and (torch.device(device).type != "cuda"
                         or not torch.cuda.is_current_stream_capturing()):
        _ON_HOST[kernel] += 1
        return
    i = KERNELS.index(kernel)
    add = 1 if when is None else when.reshape(1).to(torch.int64)
    device_counts(device)[i:i + 1].add_(add)


def reset_launches() -> None:
    """Set every count to 0 and empty the stamp rings and the lane-steps
    (the device counts and the rings' cursors in place: captured graphs
    hold their address)."""
    _ON_HOST.update(dict.fromkeys(KERNELS, 0))
    for t in _DEVICE.values():
        t.zero_()
    for ring in _STAMPS.values():
        ring[:1].zero_()
    for t in _AL.values():
        t.zero_()
    _HOST["lane_steps"] = 0


def read_launches() -> dict:
    """``{"backpass", "fused", "rollout_multi", "rollout_selected",
    "emit", "init_rollout", "emit_lane_params", "rollout_lane_params"}``:
    launches since the last :func:`reset_launches`, host and device counts
    together."""
    out = dict(_ON_HOST)
    for t in _DEVICE.values():
        for k, v in zip(KERNELS, t.tolist()):
            out[k] += v
    return out
