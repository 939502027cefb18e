"""Launch counts of the hand-written kernels.

Each kernel wrapper adds one to its count where it launches its kernel on a
CUDA device, and nowhere else (its plain version on the CPU counts
nothing): ``cuda_backpass.back_pass_cm`` (B1),
``cuda_fused.fused_derivs_back_pass`` (B3) and ``cuda_rollout.rollout_call``
(B2, the sweep and the selected rollout apart).

An eager launch with nothing to decide on the device counts on the host
(the wrapper's ``launches`` attribute).  Two kinds count on the device, in
one ``int64`` tensor per device that :func:`on_device` adds to:

* a launch inside a CUDA graph capture: the capture records the add beside
  the kernel, so each replay counts the launch and the capture itself
  counts nothing;
* a launch behind a device predicate ``when`` (a 0-d or one-element
  tensor): it adds the predicate, so a launch that does no work counts
  nothing.  B2's stage flag is one (a stage the line search does not need
  launches and exits at entry); the solver passes B1 and B3 "some lane of
  this body call runs", so a graph replay after the working set's last
  lane retired counts no launch, as the eager loop makes no body call then.

So a solve counts the same launches whether its body calls were replayed or
run eagerly.  :func:`read_launches` synchronizes to read the device counts.
"""

from __future__ import annotations

import torch

KERNELS = ("backpass", "fused", "rollout_multi", "rollout_selected")
_DEVICE: dict = {}  # torch.device -> int64 (len(KERNELS),) counts


def device_counts(device) -> torch.Tensor:
    """The device counts of ``device`` (a CUDA device), made at first use.
    Made outside a capture: a tensor made inside one would be zeroed by
    every replay."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    t = _DEVICE.get(device)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("launch counts must exist before a CUDA graph "
                               "capture: call launches.device_counts(device)")
        t = torch.zeros(len(KERNELS), dtype=torch.int64, device=device)
        _DEVICE[device] = t
    return t


def on_device(kernel: str, device, when=None) -> bool:
    """Count one launch of ``kernel`` on the device if it must be (inside a
    capture, or behind the predicate ``when``); False for an eager
    unconditional launch, which the wrapper counts on the host."""
    if when is None and not torch.cuda.is_current_stream_capturing():
        return False
    i = KERNELS.index(kernel)
    add = 1 if when is None else when.reshape(1).to(torch.int64)
    device_counts(device)[i:i + 1].add_(add)
    return True


def reset_launches() -> None:
    """Set every count to 0 (the device counts in place: captured graphs
    hold their address)."""
    from .ops import cuda_backpass as _cb
    from .ops import cuda_fused as _cf
    from .ops import cuda_rollout as _cr

    _cb.back_pass_cm.launches = 0
    _cf.fused_derivs_back_pass.launches = 0
    _cr.rollout_call.launches = {"multi": 0, "selected": 0}
    for t in _DEVICE.values():
        t.zero_()


def read_launches() -> dict:
    """``{"backpass", "fused", "rollout_multi", "rollout_selected"}``:
    launches since the last :func:`reset_launches`, host and device counts
    together."""
    from .ops import cuda_backpass as _cb
    from .ops import cuda_fused as _cf
    from .ops import cuda_rollout as _cr

    out = {"backpass": _cb.back_pass_cm.launches,
           "fused": _cf.fused_derivs_back_pass.launches,
           "rollout_multi": _cr.rollout_call.launches["multi"],
           "rollout_selected": _cr.rollout_call.launches["selected"]}
    for t in _DEVICE.values():
        for k, v in zip(KERNELS, t.tolist()):
            out[k] += v
    return out
