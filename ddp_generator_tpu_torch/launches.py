"""Launch counts of the hand-written kernels.

Each kernel wrapper adds one to its count where it launches its kernel on a
CUDA device, and nowhere else (its plain version on the CPU counts
nothing): ``cuda_backpass.back_pass_cm`` (B1),
``cuda_fused.fused_derivs_back_pass`` (B3) and ``cuda_rollout.rollout_call``
(B2, the sweep and the selected rollout apart).
"""

from __future__ import annotations

from .ops import cuda_backpass as _cb
from .ops import cuda_fused as _cf
from .ops import cuda_rollout as _cr


def reset_launches() -> None:
    """Set every count to 0."""
    _cb.back_pass_cm.launches = 0
    _cf.fused_derivs_back_pass.launches = 0
    _cr.rollout_call.launches = {"multi": 0, "selected": 0}


def read_launches() -> dict:
    """``{"backpass", "fused", "rollout_multi", "rollout_selected"}``:
    launches since the last :func:`reset_launches`."""
    return {"backpass": _cb.back_pass_cm.launches,
            "fused": _cf.fused_derivs_back_pass.launches,
            "rollout_multi": _cr.rollout_call.launches["multi"],
            "rollout_selected": _cr.rollout_call.launches["selected"]}
