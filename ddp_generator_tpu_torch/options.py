"""Solver options.

Same 19 runtime options, names, defaults and range validation as the
reference ``standard_parameters`` / ``setOptParam`` (``iLQG.c:57-216``) and
as ``ddp_generator_tpu.options``, plus the same extension knobs.  Two
differences from the JAX package:

* the value that selects the hand-written kernels is ``"kernel"`` (the JAX
  package says ``"pallas"``) for ``backpass_method`` and
  ``linesearch_method``;
* :func:`options_from_dict` keeps ``scan_unroll`` an int and
  ``use_mod_chol`` a bool (the JAX version turns both into floats).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Default 8-point alpha schedule 10^linspace(0,-3,8) (iLQG.c:36).
DEFAULT_ALPHA: Tuple[float, ...] = (
    1.0,
    0.3727594,
    0.1389495,
    0.0517947,
    0.0193070,
    0.0071969,
    0.0026827,
    0.0010000,
)

_INF = float("inf")

_INT_FIELDS = ("max_iter", "regType", "debug_level", "boxqp_max_iter",
               "scan_unroll")
_BOOL_FIELDS = ("full_ddp", "linesearch_staged", "use_mod_chol")
_STR_FIELDS = ("dtype", "lam_retry", "derivs_emitter", "boxqp_method",
               "backpass_method", "linesearch_method")


class OptionError(ValueError):
    """Bad option value (mirrors the setOptParam error strings, iLQG.c:80-89)."""


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Runtime solver options (defaults: ``standard_parameters``, iLQG.c:57-78)."""

    alpha: Tuple[float, ...] = DEFAULT_ALPHA
    tolFun: float = 1e-7
    tolConstraint: float = 1e-7
    tolGrad: float = 1e-5
    max_iter: int = 20
    lambdaInit: float = 1.0
    dlambdaInit: float = 1.0
    lambdaFactor: float = 1.6
    lambdaMax: float = 1e10
    lambdaMin: float = 1e-6
    regType: int = 1
    zMin: float = 0.0
    debug_level: int = 2
    w_pen_init_l: float = 1.0
    w_pen_init_f: float = 1.0
    w_pen_max_l: float = _INF
    w_pen_max_f: float = _INF
    w_pen_fact1: float = 4.0  # 4..10, Bertsekas p. 123 (iLQG.c:76)
    w_pen_fact2: float = 1.0

    # --- extensions (reference compile-time knobs) ---
    full_ddp: bool = True  # FULL_DDP (iLQG.h:4-6): 2nd-order dynamics terms
    dtype: str = "float64"
    # boxQP hyper-parameters (boxQP.c:52-57); "auto" tolerances resolve per
    # dtype exactly as in the JAX package.
    boxqp_max_iter: int = 100
    boxqp_min_grad: "float | str" = "auto"
    boxqp_min_rel_improve: "float | str" = "auto"
    boxqp_step_dec: float = 0.6
    boxqp_min_step: float = 1e-22
    boxqp_armijo: float = 0.1
    boxqp_method: str = "auto"
    # "serial": the step-major derivatives and the eager backward pass of
    # ops/backpass.py (boxQP ops/boxqp.py, MOD_CHOL ops/chol.py), on either
    # device.  "kernel": derivative emission, then the whole backward pass
    # as one hand-written CUDA kernel (B1, ops/cuda_backpass.py) on a CUDA
    # device, its plain PyTorch version on the CPU.  On a CUDA device the
    # emission is a CUDA kernel on the problem's CUDA model
    # (ops/cuda_emit.py), hand-written or generated (codegen.py), with
    # shared or per-lane params, so a problem the generator cannot write
    # raises NotImplementedError there, as with "fused".  "fused": derivatives
    # and backward pass in one CUDA kernel (B3, ops/cuda_fused.py).
    # "parallel": the associative-scan backward pass of
    # ops/parallel_riccati.py on the step-major derivatives (unconstrained
    # problems with full_ddp=False; the solver raises ValueError else).
    backpass_method: str = "serial"
    # "serial": every alpha rolled out by ops/forward.py at once
    # (ops/linesearch.py).  "kernel": the multi-alpha line search as the two
    # rollout modes of the hand-written CUDA kernel (B2, ops/cuda_rollout.py),
    # with shared or per-lane params (per-lane params on the "fused" path
    # take "serial").
    linesearch_method: str = "serial"
    # Staged kernel line search: roll alpha[0] first, the full sweep only
    # when some live lane rejects it.  Per-lane results are identical.
    linesearch_staged: bool = True
    # "deferred": a failed backward pass escalates lambda and the lane
    # retries on the next body call.  "inline": the retries run inside the
    # body call, re-running only the backward pass (iLQG.c:261-284).
    lam_retry: str = "deferred"
    # The torch emitter of the "kernel" path's bundle (ops/cm_derivs.py):
    # "per-family" (one reverse pass per output) or "shared" (one trace of
    # f and L).  It selects among the torch emitters only, so it acts on
    # the CPU with shared params: on a CUDA device the bundle comes from the
    # emission kernel (ops/cuda_emit.py), and per-lane params on the CPU
    # always take "per-family".
    derivs_emitter: str = "per-family"
    scan_unroll: int = 1
    use_mod_chol: bool = False

    def __post_init__(self):
        a = np.asarray(self.alpha, dtype=np.float64)
        if np.any((a < 0.0) | (a > 1.0)):
            raise OptionError("all alpha must be in the range [1.0..0.0)")
        if np.any(np.diff(a) >= 0.0):
            raise OptionError("all alpha must be monotonically decreasing")
        for nm in (
            "tolFun",
            "tolConstraint",
            "tolGrad",
            "lambdaInit",
            "dlambdaInit",
            "lambdaMax",
            "lambdaMin",
            "w_pen_init_l",
            "w_pen_init_f",
            "w_pen_max_l",
            "w_pen_max_f",
        ):
            if getattr(self, nm) < 0.0:
                raise OptionError(f"{nm}: parameter must be positive")
        if self.tolFun <= 0 or self.tolGrad <= 0 or self.tolConstraint <= 0:
            raise OptionError("parameter must be positive")
        if self.max_iter < 0:
            raise OptionError("max_iter: parameter must be positive")
        for nm in ("lambdaFactor", "w_pen_fact1", "w_pen_fact2"):
            if getattr(self, nm) < 1.0:
                raise OptionError(f"{nm}: parameter must be > 1")
        if not 1 <= self.regType <= 2:
            raise OptionError("regType: parameter must be in range [1..2]")
        if not 0.0 <= self.zMin < 1.0:
            raise OptionError("zMin: parameter must be in range [0..1)")
        if not 0 <= self.debug_level <= 6:
            raise OptionError("debug_level: parameter must be in range [0..6]")
        for nm in ("boxqp_min_grad", "boxqp_min_rel_improve"):
            v = getattr(self, nm)
            if v != "auto" and (not isinstance(v, (int, float)) or v <= 0):
                raise OptionError(f"{nm} must be 'auto' or a positive float")
        if self.boxqp_method not in ("auto", "newton", "enumerate"):
            raise OptionError("boxqp_method must be auto|newton|enumerate")
        if self.backpass_method not in ("serial", "parallel", "kernel",
                                        "fused"):
            raise OptionError(
                "backpass_method must be serial|parallel|kernel|fused"
            )
        if self.linesearch_method not in ("serial", "kernel"):
            raise OptionError("linesearch_method must be serial|kernel")
        if self.lam_retry not in ("inline", "deferred"):
            raise OptionError("lam_retry must be inline|deferred")
        if self.derivs_emitter not in ("shared", "per-family"):
            raise OptionError("derivs_emitter must be shared|per-family")
        # The kernel boxQP is the exact 3^n active-set enumeration; it never
        # runs the projected-Newton iteration or MOD_CHOL (boxQP.c:69-72).
        if self.backpass_method in ("kernel", "fused"):
            if self.use_mod_chol:
                raise OptionError(
                    f"use_mod_chol=True is not supported by "
                    f"backpass_method='{self.backpass_method}' (the kernel "
                    f"boxQP enumerates active sets and never factorizes); "
                    f"use backpass_method='serial' for MOD_CHOL"
                )
            if self.boxqp_method == "newton":
                raise OptionError(
                    f"boxqp_method='newton' is not supported by "
                    f"backpass_method='{self.backpass_method}' (the kernel "
                    f"boxQP is the exact enumeration); use 'auto', "
                    f"'enumerate', or backpass_method='serial'"
                )

    @property
    def n_alpha(self) -> int:
        return len(self.alpha)

    def replace(self, **kw) -> "SolverOptions":
        return dataclasses.replace(self, **kw)


def options_from_dict(d: dict) -> SolverOptions:
    """Build options from a name->value mapping (the MEX ``Op`` struct path,
    ``iLQG_mex.c:60-67``).  Unknown names raise, as ``setOptParam`` does
    (``iLQG.c:211-212``)."""
    valid = {f.name for f in dataclasses.fields(SolverOptions)}
    kw = {}
    for name, value in d.items():
        if name not in valid:
            raise OptionError(f"{name}: no such parameter")
        if name == "alpha":
            value = tuple(float(v) for v in np.atleast_1d(value))
        elif name in _INT_FIELDS:
            value = int(value)
        elif name in _BOOL_FIELDS:
            value = bool(value)
        elif name in _STR_FIELDS:
            value = str(value)
        elif name in ("boxqp_min_grad", "boxqp_min_rel_improve"):
            value = value if value == "auto" else float(value)
        else:
            value = float(value)
        kw[name] = value
    return SolverOptions(**kw)
