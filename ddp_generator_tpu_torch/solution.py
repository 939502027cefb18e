"""Solution returned by the solver (``ddp_generator_tpu.solution``).

Batched solvers return every field with a leading lane axis ``B``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

# Status codes (reason for termination)
STATUS_RUNNING = 0
STATUS_SUCCESS_GRADIENT = 1  # g_norm < tolGrad && lambda < 1e-5 (iLQG.c:297)
STATUS_SUCCESS_TOLFUN = 2  # dcost < tolFun (iLQG.c:329)
STATUS_EXIT_LAMBDA_MAX = 3  # lambda > lambdaMax after reject (iLQG.c:356)
STATUS_NO_DESCENT = 4  # back pass never succeeded (iLQG.c:367-371)
STATUS_DERIVS_FAILED = 5  # NaN/Inf in derivatives (iLQG.c:247-249)
STATUS_INIT_FAILED = 6  # initial rollout not finite
STATUS_MAX_ITER = 7  # iteration budget exhausted (iLQG.c:372-376)


class Solution(NamedTuple):
    success: Tensor  # bool; reference return-value semantics (iLQG.c:367-378)
    xs: Tensor  # (N+1, n_x) optimized state trajectory
    us: Tensor  # (N, n_u) optimized inputs
    cost: Tensor  # final (AL-augmented) cost
    iterations: Tensor  # int32, as o->iterations (iLQG.c:365)
    g_norm: Tensor
    lam: Tensor  # final lambda
    dlam: Tensor
    w_pen_l: Tensor
    w_pen_f: Tensor
    status: Tensor  # int32, STATUS_* above
    dcost: Tensor
    expected: Tensor
    z: Tensor
    log_linesearch: Tensor  # (max_iter,) int32: #alphas tried
    log_z: Tensor  # (max_iter,)
    log_cost: Tensor  # (max_iter,)
    # Instrumentation (see ddp_generator_tpu.solution): body calls that
    # processed the lane, how many of them re-derived a stale derivative
    # bundle, and how many of those were lambda-escalation retries.
    body_calls: Tensor  # int32
    stale_calls: Tensor  # int32
    bp_retry_calls: Tensor  # int32
