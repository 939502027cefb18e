"""The lower-precision control of a configuration's check: the answers as
a path one precision below the configuration's would give them.

The port has no dtype below float32, so the configuration's
``"control": {"reference_rollout": d}`` puts the reference in the
program's place below the line search's output: the returned inputs
rounded to ``d``, the trajectory rolled out and the cost summed by the
reference in ``d``.
"""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def transform(cfg: dict, ref, case: dict, out: dict) -> dict:
    """The program's outputs as the configuration's control gives them."""
    from reference import common

    dt = DTYPES[cfg["control"]["reference_rollout"]]
    p = {k: v.to(dt) for k, v in case["p"].items()}
    us = out["us"].to(dt)
    xs = common.rollout(ref.f, case["x0"].to(dt), us, p)
    cost = common.total_cost(ref.L, ref.F, xs, us, p)
    return dict(out, xs=xs, us=us, cost=cost)
