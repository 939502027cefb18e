"""Line-search result (``ddp_generator_tpu.ops.linesearch``).

The accepted candidate is the first (largest) alpha with ``z > zMin``; when
every alpha fails, ``new_cost``/``dcost``/``expected`` come from the last
alpha (``line_search.c:70-76``).  The batched search itself runs on the
rollout kernel, ``ops/cuda_rollout.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class LineSearchResult(NamedTuple):
    success: Tensor  # (B,) bool
    xs: Tensor  # (B, N+1, n_x) accepted candidate trajectory
    us: Tensor  # (B, N, n_u)
    new_cost: Tensor
    dcost: Tensor
    expected: Tensor
    z: Tensor
    alpha_index: Tensor  # int32 index into the alpha schedule (n_alpha if none)
