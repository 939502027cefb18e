"""Optional user outputs ("g") along a trajectory
(``ddp_generator_tpu.outputs``).

The reference lets a problem define an auxiliary output array ``g``
evaluated per step by the generated ``calcG`` / ``get_g_size``
(``iLQG_func.tem:511-521``; prototypes ``iLQG.h:87-88``), e.g. internal
forces or performance signals derived from ``(x, u, params, k)``.

Here ``g(x, u, p, k) -> (n_g, *batch)`` is written component-first like
the problem's own functions (``problem.py``): :func:`calc_g` calls it once
on the whole horizon, ``x (n_x, ..., N)``, ``u (n_u, ..., N)`` and
``k (N,)``, so a ``[k]``-indexed parameter ``p[key][k]`` gives every step's
value.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .convert import to_torch

Tensor = torch.Tensor
OutputFn = Callable[..., Tensor]  # g(x, u, p, k) -> (n_g, *batch)


def get_g_size(g: OutputFn, n_x: int, n_u: int, params: Any) -> int:
    """Output dimension (``get_g_size``, ``iLQG_func.tem:511-513``), from
    one call on ``meta`` tensors (shapes only, no data)."""
    x = torch.zeros((n_x,), dtype=torch.float64, device="meta")
    u = torch.zeros((n_u,), dtype=torch.float64, device="meta")
    shape = tuple(g(x, u, to_torch(dict(params), torch.float64, "meta"),
                    0).shape)
    if len(shape) != 1:
        raise ValueError(f"g must return a 1-D vector, got shape {shape}")
    return int(shape[0])


def calc_g(g: OutputFn, xs, us, params: Any) -> Tensor:
    """``g`` at every running step of a trajectory, or of a batch of them:
    ``xs (..., N+1, n_x)``, ``us (..., N, n_u)`` -> ``(..., N, n_g)``
    (the generated ``calcG`` for each k, ``iLQG_func.tem:515-521``), on the
    device and in the dtype of ``xs``."""
    xs = torch.as_tensor(xs)
    us = torch.as_tensor(us, dtype=xs.dtype, device=xs.device)
    N = us.shape[-2]
    p = to_torch(dict(params), xs.dtype, xs.device)
    k = torch.arange(N, device=xs.device)
    out = g(xs[..., :N, :].movedim(-1, 0), us.movedim(-1, 0), p, k)
    n_g = out.shape[0]
    return out.broadcast_to((n_g,) + us.shape[:-1]).movedim(0, -1)


def make_output_fn(g: OutputFn):
    """Trajectory-output evaluator ``(xs, us, params) -> (..., N, n_g)``
    for one solution or a batch of them."""
    return lambda xs, us, params: calc_g(g, xs, us, params)
