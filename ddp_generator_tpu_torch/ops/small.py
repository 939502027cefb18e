"""Sums and products of the small per-lane vectors and matrices of the
serial path (``ops/boxqp.py``, ``ops/backpass.py``, ``ops/chol.py``,
``ops/forward.py``), in index order.

Each is a chain of elementwise multiplies and adds over the summed index,
``((a0*b0 + a1*b1) + a2*b2) + ...``, not ``sum``/``matmul``: a reduction
kernel's order differs between devices (and ``matmul`` in float32 may use
TF32), while an elementwise multiply or add rounds alike everywhere.  So
the serial path computes the same numbers on the card as on the CPU, and a
degenerate boxQP (a control exactly at its bound with a zero gradient)
resolves the same way on both.  Leading axes are the batch.

``mv`` and ``mm`` take ``ordered=False`` for a path that is held to a
tolerance rather than bit for bit (the parallel backward pass): one
``sum`` launch instead of one add per summed index.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _ordered(x: Tensor, dim: int, ordered: bool = True) -> Tensor:
    """``x.sum(dim)``, adding the slices in index order (``ordered``) or
    by one ``sum``."""
    if not ordered:
        return x.sum(dim)
    parts = x.unbind(dim)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def total(x: Tensor) -> Tensor:
    """``x.sum(-1)`` in index order."""
    return _ordered(x, -1)


def dot(a: Tensor, b: Tensor) -> Tensor:
    """``(a * b).sum(-1)`` in index order."""
    return _ordered(a * b, -1)


def mv(A: Tensor, x: Tensor, ordered: bool = True) -> Tensor:
    """``A @ x`` for ``A (..., n, k)``, ``x (..., k)``."""
    return _ordered(A * x[..., None, :], -1, ordered)


def mm(A: Tensor, Bm: Tensor, ordered: bool = True) -> Tensor:
    """``A @ Bm`` for ``A (..., n, k)``, ``Bm (..., k, m)``: a broadcast
    multiply and a sum, not ``matmul`` (batched GEMM over a million 1x1 to
    6x6 products is the slow path of cuBLAS)."""
    return _ordered(A[..., :, :, None] * Bm[..., None, :, :], -2, ordered)


def tv(v: Tensor, T: Tensor) -> Tensor:
    """``einsum("...i,...ijk->...jk", v, T)``: the contraction of ``v``
    with the first axis of ``T``'s trailing three."""
    return _ordered(v[..., :, None, None] * T, -3)
