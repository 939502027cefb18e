"""Small tree helpers over (nested) NamedTuples and tuples of tensors
(``ddp_generator_tpu.utils.tree``), used across the solver."""

from __future__ import annotations

import torch


def tree_map(fn, *trees):
    """``fn`` over the tensors of (nested) NamedTuples or tuples of tensors
    of the same structure."""
    head = trees[0]
    if isinstance(head, tuple):
        mapped = (tree_map(fn, *ts) for ts in zip(*trees))
        return (type(head)(*mapped) if hasattr(head, "_fields")
                else tuple(mapped))
    return fn(*trees)


def tree_where(pred, a, b):
    """``torch.where(pred, a, b)`` leaf by leaf: a 0-d ``pred`` selects a
    whole tree (the JAX package's ``tree_where``); a per-lane mask ``(B,)``
    selects lanes, broadcast over each leaf's trailing axes."""
    def w(x, y):
        m = pred.reshape(pred.shape + (1,) * (x.dim() - pred.dim()))
        return torch.where(m, x, y)
    return tree_map(w, a, b)


def tree_zeros_like_shape(shape_tree):
    """A tree of zeros from a tree of shape-only tensors (``meta`` tensors,
    the counterpart of a ``jax.eval_shape`` result), on the CPU."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype), shape_tree)
