"""Carry parameters and solver state between numpy (the JAX package's
pytrees) and torch tensors, so both packages can be fed the same inputs."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_jax(p_numpy: dict, dtype: torch.dtype,
                    device: "torch.device | str") -> dict:
    """A JAX-package params dict with numpy or scalar leaves -> dict of
    tensors of ``dtype`` on ``device`` (integer leaves keep their type).
    Shapes are kept: per-lane params stay batch-major ``(B, *leaf_shape)``,
    the JAX convention; only the solver casts them to lanes-last."""
    return to_torch(dict(p_numpy), dtype, device)


def to_torch(tree: Any, dtype: torch.dtype,
             device: "torch.device | str") -> Any:
    """Inverse of :func:`to_numpy` for solver state (``xs``, ``us``,
    ``Multipliers``, ``lam`` ...): floating leaves become ``dtype`` on
    ``device``, bool and integer leaves keep their type."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            return tree.to(device=device, dtype=dtype)
        return tree.to(device=device)
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_torch(v, dtype, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, dtype, device) for v in tree)
    a = np.asarray(tree)
    t = torch.as_tensor(a, device=device)
    return t.to(dtype) if np.issubdtype(a.dtype, np.floating) else t


def to_numpy(tree: Any) -> Any:
    """Tensors in (nested) NamedTuples, tuples, lists and dicts -> numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree
