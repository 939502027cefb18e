"""Debug printing and parameter introspection
(``ddp_generator_tpu.utils.debug``).

* :func:`print_params`: the bound-parameter dump ``printParams``
  (``iLQG.c:45-55``) for a (nested) dict of params;
* :func:`format_vec` / :func:`format_mat`: ``printVec``/``printMat``/
  ``printTri`` (``printMat.c:7-70``); matrices are dense, so the triangle
  printer is a masked dense print.

Each takes tensors (on any device) or numpy arrays and prints the strings
the JAX package prints for the same values.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def format_vec(v, name: str = "") -> str:
    body = " ".join(f"{x: .6g}" for x in _np(v).ravel())
    return f"{name}= [{body}]" if name else f"[{body}]"


def format_mat(m, name: str = "", tri: bool = False) -> str:
    lines = []
    for i, row in enumerate(_np(m)):
        if tri:
            row = [row[j] if j >= i else 0.0 for j in range(len(row))]
        lines.append("  " + " ".join(f"{x: .6g}" for x in row))
    head = f"{name}=\n" if name else ""
    return head + "\n".join(lines)


def _leaves(params: Any, prefix: str = ""):
    """``(path, leaf)`` in the JAX package's flattening order (dict keys
    sorted, sequences by index), paths joined with ``/``."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _leaves(params[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from _leaves(v, f"{prefix}/[{i}]" if prefix else f"[{i}]")
    else:
        yield prefix, params


def print_params(params: Any, k: int = 0) -> str:
    """Print and return a human-readable dump of a params dict
    (``printParams``, ``iLQG.c:45-55``).  Time-varying arrays (the
    reference's ``[k]``-indexed entries, 1-D with more than 8 values) print
    their value at step ``k``."""
    lines = []
    for name, leaf in _leaves(params):
        a = _np(leaf)
        if a.ndim == 0 or a.size == 1:
            lines.append(f"{name}= {float(a.ravel()[0]):g}")
        elif a.ndim == 1 and a.size > 8:
            lines.append(f"{name}[k]= {float(a[min(k, a.size - 1)]):g}")
        else:
            lines.append(format_vec(a, name))
    out = "\n".join(lines)
    print(out)
    return out
