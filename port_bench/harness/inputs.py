"""The one generator of inputs: a configuration's parameters and initial
state, and a traffic mix's pool of initial inputs, drawn on the device from
``--seed`` with a ``torch.Generator``.

Parameter values in a configuration file are numbers, lists, or
``{"linspace": [start, stop, num], "append": [...]}``.  The initial inputs
``u0`` follow the configuration's ``"u0"``: ``{"dist": "normal",
"scale": s}`` (``s * N(0, 1)`` per entry) or ``{"dist": "neg_uniform",
"low": a, "high": b}`` (``-U(a, b)`` per entry).  A traffic file's
``"pool"`` is the number of distinct input batches made before the
window; the window cycles through them.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def param_value(v):
    if isinstance(v, dict):
        start, stop, num = v["linspace"]
        return np.concatenate([np.linspace(start, stop, int(num)),
                               np.asarray(v.get("append", []), np.float64)])
    return np.asarray(v, np.float64)


def params(cfg: dict) -> dict:
    """The configuration's parameters, float64 numpy arrays by name."""
    return {k: param_value(v) for k, v in cfg["params"].items()}


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def draw_u0(gen: torch.Generator, spec: dict, shape, dtype, device):
    dist = spec["dist"]
    if dist == "normal":
        u = torch.randn(shape, generator=gen, dtype=torch.float64,
                        device=device) * float(spec["scale"])
    elif dist == "neg_uniform":
        lo, hi = float(spec["low"]), float(spec["high"])
        u = -(lo + (hi - lo) * torch.rand(shape, generator=gen,
                                          dtype=torch.float64, device=device))
    else:
        raise ValueError(f"unknown u0 distribution {dist!r}")
    return u.to(dtype)


def pool(cfg: dict, traffic: dict, seed: int, device, T: int,
         batch: int) -> tuple:
    """``(x0s (batch, n_x), u0 pool (P, batch, T, n_u))`` on ``device``,
    in the configuration's dtype."""
    dtype = DTYPES[cfg["dtype"]]
    P = int(traffic["pool"])
    gen = generator(seed, device)
    u0 = draw_u0(gen, cfg["u0"], (P, batch, T, cfg["n_u"]), dtype, device)
    x0 = torch.as_tensor(np.asarray(cfg["x0"], np.float64), device=device)
    x0s = x0.to(dtype).expand(batch, -1).contiguous()
    return x0s, u0

