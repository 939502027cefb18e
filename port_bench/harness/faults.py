"""Faults planted in the program under test, for the check's own tests and
for reading the numbers that each fault gives (``calibrate.py``).

Each is a context manager that wraps ``solver._make_parts`` (the solve's
``init_fn``, ``body_fn`` and ``finalize_fn``, which every entry point
builds its solver from), so the timed path itself is broken underneath:

* ``unchanged``: a body call returns its state unchanged and ends the lane
  with a success exit;
* ``stalled``: a body call makes no progress: it returns its state with
  only the iteration count advanced, so every lane uses up ``max_iter``
  (status 7) with its initial inputs;
* ``half``: half of the batch is left out: the lanes of the second half are
  never processed (they come back with their initial inputs, still
  running);
* ``altered``: an answer is altered where it is produced: the returned
  inputs move by 1e-3 after the solve.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "stalled", "half", "altered")


@contextlib.contextmanager
def planted(name: str):
    import torch

    from ddp_generator_tpu_torch import solver

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}: {FAULTS}")
    make_parts = solver._make_parts

    def broken(*args, **kwargs):
        init_fn, body_fn, finalize_fn, cast = make_parts(*args, **kwargs)
        if name == "unchanged":
            def body(c, params):
                two = torch.full_like(c.status, 2)
                return c._replace(done=torch.ones_like(c.done),
                                  status=torch.where(c.done, c.status, two))
            return init_fn, body, finalize_fn, cast
        if name == "stalled":
            def body(c, params):
                return c._replace(it=c.it + 1, body_calls=c.body_calls + 1)
            return init_fn, body, finalize_fn, cast
        if name == "half":
            def init(x0s, u0s, params):
                c = init_fn(x0s, u0s, params)
                B = c.done.shape[0]
                left_out = torch.arange(B, device=c.done.device) >= B - B // 2
                return c._replace(done=c.done | left_out)
            return init, body_fn, finalize_fn, cast

        def finalize(final):
            sol = finalize_fn(final)
            return sol._replace(us=sol.us + 1e-3)
        return init_fn, body_fn, finalize, cast

    solver._make_parts = broken
    solver._batched_solver.cache_clear()  # solve()'s solvers are cached
    try:
        yield
    finally:
        solver._make_parts = make_parts
        solver._batched_solver.cache_clear()
