"""ddp_generator_tpu_torch: the batched DDP/iLQG solver in PyTorch and CUDA.

The port of ``ddp_generator_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100.  It imports no JAX.  The solver's kernels are hand-written CUDA for
``sm_90a`` (``csrc/``): the backward pass (B1), the line-search rollouts
(B2) and the fused derivatives + backward pass (B3,
``backpass_method="fused"``), built with ``nvcc`` at first use on a CUDA
device; on the CPU the same entry points run their plain PyTorch versions.
The default options run the serial path, eager PyTorch on either device
(``ops/backpass.py``, ``ops/boxqp.py``, ``ops/chol.py``,
``ops/linesearch.py``), as the JAX package's default runs ``lax.scan``.
``backpass_method="parallel"`` runs the associative-scan backward pass
of ``ops/parallel_riccati.py`` for unconstrained problems.  Around the
solver: ``debugging`` (per-step backward-pass traces), ``inspect`` (the
MMex-style derivative table), ``calc_g`` (user outputs), ``native`` (the
checkpoint engine), ``utils``, ``parallel.mesh`` (the batch sharded over
``torch.distributed`` ranks) and ``aot`` (a solver exported to one
artifact and loaded without the problem's module).  Models:
``models.car_parking``, ``models.brachistochrone`` and
``models.cartpole`` (loaded at first use).

Quick start::

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.models import car_parking

    problem = car_parking.car_parking()
    p, x0, u0 = car_parking.default_setup(T=500)
    opts = ddp.SolverOptions(max_iter=200, dtype="float32", tolFun=1e-5,
                             backpass_method="kernel",
                             linesearch_method="kernel", debug_level=0)
    solver = ddp.StepwiseSolver(problem, opts, device="cuda")
    sol = solver(np.tile(x0, (B, 1)), u0s, p)    # u0s: (B, T, 2)
"""

from . import aot, debugging, parallel
from .al import Multipliers, init_multipliers, update_multipliers
from .convert import params_from_jax, to_numpy, to_torch
from .derivs import DerivBundle, batched_calc_derivs, calc_derivs
from .inspect_api import ProblemInspector, inspect
from .ops.backpass import BackPassResult, back_pass
from .ops.boxqp import (
    BoxQPHyper,
    BoxQPResult,
    boxqp,
    boxqp_enumerate,
    boxqp_newton,
)
from .ops.chol import ModCholResult, mod_chol, mod_chol_perturb
from .ops.cuda_fused import fused_derivs_back_pass
from .ops.linesearch import LineSearchResult, line_search
from .outputs import calc_g, get_g_size, make_output_fn
from .options import DEFAULT_ALPHA, OptionError, SolverOptions, options_from_dict
from .problem import (
    PER_STEP,
    BoxConstraint,
    CudaModel,
    Problem,
    ProblemValidationError,
    clamp_u,
    limits_u,
    make_problem,
)
from .solution import (
    STATUS_DERIVS_FAILED,
    STATUS_EXIT_LAMBDA_MAX,
    STATUS_INIT_FAILED,
    STATUS_MAX_ITER,
    STATUS_NO_DESCENT,
    STATUS_RUNNING,
    STATUS_SUCCESS_GRADIENT,
    STATUS_SUCCESS_TOLFUN,
    Solution,
)
from .solver import (
    StepwiseSolver,
    make_batched_solver,
    make_solver,
    make_stepwise_solver,
    solve,
)

__version__ = "0.1.0"

# The example problems load on first use, so that a process restoring an
# AOT artifact (aot.load_solver) never imports them.
_MODELS = ("brachistochrone", "car_parking", "cartpole")


def __getattr__(name: str):
    if name in _MODELS:
        import importlib

        return importlib.import_module(f".models.{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BackPassResult",
    "BoxConstraint",
    "BoxQPHyper",
    "BoxQPResult",
    "CudaModel",
    "DEFAULT_ALPHA",
    "DerivBundle",
    "LineSearchResult",
    "ModCholResult",
    "Multipliers",
    "OptionError",
    "PER_STEP",
    "Problem",
    "ProblemInspector",
    "ProblemValidationError",
    "STATUS_DERIVS_FAILED",
    "STATUS_EXIT_LAMBDA_MAX",
    "STATUS_INIT_FAILED",
    "STATUS_MAX_ITER",
    "STATUS_NO_DESCENT",
    "STATUS_RUNNING",
    "STATUS_SUCCESS_GRADIENT",
    "STATUS_SUCCESS_TOLFUN",
    "Solution",
    "SolverOptions",
    "StepwiseSolver",
    "aot",
    "back_pass",
    "batched_calc_derivs",
    "boxqp",
    "boxqp_enumerate",
    "boxqp_newton",
    "brachistochrone",
    "calc_derivs",
    "calc_g",
    "car_parking",
    "cartpole",
    "clamp_u",
    "debugging",
    "fused_derivs_back_pass",
    "get_g_size",
    "init_multipliers",
    "inspect",
    "limits_u",
    "line_search",
    "make_batched_solver",
    "make_output_fn",
    "make_problem",
    "make_solver",
    "make_stepwise_solver",
    "mod_chol",
    "mod_chol_perturb",
    "options_from_dict",
    "parallel",
    "params_from_jax",
    "solve",
    "to_numpy",
    "to_torch",
    "update_multipliers",
]
