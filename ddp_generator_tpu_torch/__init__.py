"""ddp_generator_tpu_torch: the batched DDP/iLQG solver in PyTorch and CUDA.

The port of ``ddp_generator_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100.  It imports no JAX.  The solver's two hot kernels are hand-written
CUDA for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use on a CUDA
device; on the CPU the same entry points run their plain PyTorch versions.

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

from .al import Multipliers, init_multipliers, update_multipliers
from .convert import params_from_jax, to_numpy, to_torch
from .derivs import DerivBundle, batched_calc_derivs, calc_derivs
from .options import DEFAULT_ALPHA, OptionError, SolverOptions, options_from_dict
from .problem import (
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
    make_stepwise_solver,
    solve,
)

__version__ = "0.1.0"

__all__ = [
    "BoxConstraint",
    "CudaModel",
    "DEFAULT_ALPHA",
    "DerivBundle",
    "Multipliers",
    "OptionError",
    "Problem",
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
    "batched_calc_derivs",
    "calc_derivs",
    "clamp_u",
    "init_multipliers",
    "limits_u",
    "make_batched_solver",
    "make_problem",
    "make_stepwise_solver",
    "options_from_dict",
    "params_from_jax",
    "solve",
    "to_numpy",
    "to_torch",
    "update_multipliers",
]
