"""Options and solution of the PyTorch port against the JAX package."""

import dataclasses

import jax  # noqa: F401  (conftest pins the CPU platform)
import numpy as np
import pytest
import torch

import ddp_generator_tpu as jd
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import car_parking as tcar

# One non-default value per field (the kernel-selecting value is "kernel"
# in the port, "pallas" in JAX).
NON_DEFAULT = {
    "alpha": (1.0, 0.5, 0.25),
    "tolFun": 1e-6,
    "tolConstraint": 1e-6,
    "tolGrad": 1e-4,
    "max_iter": 33,
    "lambdaInit": 2.0,
    "dlambdaInit": 3.0,
    "lambdaFactor": 2.0,
    "lambdaMax": 1e9,
    "lambdaMin": 1e-7,
    "regType": 2,
    "zMin": 0.1,
    "debug_level": 0,
    "w_pen_init_l": 2.0,
    "w_pen_init_f": 3.0,
    "w_pen_max_l": 1e6,
    "w_pen_max_f": 1e7,
    "w_pen_fact1": 5.0,
    "w_pen_fact2": 2.0,
    "full_ddp": False,
    "dtype": "float32",
    "boxqp_max_iter": 50,
    "boxqp_min_grad": 1e-7,
    "boxqp_min_rel_improve": 1e-7,
    "boxqp_step_dec": 0.5,
    "boxqp_min_step": 1e-20,
    "boxqp_armijo": 0.2,
    "boxqp_method": "enumerate",
    "backpass_method": "kernel",
    "linesearch_method": "kernel",
    "linesearch_staged": False,
    "lam_retry": "inline",
    "derivs_emitter": "shared",
    "scan_unroll": 4,
    "use_mod_chol": False,
}
_TO_JAX = {"kernel": "pallas"}


def test_field_sets_match():
    t_fields = [f.name for f in dataclasses.fields(td.SolverOptions)]
    j_fields = [f.name for f in dataclasses.fields(jd.SolverOptions)]
    assert t_fields == j_fields
    assert set(NON_DEFAULT) == set(t_fields)


@pytest.mark.parametrize("name", sorted(NON_DEFAULT))
def test_defaults_and_round_trip_match_jax(name):
    t_def, j_def = td.SolverOptions(), jd.SolverOptions()
    jv_def = getattr(j_def, name)
    tv_def = getattr(t_def, name)
    assert tv_def == jv_def, name
    value = NON_DEFAULT[name]
    t = td.options_from_dict({name: value})
    j = jd.options_from_dict({name: _TO_JAX.get(value, value)
                              if isinstance(value, str) else value})
    tv, jv = getattr(t, name), getattr(j, name)
    if isinstance(tv, str):
        assert _TO_JAX.get(tv, tv) == jv
    else:
        # values, not types: JAX's options_from_dict makes scan_unroll and
        # use_mod_chol floats
        assert np.all(np.asarray(tv) == np.asarray(jv)), (name, tv, jv)


def test_quirk_fixed_int_and_bool():
    o = td.options_from_dict({"scan_unroll": 4.0, "use_mod_chol": 1.0,
                              "max_iter": 7.0})
    assert type(o.scan_unroll) is int and o.scan_unroll == 4
    assert type(o.use_mod_chol) is bool and o.use_mod_chol is True
    assert type(o.max_iter) is int


@pytest.mark.parametrize("bad", [
    {"alpha": (0.5, 1.0)}, {"alpha": (1.5,)}, {"tolFun": -1.0},
    {"lambdaFactor": 0.5}, {"regType": 3}, {"zMin": 1.0},
    {"debug_level": 9}, {"boxqp_min_grad": -1.0}, {"boxqp_method": "x"},
    {"backpass_method": "pallas"}, {"linesearch_method": "pallas"},
    {"lam_retry": "x"}, {"derivs_emitter": "x"},
    {"backpass_method": "kernel", "use_mod_chol": True},
    {"backpass_method": "kernel", "boxqp_method": "newton"},
    {"nope": 1},
])
def test_invalid_options_raise(bad):
    with pytest.raises(td.OptionError):
        td.options_from_dict(bad)


@pytest.mark.parametrize("kw", [
    dict(backpass_method="parallel", linesearch_method="kernel"),
])
def test_unported_paths_validate_then_raise(kw):
    """``parallel`` on CarParking (box constraints) raises ValueError
    naming ``parallel``, as JAX's
    ``test_parallel_rejected_for_constrained_problems``."""
    opts = td.SolverOptions(full_ddp=False, **kw)
    with pytest.raises(ValueError, match="parallel"):
        td.StepwiseSolver(tcar.car_parking(), opts, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(backpass_method="serial", linesearch_method="kernel"),
    dict(backpass_method="fused", linesearch_method="serial"),
    dict(backpass_method="kernel", linesearch_method="serial"),
    dict(backpass_method="kernel", linesearch_method="kernel",
         lam_retry="inline"),
    dict(inline_below=64),
])
def test_ported_paths_construct(kw):
    """The serial path, every mix of it with the kernels, inline retries
    and inline_below build a solver (they raised before they were
    ported)."""
    below = kw.pop("inline_below", 0)
    opts = td.SolverOptions(**kw)
    solver = td.StepwiseSolver(tcar.car_parking(), opts, device="cpu",
                               inline_below=below)
    assert solver.inline_below == below


def test_fused_path_is_ported_and_ignores_the_emitter():
    # as in JAX, the fused path computes its own derivatives
    opts = td.SolverOptions(backpass_method="fused",
                            linesearch_method="kernel",
                            derivs_emitter="shared")
    td.StepwiseSolver(tcar.car_parking(), opts, device="cpu")
    # the kernel path emits with either emitter: "shared" builds and solves
    p, x0, _ = tcar.default_setup(T=12)
    u0s = 0.1 * np.random.default_rng(0).standard_normal((2, 12, 2))
    sol = td.StepwiseSolver(tcar.car_parking(), dataclasses.replace(
        opts, backpass_method="kernel", max_iter=3), min_compact_batch=2,
        device="cpu")(np.tile(x0, (2, 1)), u0s, p)
    assert sol.cost.shape == (2,) and bool(torch.isfinite(sol.cost).all())
    # per-lane params: the fused path takes the serial one (no emitter)
    assert td.StepwiseSolver(tcar.car_parking(), opts, batch_params=True,
                             device="cpu").batch_params


@pytest.mark.parametrize("kw", [
    dict(pipeline_depth=2), dict(batch_params=True, pipeline_depth=3),
    dict(mesh=object()),
])
def test_unported_stepwise_levers_raise(kw):
    """``pipeline_depth > 1`` constructs and stores its depth; ``mesh``
    (ported: ``parallel/mesh.py``, ``tests/test_torch_mesh.py``) takes a
    ``DeviceMesh`` and raises for anything else."""
    opts = td.SolverOptions(backpass_method="kernel",
                            linesearch_method="kernel")
    if "mesh" in kw:
        with pytest.raises(TypeError, match="DeviceMesh"):
            td.StepwiseSolver(tcar.car_parking(), opts, device="cpu", **kw)
        return
    s = td.StepwiseSolver(tcar.car_parking(), opts, device="cpu", **kw)
    assert s.pipeline_depth == kw["pipeline_depth"]


def test_status_codes_and_solution_fields_match():
    for name in dir(jd):
        if name.startswith("STATUS_"):
            assert getattr(td, name) == getattr(jd, name), name
    assert td.Solution._fields == jd.Solution._fields
