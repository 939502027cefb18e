"""AOT export of the kernel path's configuration (``aot.py``): the bench
configuration (``backpass_method="kernel"`` and the kernel line search,
here their plain versions) at a fixed batch, restored and held against
the port's direct solve bit for bit and against the JAX package's
``aot``-restored Pallas configuration (cost rtol 1e-6, the hold of
``test_torch_solver.py`` on the kernel path against JAX's Pallas one:
``pallas_math`` substitutes transcendentals); and the same configuration
of CarParking with its hand-written CUDA model stripped, whose artifact
carries the generated model's header and loads in a process that never
imports the problem's module."""

import dataclasses

import numpy as np
import torch

import ddp_generator_tpu as jd
from ddp_generator_tpu import aot as jaot
from ddp_generator_tpu.models import car_parking as jcar
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch import aot, codegen
from ddp_generator_tpu_torch.models import car_parking
from test_torch_aot import load_in_subprocess


def _inputs(B=3, T=16):
    p, x0, u0 = car_parking.default_setup(T=T, seed=0)
    rng = np.random.default_rng(0)
    return (p, np.tile(np.asarray(x0), (B, 1)),
            0.1 * rng.standard_normal((B,) + np.shape(u0)))


def _opts(mod, method):
    return mod.SolverOptions(max_iter=4, dtype="float64",
                             backpass_method=method,
                             linesearch_method=method)


def test_roundtrip_bench_configuration_fixed_batch():
    problem = car_parking.car_parking()
    p, x0s, u0s = _inputs()
    o = _opts(td, "kernel")
    blob = aot.export_solver(problem, o, horizon=16, params=p, batch=3)
    got = aot.load_solver(blob, device="cpu")(x0s, u0s, p)
    want = td.make_batched_solver(problem, o, device="cpu")(x0s, u0s, p)
    for name, a, b in zip(td.Solution._fields, got, want):
        assert torch.equal(a, b), name
    ref = jaot.load_solver(jaot.export_solver(
        jcar.car_parking(), _opts(jd, "pallas"), horizon=16, params=p,
        batch=3))(x0s, u0s, p)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-6)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))


def test_generated_model_artifact_loads_without_the_problem(tmp_path):
    problem = dataclasses.replace(car_parking.car_parking(), cuda_model=None)
    p, x0s, u0s = _inputs(B=2, T=9)
    o = _opts(td, "kernel")
    blob = aot.export_solver(problem, o, horizon=9, params=p, batch=2)
    # the artifact carries the generated model (no tracing at load)
    restored = aot.load_solver(blob, device="cpu")
    assert restored.problem.cuda_model == codegen.model_for(problem, p)
    got = load_in_subprocess(tmp_path, blob, x0s, u0s, p)
    want = td.make_batched_solver(problem, o, device="cpu")(x0s, u0s, p)
    for name in td.Solution._fields:
        np.testing.assert_array_equal(got[name],
                                      td.to_numpy(getattr(want, name)),
                                      err_msg=name)
