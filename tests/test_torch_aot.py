"""AOT export and load of the port's solver (``aot.py``): the cases of
``tests/test_aot.py``, each restored solve held against the port's direct
solve (every field bit for bit) and against the JAX package's
``aot``-restored solve at that test's tolerances (cost rtol 1e-12, ``us``
at ``assert_allclose``'s default, iterations equal), and an artifact
loaded and solved in a subprocess that never imports the problem's
module.  The kernel path's configuration is in
``test_torch_aot_kernels.py``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ddp_generator_tpu as jd
from ddp_generator_tpu import aot as jaot
from ddp_generator_tpu.models import brachistochrone as jbrachi
from ddp_generator_tpu.models import car_parking as jcar
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch import aot
from ddp_generator_tpu_torch.models import brachistochrone, car_parking

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(T=16):
    problem = car_parking.car_parking()
    p, x0, u0 = car_parking.default_setup(T=T, seed=0)
    return problem, p, np.asarray(x0), np.asarray(u0)


def _opts(mod, **kw):
    return mod.SolverOptions(dtype="float64", **kw)


def _equal(got, want):
    for name, a, b in zip(td.Solution._fields, got, want):
        assert torch.equal(a, b), name


def _like_jax(got, want):
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=1e-12)
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))


def test_roundtrip_single_instance():
    problem, p, x0, u0 = _setup()
    blob = aot.export_solver(problem, _opts(td, max_iter=3),
                             horizon=u0.shape[0], params=p)
    assert isinstance(blob, bytes) and len(blob) > 0
    got = aot.load_solver(blob, device="cpu")(x0, u0, p)
    _equal(got, td.solve(problem, x0, u0, p, _opts(td, max_iter=3),
                         device="cpu"))
    ref = jaot.load_solver(jaot.export_solver(
        jcar.car_parking(), _opts(jd, max_iter=3), horizon=u0.shape[0],
        params=p))(x0, u0, p)
    _like_jax(got, ref)


def test_symbolic_batch_dim():
    problem, p, x0, u0 = _setup(T=8)
    blob = aot.export_solver(problem, _opts(td, max_iter=2), horizon=8,
                             params=p, batch="B")
    restored = aot.load_solver(blob, device="cpu")
    jrestored = jaot.load_solver(jaot.export_solver(
        jcar.car_parking(), _opts(jd, max_iter=2), horizon=8, params=p,
        batch="B"))
    for B in (1, 3):
        x0s = np.tile(x0, (B, 1))
        u0s = np.tile(u0, (B, 1, 1))
        got = restored(x0s, u0s, p)
        assert got.cost.shape == (B,)
        _equal(got, td.make_batched_solver(problem, _opts(td, max_iter=2),
                                           device="cpu")(x0s, u0s, p))
        _like_jax(got, jrestored(x0s, u0s, p))


def test_save_solver_incremental(tmp_path):
    problem = brachistochrone.brachistochrone()
    p, x0, u0 = brachistochrone.default_setup(n=4)
    o = _opts(td, max_iter=2)
    path = str(tmp_path / "brachi.ddpexe")
    assert aot.save_solver(path, problem, o, horizon=u0.shape[0], params=p)
    # an artifact already there is kept (make_iLQG.m:30-37)
    assert not aot.save_solver(path, problem, o, horizon=u0.shape[0],
                               params=p)
    assert aot.save_solver(path, problem, o, horizon=u0.shape[0], params=p,
                           force=True)
    got = aot.load_solver_file(path, device="cpu")(x0, u0, p)
    _equal(got, td.solve(problem, x0, u0, p, o, device="cpu"))
    jpath = str(tmp_path / "brachi_jax.ddpexe")
    jaot.save_solver(jpath, jbrachi.brachistochrone(), _opts(jd, max_iter=2),
                     horizon=u0.shape[0], params=p)
    _like_jax(got, jaot.load_solver_file(jpath)(x0, u0, p))


def test_shape_mismatch_rejected():
    """Wrong shapes and dtypes raise, as iLQG_mex.c:39-43 and JAX's
    restored call do."""
    problem, p, x0, u0 = _setup(T=8)
    restored = aot.load_solver(aot.export_solver(
        problem, _opts(td, max_iter=1), horizon=8, params=p), device="cpu")
    bad_u = np.zeros((9, 2))
    with pytest.raises(ValueError, match="shape"):
        restored(x0, bad_u, p)
    with pytest.raises(ValueError, match="dtype"):
        restored(x0.astype(np.float32), u0, p)
    with pytest.raises(ValueError, match="limW"):
        restored(x0, u0, dict(p, limW=np.zeros(3)))
    jrestored = jaot.load_solver(jaot.export_solver(
        jcar.car_parking(), _opts(jd, max_iter=1), horizon=8, params=p))
    with pytest.raises(Exception):
        np.asarray(jrestored(x0, bad_u, p).cost)


def test_symbolic_batch_with_kernels_rejected():
    problem, p, x0, u0 = _setup()
    for kw in (dict(backpass_method="kernel"), dict(backpass_method="fused"),
               dict(linesearch_method="kernel")):
        with pytest.raises(ValueError, match="symbolic"):
            aot.export_solver(problem, td.SolverOptions(max_iter=2, **kw),
                              horizon=u0.shape[0], params=p, batch="B")
    with pytest.raises(ValueError, match="symbolic"):
        jaot.export_solver(jcar.car_parking(),
                           jd.SolverOptions(max_iter=2,
                                            backpass_method="pallas"),
                           horizon=u0.shape[0], params=p, batch="B")


LOADER = """
import sys
import numpy as np
sys.path.insert(0, {root!r})
from ddp_generator_tpu_torch import aot, to_numpy
d = np.load({inputs!r}, allow_pickle=True)
params = d["params"].item()
sol = aot.load_solver_file({path!r}, device="cpu")(d["x0s"], d["u0s"], params)
np.savez({out!r}, **{{k: to_numpy(v) for k, v in sol._asdict().items()}})
bad = sorted(m for m in sys.modules if m.startswith(
    ("ddp_generator_tpu_torch.models", "ddp_generator_tpu.")))
assert not bad, bad
"""


def load_in_subprocess(tmp_path, blob: bytes, x0s, u0s, p) -> dict:
    """Solve with the artifact in a fresh process that imports only the
    port's ``aot`` (no problem module, nothing of the JAX package); its
    Solution fields."""
    path, inputs, out = (str(tmp_path / n) for n in
                         ("solver.ddpexe", "inputs.npz", "out.npz"))
    with open(path, "wb") as fh:
        fh.write(blob)
    np.savez(inputs, x0s=x0s, u0s=u0s,
             params=np.array(dict(p), dtype=object))
    code = LOADER.format(root=ROOT, inputs=inputs, path=path, out=out)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(out))


def test_load_in_a_process_without_the_problem_module(tmp_path):
    problem, p, x0, u0 = _setup(T=10)
    o = _opts(td, max_iter=3)
    rng = np.random.default_rng(2)
    x0s = np.tile(x0, (4, 1))
    u0s = 0.1 * rng.standard_normal((4, 10, 2))
    got = load_in_subprocess(tmp_path, aot.export_solver(
        problem, o, horizon=10, params=p, batch=4), x0s, u0s, p)
    want = td.make_batched_solver(problem, o, device="cpu")(x0s, u0s, p)
    for name in td.Solution._fields:
        np.testing.assert_array_equal(got[name],
                                      td.to_numpy(getattr(want, name)),
                                      err_msg=name)
