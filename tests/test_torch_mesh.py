"""The batch mesh over ``torch.distributed`` (``parallel/mesh.py``,
``StepwiseSolver(mesh=...)``): the port of ``tests/test_multiprocess.py``
and ``tests/test_mesh_stepwise.py``.

Two real processes (``tests/torch_mesh_worker.py``, ``gloo`` on localhost)
solve one global batch; their rows, put back together, are held against
the JAX package's batched solve (cost rtol 1e-10, and 1e-6 for the kernel
path's plain versions, as JAX's test) and against the port's unmeshed
solves (integers exact, floats rtol 1e-12).  Rank 0 emits another
problem's bundle first, so the two processes' histories differ.  Every
collective of the meshed StepwiseSolver is recorded: exactly one ``int64``
scalar all-reduce per chunk (the port's form of
``test_mesh_chunk_program_has_no_collectives``).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import ddp_generator_tpu as jd
from ddp_generator_tpu.models import brachistochrone as jbrachi
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.parallel import mesh as pmesh

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_worker as worker  # noqa: E402

WORLD = 2
INT_FIELDS = ("success", "iterations", "status", "log_linesearch",
              "body_calls", "stale_calls", "bp_retry_calls")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The two ranks, started (the JAX reference compiles meanwhile)."""
    out = tmp_path_factory.mktemp("mesh")
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"),
         str(r), str(WORLD), port, str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(WORLD)]
    yield procs, out
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def ranks(launched):
    procs, out = launched
    for p in procs:
        o, e = p.communicate(timeout=240)
        assert p.returncode == 0, (
            f"rank failed:\n{o.decode()[-2000:]}\n{e.decode()[-3000:]}")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _global(ranks, key):
    """A field of every rank's rows, put back in place."""
    parts = sorted(((int(r["start"]), int(r["stop"]), r[key])
                    for r in ranks), key=lambda t: t[0])
    assert parts[0][0] == 0 and all(a[1] == b[0]
                                    for a, b in zip(parts, parts[1:]))
    return np.concatenate([v for _, _, v in parts])


def _same(got: dict, want, what):
    for name in want._fields:
        w = td.to_numpy(getattr(want, name))
        g = got[name]
        assert g.shape == w.shape, (what, name)
        if name in INT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12,
                                       err_msg=f"{what} {name}")


def _solution(ranks, prefix):
    return {name: _global(ranks, f"{prefix}_{name}")
            for name in td.Solution._fields}


@pytest.fixture(scope="module")
def jax_cost(launched):
    p, x0s, u0s = worker.setup()
    o = jd.SolverOptions(max_iter=15, w_pen_init_f=40.0, w_pen_fact2=2.0,
                         full_ddp=False)
    sol = jd.make_batched_solver(jbrachi.brachistochrone(), o)(x0s, u0s, p)
    return np.asarray(sol.cost)


def test_sharded_and_meshed_stepwise_match_jax(jax_cost, ranks):
    assert [int(r["start"]) for r in ranks] == [0, 4]
    np.testing.assert_allclose(_global(ranks, "sharded_cost"), jax_cost,
                               rtol=1e-10)
    np.testing.assert_allclose(_global(ranks, "stepwise_cost"), jax_cost,
                               rtol=1e-6)


def test_meshed_equals_unmeshed_port(ranks):
    """Each rank's rows equal the single-process solves of the port:
    make_batched_solver, StepwiseSolver, and the CarParking StepwiseSolver
    with per-rank compaction and a late count against the unmeshed one
    with the synchronous read."""
    problem = td.brachistochrone.brachistochrone()
    p, x0s, u0s = worker.setup()
    want = td.make_batched_solver(problem, worker.options(),
                                  device="cpu")(x0s, u0s, p)
    _same(_solution(ranks, "sharded"), want, "make_sharded_solver")
    want = td.StepwiseSolver(problem, worker.stepwise_options(), chunk=4,
                             compact_levels=1, min_compact_batch=2,
                             device="cpu")(x0s, u0s, p)
    _same(_solution(ranks, "stepwise"), want, "StepwiseSolver(mesh)")
    cp, cp_p, cp_x0s, cp_u0s = worker.car_setup()
    want = td.StepwiseSolver(cp, worker.car_options(), chunk=3,
                             compact_levels=1, min_compact_batch=4,
                             device="cpu")(cp_x0s, cp_u0s, cp_p)
    got = _solution(ranks, "car")
    _same(got, want, "CarParking StepwiseSolver(mesh)")
    # lanes of different lengths, and each rank compacted its own width
    assert len(set(got["iterations"].tolist())) > 2
    for r in ranks:
        assert r["car_widths"].tolist() == [8, 4]


def test_meshed_per_lane_params_with_compaction(ranks):
    """batch_params=True: each rank takes its rows of every param leaf and
    re-gathers them on its compaction."""
    cp, cp_p, cp_x0s, cp_u0s = worker.car_setup()
    want = td.StepwiseSolver(cp, worker.car_options(), chunk=3,
                             batch_params=True, compact_levels=1,
                             min_compact_batch=4, device="cpu")(
        cp_x0s, cp_u0s, worker.car_lane_params(cp_p))
    got = _solution(ranks, "lanes")
    _same(got, want, "per-lane StepwiseSolver(mesh)")
    limw = worker.car_lane_params(cp_p)["limW"]
    assert (np.abs(got["us"][..., 0]) <= limw[:, 1:] + 1e-12).all()
    # rank 0 holds the straggler (lane 6, 19 iterations) and compacts
    assert [r["lanes_widths"].tolist() for r in ranks] == [[8, 4], [8]]


def test_batch_stats_over_the_mesh(ranks):
    problem = td.brachistochrone.brachistochrone()
    p, x0s, u0s = worker.setup()
    sol = td.make_batched_solver(problem, worker.options(),
                                 device="cpu")(x0s, u0s, p)
    want = pmesh.batch_stats(sol)
    for r in ranks:
        assert int(r["stats_n_success"]) == int(want.n_success) == 8
        assert int(r["stats_n_instances"]) == 8
        np.testing.assert_allclose(r["stats_mean_cost"],
                                   float(want.mean_cost), rtol=1e-12)
        np.testing.assert_allclose(r["stats_mean_iterations"],
                                   float(want.mean_iterations), rtol=1e-12)
        np.testing.assert_allclose(r["stats_max_g_norm"],
                                   float(want.max_g_norm), rtol=1e-12)


@pytest.mark.parametrize("solve", ["", "car_"])
def test_one_int64_scalar_allreduce_per_chunk(ranks, solve):
    counts = [r[f"{solve}global_counts"].tolist() for r in ranks]
    assert counts[0] == counts[1] and counts[0][-1] == 0
    for r in ranks:
        calls = r[f"{solve}collectives"].tolist()
        assert calls == ["all_reduce:1:torch.int64"] * len(calls)
        assert len(calls) == int(r[f"{solve}allreduces"]) == int(
            r[f"{solve}chunks"]) == len(counts[0])
    assert all(bool(r["indivisible_raises"]) for r in ranks)


def test_world_of_one_mesh():
    """With no process group, make_mesh makes a world of one; the meshed
    solvers then equal the unmeshed ones, and shard_range places the
    whole batch."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        mesh = pmesh.make_mesh(device_type="cpu")
        assert mesh.size() == 1 and pmesh.shard_range(mesh, 5) == (0, 5)
        with pytest.raises(ValueError):
            pmesh.make_mesh([1], device_type="cpu")
        problem = td.brachistochrone.brachistochrone()
        p, x0s, u0s = worker.setup(n=12, B=3)
        sol, stats = pmesh.make_sharded_solver(
            problem, worker.options(), mesh=mesh, device="cpu")(x0s, u0s, p)
        want = td.make_batched_solver(problem, worker.options(),
                                      device="cpu")(x0s, u0s, p)
        for a, b in zip(sol, want):
            assert torch.equal(a, b)
        assert int(stats.n_instances) == 3
        s = td.StepwiseSolver(problem, worker.stepwise_options(), chunk=4,
                              mesh=mesh, device="cpu")
        got = s(x0s, u0s, p)
        want = td.StepwiseSolver(problem, worker.stepwise_options(), chunk=4,
                                 device="cpu")(x0s, u0s, p)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert s.last_stats.allreduces == s.last_stats.chunks > 0
    finally:
        dist.destroy_process_group()
