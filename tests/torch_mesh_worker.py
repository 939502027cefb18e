"""One rank of the two-process ``torch.distributed`` run of
``test_torch_mesh.py`` (the port's ``mp_worker.py``).

    python tests/torch_mesh_worker.py RANK WORLD PORT OUT_DIR

Joins a ``gloo`` world on localhost through
``parallel.mesh.multihost_initialize``, makes the mesh on the CPU and
solves the global Brachistochrone batch (n=30, B=8, max_iter 15, float64)
twice: ``make_sharded_solver`` (eager batched solve of this rank's rows)
and ``StepwiseSolver(mesh=...)`` on the kernel path's plain versions;
then CarParking (T=30, B=16, max_iter 25, float64, lanes of 8 to 13
iterations) through ``StepwiseSolver(mesh=...)`` with per-rank
compaction and the active count read one chunk late
(``pipeline_depth=2``), and again with every param per lane
(``batch_params=True``, ``limW`` varying).  Rank 0 first emits a
CarParking bundle, so the two processes' histories differ.  Every
collective call is recorded.  Writes this rank's rows of every Solution,
the statistics and the record to ``OUT_DIR/rank{RANK}.npz``.  Imports no
JAX.
"""

import os
import sys

import numpy as np


def setup(n=30, B=8):
    from ddp_generator_tpu_torch.models import brachistochrone

    p, x0, _ = brachistochrone.default_setup(n)
    rng = np.random.default_rng(0)
    x0s = np.tile(np.asarray(x0), (B, 1))
    u0s = -np.abs(rng.uniform(0.5, 1.5, (B, n, 1)))
    return p, x0s, u0s


def options(**kw):
    import ddp_generator_tpu_torch as ddp

    return ddp.SolverOptions(max_iter=15, w_pen_init_f=40.0,
                             w_pen_fact2=2.0, full_ddp=False, **kw)


def stepwise_options():
    return options(backpass_method="kernel", linesearch_method="kernel",
                   debug_level=0)


def car_setup(B=16, T=30):
    from ddp_generator_tpu_torch.models import car_parking

    p, x0, _ = car_parking.default_setup(T=T, seed=0)
    rng = np.random.default_rng(1)
    x0s = np.tile(np.asarray(x0), (B, 1)) + 0.5 * rng.standard_normal((B, 4))
    u0s = rng.uniform(0.05, 1.0, (B, 1, 1)) * rng.standard_normal((B, T, 2))
    return car_parking.car_parking(), p, x0s, u0s


def car_lane_params(p, B=16):
    """Every CarParking param per lane (``batch_params=True``), ``limW``
    from +-0.3 to +-0.5 over the lanes."""
    out = {k: np.tile(np.asarray(v, dtype=np.float64)[None],
                      (B,) + (1,) * np.ndim(v)) for k, v in p.items()}
    out["limW"] = np.linspace(0.3, 0.5, B)[:, None] * np.array([-1.0, 1.0])
    return out


def car_options():
    import ddp_generator_tpu_torch as ddp

    return ddp.SolverOptions(max_iter=25, backpass_method="kernel",
                             linesearch_method="kernel", debug_level=0)


def record_collectives(dist):
    """Wrap the collectives: ``calls`` lists ``(name, numel, dtype)``."""
    calls = []
    names = ("all_reduce", "broadcast", "all_gather",
             "all_gather_into_tensor",
             "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
             "all_to_all_single", "reduce", "gather", "scatter", "send",
             "recv", "barrier")
    for name in names:
        fn = getattr(dist, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            t = args[0] if args and hasattr(args[0], "numel") else None
            calls.append((_name, -1 if t is None else t.numel(),
                          "" if t is None else str(t.dtype)))
            return _fn(*args, **kwargs)

        setattr(dist, name, wrapped)
    return calls


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import torch
    import torch.distributed as dist

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.models import brachistochrone, car_parking
    from ddp_generator_tpu_torch.ops.cm_derivs import cm_emit
    from ddp_generator_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    if rank == 0:
        # another history: a CarParking emission before any solve
        cp = car_parking.car_parking()
        B, T = 3, 7
        xs = torch.randn(B, T + 1, 4, dtype=torch.float64)
        us = torch.randn(B, T, 2, dtype=torch.float64)
        z = lambda *s: torch.zeros(s, dtype=torch.float64)
        cm_emit(cp, xs, us, z(B, T, 0), z(B, T, 0), z(B, 0), z(B, 0),
                1 + z(B), 1 + z(B),
                ddp.params_from_jax(car_parking.default_params(),
                                    torch.float64, "cpu"), True)
    pmesh.multihost_initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=world, process_id=rank)
    assert dist.get_backend() == "gloo"
    mesh = pmesh.make_mesh(device_type="cpu")
    assert mesh.size() == world and mesh.mesh_dim_names == ("batch",)

    problem = brachistochrone.brachistochrone()
    p, x0s, u0s = setup()
    B = len(u0s)
    start, stop = pmesh.shard_range(mesh, B)
    try:
        pmesh.shard_range(mesh, B - 1)
        indivisible_raises = False
    except ValueError:
        indivisible_raises = True

    sharded = pmesh.make_sharded_solver(problem, options(), mesh=mesh,
                                        device="cpu")
    sol, stats = sharded(x0s, u0s, p)

    calls = record_collectives(dist)
    stepwise = ddp.StepwiseSolver(problem, stepwise_options(), chunk=4,
                                  compact_levels=1, min_compact_batch=2,
                                  mesh=mesh, device="cpu")
    sol2 = stepwise(x0s, u0s, p)
    s = stepwise.last_stats
    n_calls = len(calls)
    cp, cp_p, cp_x0s, cp_u0s = car_setup()
    car = ddp.StepwiseSolver(cp, car_options(), chunk=3, compact_levels=1,
                             min_compact_batch=4, mesh=mesh,
                             pipeline_depth=2, device="cpu")
    sol3 = car(cp_x0s, cp_u0s, cp_p)
    c = car.last_stats
    n_car = len(calls)
    lanes = ddp.StepwiseSolver(cp, car_options(), chunk=3, batch_params=True,
                               compact_levels=1, min_compact_batch=4,
                               mesh=mesh, device="cpu")
    sol4 = lanes(cp_x0s, cp_u0s, car_lane_params(cp_p))
    out_np = {f"sharded_{k}": ddp.to_numpy(v)
              for k, v in sol._asdict().items()}
    out_np.update({f"stepwise_{k}": ddp.to_numpy(v)
                   for k, v in sol2._asdict().items()})
    out_np.update({f"car_{k}": ddp.to_numpy(v)
                   for k, v in sol3._asdict().items()})
    out_np.update({f"lanes_{k}": ddp.to_numpy(v)
                   for k, v in sol4._asdict().items()})
    out_np.update({f"stats_{k}": float(v)
                   for k, v in stats._asdict().items()})
    np.savez(os.path.join(out, f"rank{rank}.npz"), start=start, stop=stop,
             indivisible_raises=indivisible_raises, chunks=s.chunks,
             allreduces=s.allreduces,
             global_counts=np.asarray(s.global_counts),
             car_widths=np.asarray(car.last_stats.eager),
             lanes_widths=np.asarray(lanes.last_stats.eager),
             collectives=np.asarray([f"{n}:{k}:{d}"
                                     for n, k, d in calls[:n_calls]]),
             car_chunks=c.chunks, car_allreduces=c.allreduces,
             car_global_counts=np.asarray(c.global_counts),
             car_collectives=np.asarray([f"{n}:{k}:{d}"
                                         for n, k, d in
                                         calls[n_calls:n_car]]),
             **out_np)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
