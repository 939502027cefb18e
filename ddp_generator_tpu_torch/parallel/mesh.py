"""Batch data parallelism over ``torch.distributed``
(``ddp_generator_tpu.parallel.mesh``).

The reference is one instance per process (``iLQG_mex.c:19-144``); the
JAX package shards the instance batch of its ``vmap``-ed solver over a
1-D device mesh.  Here the idiom is torch's: one process per card (or
several sharing one), a 1-D :class:`~torch.distributed.device_mesh.
DeviceMesh` over the world, and every rank solving its own contiguous
slice of the global batch with the single-device machinery.  Instances
are independent, so nothing of a solve crosses processes except host
scalars: the convergence statistics (:func:`batch_stats`) and, in
:class:`~..solver.StepwiseSolver` with a mesh, one ``int64`` all-reduce of
the active count per chunk.  Those run on a ``gloo`` group of the same
ranks (:func:`host_group`), so the card's stream never waits on a
collective and two ranks can share one card.

Every rank passes the GLOBAL inputs, as the JAX package's single-
controller view does; rank ``r`` of ``W`` takes rows ``[r*B/W,
(r+1)*B/W)`` (:func:`shard_range`) and returns its own rows of the
Solution.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..options import SolverOptions
from ..problem import Problem
from ..solution import Solution
from ..solver import make_batched_solver

Tensor = torch.Tensor

BATCH_AXIS = "batch"

# a mesh's own (non-gloo) group -> the gloo group of the same ranks
_HOST_GROUPS: dict = {}


def multihost_initialize(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None, **kwargs) -> None:
    """``torch.distributed.init_process_group`` with JAX's keywords
    (``jax.distributed.initialize``): ``coordinator_address`` ``"host:port"``
    becomes ``init_method="tcp://host:port"``, ``num_processes`` the
    ``world_size`` and ``process_id`` the ``rank``; torch's own keywords
    pass through.  ``backend`` defaults to ``"nccl"`` when each rank of
    this host has its own card (``LOCAL_WORLD_SIZE``, else the world, at
    most the cards), and to ``"gloo"`` otherwise; with ``"nccl"`` each rank
    takes card ``LOCAL_RANK`` (else ``rank %`` the cards)."""
    if coordinator_address is not None:
        kwargs.setdefault("init_method", f"tcp://{coordinator_address}")
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    world = int(kwargs.get("world_size", os.environ.get("WORLD_SIZE", 1)))
    rank = int(kwargs.get("rank", os.environ.get("RANK", 0)))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = "nccl" if 0 < local <= cards else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % cards)))
    dist.init_process_group(backend=backend, **kwargs)


def make_mesh(devices: Optional[Sequence[int]] = None,
              axis: str = BATCH_AXIS, *,
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the world's ranks (``devices``: None, or the ranks
    ``0..W-1`` in order) with ``mesh_dim_names=(axis,)``.  With no process
    group yet it makes a world of one (a ``HashStore``, rank 0), as the
    JAX package's mesh works without ``jax.distributed``.  Device type
    ``"cuda"`` unless the caller asks for ``"cpu"``.  Also makes the mesh's
    ``gloo`` group for host scalars (:func:`host_group`); every rank must
    call it, in the same order as its other group creations."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r)
                                                        for r in devices]
    if ranks != list(range(world)):
        raise ValueError(f"make_mesh: the mesh spans the world's ranks "
                         f"0..{world - 1} in order, got {ranks}")
    mesh = DeviceMesh(device_type, torch.tensor(ranks),
                      mesh_dim_names=(axis,))
    host_group(mesh, axis)
    return mesh


def host_group(mesh: DeviceMesh, axis: str = BATCH_AXIS):
    """The ``gloo`` group of the mesh's ranks that carries host scalars:
    the mesh's own group when that is ``gloo``, else one made once."""
    g = mesh.get_group(axis)
    if dist.get_backend(g) == "gloo":
        return g
    if g not in _HOST_GROUPS:
        _HOST_GROUPS[g] = dist.new_group(ranks=mesh.mesh.flatten().tolist(),
                                         backend="gloo")
    return _HOST_GROUPS[g]


def shard_range(mesh: DeviceMesh, B: int,
                axis: str = BATCH_AXIS) -> tuple[int, int]:
    """The rows ``[start, stop)`` of a global batch of ``B`` this rank
    solves; raises ``ValueError`` unless the mesh's size divides ``B``."""
    W, r = mesh.size(), mesh.get_local_rank(axis)
    if B % W:
        raise ValueError(f"batch {B} is not divisible by the mesh size {W}")
    n = B // W
    return r * n, (r + 1) * n


def local_rows(a, start: int, stop: int):
    """Rows ``[start, stop)`` of a global array or tensor."""
    return a[start:stop] if isinstance(a, Tensor) else np.asarray(a)[
        start:stop]


class BatchStats(NamedTuple):
    """Convergence statistics over the global batch (0-d tensors on the
    host: counts ``int64``, the rest ``float64``)."""

    n_success: Tensor
    n_instances: Tensor
    mean_cost: Tensor
    mean_iterations: Tensor
    max_g_norm: Tensor


def batch_stats(sol: Solution, mesh: Optional[DeviceMesh] = None,
                axis: str = BATCH_AXIS) -> BatchStats:
    """:class:`BatchStats` of ``sol``'s lanes, or with ``mesh`` of every
    rank's lanes together: one all-reduce of the packed sums and one of
    the maximum, on the mesh's host group."""
    f64 = torch.float64
    sums = torch.stack([
        sol.success.to(f64).sum(), torch.tensor(float(sol.cost.shape[0]),
                                                dtype=f64,
                                                device=sol.cost.device),
        sol.cost.to(f64).sum(), sol.iterations.to(f64).sum()]).cpu()
    top = sol.g_norm.to(f64).max().reshape(1).cpu()
    if mesh is not None:
        g = host_group(mesh, axis)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=g)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
    n = sums[1]
    return BatchStats(n_success=sums[0].to(torch.int64),
                      n_instances=n.to(torch.int64), mean_cost=sums[2] / n,
                      mean_iterations=sums[3] / n, max_g_norm=top[0])


def make_sharded_solver(problem: Problem,
                        options: SolverOptions = SolverOptions(),
                        mesh: Optional[DeviceMesh] = None,
                        batch_params: bool = False, axis: str = BATCH_AXIS,
                        *, device):
    """Batched solver with the instance axis sharded over the mesh:
    ``(x0s (B, n_x), u0s (B, N, n_u), params) -> (Solution, BatchStats)``.

    Every rank passes the global batch; rank ``r`` solves its rows
    (:func:`shard_range`; a ``B`` the mesh does not divide raises
    ``ValueError``) with :func:`~..solver.make_batched_solver` on
    ``device`` (on a card one CUDA graph, its loop a WHILE node) and
    returns its own rows of the Solution.  With
    ``batch_params`` each rank takes its rows of every param leaf; shared
    params are used whole.  The statistics are over the global batch."""
    if mesh is None:
        mesh = make_mesh(axis=axis, device_type=torch.device(device).type)
    solve = make_batched_solver(problem, options, batch_params, device=device)

    def fn(x0s, u0s, params: Any):
        start, stop = shard_range(mesh, len(u0s), axis)
        if batch_params:
            params = {k: local_rows(v, start, stop)
                      for k, v in params.items()}
        sol = solve(local_rows(x0s, start, stop),
                    local_rows(u0s, start, stop), params)
        return sol, batch_stats(sol, mesh, axis)

    return fn


def all_reduce_count(count: int, mesh: DeviceMesh,
                     axis: str = BATCH_AXIS) -> int:
    """The sum over the mesh of one ``int64`` host scalar (the active
    count of :class:`~..solver.StepwiseSolver`'s chunk), on the host
    group."""
    t = torch.tensor(int(count), dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=host_group(mesh, axis))
    return int(t)
