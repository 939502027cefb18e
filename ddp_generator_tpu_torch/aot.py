"""Ahead-of-time export: a solver in one artifact, loaded without the
problem's Python module (``ddp_generator_tpu.aot``).

The reference builds ``iLQG<Problem>.<mexext>`` once (Maxima codegen and
``mex``, ``make_iLQG.m:43-96``) and later runs load the binary; the
JAX package serializes its jitted solver as StableHLO.  A CUDA graph
cannot be serialized, so the port's artifact is its own format, not
interchangeable with JAX's: one zip holding

* ``meta.json``: the format version, the options (their fields, restored
  with :func:`~.options.options_from_dict`), ``n_x``, ``n_u``, the
  horizon, the param spec (key, shape, dtype of every leaf as the solver
  casts it), ``batch`` (``None``, an int, or the symbolic ``"B"``), the
  dtype, the device types it may load on (``platforms``), ``box_meta``
  and the CUDA model's description;
* ``programs/<platform>/<function>/<signature>.pt2``: each of ``f``,
  ``L``, ``F`` and the ``h``, ``hle``, ``hli``, ``hfe``, ``hfi`` lists as a
  ``torch.export`` program (``torch.export.save`` bytes), one per call
  signature the solver uses (:data:`SIGNATURES`), with the lane axis and
  the step (or alpha) axis dynamic;
* ``model.cuh``: for the kernel and fused paths, the CUDA model's header
  (hand-written, checked against this installation's at load, or the one
  ``codegen.generate_cuda_model`` wrote), so :func:`load_solver` builds
  the kernels at first use without tracing anything.

:func:`load_solver` rebuilds a :class:`~.problem.Problem` from the
exported programs and wraps :func:`~.solver.make_solver` (``batch=None``)
or :func:`~.solver.make_batched_solver` in the shape and dtype checks of
``iLQG_mex.c:39-43``.  Like the JAX artifact it is bound to the problem,
the options, the horizon, the params' shapes and dtypes and the batch;
``batch_params=True`` is not exported (JAX: ``in_axes=(0, 0, None)``).
:func:`save_solver` skips an existing artifact unless ``force``
(``make_iLQG.m:30-37``).
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import time
import zipfile
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np
import torch

from . import codegen
from .convert import to_torch
from .options import SolverOptions, options_from_dict
from .problem import CudaModel, Problem, make_problem
from .solver import _DTYPES, make_batched_solver, make_solver

Tensor = torch.Tensor

FORMAT_VERSION = 1
#: Call signatures of the problem functions: ``point`` ``x (n,)``, ``lane``
#: ``x (n, W)`` with a scalar step, ``plane`` ``x (n, M, W)`` with ``k (M,
#: 1)`` (emission, multipliers, ``cost_only``), ``sweep`` ``x (n, M, W)``
#: with a scalar step (the multi-alpha rollout's plain version).  The
#: final-stage functions (no ``u``) have no ``plane`` call.
SIGNATURES = ("point", "lane", "plane", "sweep")
_FAMILIES = ("h", "hle", "hli", "hfe", "hfi")
_NO_U = ("F", "hfe", "hfi")
_MODELS_DIR = Path(__file__).resolve().parent / "csrc" / "models"
# example sizes of the dynamic axes at export (any size >= 1 is served)
_W_EXAMPLE, _M_EXAMPLE = 7, 5


class _Fn(torch.nn.Module):
    def __init__(self, fn, has_u: bool):
        super().__init__()
        self.fn, self.has_u = fn, has_u

    def forward(self, x, u, p, k):
        return self.fn(x, u, p, k) if self.has_u else self.fn(x, p, k)


def _functions(problem: Problem) -> list:
    """``[(name, fn, has_u)]``: ``f``, ``L``, ``F``, then ``h0``, ...,
    ``hle0``, ..."""
    out = [("f", problem.f, True), ("L", problem.L, True),
           ("F", problem.F, False)]
    for fam in _FAMILIES:
        out += [(f"{fam}{i}", fn, fam not in _NO_U)
                for i, fn in enumerate(getattr(problem, fam))]
    return out


def _signatures(has_u: bool) -> tuple:
    return SIGNATURES if has_u else ("point", "lane", "sweep")


# (function, has_u, signature, n_x, n_u, param spec, dtype, device type)
# -> saved program: a process exporting one problem twice exports once
_PROGRAMS: dict = {}


def _export_one(fn, has_u: bool, sig: str, n_x: int, n_u: int, p: dict,
                dtype, device) -> bytes:
    """One problem function at one call signature, exported and saved
    (once per process for the same function, signature and spec)."""
    key = (fn, has_u, sig, n_x, n_u, dtype, device.type,
           tuple((k, tuple(v.shape), v.dtype) for k, v in p.items()))
    if key not in _PROGRAMS:
        _PROGRAMS[key] = _export_new(fn, has_u, sig, n_x, n_u, p, dtype,
                                     device)
    return _PROGRAMS[key]


def _export_new(fn, has_u, sig, n_x, n_u, p, dtype, device) -> bytes:
    from torch.export import Dim, export

    W, M = Dim("W", min=1), Dim("M", min=1)
    mid = {"point": (), "lane": (_W_EXAMPLE,),
           "plane": (_M_EXAMPLE, _W_EXAMPLE),
           "sweep": (_M_EXAMPLE, _W_EXAMPLE)}[sig]
    dyn = {"point": None, "lane": {1: W}, "plane": {1: M, 2: W},
           "sweep": {1: M, 2: W}}[sig]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((n_x,) + mid, generator=gen, dtype=dtype).to(device)
    u = (torch.randn((n_u,) + mid, generator=gen, dtype=dtype).to(device)
         if has_u else torch.zeros((), dtype=dtype, device=device))
    k = (torch.arange(_M_EXAMPLE, device=device)[:, None] if sig == "plane"
         else torch.tensor(1, device=device))
    shapes = (dyn, dyn if has_u else None, {key: None for key in p},
              {0: M} if sig == "plane" else None)
    try:
        ep = export(_Fn(fn, has_u), (x, u, p, k), dynamic_shapes=shapes)
    except Exception as err:
        raise ValueError(
            f"export_solver: a problem function could not be exported at "
            f"its {sig!r} call ({type(err).__name__}: {err}); write it with "
            "torch operations on the component-first tensors, with no "
            "Python branch on values or on the step k") from err
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _param_spec(params: Any, dtype) -> tuple[dict, list]:
    """The params as the solver casts them (on the CPU) and their spec
    ``[[key, shape, dtype], ...]``; flat dicts of arrays only."""
    if not isinstance(params, dict) or any(isinstance(v, dict)
                                           for v in params.values()):
        raise ValueError("export_solver: params must be a flat dict of "
                         "arrays")
    p = to_torch(dict(params), dtype, torch.device("cpu"))
    return p, [[k, list(v.shape), str(v.dtype).replace("torch.", "")]
               for k, v in p.items()]


def _model_meta(problem: Problem, params) -> tuple[Optional[dict], str]:
    """The CUDA model the kernels run: its description and header."""
    model = problem.cuda_model
    if model is None:
        model = codegen.model_for(problem, params)
    if isinstance(model, codegen.GeneratedModel):
        return dict(kind="generated", name=model.name, struct=model.struct,
                    fixed=[[k, list(s)] for k, s in model.fixed],
                    tail=[[k, list(s)] for k, s in model.tail],
                    n_params=model.n_params, n_tail=model.n_tail), \
            model.header
    return (dict(kind="hand_written", name=model.name,
                 param_order=[list(e) for e in model.param_order]),
            _hand_written_header(model.name).read_text())


def _hand_written_header(name: str) -> Path:
    """The header under ``csrc/models`` that holds the model ``name``
    (the longest file stem that begins its name)."""
    found = [p for p in _MODELS_DIR.glob("*.cuh") if name.startswith(p.stem)]
    if not found:
        raise ValueError(f"no hand-written CUDA model header for {name!r}")
    return max(found, key=lambda p: len(p.stem))


def export_solver(problem: Problem, options: SolverOptions, horizon: int,
                  params: Any, batch: Optional[int | str] = None,
                  platforms: Optional[Sequence[str]] = None) -> bytes:
    """Export a solver for ``(x0, u0, params)`` of fixed shapes.

    * ``params``: example params (only keys, shapes and dtypes are used),
      the role of the reference's ``paramdesc[]`` (``iLQG_mex.c:70-84``);
    * ``batch``: None for a one-instance solver, an int for a fixed batch,
      a string such as ``"B"`` for any batch size (not with the kernels,
      as in the JAX package: ``ValueError`` matching ``"symbolic"``);
    * ``platforms``: device types the artifact may load on, from
      ``"cuda"`` and ``"cpu"``; default the CUDA device if there is one,
      else the CPU.  Each platform's programs are exported on it."""
    if batch is not None and not isinstance(batch, (int, str)):
        raise ValueError(f"batch must be None, an int or a symbolic name, "
                         f"got {batch!r}")
    kernels = (options.backpass_method in ("kernel", "fused")
               or options.linesearch_method == "kernel")
    if kernels and isinstance(batch, str):
        raise ValueError(
            "CUDA-kernel solvers cannot be exported with a symbolic batch "
            "dim; pass a fixed integer batch")
    plats = tuple(platforms) if platforms else (
        ("cuda",) if torch.cuda.is_available() else ("cpu",))
    for plat in plats:
        if plat not in ("cuda", "cpu"):
            raise ValueError(f"platforms must be from ('cuda', 'cpu'), got "
                             f"{plat!r}")
        if plat == "cuda" and not torch.cuda.is_available():
            raise ValueError("export for 'cuda' needs a CUDA device")
    dtype = _DTYPES[options.dtype]
    p_cpu, spec = _param_spec(params, dtype)
    files = {}
    for plat in plats:
        device = torch.device(plat)
        p = {k: v.to(device) for k, v in p_cpu.items()}
        for name, fn, has_u in _functions(problem):
            for sig in _signatures(has_u):
                files[f"programs/{plat}/{name}/{sig}.pt2"] = _export_one(
                    fn, has_u, sig, problem.n_x, problem.n_u, p, dtype,
                    device)
    model = None
    if kernels:
        model, files["model.cuh"] = _model_meta(problem, params)
    meta = dict(
        format=FORMAT_VERSION, name=problem.name, n_x=problem.n_x,
        n_u=problem.n_u, horizon=int(horizon), batch=batch,
        dtype=options.dtype, platforms=list(plats), params=spec,
        options={f.name: getattr(options, f.name)
                 for f in dataclasses.fields(options)},
        families={fam: len(getattr(problem, fam)) for fam in _FAMILIES},
        box_meta=[[bc.u_index, bc.sign] for bc in problem.box_constraints],
        model=model)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta))
        for path, data in files.items():
            z.writestr(path, data)
    return buf.getvalue()


class _Exported:
    """A problem function restored from its exported programs: dispatches
    on the call's signature and device, with the step as a tensor.  Each
    program is deserialized at its signature's first call (a solve on the
    card calls two or three of the four); ``seconds`` keeps the host
    seconds of each deserialization and of each program's first call."""

    def __init__(self, name: str, saved: dict, keys: list):
        self.name, self.saved, self.keys = name, saved, keys
        self.programs: dict = {}
        self.seconds: dict = {"deserialize": [], "first_calls": []}

    def __call__(self, x, *rest):
        *u, p, k = rest
        if not isinstance(k, Tensor):
            # a fill, not a copy from host memory: a CUDA graph captures it
            k = torch.full((), int(k), dtype=torch.int64, device=x.device)
        if x.dim() == 1:
            sig = "point"
        elif x.dim() == 2:
            sig = "lane"
        else:
            sig = "plane" if k.dim() else "sweep"
        at = (x.device.type, sig)
        uu = u[0] if u else torch.zeros((), dtype=x.dtype, device=x.device)
        args = (x, uu, {key: p[key] for key in self.keys}, k)
        prog = self.programs.get(at)
        if prog is not None:
            return prog(*args)
        if at not in self.saved:
            raise ValueError(f"{self.name}: no exported program for a "
                             f"{sig!r} call on {x.device.type}")
        t0 = time.perf_counter()
        prog = self.programs[at] = torch.export.load(
            io.BytesIO(self.saved[at])).module()
        t1 = time.perf_counter()
        out = prog(*args)
        self.seconds["deserialize"].append(t1 - t0)
        self.seconds["first_calls"].append(time.perf_counter() - t1)
        return out


def _restore_model(meta: dict, header: str):
    d = meta["model"]
    if d["kind"] == "generated":
        return codegen.GeneratedModel(
            name=d["name"], struct=d["struct"], header=header,
            fixed=tuple((k, tuple(s)) for k, s in d["fixed"]),
            tail=tuple((k, tuple(s)) for k, s in d["tail"]),
            n_params=d["n_params"], n_tail=d["n_tail"])
    path = _hand_written_header(d["name"])
    if path.read_text() != header:
        raise ValueError(
            f"the artifact's CUDA model {d['name']!r} differs from this "
            f"installation's {path.name}; export the solver again")
    return CudaModel(name=d["name"], param_order=tuple(
        (k, n) for k, n in d["param_order"]))


def _shape(a) -> tuple:
    return tuple(a.shape) if isinstance(a, Tensor) else np.shape(a)


def _check(what: str, a, shape: tuple, dtype: torch.dtype) -> None:
    """``iLQG_mex.c:39-43``: the argument's shape and dtype as exported;
    a Python number stands for a 0-d floating param."""
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        if shape == () and dtype.is_floating_point:
            return
        raise ValueError(f"{what}: a number where the artifact takes "
                         f"shape {shape}")
    if isinstance(a, Tensor):
        got_shape, got = tuple(a.shape), a.dtype
    else:
        arr = np.asarray(a)
        got_shape = arr.shape
        got = torch.from_numpy(np.zeros((), arr.dtype)).dtype
    if got_shape != tuple(shape) or got != dtype:
        raise ValueError(
            f"{what} has shape {got_shape} and dtype "
            f"{str(got).replace('torch.', '')}; the artifact was exported "
            f"for {tuple(shape)} {str(dtype).replace('torch.', '')}")


def load_solver(blob: bytes, *, device):
    """Restore an exported solver on ``device`` (a device type the artifact
    names in its ``platforms``).  The problem's Python module is not
    needed and nothing is traced; the CUDA kernels are built at first use.
    The callable takes ``(x0, u0, params)`` of the exported shapes and
    dtypes (a leading batch axis unless ``batch`` was None) and raises
    ``ValueError`` on any other."""
    device = torch.device(device)
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format") != FORMAT_VERSION:
            raise ValueError(f"artifact format {meta.get('format')!r}; this "
                             f"port reads {FORMAT_VERSION}")
        if device.type not in meta["platforms"]:
            raise ValueError(f"the artifact was exported for "
                             f"{meta['platforms']}, not {device.type}")
        header = (z.read("model.cuh").decode() if meta["model"] else None)
        keys = [k for k, _, _ in meta["params"]]
        fns = {}
        names = ["f", "L", "F"] + [f"{fam}{i}" for fam in _FAMILIES
                                   for i in range(meta["families"][fam])]
        for name in names:
            has_u = not name.startswith(_NO_U)
            saved = {(device.type, sig): z.read(
                f"programs/{device.type}/{name}/{sig}.pt2")
                for sig in _signatures(has_u)}
            fns[name] = _Exported(name, saved, keys)
    fam = {f: [fns[f"{f}{i}"] for i in range(meta["families"][f])]
           for f in _FAMILIES}
    problem = make_problem(
        meta["n_x"], meta["n_u"], fns["f"], fns["L"], fns["F"], h=fam["h"],
        hle=fam["hle"], hli=fam["hli"], hfe=fam["hfe"], hfi=fam["hfi"],
        name=meta["name"], validate=False,
        box_meta=[tuple(e) for e in meta["box_meta"]],
        cuda_model=_restore_model(meta, header) if header else None)
    options = options_from_dict(meta["options"])
    meta["device"] = str(device)
    return RestoredSolver(problem, options, meta, list(fns.values()))


class RestoredSolver:
    """An exported solver restored by :func:`load_solver`: call it with
    ``(x0, u0, params)``.  ``problem`` (its functions the exported
    programs), ``options``, ``horizon`` and ``batch`` are as exported;
    :meth:`stage_seconds` says what restoring the programs has cost so
    far.  The solve is :func:`~.solver.make_batched_solver`'s: on a CUDA
    device its first call captures the whole solve, the exported programs'
    calls included, as one CUDA graph (a WHILE node for the loop), and
    every call replays it."""

    def __init__(self, problem: Problem, options: SolverOptions, meta: dict,
                 functions: Sequence[_Exported] = ()):
        self.problem, self.options = problem, options
        self._functions = list(functions)
        self.batch, self.horizon = meta["batch"], meta["horizon"]
        self._dtype = _DTYPES[meta["dtype"]]
        self._spec = [(k, tuple(s), getattr(torch, d))
                      for k, s, d in meta["params"]]
        device = torch.device(meta["device"])
        self._solve = (
            make_solver(problem, options, device=device)
            if self.batch is None
            else make_batched_solver(problem, options, device=device))

    def __call__(self, x0, u0, params):
        lead = ()
        if self.batch is not None:
            n = _shape(x0)[0] if _shape(x0) else -1
            if isinstance(self.batch, int) and n != self.batch:
                raise ValueError(f"x0 has batch {n}; the artifact was "
                                 f"exported for batch {self.batch}")
            lead = (max(n, 0),)
        p = self.problem
        _check("x0", x0, lead + (p.n_x,), self._dtype)
        _check("u0", u0, lead + (self.horizon, p.n_u), self._dtype)
        keys = [k for k, _, _ in self._spec]
        if not isinstance(params, dict) or set(params) != set(keys):
            raise ValueError(f"params must have the keys {sorted(keys)}")
        for key, shape, dt in self._spec:
            _check(f"params[{key!r}]", params[key], shape, dt)
        return self._solve(x0, u0, params)

    def stage_seconds(self) -> dict:
        """Host seconds spent so far deserializing the exported programs
        (each at its first call; in all, and the longest one) and in those
        first calls, and the number of programs deserialized."""
        load = [t for f in self._functions for t in f.seconds["deserialize"]]
        return dict(
            deserialize_s=sum(load), deserialize_max_s=max(load, default=0.0),
            first_calls_s=sum(t for f in self._functions
                              for t in f.seconds["first_calls"]),
            programs=len(load))


def save_solver(path: str, *args, force: bool = False, **kwargs) -> bool:
    """Export to ``path`` unless an artifact is already there
    (``make_iLQG.m:30-37``); True when a new one was written."""
    if not force and os.path.exists(path) and os.path.getsize(path) > 0:
        return False
    blob = export_solver(*args, **kwargs)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(blob)
    os.replace(tmp, path)
    return True


def load_solver_file(path: str, *, device):
    """:func:`load_solver` of the artifact at ``path``."""
    with open(path, "rb") as fh:
        return load_solver(fh.read(), device=device)
