"""The solver's initial open-loop rollout on kernel B2
(``ops/cuda_rollout.py:initial_rollout``) against ``forward_pass`` at alpha
0, on the CPU, where ``rollout_call`` runs B2's plain version.

* the helper's ``xs``, ``us``, ``cost`` and ``ok`` equal ``forward_pass``'s
  bit for bit: CarParking in float32 and float64 (controls past both box
  limits, a lane whose speed turns the dynamics' square root NaN) and
  ``brachistochrone_hli`` in float64 (its ``[k]``-indexed floor under
  ``mu_li`` = 1 and ``w_pen_l`` = 40, its terminal equality);
* ``init_fn``'s whole carry through the helper equals the carry through
  ``forward_pass``, a lane whose ``u0`` drives the state non-finite
  included (``ok`` False, ``STATUS_INIT_FAILED``, ``xs[:, 0] == x0``);
* the route: the kernel line search on a CUDA device, with shared or
  per-lane params, takes the helper; the serial line search, the fused
  path with per-lane params (whose line search is serial) and the CPU take
  ``forward_pass``.

The file imports no JAX.
"""

import numpy as np
import pytest
import torch

import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch import launches
from ddp_generator_tpu_torch import solver as slv
from ddp_generator_tpu_torch.al import init_multipliers
from ddp_generator_tpu_torch.models import brachistochrone as tbr
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.ops import cuda_rollout as cr
from ddp_generator_tpu_torch.ops.forward import forward_pass

DTYPES = {"f32": torch.float32, "f64": torch.float64}
# (problem, dtype, w_pen_init_l, w_pen_init_f): the options the benchmark's
# configurations run, and CarParking in float64 besides
CASES = {"car_f32": ("car", "f32", 1.0, 1.0),
         "car_f64": ("car", "f64", 1.0, 1.0),
         "brachi_hli_f64": ("brachi_hli", "f64", 40.0, 1e-5)}


def _inputs(name, B, N, seed=0):
    """``(problem, params, x0s, u0s)`` of ``name`` at ``B`` lanes and ``N``
    steps.  CarParking's controls reach past |w| <= 0.5 and |a| <= 2 and
    its last lane (of three) starts so fast that ``|h v sin w| > d``: the
    dynamics' square root turns NaN."""
    rng = np.random.default_rng(seed)
    if name == "car":
        p, x0, _ = tcar.default_setup(T=N, seed=0)
        x0s = np.tile(x0, (B, 1)) + 0.05 * rng.standard_normal((B, 4))
        u0s = 2.0 * rng.standard_normal((B, N, 2))
        if B > 2:
            x0s[2, 3] = 300.0
        return tcar.car_parking(), p, x0s, u0s
    p, x0, _ = tbr.default_setup_hli(N)
    u0s = -rng.uniform(0.5, 1.5, (B, N, 1))
    return tbr.brachistochrone_hli(), p, np.tile(x0, (B, 1)), u0s


def _rollouts(case, B, N):
    problem_name, dt, wl, wf = CASES[case]
    dtype = DTYPES[dt]
    problem, p, x0s, u0s = _inputs(problem_name, B, N)
    pt = {k: torch.as_tensor(np.asarray(v), dtype=dtype) for k, v in p.items()}
    x0 = torch.as_tensor(x0s, dtype=dtype)
    u0 = torch.as_tensor(u0s, dtype=dtype)
    m = init_multipliers(problem, B, N, dtype, "cpu")
    w_l = torch.full((B,), wl, dtype=dtype)
    w_f = torch.full((B,), wf, dtype=dtype)
    ref = forward_pass(problem, x0, None, u0, None, None, 0.0, pt, m.mu_le,
                       m.mu_li, m.mu_fe, m.mu_fi, w_l, w_f)
    out = cr.initial_rollout(problem, x0, u0, pt, m, w_l, w_f)
    return ref, out


@pytest.mark.parametrize("B,N", [(1, 7), (3, 40)])
@pytest.mark.parametrize("case", list(CASES))
def test_initial_rollout_equals_forward_pass(case, B, N):
    launches.reset_launches()
    ref, out = _rollouts(case, B, N)
    assert isinstance(out, type(ref))
    for name in ref._fields:
        a, b = getattr(out, name), getattr(ref, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=name)
    if case.startswith("car") and B == 3:
        assert out.ok.tolist() == [True, True, False]
    else:
        assert bool(out.ok.all())
    # the plain version launches nothing, so counts nothing
    assert launches.read_launches()["init_rollout"] == 0


def _options(name, dt, linesearch="kernel"):
    kw = (dict(w_pen_init_l=40.0, w_pen_init_f=1e-5, w_pen_max_f=1.0,
               w_pen_fact2=1.0, full_ddp=False, backpass_method="fused")
          if name == "brachi_hli" else dict(backpass_method="kernel"))
    return td.SolverOptions(max_iter=5, dtype=f"float{dt[1:]}",
                            debug_level=0,
                            linesearch_method=linesearch, **kw)


def _carry(monkeypatch, name, dt, on_b2, x0s, u0s, p, problem):
    """``init_fn``'s carry on the CPU with the route forced to the helper
    (``on_b2``) or left at ``forward_pass``; the calls each route made."""
    calls = {"forward_pass": 0, "initial_rollout": 0}

    def counted(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(slv, "forward_pass",
                        counted(forward_pass, "forward_pass"))
    monkeypatch.setattr(slv, "initial_rollout",
                        counted(cr.initial_rollout, "initial_rollout"))
    monkeypatch.setattr(slv, "_init_on_b2", lambda *a: on_b2)
    init, _, _, cast = slv._make_parts(problem, _options(name, dt), "cpu")
    c = init(x0s, u0s, cast(p, len(u0s), u0s.shape[1]))
    monkeypatch.undo()
    return c, calls


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("name", ["car", "brachi_hli"])
def test_init_fn_carry_through_the_helper(monkeypatch, name, dt):
    """Every field of ``init_fn``'s carry through the helper equals the
    carry through ``forward_pass``; a lane whose ``u0`` holds an infinity
    from step 3 on turns the state non-finite: ``ok`` False, the lane
    ``STATUS_INIT_FAILED`` and done, and ``xs[:, 0]`` still ``x0``."""
    problem, p, x0s, u0s = _inputs(name, 3, 40, seed=1)
    u0s[1, 3:] = np.inf
    ref, ref_calls = _carry(monkeypatch, name, dt, False, x0s, u0s, p,
                            problem)
    out, out_calls = _carry(monkeypatch, name, dt, True, x0s, u0s, p,
                            problem)
    assert ref_calls == {"forward_pass": 1, "initial_rollout": 0}
    assert out_calls == {"forward_pass": 0, "initial_rollout": 1}
    for field, a, b in zip(ref._fields, out, ref):
        for x, y in zip(a, b) if field == "mult" else ((a, b),):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                       msg=field)
    failed = out.status == td.STATUS_INIT_FAILED
    # CarParking's third lane fails too: its speed (see _inputs)
    assert failed.tolist() == [False, True, name == "car"]
    assert out.done.tolist() == failed.tolist()
    assert not bool(torch.isfinite(out.xs[1, -1]).all())
    x0 = torch.as_tensor(x0s, dtype=DTYPES[dt])
    assert torch.equal(out.xs[:, 0], x0)


@pytest.mark.parametrize("device,linesearch,batch_params,on_b2,backpass", [
    ("cuda", "kernel", False, True, "kernel"),
    ("cuda:0", "kernel", False, True, "kernel"),
    ("cuda", "serial", False, False, "kernel"),
    ("cuda", "kernel", True, True, "kernel"),
    ("cuda", "kernel", True, False, "fused"),
    ("cpu", "kernel", False, False, "kernel"),
    ("cpu", "serial", False, False, "kernel"),
])
def test_route_rule(device, linesearch, batch_params, on_b2, backpass):
    """The helper exactly where B2 rolls the line search: a CUDA device and
    the kernel line search, shared or per-lane params, but not the fused
    path with per-lane params (serial derivatives, backward pass and line
    search)."""
    o = td.SolverOptions(linesearch_method=linesearch,
                         backpass_method=backpass)
    assert slv._init_on_b2(torch.device(device), o, batch_params) is on_b2
    assert (slv._line_search_of(o, batch_params) == "kernel") == (
        linesearch == "kernel"
        and not (batch_params and backpass == "fused"))


@pytest.mark.parametrize("linesearch,batch_params", [
    ("kernel", False), ("serial", False), ("kernel", True)])
def test_cpu_init_fn_calls_forward_pass(monkeypatch, linesearch,
                                        batch_params):
    """On the CPU every route's ``init_fn`` rolls with ``forward_pass``
    and never calls the helper."""
    calls = []
    monkeypatch.setattr(slv, "forward_pass",
                        lambda *a, **kw: calls.append("fp") or
                        forward_pass(*a, **kw))
    monkeypatch.setattr(slv, "initial_rollout",
                        lambda *a, **kw: calls.append("b2") or
                        cr.initial_rollout(*a, **kw))
    problem, p, x0s, u0s = _inputs("car", 2, 7)
    o = _options("car", "f64", linesearch)
    if batch_params:  # every leaf gets a lane axis
        p = {k: np.stack([np.asarray(v)] * 2) for k, v in p.items()}
    init, _, _, cast = slv._make_parts(problem, o, "cpu", batch_params)
    c = init(x0s, u0s, cast(p, 2, u0s.shape[1]))
    assert calls == ["fp"]
    assert c.xs.shape == (2, 8, 4)
