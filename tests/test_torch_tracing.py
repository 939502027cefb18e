"""Tracing a solve (``launches.py``): launch counts, host spans, device
stamps and lane-steps.

On the CPU: ``StepwiseSolver``'s spans under ``torch.profiler`` (their
nesting, their count and their shared call id, which an execution trace
keeps), no ``record_function`` without a profiler, ``LoopStats.lane_steps``
on the static and the eager route, the order of a body call's stamps (with
``launches.stamp`` recording tags: the CPU has no stamp kernel), and the
decoding of a stamp ring; an eager launch counted by ``launches.count`` and
read back by ``read_launches`` alone, with ``launches.py`` loaded on its own
(it imports no kernel wrapper).  On a card (``cuda`` marker): a whole-solve
graph's stamps and spans.  The file imports no JAX; run its card test past
``tests/conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider \\
        -o "markers=cuda: needs a CUDA device" -m cuda -q \\
        tests/test_torch_tracing.py
"""

import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ExecutionTraceObserver, ProfilerActivity, profile

import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch import launches
from ddp_generator_tpu_torch.models import brachistochrone as tbr
from ddp_generator_tpu_torch.models import car_parking as tcar

B, T = 8, 10
BODY = ["body", "derivs", "backpass", "linesearch", "body_end"]
INIT = ["init", "init_end"]  # init_fn's entry and its carry built


def _inputs():
    """Every other lane fails its initial rollout, so the first chunk's
    count halves the working set: one compaction, 8 -> 4."""
    p, x0, _ = tcar.default_setup(T=T, seed=0)
    rng = np.random.default_rng(3)
    x0s = np.tile(x0, (B, 1)) + 0.3 * rng.standard_normal((B, 4))
    x0s[::2, 0] = np.nan
    return p, x0s, 0.1 * rng.standard_normal((B, T, 2))


def _solver(backpass="kernel", debug_level=0, **kw):
    opts = td.SolverOptions(max_iter=6, backpass_method=backpass,
                            linesearch_method="kernel",
                            debug_level=debug_level)
    return td.StepwiseSolver(tcar.car_parking(), opts, chunk=2,
                             compact_levels=2, min_compact_batch=2,
                             device="cpu", **kw)


def test_stepwise_spans_nest_and_share_the_call_id(tmp_path):
    p, x0s, u0s = _inputs()
    s = _solver()
    s(x0s, u0s, p)  # call 1, untraced
    et = ExecutionTraceObserver().register_callback(str(tmp_path / "et.json"))
    with profile(activities=[ProfilerActivity.CPU],
                 execution_trace_observer=et) as prof:
        s(x0s, u0s, p)
    st = s.last_stats
    spans = [e for e in prof.events() if e.name.startswith("ddp.")]
    n = Counter(e.name for e in spans)
    assert st.eager == (B, B // 2)  # one compaction
    assert n["ddp.stepwise.call"] == 1
    assert n["ddp.stepwise.init"] == n["ddp.stepwise.finalize"] == 1
    assert n["ddp.stepwise.compact"] == len(st.eager) - 1 == 1
    # depth 1: a count is pushed after each chunk and read at once
    assert n["ddp.stepwise.enqueue"] == st.host_reads
    assert n["ddp.stepwise.read_wait"] == st.host_reads
    call = next(e for e in spans if e.name == "ddp.stepwise.call")
    for e in spans:
        if e is not call:
            assert e.cpu_parent is not None
            assert e.cpu_parent.name == "ddp.stepwise.call"
            assert call.time_range.start <= e.time_range.start
            assert e.time_range.end <= call.time_range.end
    nodes = json.loads((tmp_path / "et.json").read_text())["nodes"]
    ids = {tuple(x["inputs"]["values"]) for x in nodes
           if x["name"].startswith("ddp.")}
    assert ids == {("2",)}  # the second call of this solver


def test_no_profiler_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    p, x0s, u0s = _inputs()
    sol = _solver()(x0s, u0s, p)
    assert np.isfinite(td.to_numpy(sol).cost[1::2]).all()
    with launches.span("ddp.stepwise.call", 1):
        pass


@pytest.mark.parametrize("route", ["static", "eager"])
def test_lane_steps_sum_the_working_widths(route, capsys):
    p, x0s, u0s = _inputs()
    s = _solver(debug_level=3 if route == "eager" else 0)
    widths = []
    inner = s._body

    def body(c, params):
        widths.append(int(c.cost.shape[0]))
        return inner(c, params)

    s._body = s._body_inline = body
    launches.reset_launches()
    sol = td.to_numpy(s(x0s, u0s, p))
    capsys.readouterr()  # debug_level 3 prints every iteration
    st = s.last_stats
    assert st.eager == (B, B // 2)  # on the CPU both routes run eagerly
    assert len(widths) == st.body_calls
    assert st.lane_steps == sum(widths) == launches.read_lane_steps()
    assert st.lane_steps >= int(sol.body_calls.sum()) > 0


@pytest.mark.parametrize("entry,backpass", [("stepwise", "kernel"),
                                            ("stepwise", "fused"),
                                            ("batched", "kernel")])
def test_body_call_stamps_in_order(monkeypatch, entry, backpass):
    tags = []
    monkeypatch.setattr(launches, "stamp",
                        lambda tag, device: tags.append(tag))
    p, x0s, u0s = _inputs()
    body = [t for t in BODY if backpass == "kernel" or t != "derivs"]
    launches.reset_launches()
    if entry == "stepwise":
        s = _solver(backpass)
        s(x0s, u0s, p)
        assert tags == INIT + body * s.last_stats.body_calls
    else:
        opts = td.SolverOptions(max_iter=6, backpass_method=backpass,
                                linesearch_method="kernel")
        sol = td.make_batched_solver(tcar.car_parking(), opts,
                                     device="cpu")(x0s, u0s, p)
        trips = int(sol.body_calls.max())
        assert trips > 0
        assert tags == INIT + ["loop"] + body * trips + ["loop_end"]
    assert launches.read_al_updates() == 0  # CarParking has no AL family


def _ring(cap, tags_ns, cursor):
    ring = torch.zeros(2 + 2 * cap, dtype=torch.int64)
    ring[0], ring[1] = cursor, cap
    for i, (tag, ns) in enumerate(tags_ns):
        j = 2 + 2 * (i % cap)
        ring[j], ring[j + 1] = launches.STAMP_TAGS.index(tag), ns
    return ring


@pytest.mark.parametrize("n", [3, 4, 7])
def test_decode_stamps_orders_a_ring_and_counts_the_lost(n):
    cap = 4
    stamps = [(BODY[i % len(BODY)], 100 + 10 * i) for i in range(n)]
    entries, lost = launches.decode_stamps(_ring(cap, stamps, n))
    assert entries == stamps[-cap:]
    assert lost == max(0, n - cap)


def test_reset_empties_the_rings_in_place(monkeypatch):
    ring = _ring(4, [("body", 5), ("derivs", 9)], 2)
    ptr = ring.data_ptr()
    monkeypatch.setitem(launches._STAMPS, torch.device("cpu", 0), ring)
    launches.add_lane_steps(12)
    launches.reset_launches()
    assert ring.data_ptr() == ptr
    assert int(ring[0]) == 0 and int(ring[1]) == 4
    assert launches.decode_stamps(ring) == ([], 0)
    assert launches.read_lane_steps() == 0


@pytest.mark.parametrize("kernel", launches.KERNELS)
def test_an_eager_count_adds_one_to_its_kernel_alone(kernel):
    launches.reset_launches()
    before = launches.read_launches()
    launches.count(kernel, "cpu")
    assert launches.read_launches() == {**before, kernel: before[kernel] + 1}
    launches.reset_launches()
    assert launches.read_launches()[kernel] == 0


def test_launches_counts_without_the_kernel_wrappers():
    """``launches.py`` loaded alone, outside its package, counts, reads and
    resets: it imports no module of the port."""
    path = Path(launches.__file__)
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('l', {str(path)!r})\n"
        "l = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(l)\n"
        "l.reset_launches()\n"
        "l.count('backpass', 'cpu')\n"
        "assert l.read_launches()['backpass'] == 1, l.read_launches()\n"
        "l.reset_launches()\n"
        "assert not any(l.read_launches().values())\n"
        "print([m for m in sys.modules if m.startswith("
        "'ddp_generator_tpu_torch')])\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stamp kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_solve_graph_stamps_and_spans_on_the_card(card):
    """testCar's solve at one lane: 5 stamps a trip and the 6 of the
    solve (``init_fn``'s 2 among them), in time order, ``solve`` to ``solve_end`` within 2% of the
    replay's CUDA-event time; under the profiler the call's spans."""
    p, x0, _ = tcar.default_setup(T=500, seed=0)
    u0 = 0.1 * np.random.default_rng(5).standard_normal((1, 500, 2))
    opts = td.SolverOptions(max_iter=200, dtype="float32", tolFun=1e-5,
                            backpass_method="kernel",
                            linesearch_method="kernel", full_ddp=True)
    solver = td.make_batched_solver(tcar.car_parking(), opts, device=card)
    x0s = torch.as_tensor(x0[None], device=card)
    u0s = torch.as_tensor(u0, device=card)
    sol = solver(x0s, u0s, p)  # captures the graph
    g = next(iter(solver.graphs.values()))
    launches.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    g.graph.replay()
    end.record()
    torch.cuda.synchronize()
    entries, lost = launches.read_stamps(card)
    trips = int(sol.body_calls[0])
    assert lost == 0
    assert [t for t, _ in entries] == (["solve"] + INIT + ["loop"]
                                       + BODY * trips
                                       + ["loop_end", "solve_end"])
    ns = [t for _, t in entries]
    assert all(a <= b for a, b in zip(ns, ns[1:]))
    event_ms = start.elapsed_time(end)
    assert (ns[-1] - ns[0]) * 1e-6 == pytest.approx(event_ms, rel=0.02)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solver(x0s, u0s, p)
    spans = {e.name: e for e in prof.events()
             if e.name.startswith("ddp.solve_graph.")}
    assert set(spans) == {"ddp.solve_graph.call",
                          "ddp.solve_graph.read_wait"}
    assert spans["ddp.solve_graph.read_wait"].cpu_parent.name == \
        "ddp.solve_graph.call"


def _brachi_hli(entry):
    """A small brachistochrone_hli solve on the fused path (its AL families:
    the moving floor and the terminal equality), stepwise or whole."""
    p, x0, _ = tbr.default_setup_hli(T)
    u0s = -(0.5 + np.random.default_rng(4).random((4, T, 1)))
    opts = td.SolverOptions(max_iter=20, w_pen_init_l=40.0,
                            w_pen_init_f=1e-5, w_pen_max_f=1.0,
                            w_pen_fact2=1.0, full_ddp=False,
                            backpass_method="fused",
                            linesearch_method="kernel")
    x0s = np.tile(x0, (4, 1))
    if entry == "stepwise":
        s = td.StepwiseSolver(tbr.brachistochrone_hli(), opts,
                              min_compact_batch=2, device="cpu")
        return s(x0s, u0s, p), s.last_stats.body_calls
    sol = td.make_batched_solver(tbr.brachistochrone_hli(), opts,
                                 device="cpu")(x0s, u0s, p)
    return sol, int(sol.body_calls.max())


@pytest.mark.parametrize("entry", ["stepwise", "batched"])
def test_al_stamp_and_update_count(monkeypatch, entry):
    """A body call of a problem with AL families stamps ``al`` after its
    multiplier update and re-cost, and counts the running lanes it
    updated; CarParking's body calls do neither (test above)."""
    tags = []
    monkeypatch.setattr(launches, "stamp",
                        lambda tag, device: tags.append(tag))
    launches.reset_launches()
    sol, calls = _brachi_hli(entry)
    body = ["body", "backpass", "linesearch", "al", "body_end"]
    want = body * calls
    assert tags == INIT + (want if entry == "stepwise"
                           else ["loop"] + want + ["loop_end"])
    updates = launches.read_al_updates()
    assert 0 < updates <= int(sol.body_calls.sum())
    launches.reset_launches()
    assert launches.read_al_updates() == 0
