"""Reading the profiler's Chrome trace: busy time, idle gaps, breakdown."""

import pytest

from harness import trace


def _events():
    return [
        {"ph": "X", "cat": "user_annotation", "name": trace.SPAN,
         "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 101.0, "dur": 2.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 150.0,
         "dur": 40.0},
        {"ph": "X", "cat": "kernel", "name": "void k1<float>(int)",
         "ts": 110.0, "dur": 20.0, "args": {"grid": [256, 1, 1]}},
        {"ph": "X", "cat": "kernel", "name": "void k2(int)", "ts": 120.0,
         "dur": 20.0, "args": {"grid": [1, 1, 1]}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 180.0,
         "dur": 5.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0.0},
    ]


def test_busy_is_the_union_within_the_span():
    tr = trace.window_of(_events())
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s() == pytest.approx(35e-6)  # 110-140 and 180-185
    assert [round(d) for _, d in tr.gaps()] == [10, 40, 15]


def test_breakdown_names_gaps_by_the_host():
    tr = trace.window_of(_events())
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] in ("k1<float>", "k2")
    assert bd["idle_gaps"][0][0] == "host: aten::item"
    assert bd["idle_gaps"][0][1] == pytest.approx(40e-6)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert tr.kernels()[0].grid == (256, 1, 1)


def test_short_name():
    assert trace.short_name(
        "void ddp::rollout_kernel<ddp::A, float, true, true>(ddp::R<float>)"
    ) == "ddp::rollout_kernel<ddp::A, float, true, true>"
    assert trace.short_name(
        "void ddp::(anonymous namespace)::k<float>(int)") == "ddp::k<float>"
