"""The roofline arithmetic on a synthetic trace of known times and widths."""

import copy

import pytest

from harness import roofline
from harness.trace import DeviceOp

B1 = "void ddp::backpass_kernel<float, 4, 2, 1, true>(ddp::BackpassArgs<float>)"
SWEEP = ("void ddp::rollout_kernel<ddp::CarParking, float, true, true>"
         "(ddp::RolloutArgs<float>)")
SEL = ("void ddp::rollout_kernel<ddp::CarParking, float, false, true>"
       "(ddp::RolloutArgs<float>)")
B3 = "void ddp::fused_kernel<ddp::BrachistochroneHli, double, 1, false>(x)"


def test_classify():
    assert roofline.classify(B1) == roofline.B1
    assert roofline.classify(SWEEP) == roofline.B2_SWEEP
    assert roofline.classify(SEL) == roofline.B2_SEL_COST
    assert roofline.classify(SEL.replace("false, true", "false, false")) \
        == roofline.B2_SEL
    assert roofline.classify(B3) == roofline.B3
    assert roofline.classify(SWEEP.replace(
        "ddp::CarParking", "ddp::(anonymous namespace)::CarParking")) \
        == roofline.B2_SWEEP
    assert roofline.classify("_ZN3ddp14rollout_kernelINS_10CarParkingEfLb1ELb1EEEvNS_11RolloutArgsIT0_EE") == roofline.B2_SWEEP
    assert roofline.classify("void at::native::vectorized_elementwise_kernel") is None


def _shape(spec):
    return roofline.Shape(spec.config("car_parking_f32_kernel"), 11)


def test_b1_bound_is_the_known_bytes_bound(spec):
    s = _shape(spec)
    counts = spec.counts("car_parking_f32_kernel")
    # 161 values read and 10 written a step and lane (PERF.md: 0.209 ms)
    b = roofline.launch_bound_s(roofline.B1, 2048, s, counts)
    per_lane = (500 * 171 + 24) * 4 + 1  # lam, cx, cxx; dV, g; failed
    assert b == pytest.approx(2048 * per_lane / 3.35e12)
    assert b == pytest.approx(0.209e-3, rel=0.01)


def test_shares_of_a_synthetic_trace(spec):
    s = _shape(spec)
    counts = spec.counts("car_parking_f32_kernel")
    full = roofline.launch_bound_s(roofline.B1, 2048, s, counts)
    half = roofline.launch_bound_s(roofline.B1, 1024, s, counts)
    assert half == pytest.approx(full / 2)
    # two launches at 2048 lanes (grid 256), one at 1024 (grid 128), each
    # taking four times its bound
    ops = [DeviceOp(B1, 0.0, 4e6 * full, True, (256, 1, 1)),
           DeviceOp(B1, 10.0, 4e6 * full, True, (256, 1, 1)),
           DeviceOp(B1, 20.0, 4e6 * half, True, (128, 1, 1)),
           DeviceOp("other", 30.0, 1e3, True, (1, 1, 1))]
    got = roofline.share([(ops, (roofline.B1,), None)], s, counts, 2048)
    assert got == pytest.approx(25.0)
    # a count doubled where the kernel runs at its bound reads over 100%
    at_bound = [DeviceOp(B1, 0.0, 1e6 * full, True, (256, 1, 1))]
    assert roofline.share([(at_bound, (roofline.B1,), None)], s, counts,
                          2048) == pytest.approx(100.0)
    # where the operations bind, a doubled count reads 200%
    heavy = copy.deepcopy(counts)
    heavy["b1"]["per_step"] = 200000
    t = roofline.launch_bound_s(roofline.B1, 2048, s, heavy)
    assert t > full
    at_ops_bound = [DeviceOp(B1, 0.0, 1e6 * t, True, (256, 1, 1))]
    heavy["b1"]["per_step"] *= 2
    assert roofline.share([(at_ops_bound, (roofline.B1,), None)], s, heavy,
                          2048) == pytest.approx(200.0, rel=1e-4)


def test_b2_counts_only_launches_that_did_work(spec):
    s = _shape(spec)
    counts = spec.counts("car_parking_f32_kernel")
    sweep = roofline.launch_bound_s(roofline.B2_SWEEP, 2048, s, counts)
    ops = [DeviceOp(SWEEP, 0.0, 10e6 * sweep, True, (256, 2, 1)),
           DeviceOp(SWEEP, 1.0, 2.0, True, (256, 2, 1)),  # flag 0: exits
           DeviceOp(SWEEP, 2.0, 2.0, True, (256, 2, 1))]
    got = roofline.share([(ops, (roofline.B2_SWEEP,), 1)], s, counts, 2048)
    assert got == pytest.approx(10.0)


def test_width_is_the_grid_times_eight_lanes_at_most_the_batch():
    assert roofline.width_of((256, 1, 1), 2048) == 2048
    assert roofline.width_of((16, 1, 1), 2048) == 128
    assert roofline.width_of((1, 1, 1), 1) == 1
