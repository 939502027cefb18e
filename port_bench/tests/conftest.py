"""The benchmark's CPU tests: ``python -m pytest port_bench/tests``.

Tests that need the card carry the ``cuda`` marker and take the ``card``
fixture, which skips them where ``torch.cuda`` sees no device; run them on
the card with ``python -m pytest port_bench/tests -m cuda``."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Tiny CPU sizes of each cell (the kernels' plain versions): what a test
# run can hold.  CarParking on the CPU takes ~100 s a lane at T=500.
TINY = {
    "car_parking_f32_kernel.batch2048": {
        "config": {"T": 30, "options": {"max_iter": 25},
                   "stepwise": {"min_compact_batch": 2}},
        "traffic": {"batch": 8, "pool": 2}},
    "car_parking_f32_kernel.single": {
        "config": {"T": 30, "options": {"max_iter": 25}},
        "traffic": {"pool": 2}},
}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def spec():
    from harness.spec import Spec

    return Spec()
