"""The operation counts behind ``chip_smoke.py``'s kernel bounds.

``scripts/count_ops.py`` builds the kernels' headers with ``g++`` on a
counting number type and counts the arithmetic of kernels B1 and B3 per
(step, lane) and per lane, and of one B2 rollout step, on CarParking.
``chip_smoke.py`` keeps those counts as constants (``OPS``), so that the
script needs no compiler beside ``nvcc``; this test holds the constants to
the count, so that a kernel whose arithmetic changes cannot keep a stale
bound.  Skips when no C++ compiler is found.
"""

import importlib.util
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_op_counts_match_the_kernels():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler: the count builds the headers with g++")
    counted = _load("count_ops", ROOT / "scripts" / "count_ops.py").count()
    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    assert counted == smoke.OPS
    # the derivative work dominates B3's step; B1's step is the Riccati step
    assert counted["fused_per_step"] > 4 * counted["backpass_per_step"]
