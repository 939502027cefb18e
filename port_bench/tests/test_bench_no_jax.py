"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program either.  Module names are compared by their
top-level name, the part before the first dot, whole: the port's name
begins with the JAX package's."""

import json
import subprocess
import sys

from conftest import BENCH, ROOT

PROBE = r"""
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(imports: str) -> set:
    code = PROBE.format(bench=str(BENCH), root=str(ROOT), imports=imports)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, check=True, timeout=300)
    return set(json.loads(proc.stdout.splitlines()[-1]))


def test_run_metrics_and_harness_load_no_jax():
    names = [p.stem for p in (BENCH / "metrics").glob("*.py")]
    imports = "\n".join([
        "import run, calibrate",
        "import harness.cell, harness.trace, harness.roofline",
        "import harness.control, harness.faults",
        "from harness.spec import Spec",
        "s = Spec()",
        *(f"s.metric_reader({n!r})" for n in names),
        "import reference.car_parking",
        "import ddp_generator_tpu_torch",
        "from ddp_generator_tpu_torch.models import car_parking",
    ])
    top = _top_level(imports)
    assert "ddp_generator_tpu_torch" in top
    for bad in ("jax", "jaxlib", "flax", "ddp_generator_tpu"):
        assert bad not in top


def test_reference_loads_nothing_of_the_program():
    top = _top_level("import reference.car_parking, reference.common")
    for bad in ("jax", "jaxlib", "flax", "ddp_generator_tpu",
                "ddp_generator_tpu_torch"):
        assert bad not in top
