"""The PyTorch port (the package, ``chip_smoke.py`` and the example scripts
``scripts/*_torch.py``) imports no JAX, and ``chip_smoke.py`` refuses to
run without a GPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "ddp_generator_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + [
    ROOT / "scripts" / f"{name}_torch.py"
    for name in ("try_car", "try_brachi", "plot_car", "plot_brachi")],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ddp_generator_tpu"), (path, mod)


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_importing_the_port_loads_no_jax():
    code = ("import sys, ddp_generator_tpu_torch, "
            "ddp_generator_tpu_torch.models.car_parking, "
            "ddp_generator_tpu_torch.models.brachistochrone, "
            "ddp_generator_tpu_torch.ops.cm_derivs, "
            "ddp_generator_tpu_torch.ops.cuda_fused, "
            "ddp_generator_tpu_torch.codegen, "
            "ddp_generator_tpu_torch.ops.parallel_riccati, "
            "ddp_generator_tpu_torch.debugging, "
            "ddp_generator_tpu_torch.inspect_api, "
            "ddp_generator_tpu_torch.outputs, "
            "ddp_generator_tpu_torch.native, "
            "ddp_generator_tpu_torch.utils.debug, "
            "ddp_generator_tpu_torch.utils.timing, "
            "ddp_generator_tpu_torch.utils.tree, "
            "ddp_generator_tpu_torch.parallel.mesh, "
            "ddp_generator_tpu_torch.aot; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ddp_generator_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_without_gpu_fails_and_prints_no_result():
    env = _clean_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
