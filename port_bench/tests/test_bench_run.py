"""A whole run on the CPU at a tiny size (the harness past its look for a
card), the last line, and the refusal without a card."""

import json
import subprocess
import sys
import time

import pytest

import run as run_py
from conftest import BENCH, ROOT, TINY
from harness.cell import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", sorted(TINY))
def test_tiny_run_is_correct_and_its_line_has_the_result_keys(spec,
                                                                workload):
    line = run_cell(spec, workload, 2 ** 31 + 12345, 0.5, False, "cpu",
                    time.time(), TINY[workload])
    assert list(line) == KEYS + ["checks"]  # checks last
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0
    assert line["attempted"] >= TINY[workload]["traffic"].get("batch", 1)
    e2e = {m["name"] for m in spec.metrics_for(workload, trace=False)}
    assert set(line["metrics"]) == e2e
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_no_card_fails_and_prints_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_py.main(["--workload", "car_parking_f32_kernel.batch2048",
                      "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_fails(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run_py.main(["--workload", "car_parking_f32_kernel.single",
                      "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ddp_generator_tpu_torch_x", sys)
    assert run_py.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run_py.forbidden_modules() == ["jax"]


def test_a_directory_with_only_the_benchmark_fails(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "car_parking_f32_kernel.single", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card, spec):
    over = {"config": {"options": {"max_iter": 20}},
            "traffic": {"batch": 256, "pool": 2}}
    line = run_cell(spec, "car_parking_f32_kernel.batch2048", 7, 1.0, True,
                    "cuda", time.time(), over)
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert all(0 < m["value"] <= 105 for k, m in line["metrics"].items()
               if k.endswith("roofline_pct"))
