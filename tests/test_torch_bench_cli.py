"""``bench_torch.py``, the port's bench entry: the real CLI on the CPU at a
toy shape prints ONE JSON line with ``bench.py``'s keys and the port's own
(as ``tests/test_bench_cli.py`` holds ``bench.py``); without ``--cpu`` and
without a CUDA device it exits nonzero and prints no JSON."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = ["--batch", "8", "--T", "30", "--max-iter", "25", "--repeats", "1"]
KEYS = {"metric", "value", "unit", "vs_baseline", "solved_pct",
        "exhausted_pct", "mean_iterations", "mean_body_calls", "stale_pct",
        "device", "torch_cuda", "launches_per_solve"}


def _run(*flags, env=None):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), *flags],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, **(env or {})))


@pytest.mark.parametrize("flags", [(), ("--no-precompile",)],
                         ids=["precompile", "no_precompile"])
def test_bench_torch_cli_cpu_toy(flags):
    out = _run("--cpu", *TOY, *flags)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected ONE JSON line on stdout: {lines}"
    rec = json.loads(lines[0])
    assert set(rec) == KEYS
    assert rec["metric"] == "carparking_batched_solves_per_s_per_chip"
    assert rec["unit"] == "solves/s"
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert 0 <= rec["solved_pct"] <= 100 and 0 <= rec["exhausted_pct"] <= 100
    assert rec["solved_pct"] + rec["exhausted_pct"] <= 100
    assert 1 <= rec["mean_iterations"] <= 25
    assert rec["mean_body_calls"] >= rec["mean_iterations"]
    assert rec["device"] == "cpu"
    # the wrappers count launches of their kernels only: none on the CPU
    assert rec["launches_per_solve"] == {
        "backpass": 0, "fused": 0, "rollout_multi": 0,
        "rollout_selected": 0}
    assert "warm-up solve" in out.stderr
    # precompile by default, as bench.py; on the CPU it captures nothing
    assert ("precompile: " in out.stderr) == (not flags)
    assert "0 graph replays" in out.stderr


def test_bench_torch_refuses_to_fall_back_to_cpu():
    out = _run(*TOY, env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not any(ln.lstrip().startswith("{")
                   for ln in out.stdout.splitlines())
    assert "no CUDA device" in out.stderr
