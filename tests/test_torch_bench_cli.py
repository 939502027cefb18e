"""``bench_torch.py``, the port's bench entry: the real CLI on the CPU at a
toy shape prints ONE JSON line with ``bench.py``'s keys and the port's own
(as ``tests/test_bench_cli.py`` holds ``bench.py``); so does each of
``bench.py``'s levers (``--pipeline-depth``, ``--shared-derivs``,
``--mesh``, ``--artifact``), and those that change no lane's result
repeat the no-lever run's counts; without ``--cpu`` and without a CUDA
device it exits nonzero and prints no JSON, whatever the flags."""

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


def _start(*flags):
    """``bench_torch.py --cpu`` at the toy shape, started (one thread: the
    lever runs go together)."""
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--cpu",
         *TOY, *flags], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"))


def _record(out):
    """The one JSON line of a run that ended well."""
    rc, stdout, stderr = out
    assert rc == 0, stderr[-3000:]
    lines = [ln for ln in stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected ONE JSON line on stdout: {lines}"
    return json.loads(lines[0])


LEVERS = {"pipeline_depth": ("--pipeline-depth", "4"),
          "shared_derivs": ("--shared-derivs",), "mesh": ("--mesh", "2"),
          "artifact": ("--artifact",)}
# the levers that change no lane's result: their counts are the no-lever
# run's
SAME_COUNTS = ("solved_pct", "exhausted_pct", "mean_iterations",
               "mean_body_calls", "stale_pct")


@pytest.fixture(scope="module")
def lever_runs(tmp_path_factory):
    """``(rc, stdout, stderr)`` of the no-lever run and of each lever's,
    all started together; the artifact's run twice, the second reusing
    the first's file."""
    art = str(tmp_path_factory.mktemp("artifact") / "car.ddpexe")
    procs = {"none": _start()}
    for name, flags in LEVERS.items():
        procs[name] = _start(*flags, *((art,) if name == "artifact" else ()))
    out = {}
    try:
        out["artifact"] = (procs["artifact"].wait(timeout=400),
                           *procs["artifact"].communicate())
        procs["artifact_reused"] = _start("--artifact", art)
        for name, proc in procs.items():
            if name not in out:
                stdout, stderr = proc.communicate(timeout=400)
                out[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.mark.parametrize("lever", list(LEVERS) + ["artifact_reused"])
def test_bench_torch_levers_cpu_toy(lever_runs, lever):
    base = _record(lever_runs["none"])
    rec = _record(lever_runs[lever])
    stderr = lever_runs[lever][2]
    want = set(KEYS)
    if lever == "mesh":
        want |= {"n_chips", "n_ranks", "aggregate_solves_per_s"}
        assert rec["n_ranks"] == 2 and rec["n_chips"] == 1
        assert rec["aggregate_solves_per_s"] > 0
        assert rec["value"] == rec["aggregate_solves_per_s"]
        assert "ranks=2" in stderr
    assert set(rec) == want
    assert rec["device"] == "cpu" and rec["value"] > 0
    assert rec["launches_per_solve"] == base["launches_per_solve"]
    if lever != "shared_derivs":
        # depth d only reads the count late; each rank solves its own rows;
        # the restored solver is make_batched_solver: every lane as before
        assert {k: rec[k] for k in SAME_COUNTS} == {
            k: base[k] for k in SAME_COUNTS}
    if lever.startswith("artifact"):
        assert ("artifact reused" in stderr) == (lever == "artifact_reused")
        assert ("artifact exported+written" in stderr) == (
            lever == "artifact")
        assert "artifact loaded in" in stderr
        assert "artifact first solve:" in stderr and "deserialize" in stderr
        assert "precompile" not in stderr  # --artifact implies none


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
        "rollout_selected": 0, "emit": 0, "init_rollout": 0}
    assert "warm-up solve" in out.stderr
    # precompile by default, as bench.py; on the CPU it captures nothing
    assert ("precompile: " in out.stderr) == (not flags)
    assert "0 graph replays" in out.stderr


def test_bench_torch_refuses_to_fall_back_to_cpu(tmp_path):
    for flags in ((), ("--mesh", "2"),
                  ("--artifact", str(tmp_path / "a.ddpexe")),
                  ("--mesh", "2", "--pipeline-depth", "4",
                   "--shared-derivs")):
        out = _run(*TOY, *flags, env={"CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0, flags
        assert not any(ln.lstrip().startswith("{")
                       for ln in out.stdout.splitlines()), flags
        assert "no CUDA device" in out.stderr, flags
    assert not (tmp_path / "a.ddpexe").exists()
