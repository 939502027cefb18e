"""The port's example scripts (``scripts/try_car_torch.py``,
``try_brachi_torch.py``, ``plot_car_torch.py``, ``plot_brachi_torch.py``)
against the JAX package's (``scripts/try_car.py``, ``try_brachi.py``):
each pair run as subprocesses at the same small arguments, the port's on
``--device cpu`` (the serial path, float64, as the JAX scripts), their
printed summaries parsed and compared at ``tests/test_torch_solver.py``'s
tolerances: status, iterations and success equal, cost to rtol 1e-8, the
final state to atol 1e-7.  The plot scripts write their PNG where
matplotlib is installed and, with it hidden, say that no PNG was written
and exit 0."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
NUM = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"
# the JAX scripts' arguments and the port's: car T=60 with 30 iterations,
# the Brachistochrone at n=50
RUNS = {
    "car_jax": ("try_car.py", "60", "30"),
    "car_torch": ("try_car_torch.py", "60", "30", "--device", "cpu"),
    "brachi_jax": ("try_brachi.py", "50"),
    "brachi_torch": ("try_brachi_torch.py", "50", "--device", "cpu"),
}
# a script run with matplotlib hidden: `import matplotlib` raises ImportError
HIDDEN = ("import runpy, sys; sys.modules['matplotlib'] = None; "
          "sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], "
          "run_name='__main__')")


def _start(args, hide_matplotlib=False):
    cmd = [sys.executable] + (["-c", HIDDEN] if hide_matplotlib else [])
    cmd += [os.path.join(SCRIPTS, args[0]), *args[1:]]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=dict(os.environ, JAX_PLATFORMS="cpu",
                                     OMP_NUM_THREADS="1"))


def _finish(procs: dict) -> dict:
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=400)
            out[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.fixture(scope="module")
def summaries():
    """``{run: (rc, stdout, stderr)}`` of the four try scripts, started
    together."""
    return _finish({name: _start(args) for name, args in RUNS.items()})


def _parse(out) -> dict:
    """The summary's values by label."""
    rc, stdout, stderr = out
    assert rc == 0, stderr[-3000:]

    def nums(label):
        m = re.search(rf"^{re.escape(label)}(.*)$", stdout, re.M)
        assert m, f"no {label!r} line in:\n{stdout}"
        # numpy 2 prints a list of its scalars as [np.float64(x), ...]
        text = m.group(1).replace("np.float64(", "(")
        return [float(v) for v in re.findall(NUM, text)]

    res = re.search(r"success: (True|False) status: (\d+) iters: (\d+)",
                    stdout)
    assert res, stdout
    cost, g_norm, lam = nums("cost:")
    rec = dict(success=res.group(1) == "True", status=int(res.group(2)),
               iterations=int(res.group(3)), cost=cost, g_norm=g_norm,
               lam=lam)
    if "final state:" in stdout:
        rec["final"] = nums("final state:")
        rec["bounds"] = nums("u in bounds:")
        rec["ms_per_iter"] = nums("run:")[1]
    else:
        rec["final"] = nums("y_final:")[:1]
        rec["cycloid"] = nums("cycloid errors at quarter points:")
    return rec


@pytest.mark.parametrize("case", ["car", "brachi"])
def test_try_script_matches_jax(summaries, case):
    jax_rec = _parse(summaries[f"{case}_jax"])
    rec = _parse(summaries[f"{case}_torch"])
    assert "device: cpu" in summaries[f"{case}_torch"][1]
    for key in ("success", "status", "iterations"):
        assert rec[key] == jax_rec[key], key
    np.testing.assert_allclose(rec["cost"], jax_rec["cost"], rtol=1e-8)
    np.testing.assert_allclose(rec["final"], jax_rec["final"], atol=1e-7)
    if case == "car":
        # "u in bounds: |w| <=0.5; |a| <=2.0"
        w, w_lim, a, a_lim = rec["bounds"]
        assert (w_lim, a_lim) == (0.5, 2.0) and w <= w_lim and a <= a_lim
        np.testing.assert_allclose(rec["bounds"], jax_rec["bounds"],
                                   atol=1e-7)
    else:
        assert len(rec["cycloid"]) == 4
        np.testing.assert_allclose(rec["cycloid"], jax_rec["cycloid"],
                                   atol=1e-7)


PLOTS = {"car": ("plot_car_torch.py", "60", "30"),
         "brachi": ("plot_brachi_torch.py",)}


@pytest.fixture(scope="module")
def plots(tmp_path_factory):
    """Each plot script run with matplotlib and with it hidden, all started
    together: ``{(case, hidden): ((rc, stdout, stderr), png path)}``."""
    tmp = tmp_path_factory.mktemp("plots")
    procs, pngs = {}, {}
    for case, args in PLOTS.items():
        for hidden in (False, True):
            png = str(tmp / f"{case}_{int(hidden)}.png")
            pngs[(case, hidden)] = png
            procs[(case, hidden)] = _start((*args, png, "--device", "cpu"),
                                           hide_matplotlib=hidden)
    out = _finish(procs)
    return {k: (v, pngs[k]) for k, v in out.items()}


@pytest.mark.parametrize("hidden", [False, True],
                         ids=["matplotlib", "no_matplotlib"])
@pytest.mark.parametrize("case", list(PLOTS))
def test_plot_script(plots, case, hidden):
    if not hidden:
        pytest.importorskip("matplotlib")
    (rc, stdout, stderr), png = plots[(case, hidden)]
    assert rc == 0, stderr[-3000:]
    assert "success: True" in stdout
    if hidden:
        assert "no PNG written" in stdout
        assert not os.path.exists(png)
    else:
        assert f"wrote {png}" in stdout
        with open(png, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
