"""``BENCHMARK.json`` and the files it names, found by name.

Layout under ``port_bench/``: ``configs/<config>.json`` (the file that
``BENCHMARK.json`` names), ``traffic/<traffic>.json``,
``metrics/<metric>.py`` (one reader per metric, end to end and per layer),
``counts/<config>.json`` (frozen operation counts),
``limits/<workload>.json`` (the limit of each number that decides
``correct``) and ``reference/<name>.py`` (a configuration's plain
reference, named by its file).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = Path(__file__).resolve().parents[1]


def _read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Spec:
    """The benchmark as ``BENCHMARK.json`` at ``root`` defines it."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root, self.dir = Path(root), Path(bench_dir)
        self.data = _read_json(self.root / "BENCHMARK.json")
        self.workloads = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.end_to_end = list(self.data["end_to_end"])
        self.per_layer = list(self.data["per_layer"])

    def workload(self, name: str) -> dict:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(self.workloads)})")
        return self.workloads[name]

    def config(self, name: str) -> dict:
        """The configuration's file, with the entry's name."""
        entry = self.configs[name]
        cfg = _read_json(self.root / entry["file"])
        if cfg.get("name", name) != name:
            raise ValueError(f"{entry['file']} names {cfg['name']!r}, "
                             f"not {name!r}")
        return dict(cfg, name=name)

    def traffic(self, name: str) -> dict:
        return _read_json(self.dir / "traffic" / f"{name}.json")

    def counts(self, config: str) -> dict:
        return _read_json(self.dir / "counts" / f"{config}.json")

    def limits(self, workload: str) -> dict:
        return _read_json(self.dir / "limits" / f"{workload}.json")

    def metrics_for(self, workload: str, trace: bool) -> list:
        """The metrics a run of ``workload`` reports: the end-to-end ones
        without a trace, the per-layer ones with it; a metric with a
        ``workloads`` key only in those cells."""
        pool = self.per_layer if trace else self.end_to_end
        return [m for m in pool
                if workload in m.get("workloads", (workload,))]

    def metric_reader(self, name: str):
        """``metrics/<name>.py``'s ``read(run)``."""
        path = self.dir / "metrics" / f"{name}.py"
        mod_name = "port_bench_metric_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def reference(self, name: str):
        """``reference/<name>.py`` as a module of the ``reference`` package."""
        return importlib.import_module(f"reference.{name}")
