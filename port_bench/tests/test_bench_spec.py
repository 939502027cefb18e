"""BENCHMARK.json and the files it names, found by name."""

import json
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files(spec):
    for name, cell in spec.workloads.items():
        cfg = spec.config(cell["config"])
        assert cfg["name"] == cell["config"]
        traffic = spec.traffic(cell["traffic"])
        assert traffic["entry"] in ("stepwise", "solve")
        limits = spec.limits(name)["limits"]
        assert limits and all(isinstance(v, float) for v in limits.values())
        counts = spec.counts(cell["config"])
        assert {"b1", "b2", "b3"} <= set(counts)
        ref = spec.reference(cfg["reference"])
        assert callable(ref.numbers)


def test_every_metric_has_a_reader(spec):
    for m in spec.end_to_end + spec.per_layer:
        assert NAME.match(m["name"]), m["name"]
        assert callable(spec.metric_reader(m["name"]))
        for w in m.get("workloads", ()):
            assert w in spec.workloads


def test_metrics_for_a_cell(spec):
    names = {m["name"] for m in spec.metrics_for(
        "car_parking_f32_kernel.single", trace=False)}
    assert names == {"solve_ms_p50", "setup_s"}
    names = {m["name"] for m in spec.metrics_for(
        "car_parking_f32_kernel.batch2048", trace=True)}
    assert {"b1_roofline_pct", "device_idle_pct.batch"} <= names
    assert "device_loop.trip_ms" not in names


def test_every_cell_reports_setup_another_metric_and_a_layer(spec):
    for name in spec.workloads:
        e2e = {m["name"] for m in spec.metrics_for(name, trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_for(name, trace=True)
    for m in spec.per_layer:
        moved = next(e for e in spec.end_to_end if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in moved.get("workloads", spec.workloads)


def test_run_py_names_no_config_mix_or_metric(spec):
    text = (BENCH / "run.py").read_text()
    text += "".join(p.read_text() for p in (BENCH / "harness").glob("*.py"))
    names = set(spec.workloads) | set(spec.configs)
    names |= {c["traffic"] for c in spec.workloads.values()}
    names |= {m["name"] for m in spec.end_to_end + spec.per_layer}
    for n in names:
        assert not re.search(rf"\b{re.escape(n)}\b", text), n


def test_benchmark_json_shape():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= data["run_seconds"] <= 51
    for c in data["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(data["paths"][0] + "/")
    for m in data["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
