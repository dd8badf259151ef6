"""The benchmark is driven by data: a configuration, a traffic mix, a
cell's checks and a per-layer metric are files found by the name
`BENCHMARK.json` gives them, so a later change adds them without editing
a file. And `BENCHMARK.json` keeps to the shape the benchmark's contract
sets: its keys, names, units and files."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest

from portbench import harness, spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\t\n\r]{1,200}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and bench["command"] == ["python3", "portbench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_units(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for e in bench[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher"), e["name"]
            assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for key in ("why", "layer") + (("source",) if section == "configs" else ()):
            if key in e:
                assert LINE.fullmatch(e[key]), (e["name"], key)


def test_cells_metrics_and_files(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for c in configs.values():
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in cells.values()), c["name"]
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    for w in cells.values():
        assert w["config"] in configs and w["chips"] in (1, 4) and NAME.fullmatch(w["traffic"])
        reported = [m for m in bench["end_to_end"] if spec.reports(m, w["name"])]
        assert {"setup_s"} < {m["name"] for m in reported}, w["name"]
        layers = [m for m in bench["per_layer"] if spec.reports(m, w["name"])]
        assert layers and all(spec.reports(next(x for x in bench["end_to_end"] if x["name"] == m["moves"]),
                                           w["name"]) for m in layers), w["name"]
        spec.resolve(w["name"], ROOT)  # every file of the cell is there and readable
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and a cell as new files (and entries of BENCHMARK.json); the
    harness resolves each by name and runs the cell, no file edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    pb = tmp_path / "portbench"
    config = json.loads((pb / "configs" / "analytical-demo.json").read_text())
    config["scene"]["lights"][".emission.x"] = [5.0]
    (pb / "configs" / "brighter-demo.json").write_text(json.dumps(config))
    mix = json.loads((pb / "traffic" / "frames.json").read_text())
    mix.update(width=40, height=20, spp=2)
    (pb / "traffic" / "small-frames.json").write_text(json.dumps(mix))
    (pb / "checks" / "brighter.small-frames.json").write_text(json.dumps(
        {"sample": 1, "limits": {"frame_q999": 1e-4, "frame_mean": 1e-5, "accumulate_max": 0.0}}))
    (pb / "metrics" / "frames_done.small.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "brighter-demo", "source": "https://example.org/brighter",
                             "file": "portbench/configs/brighter-demo.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "brighter.small-frames", "config": "brighter-demo",
                               "traffic": "small-frames", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "frame_ms":
            m["workloads"].append("brighter.small-frames")
    bench["per_layer"].append({"name": "frames_done.small", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "frame_ms",
                               "workloads": ["brighter.small-frames"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.resolve("brighter.small-frames", tmp_path)
    assert cell.config["scene"]["lights"][".emission.x"] == [5.0]
    assert (cell.traffic["width"], cell.traffic["spp"]) == (40, 2)
    assert [m["name"] for m, _ in cell.per_layer] == ["frames_done.small"]
    result, _ = harness.run("brighter.small-frames", 3, 0.2, False, time.perf_counter(), root=tmp_path,
                            device="cpu")
    assert result["correct"] and set(result["metrics"]) == {"frame_ms", "setup_s"}
    result, _ = harness.run("brighter.small-frames", 3, 0.2, True, time.perf_counter(), root=tmp_path,
                            device="cpu")
    assert result["metrics"]["frames_done.small"]["value"] == result["attempted"]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_missing_file_is_named(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    with pytest.raises(FileNotFoundError, match="analytical-demo"):
        spec.resolve("analytical.frames", tmp_path)
    with pytest.raises(ValueError):
        spec.named_file(ROOT, "traffic", "../frames", ".json")
