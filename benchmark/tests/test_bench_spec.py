"""BENCHMARK.json against the benchmark's files, the character rules of
its names, and a configuration, traffic and metric added as new files and
entries alone."""

from __future__ import annotations

import json
import re
import shutil
from types import SimpleNamespace

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            texts = [e[k] for k in ("why", "layer") if k in e]
            if group == "configs":
                texts.append(e["source"])
            for text in texts:
                assert 1 <= len(text) <= 200 and "\n" not in text
                assert "\t" not in text
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    assert 1 <= bench["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_cell_finds_its_files_and_reports_what_it_must(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = spec.find_cell(bench, w["name"])
        assert w["chips"] == 1
        spec.module("drivers", cell.traffic["driver"]).Driver
        spec.module("scenes", cell.config["scene"]).build
        spec.module("reference", cell.config["reference"]).run
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer + cell.end_to_end:
            spec.metric_reader(m["name"])
        for m in cell.per_layer:
            assert m["moves"] in e2e and m["moves"] in reported
    for c in bench["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            assert json.load(f)["name"] == c["name"]


def test_layers_are_named_alike(bench):
    perf = (spec.ROOT / "PERF.md").read_text()
    for m in bench["per_layer"]:
        assert f"`{m['layer']}`" in perf, m["layer"]


def test_new_cell_config_traffic_and_metric_are_files_and_entries(
        tmp_path, monkeypatch):
    """A later change adds a configuration, a traffic mix and a metric by
    adding files and entries: the harness finds them by name."""
    base = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((base / "configs" / "bonded_colony.json").read_text())
    cfg.update(name="bonded_colony_loose", jitter=0.5)
    (base / "configs" / "bonded_colony_loose.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "colony_frames_1m.json")
                         .read_text())
    traffic["cells"] = 262144
    (base / "traffic" / "colony_frames_256k.json").write_text(
        json.dumps(traffic))
    (base / "metrics" / "frames_per_s.py").write_text(
        "def read(ctx):\n    return len(ctx.frame_s) / ctx.window_s\n")
    bench = spec.load_benchmark()
    bench["configs"].append({"name": "bonded_colony_loose", "source": "x",
                             "file": "benchmark/configs/"
                                     "bonded_colony_loose.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "colony_256k_loose", "chips": 1,
                               "config": "bonded_colony_loose",
                               "traffic": "colony_frames_256k", "why": "x"})
    bench["end_to_end"].append({"name": "frames_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["colony_256k_loose"]})
    monkeypatch.setattr(spec, "BENCH_DIR", base)
    cell = spec.find_cell(bench, "colony_256k_loose")
    assert cell.config["jitter"] == 0.5
    assert cell.traffic["cells"] == 262144
    names = [m["name"] for m in cell.end_to_end]
    assert "frames_per_s" in names and "setup_s" in names
    read = spec.metric_reader("frames_per_s")
    assert read(SimpleNamespace(frame_s=[0.5, 0.5], window_s=1.0)) == 2.0
    assert spec.module("drivers", cell.traffic["driver"]).Driver
