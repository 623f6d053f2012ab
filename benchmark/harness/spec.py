"""A cell's files, found by the names in BENCHMARK.json: its
configuration (`configs/<config>.json`), its traffic (`traffic/
<traffic>.json`), the driver that traffic names (`drivers/<driver>.py`),
the configuration's input generator (`scenes/<scene>.py`) and plain
reference (`reference/<reference>.py`), and a reader for each per-layer
metric (`metrics/<metric>.py`). Adding a cell, a configuration or a metric
adds files and entries; no file here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    entry: dict           # the cell's entry of BENCHMARK.json `workloads`
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    end_to_end: list      # the end-to-end metrics this cell reports
    per_layer: list       # the per-layer metrics this cell reports


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(kind: str, name: str) -> dict:
    with open(BENCH_DIR / kind / f"{name}.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> Cell:
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise SystemExit(f"unknown workload {name!r} (known: {known})")
    entry = entries[0]
    return Cell(
        name=name, entry=entry,
        config=load_json("configs", entry["config"]),
        traffic=load_json("traffic", entry["traffic"]),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def module(kind: str, name: str):
    """benchmark.<kind>.<name>, a module named like a package member."""
    return importlib.import_module(f"benchmark.{kind}.{name}")


def metric_reader(name: str):
    """The `read(ctx)` of metrics/<name>.py; a metric's name may hold dots,
    so the file is loaded by its path."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
