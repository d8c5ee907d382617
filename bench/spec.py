"""Finds a cell's parts by name: ``BENCHMARK.json``, the configuration file
it names, ``bench/traffic/<mix>.json``, ``bench/limits/<cell>.json`` and
``bench/metrics/<metric>.py``.  A new configuration, mix or metric is new
files and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise KeyError(f"BENCHMARK.json has no config {name!r}")


def traffic(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def limits(name: str) -> dict:
    return _json(BENCH / "limits" / f"{name}.json")


def metrics(bench: dict, cell_name: str, traced: bool) -> list:
    """The cell's metric entries: with ``traced`` its per-layer metrics,
    else its end-to-end ones."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def reader(name: str):
    """``bench/metrics/<name>.py``'s ``read(run) -> float | None``."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                      path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
