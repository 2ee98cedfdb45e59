"""A cell of BENCHMARK.json and the files it resolves to, by name.

A cell `<config>.<traffic>` reads:
- the configuration's `file` (under `benchmark/configs/<config>/`),
- the traffic mix `benchmark/traffic/<traffic>.json`, whose `driver`
  names the module `benchmark/drivers/<driver>.py` that serves it,
- its correctness limits `benchmark/checks/<cell>.json`,
- each per-layer metric's reader `benchmark/metrics/<metric>.py`,
- every trace-kernel entry `benchmark/kernels/*.json`.
A later cell, configuration, traffic mix, metric or kernel entry is new
files and new entries of BENCHMARK.json; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration's file, with "name"
    config_dir: Path
    traffic: dict           # the traffic mix's file, with "name"
    check: dict             # the correctness check's sizes and {number: limit}
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload '{name}'; have {sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg_file = root / cfg_entry["file"]
    config = {**json.loads(cfg_file.read_text()), "name": cfg_entry["name"]}
    traffic = {**json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json")
                            .read_text()), "name": w["traffic"]}
    check = json.loads((root / "benchmark" / "checks" / f"{name}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config, config_dir=cfg_file.parent,
                traffic=traffic, check=check,
                end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def load_module(path: Path, name: str):
    """Import a file of the benchmark by path (metric readers have dots in
    their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell, root: Path = ROOT):
    return load_module(root / "benchmark" / "drivers" / f"{cell.traffic['driver']}.py",
                       f"bench_driver_{cell.traffic['driver']}")


def reader(metric: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "metrics" / f"{metric}.py",
                       "bench_metric_" + metric.replace(".", "_"))


def kernel_entries(root: Path = ROOT) -> list:
    return [{**json.loads(p.read_text()), "name": p.stem}
            for p in sorted((root / "benchmark" / "kernels").glob("*.json"))]
