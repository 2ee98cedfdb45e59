"""Helpers of the benchmark's tests."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DATA_DIRS = ("configs", "traffic", "checks", "kernels", "metrics", "drivers", "harness")


def scratch_root(tmp_path: Path) -> Path:
    """A copy of BENCHMARK.json and the benchmark's data files: a checkout
    that a test may add to."""
    (tmp_path / "benchmark").mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in DATA_DIRS:
        shutil.copytree(ROOT / "benchmark" / d, tmp_path / "benchmark" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def edit_json(path: Path, **changes):
    data = json.loads(path.read_text())
    for key, value in changes.items():
        node = data
        *parents, last = key.split("__")
        for p in parents:
            node = node[p]
        node[last] = value
    path.write_text(json.dumps(data))
