"""BENCHMARK.json against the benchmark's contract, and every cell's files
resolved by name."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark.harness import cell as celllib
from benchmark.tests.helpers import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for c in BENCH["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        limit = 0.25
        assert 0.01 <= m["bound"] <= limit
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert _line(m["layer"])


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        mine = [m["name"] for m in BENCH["end_to_end"] if celllib.reports(m, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in BENCH["per_layer"] if celllib.reports(m, w["name"])]
        assert layer
        for m in layer:
            assert m["moves"] in mine, (m["name"], w["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


def test_every_cell_resolves_by_name():
    for w in BENCH["workloads"]:
        cell = celllib.resolve(w["name"], ROOT)
        cfg_file = ROOT / next(c["file"] for c in BENCH["configs"] if c["name"] == w["config"])
        assert cfg_file.is_relative_to(ROOT / "benchmark")
        assert cell.config["reduced"] == next(c["reduced"] for c in BENCH["configs"]
                                              if c["name"] == w["config"])
        drv = celllib.driver(cell, ROOT)
        assert hasattr(drv, "Driver")
        assert set(cell.check["limits"])
        assert set(drv.FAULTS) >= {"state_unchanged", "half_the_samples", "altered_image"}
        for module, attr, wrap in drv.FAULTS.values():
            assert callable(wrap)
        for m in cell.per_layer:
            assert callable(celllib.reader(m["name"], ROOT).read)


def test_kernel_entries_name_real_entries():
    import importlib

    for spec in celllib.kernel_entries(ROOT):
        mod = importlib.import_module(spec["module"])
        assert callable(getattr(mod, spec["entry"])), spec["name"]
        assert spec["kernel"] and spec["rays"]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "mitsuba_tpu_torch_like", sys)
    assert "mitsuba_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mitsuba_tpu.ops", sys)
    assert "mitsuba_tpu" in run.forbidden_modules()


@pytest.mark.parametrize("modules, banned", [
    # what a run imports: the harness, the drivers, the readers, the program
    (["benchmark.run", "benchmark.harness.cell", "benchmark.harness.profile",
      "benchmark.harness.queries", "benchmark.inputs.scene_file", "benchmark.calibrate",
      "mitsuba_tpu_torch.cli", "mitsuba_tpu_torch.integrators.common",
      "mitsuba_tpu_torch.integrators.path", "mitsuba_tpu_torch.integrators.boundary",
      "mitsuba_tpu_torch.scene.xml", "benchmark.harness.faults",
      "mitsuba_tpu_torch.scene.bvh", "mitsuba_tpu_torch.ops.brute_kernel",
      "mitsuba_tpu_torch.ops.bvh_kernel"], ["jax", "jaxlib", "flax", "mitsuba_tpu"]),
    # the plain reference imports nothing of the program either
    (["benchmark.reference.scene", "benchmark.reference.intersect",
      "benchmark.reference.pathtracer", "benchmark.reference.compare",
      "benchmark.reference.gradstep"],
     ["jax", "jaxlib", "flax", "mitsuba_tpu", "mitsuba_tpu_torch"]),
])
def test_imports_stay_clear(modules, banned):
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, env={**os.environ, "USE_FLAX": "0"})
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & set(banned), tops & set(banned)
