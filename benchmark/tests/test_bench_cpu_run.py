"""Whole runs of each cell with the harness's look for a card skipped: the
run is correct against the plain reference, and with the timed path
broken underneath (each fault its driver names in `FAULTS`) it is not.

Here on the CPU the cells run at a tiny size: their configuration's
scene, sampler, spp, filter and integrator at a 32x32 film (the big mesh
with 4,644 triangles, still above the BVH threshold); an images cell
checks 4 images against 8 of the reference. The cells' limits hold at
their own sizes, on the card; readings at this size differ, so here they
are held to `TINY_LIMITS`, set from CPU readings as PERF.md records. The
faults caught at this size are `TINY_FAULTS`; the others (half the
samples, which only an image's noise shows) are caught on the card at the
cells' own size (`test_bench_card.py`), where the readings separate.
"""
from __future__ import annotations

import io
import json

import pytest
import torch

from benchmark.harness import cell as celllib, faults
from benchmark.tests.helpers import ROOT, edit_json, scratch_root

TINY = {
    "cornell_path.images": {"film__width": 32, "film__height": 32},
    "sphere70k.images": {"film__width": 32, "film__height": 32,
                         "geometry_args": {"nu": 80, "nv": 30}},
    "cornell_path.grad": {"film__width": 32, "film__height": 32},
}
TINY_LIMITS = {
    "cornell_path.images": {"bias_chi2": 6.0, "worst_image_error": 2.5},
    "sphere70k.images": {"bias_chi2": 6.0, "worst_image_error": 2.5},
    "cornell_path.grad": {"loss_gap": 2.0, "grad_gap": 0.5, "change_gap": 0.1,
                          "image_error": 2.0},
}
TINY_FAULTS = {
    "cornell_path.images": ["state_unchanged", "altered_image"],
    "sphere70k.images": ["state_unchanged", "altered_image"],
    "cornell_path.grad": ["state_unchanged", "altered_image"],
}
TINY_SECONDS = 20.0


def tiny_root(tmp_path, cell):
    root = scratch_root(tmp_path)
    c = celllib.resolve(cell, root)
    edit_json(root / "benchmark" / "configs" / c.config["name"] / "config.json", **TINY[cell])
    traffic = root / "benchmark" / "traffic" / f"{c.traffic['name']}.json"
    edit_json(traffic, profile_min_requests=1, profile_min_seconds=0.0)
    if "warmup_images" in c.traffic:
        edit_json(traffic, warmup_images=1)
    check = root / "benchmark" / "checks" / f"{cell}.json"
    edit_json(check, reference_images=8, limits=TINY_LIMITS[cell])
    if "checked_images" in c.check:
        edit_json(check, checked_images=4)
    return root


def run_cell(root, cell, device, seconds, trace=0, seed=2147483659):
    from benchmark import run

    out = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], device=device, stdout=out, root=root)
    assert rc == 0
    return json.loads(out.getvalue().splitlines()[-1])


def e2e_names(cell):
    return {m["name"] for m in celllib.resolve(cell, ROOT).end_to_end}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_run_is_correct(tmp_path, cell):
    res = run_cell(tiny_root(tmp_path, cell), cell, torch.device("cpu"), TINY_SECONDS)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == e2e_names(cell)
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell, expected", [
    # on the CPU: no device operation, no row in the table of peaks
    ("cornell_path.images", {"load_s", "replays_per_image.render", "device_idle.render"}),
    ("cornell_path.grad", {"load_s", "backward_s.grad", "device_idle.grad"}),
])
def test_tiny_traced_run(tmp_path, cell, expected):
    res = run_cell(tiny_root(tmp_path, cell), cell, torch.device("cpu"), TINY_SECONDS,
                   trace=1)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == expected
    assert res["device"]["window_s"] > 0 and "breakdown" in res


@pytest.mark.parametrize("cell, fault", [(c, f) for c in sorted(TINY) for f in TINY_FAULTS[c]])
def test_tiny_fault_is_caught(tmp_path, cell, fault):
    root = tiny_root(tmp_path, cell)
    with faults.planted(celllib.driver(celllib.resolve(cell, root), root).FAULTS[fault]):
        res = run_cell(root, cell, torch.device("cpu"), TINY_SECONDS)
    assert res["correct"] is False, res["checks"]


def test_tiny_limits_cover_the_cells_numbers():
    for cell in TINY:
        limits = json.loads((ROOT / "benchmark" / "checks" / f"{cell}.json").read_text())
        assert set(limits["limits"]) == set(TINY_LIMITS[cell])


def test_cell_config_and_metric_added_from_new_files(tmp_path):
    """A later change adds a configuration, a cell and a per-layer metric as
    new files and BENCHMARK.json entries; no file of the benchmark changes."""
    root = tiny_root(tmp_path, "cornell_path.images")
    bench_dir = root / "benchmark"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    cfg = json.loads((bench_dir / "configs" / "cornell_path" / "config.json").read_text())
    cfg["film"]["rfilter"] = "box"
    new_cfg = bench_dir / "configs" / "cornell_box" / "config.json"
    new_cfg.parent.mkdir()
    new_cfg.write_text(json.dumps(cfg))
    (bench_dir / "checks" / "cornell_box.images.json").write_text(
        (bench_dir / "checks" / "cornell_path.images.json").read_text())
    (bench_dir / "metrics" / "images_seen.py").write_text(
        "def read(ctx):\n    return ctx.counters.get('requests')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cornell_box", "source": "the cornell_path box",
                             "file": "benchmark/configs/cornell_box/config.json",
                             "reduced": cfg["reduced"], "why": "a box film"})
    bench["workloads"].append({"name": "cornell_box.images", "config": "cornell_box",
                               "traffic": "images", "chips": 1, "why": "a box film"})
    for m in bench["end_to_end"]:
        if "cornell_path.images" in m.get("workloads", []):
            m["workloads"].append("cornell_box.images")
    bench["per_layer"].append({"name": "images_seen", "unit": "images", "better": "higher",
                               "source": "program_counter", "layer": "compiled render",
                               "moves": "samples_per_s", "workloads": ["cornell_box.images"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell(root, "cornell_box.images", torch.device("cpu"), TINY_SECONDS, trace=1)
    assert res["correct"], res["checks"]
    assert res["metrics"]["images_seen"]["value"] >= 1
    assert all(p.read_bytes() == b for p, b in before.items())
