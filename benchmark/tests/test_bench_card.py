"""On the card, at each cell's own size and limits: the control (the plain
reference computed in bfloat16, the precision below the configurations'
float32, put in the program's place) fails on three seeds while the
program passes; and a short run (a 10 s window, the harness's look for a
card skipped) with each fault of the cell's driver (`FAULTS`) planted in
the timed path comes out not correct. `python -m pytest benchmark/tests
-q -m cuda`.
"""
from __future__ import annotations

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import cell as celllib, faults
from benchmark.reference import compare
from benchmark.tests.helpers import ROOT
from benchmark.tests.test_bench_cpu_run import run_cell

CELLS = [w["name"] for w in celllib.load_benchmark(ROOT)["workloads"]]
CELL_FAULTS = [(c, f) for c in CELLS
               for f in celllib.driver(celllib.resolve(c, ROOT), ROOT).FAULTS]


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_and_program_passes(cuda_device, cell_name):
    cell = celllib.resolve(cell_name, ROOT)
    limits = cell.check["limits"]
    for seed in calibrate.seeds(3, 5551212):
        d = calibrate.driver_for(cell, cuda_device, seed)
        try:
            ok, checks = compare.judge(d.readings(), limits)
            assert ok, (seed, checks)
            ok, checks = compare.judge(d.readings(dtype=torch.bfloat16), limits)
            assert not ok, (seed, checks)
        finally:
            d.cleanup()


@pytest.mark.cuda
@pytest.mark.parametrize("cell, fault", CELL_FAULTS)
def test_fault_is_caught(cuda_device, cell, fault):
    with faults.planted(celllib.driver(celllib.resolve(cell, ROOT), ROOT).FAULTS[fault]):
        res = run_cell(ROOT, cell, cuda_device, 10.0)
    assert res["correct"] is False, res["checks"]
