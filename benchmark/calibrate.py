"""Readings that a cell's correctness limits are set from, all in one
process on the card, at the cell's own size:

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--out chiprun_out/calib.jsonl]

For each seed: the cell's driver sets up as a run does, leaves what a
window would leave for the check (`Driver.sample_window`: for images, the
`checked_images` that a window of the check's `window_images` would keep,
drawn from the seed), and prints the compared numbers against the plain
reference (`"kind": "program"`), with the driver's readings that are not
compared (`notes`). For the control seeds, the same numbers with the
reference computed in bfloat16 in the program's place (`"kind":
"control_bf16"`), and for each fault of the cell's driver (`FAULTS`),
planted in the timed path of a fresh set-up (`"kind": <fault>`). One JSON
line each.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds(n, base):
    rng = random.Random(base)
    return [rng.randrange(2 ** 31, 2 ** 32) for _ in range(n)]


def driver_for(cell, device, seed):
    """A driver set up and holding what a window would leave for the check."""
    from benchmark.harness import cell as celllib

    d = celllib.driver(cell, ROOT).Driver(cell, device, seed, {})
    d.setup()
    d.sample_window()
    return d


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--base", type=int, default=20261017)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cell as celllib, faults

    cell = celllib.resolve(args.workload, ROOT)
    planted = celllib.driver(cell, ROOT).FAULTS
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(**rec):
        line = json.dumps({"workload": args.workload, **rec})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(seeds(args.seeds, args.base)):
        t0 = time.perf_counter()
        d = driver_for(cell, device, seed)
        t1 = time.perf_counter()
        vals = d.readings()
        emit(kind="program", seed=seed, **vals, **d.notes(), setup_s=t1 - t0,
             reference_s=time.perf_counter() - t1)
        if i < args.control_seeds:
            t1 = time.perf_counter()
            emit(kind="control_bf16", seed=seed, **d.readings(dtype=torch.bfloat16),
                 seconds=time.perf_counter() - t1)
        d.cleanup()
        if i < args.control_seeds:
            for name, fault in planted.items():
                with faults.planted(fault):
                    f = driver_for(cell, device, seed)
                emit(kind=name, seed=seed, **f.readings(), **f.notes())
                f.cleanup()
    if out:
        out.close()


if __name__ == "__main__":
    main()
