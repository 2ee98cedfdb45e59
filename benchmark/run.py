"""Run one cell of BENCHMARK.json once, on the card this process is given.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernels' build on a checkout's first run, the scene's
load, the warm-up requests) is `setup_s`. The window then serves requests
one at a time for `--seconds` and the cell's driver reduces them to its
end-to-end metrics. With `--trace 1` the window runs the same, a few whole
requests are then profiled, and the line carries the cell's per-layer
metrics (`benchmark/metrics/<name>.py`) instead. Last, the driver checks
what the window produced against the plain reference, with the program's
state freed, and the last line of standard output is the result:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"], "checks"}

Exits non-zero with no result where there is no CUDA device or fewer than
the cell asks for, and where `jax`, `jaxlib`, `flax` or `mitsuba_tpu`
(top-level names, compared whole) was imported.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "mitsuba_tpu")


def cache_env():
    """Fixed build-cache directories inside the checkout (the port builds
    its CUDA libraries into mitsuba_tpu_torch/_build/ by itself)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(torch, device, peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak)}


class Context:
    """What the per-layer readers read: host spans (seconds), the window's
    counters, the profiled requests' device trace and query tally, the
    card's peaks."""

    def __init__(self, spans, counters, summary=None, tally=None, peaks=None):
        self.spans = spans
        self.counters = counters
        self.trace = summary
        self.tally = tally
        self.peaks = peaks


def peaks_for(kind: str):
    table = json.loads((ROOT / "benchmark" / "harness" / "peaks.json").read_text())
    return table.get(kind)


def main(argv=None, device=None, stdout=None, root=ROOT):
    """One run. `device` set (a test's CPU) skips the look for a card;
    `root` is the checkout whose BENCHMARK.json and data files name the
    cell (a test's scratch copy)."""
    args = parse(sys.argv[1:] if argv is None else argv)
    stdout = stdout or sys.stdout
    cache_env()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cell as celllib, profile, queries

    cell = celllib.resolve(args.workload, root)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    spans = {}
    tally = None
    if args.trace:
        tally = queries.Tally(celllib.kernel_entries(root))
        tally.install()
    driver = celllib.driver(cell, root).Driver(cell, device, args.seed, spans, tally)
    driver.setup()
    driver.sync()
    setup_s = time.perf_counter() - T_START

    before = driver.counters()
    records = []
    t0 = time.perf_counter()
    while not records or time.perf_counter() - t0 < args.seconds:
        records.append(driver.request())
    window_s = time.perf_counter() - t0
    counters = driver.window_counters(before, driver.counters(), records)
    e2e = {**driver.end_to_end(records, window_s), "setup_s": setup_s}

    summary = None
    if args.trace:
        tally.reset()
        _, summary = profile.trace_requests(driver.request, cell.traffic["profile_min_requests"],
                                            cell.traffic["profile_min_seconds"], device)
        tally.uninstall()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    info = device_info(torch, device, peak)

    driver.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    correct, checks = driver.check()

    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run imported {bad}", file=sys.stderr)
        return 3
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if args.trace:
        ctx = Context(spans, counters, summary, tally, peaks_for(info["kind"]))
        values = {m["name"]: celllib.reader(m["name"], root).read(ctx) for m in cell.per_layer}
        info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    else:
        values = {m["name"]: e2e[m["name"]] for m in cell.end_to_end}
    metrics = {k: {"value": float(v), "unit": units[k]} for k, v in values.items()
               if v is not None}
    result = {"correct": correct, "attempted": len(records), "failed": 0, "metrics": metrics,
              "device": info}
    if args.trace:
        result["breakdown"] = summary.breakdown()
    # a number that is not finite fails its check; JSON has no name for it
    result["checks"] = {name: {"value": c["value"] if math.isfinite(c["value"]) else None,
                               "limit": c["limit"]} for name, c in checks.items()}
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), file=stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
