"""Where a cell's time goes, by the program's own spans: one run of a cell
as `run.py` makes it (set-up, a window of `--seconds`, whole requests
profiled after it), its trace split over the `mitsuba.*` spans
(`harness/spans.py`), and the window's rays handed to the trace kernels
(the kernel modules' `KERNEL_RAYS`).

    python3 benchmark/attribute.py --workload <cell> --seed <n> [--seconds <s>] [--span-cost <n>]

Prints one JSON line: the profiled requests' `program_idle_gaps`,
`program_device_ops`, `backward_by_forward_span` and
`backward_by_span_and_node` (the top 10 of each);
in an images cell also `chunk_device_ops_by_span`, from one eager chunk
of the render at the graph's chunk (a replayed graph's kernels cannot be
split by span); `readings`, the numbers the span metrics of a traced run
would read; and `sums`, what the attributions must add up to.
`--span-cost n` profiles n more requests with the spans on and n with
them made no-ops, in turns, and reports the host seconds of each
request's `bench.forward` span (the grad cell) or `bench.render` span.
Needs a CUDA device; runs no check against the reference. A device
number is read only from a run on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_events(fn, device) -> list:
    """The Chrome-trace events of fn() run inside `bench.window`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness.profile import WINDOW

    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def trace_requests(driver, traffic, device):
    """(requests profiled, events): at least the traffic's profiled
    requests and seconds, as `harness/profile.trace_requests` takes them."""
    n = [0]

    def requests():
        t0 = time.perf_counter()
        while n[0] < traffic["profile_min_requests"] or \
                time.perf_counter() - t0 < traffic["profile_min_seconds"]:
            driver.request(traced=True)
            n[0] += 1

    events = profile_events(requests, device)
    return n[0], events


def kernel_rays() -> int:
    from mitsuba_tpu_torch.ops import brute_kernel, bvh_kernel

    return sum(brute_kernel.KERNEL_RAYS.values()) + sum(bvh_kernel.KERNEL_RAYS.values())


def chunk_events(driver, device) -> list:
    """One eager chunk of the images cell's render at the graph's chunk:
    the replayed kernels, launched one by one under their spans."""
    import torch

    from mitsuba_tpu_torch.integrators import common

    scene, cam, cfg = driver.scene, driver.cam, driver.cfg
    chunk = cfg.resolve_chunk(cam.width, cam.height)
    pixel_ids = torch.arange(cam.width * cam.height, dtype=torch.int64, device=device)
    layout = common.chunk_layout(pixel_ids, chunk, cam.width)
    base = torch.zeros((), dtype=torch.int64, device=device)
    with torch.no_grad():
        common.chunk_sum(scene, cam, driver.li, cfg, layout, base, chunk)
        return profile_events(
            lambda: common.chunk_sum(scene, cam, driver.li, cfg, layout, base, chunk), device)


def _span_seconds(events, name) -> list:
    return [e["dur"] / 1e6 for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation" and e.get("name") == name]


def span_cost(driver, device, n: int, name: str) -> dict:
    """Host seconds of the request span `name`, spans on against spans
    made no-ops (every module's `span` bound to the no-op), in turns."""
    from mitsuba_tpu_torch.utils import stats

    span = stats.span
    users = [m for k, m in sys.modules.items() if k.startswith("mitsuba_tpu_torch")
             and m is not stats and getattr(m, "span", None) is span]
    out = {"on": [], "off": []}
    for i in range(2 * n):
        off = i % 2 == 1
        for m in users:
            m.span = (lambda _name: stats._NO_SPAN) if off else span
        try:
            events = profile_events(lambda: driver.request(traced=True), device)
        finally:
            for m in users:
                m.span = span
        out["off" if off else "on"] += _span_seconds(events, name)
    return {k: {"median_s": statistics.median(v), "values": v} for k, v in out.items()}


def readings(cell, records, rays, n_profiled, idle, backward, chunk) -> dict:
    """The numbers the span metrics of a traced run would read."""
    per = 1.0 / n_profiled
    if cell.traffic["driver"] == "images":
        samples = sum(r["samples"] for r in records)
        chunk_total = sum(chunk.values())
        return {
            "rays_per_sample.render": rays / samples if samples else None,
            "jit_idle_ms.render": 1e3 * per * sum(
                v for k, v in idle.items() if k.startswith("mitsuba.render_jit")),
            "sampler_share.render": 100.0 * chunk.get("mitsuba.sampler", 0.0) / chunk_total
            if chunk_total else None,
        }
    return {
        "forward_idle_s.grad": per * sum(v for k, v in idle.items() if k != "none"),
        "trace_backward_s.grad": per * backward.get("mitsuba.trace", 0.0),
        "shading_backward_s.grad": per * backward.get("mitsuba.shading", 0.0),
        "film_backward_s.grad": per * backward.get("mitsuba.film", 0.0),
    }


def main(argv=None, device=None, stdout=None, root=ROOT):
    """One run; `device` set (a test's CPU) skips the look for a card,
    `root` is the checkout whose files name the cell."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--span-cost", type=int, default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import run
    from benchmark.harness import cell as celllib, profile, spans

    run.cache_env()
    if device is None:
        if not torch.cuda.is_available():
            print("attribute: needs a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    cell = celllib.resolve(args.workload, root)
    driver = celllib.driver(cell, root).Driver(cell, device, args.seed, {}, None)
    driver.setup()
    driver.sync()

    rays0, records, t0 = kernel_rays(), [], time.perf_counter()
    while not records or time.perf_counter() - t0 < args.seconds:
        records.append(driver.request())
    driver.sync()
    rays = kernel_rays() - rays0

    n, events = trace_requests(driver, cell.traffic, device)
    summary = profile.summarize(events)
    tr = spans.ProgramTrace(events)
    idle = spans.program_idle(events, tr)
    device_ops = spans.program_device(events, tr)
    backward = spans.backward_device(events, tr)
    engine_s = sum(s for s, launch in tr.kernels_in_window()
                   if launch and launch[0] != tr.window_tid)
    chunk = spans.program_device(chunk_events(driver, device)) \
        if cell.traffic["driver"] == "images" else {}
    result = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "window_requests": len(records), "window_rays": rays, "profiled_requests": n,
        "readings": readings(cell, records, rays, n, idle, backward, chunk),
        "sums": {"window_s": summary.window_s, "busy_s": summary.busy_s,
                 "idle_s": summary.window_s - summary.busy_s,
                 "program_idle_s": sum(idle.values()),
                 "bench_idle_s": summary.idle_by_span,
                 "kernel_s": sum(summary.kernel_s.values()),
                 "program_device_s": sum(device_ops.values()),
                 "backward_s": sum(backward.values()),
                 "off_window_thread_kernel_s": engine_s},
        "breakdown": {"program_idle_gaps": spans.top(idle),
                      "program_device_ops": spans.top(device_ops),
                      "backward_by_forward_span": spans.top(backward),
                      "backward_by_span_and_node": spans.top(
                          spans.backward_device(events, tr, by_node=True)),
                      "chunk_device_ops_by_span": spans.top(chunk),
                      "device_ops": summary.breakdown()["device_ops"]},
    }
    if args.span_cost:
        name = "bench.forward" if cell.traffic["driver"] == "grad" else "bench.render"
        result["span_cost"] = span_cost(driver, device, args.span_cost, name)
    print(json.dumps(result), file=stdout or sys.stdout, flush=True)
    driver.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
