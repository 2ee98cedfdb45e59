"""The device trace of a few whole requests: torch.profiler's record of
every operation on the card, reduced to what the per-layer metrics read.

`summarize(events)` takes the Chrome-trace events the profiler exports:
- the window: the host span `bench.window` around the profiled requests;
- busy: the union of the intervals of every device operation (kernels,
  copies, fills) inside the window, so that operations that overlap are
  counted once; idle is the window less busy;
- the device seconds of each kernel name (summed; operations that overlap
  each count their own time);
- the idle time under each host span: each idle gap split over the
  innermost `bench.*` span the host was in ("outside" where it was in
  none).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: dict          # kernel name -> summed device seconds
    idle_by_span: dict      # host span -> idle seconds

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name holds any of `names`."""
        return sum(s for k, s in self.kernel_s.items() if any(n in k for n in names))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def union(intervals):
    """Merged, sorted [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events) -> Summary:
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("bench.")]
    win = next(e for e in spans if e["name"] == WINDOW)
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    dev, kernel_s = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        s0, s1 = max(s, w0), min(s + d, w1)
        if s1 <= s0:
            continue
        dev.append((s0, s1))
        if e["cat"] == "kernel":
            kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + (s1 - s0) / 1e6
    busy = union(dev)
    # elementary host segments, each under its innermost bench.* span
    inner = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in spans if e["name"] != WINDOW]
    cuts = sorted({w0, w1, *(min(max(t, w0), w1) for a, b, _ in inner for t in (a, b))})
    segments = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        held = [(hi - lo, n) for lo, hi, n in inner if lo <= a and b <= hi]
        segments.append((a, b, min(held)[1] if held else "outside"))
    gaps, cursor = [], w0
    for s0, s1 in busy + [[w1, w1]]:
        if s0 > cursor:
            gaps.append((cursor, s0))
        cursor = max(cursor, s1)
    idle_by_span, i = {}, 0
    for g0, g1 in gaps:
        while segments[i][1] <= g0:
            i += 1
        j = i
        while j < len(segments) and segments[j][0] < g1:
            a, b, name = segments[j]
            idle_by_span[name] = idle_by_span.get(name, 0.0) + (min(b, g1) - max(a, g0)) / 1e6
            j += 1
    return Summary(window_s=(w1 - w0) / 1e6, busy_s=sum(e - s for s, e in busy) / 1e6,
                   kernel_s=kernel_s, idle_by_span=idle_by_span)


def trace_requests(request, min_requests: int, min_seconds: float, device) -> tuple:
    """Profile whole requests after the window: at least `min_requests`
    and `min_seconds` of them, each `request(traced=True)`. Returns (the
    number profiled, Summary)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    n = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            while n < min_requests or time.perf_counter() - t0 < min_seconds:
                request(traced=True)
                n += 1
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return n, summarize(events)
