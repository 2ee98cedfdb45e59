"""Statistics / profiling counters + progress reporting (a copy of the
JAX package's utils/stats.py).

Reference: include/mitsuba/core/statistics.h — StatsCounter (:94) with
cache-line-padded per-core slots (:49,73), ProgressReporter (:287),
Statistics::printStats (mitsuba.cpp:408) printing the grouped counter
table at exit.

The reference pads counters across cores because CPU threads contend;
here per-lane counting happens on the device as reductions over masks
(e.g. path.li_with_stats' useful-ray count), so the registry is
host-side: render paths hand their reduced totals back as scalars,
`record`/`add` file them under dotted categories, and `print_stats()`
renders the same grouped report. Counters can also carry
a base for ratio statistics (percentage-of-base, statistics.h EPercentage
analog).

`span(name)` marks a layer of the renderer (the compiled render's host
work, the sampler, trace, shading, film, the gradient forward) for
torch.profiler: while a profiler records, it is a `record_function`
named "mitsuba." + name, in the same trace as the device's kernels and on
their clock; otherwise it is one shared no-op context that reads no
clock. A span's parent is the span around it on the same host thread. It
opens and closes in Python only, so a replayed CUDA graph opens none.
"""
from __future__ import annotations

import contextlib
import sys
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range "mitsuba.<name>" while torch.profiler records,
    else a shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function("mitsuba." + name)
    return _NO_SPAN


@dataclass
class _Counter:
    value: float = 0.0
    base: float = 0.0
    unit: str = ""
    is_ratio: bool = False


class Statistics:
    """Process-global counter registry (statistics.h Statistics)."""

    def __init__(self):
        self._counters: "OrderedDict[str, _Counter]" = OrderedDict()

    def counter(self, name: str, unit: str = "",
                is_ratio: bool = False) -> _Counter:
        """Get-or-create a counter. Dotted names group the report
        ('Intersections.rays', 'MLT.accepted')."""
        c = self._counters.get(name)
        if c is None:
            c = _Counter(unit=unit, is_ratio=is_ratio)
            self._counters[name] = c
        return c

    def add(self, name: str, value, base=None, unit: str = "") -> None:
        c = self.counter(name, unit=unit, is_ratio=base is not None)
        c.value += float(value)
        if base is not None:
            c.base += float(base)

    def record(self, name: str, value, unit: str = "") -> None:
        """Set (not accumulate) — for gauges like rays/s."""
        c = self.counter(name, unit=unit)
        c.value = float(value)

    def reset(self) -> None:
        self._counters.clear()

    def has_stats(self) -> bool:
        return bool(self._counters)

    def format_stats(self) -> str:
        """The Statistics::printStats table (mitsuba.cpp:408)."""
        groups: Dict[str, list] = OrderedDict()
        for name, c in self._counters.items():
            grp, _, leaf = name.rpartition(".")
            groups.setdefault(grp or "General", []).append((leaf, c))
        lines = ["Statistics:"]
        for grp, items in groups.items():
            lines.append(f"  * {grp}:")
            for leaf, c in items:
                if c.is_ratio and c.base > 0:
                    pct = 100.0 * c.value / c.base
                    lines.append(
                        f"      {leaf}: {_fmt(c.value)} of "
                        f"{_fmt(c.base)} ({pct:.2f}%)")
                else:
                    unit = f" {c.unit}" if c.unit else ""
                    lines.append(f"      {leaf}: {_fmt(c.value)}{unit}")
        return "\n".join(lines)

    def print_stats(self, stream=None) -> None:
        print(self.format_stats(), file=stream or sys.stderr)


def _fmt(v: float) -> str:
    """Human units like the reference's formatted counters."""
    a = abs(v)
    for thresh, suff in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if a >= thresh:
            return f"{v / thresh:.3g}{suff}"
    if v == int(v):
        return str(int(v))
    return f"{v:.4g}"


_stats = Statistics()


def get_statistics() -> Statistics:
    return _stats


class ProgressReporter:
    """statistics.h:287 — console progress bar with ETA.

    Host-side: drive it between device dispatches (spp chunks,
    checkpoint blocks)."""

    def __init__(self, title: str, total: int, stream=None,
                 enabled: bool = True, width: int = 40):
        self.title = title
        self.total = max(int(total), 1)
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = enabled
        self.width = width
        self.t0 = time.time()
        self._last_len = 0

    def update(self, done: int) -> None:
        if not self.enabled:
            return
        done = min(int(done), self.total)
        frac = done / self.total
        filled = int(self.width * frac)
        bar = "+" * filled + "-" * (self.width - filled)
        elapsed = time.time() - self.t0
        eta = elapsed / max(frac, 1e-9) * (1.0 - frac)
        line = (f"\r{self.title}: [{bar}] ({done}/{self.total}, "
                f"ETA: {eta:5.1f}s)")
        pad = max(self._last_len - len(line), 0)
        self.stream.write(line + " " * pad)
        self._last_len = len(line)
        try:
            self.stream.flush()
        except Exception:
            pass

    def finish(self) -> None:
        if not self.enabled:
            return
        self.update(self.total)
        self.stream.write("\n")
