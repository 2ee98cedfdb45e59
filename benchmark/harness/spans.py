"""The program's own spans in a device trace: the `mitsuba.*` ranges that
`mitsuba_tpu_torch` opens with `utils/stats.span` while torch.profiler
records, read from the Chrome-trace events the profiler exports (the
events `profile.summarize` reads).

- `program_idle(events)`: the window's idle seconds (the gaps between the
  device operations inside `bench.window`, as `profile.summarize` finds
  them), each split over the innermost `mitsuba.*` span of the thread that
  holds the window; "none" where that thread is in no such span.
- `program_device(events)`: each kernel's device seconds inside the window
  by the innermost `mitsuba.*` span around its host launch, found by the
  launch's `correlation` (`cudaLaunchKernel`, `cudaGraphLaunch`, ...). The
  kernels of a replayed CUDA graph fall under the span around the replay.
- `backward_device(events)`: each kernel of the backward inside the
  window (launched inside a backward node, the `autograd::engine::
  evaluate_function: ...` op around the launch, or anywhere on a thread of
  autograd's engine that ran nodes and no forward op), by its node, whose
  `Sequence number` names the forward op that made it on the one host
  thread that made forward ops: the seconds go to the innermost
  `mitsuba.*` span around that forward op ("none" where it is in none;
  "unlinked" for a launch outside a node, such as the engine's sums of
  gradients that meet, or a node no forward op made, such as
  AccumulateGrad).

Spans nest on a host thread as the Python `with` blocks that open them,
so the innermost span at an instant is the shortest one that holds it.
"""
from __future__ import annotations

import bisect
import collections

from benchmark.harness import profile

PREFIX = "mitsuba."
NODE = "autograd::engine::evaluate_function: "
NONE, UNLINKED = "none", "unlinked"


def _complete(events, cat):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == cat]


def _interval(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


class _Timeline:
    """The innermost of some intervals at any instant, per host thread."""

    def __init__(self, events):
        by_tid = collections.defaultdict(list)
        for e in events:
            by_tid[e["tid"]].append((*_interval(e), e))
        self.pieces = {tid: _pieces(iv) for tid, iv in by_tid.items()}

    def at(self, tid, t):
        """The innermost event of `tid` holding instant t, or None."""
        starts, items = self.pieces.get(tid, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return None
        a, b, e = items[i]
        return e if a <= t < b else None

    def segments(self, tid, lo, hi):
        """(a, b, innermost event or None) pieces covering [lo, hi)."""
        starts, items = self.pieces.get(tid, ((), ()))
        out, cursor = [], lo
        for a, b, e in items[max(bisect.bisect_right(starts, lo) - 1, 0):]:
            if a >= hi:
                break
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if a > cursor:
                out.append((cursor, a, None))
            out.append((a, b, e))
            cursor = b
        if cursor < hi:
            out.append((cursor, hi, None))
        return out


def _pieces(intervals):
    """Sorted, disjoint [a, b) pieces, each with its innermost (shortest)
    holding interval's event; instants in no interval have no piece."""
    cuts = sorted({t for a, b, _ in intervals for t in (a, b)})
    order = sorted(intervals, key=lambda x: x[0])
    active, j, items = [], 0, []
    for a, b in zip(cuts[:-1], cuts[1:]):
        while j < len(order) and order[j][0] <= a:
            active.append(order[j])
            j += 1
        active = [x for x in active if x[1] > a]
        if active:
            lo, hi, e = min(active, key=lambda x: x[1] - x[0])
            items.append((a, b, e))
    return [a for a, _, _ in items], items


def _window(events):
    win = next(e for e in _complete(events, "user_annotation")
               if e.get("name") == profile.WINDOW)
    return (*_interval(win), win["tid"])


class ProgramTrace:
    """The events of one profile, indexed for the three attributions."""

    def __init__(self, events):
        self.w0, self.w1, self.window_tid = _window(events)
        self.spans = _Timeline([e for e in _complete(events, "user_annotation")
                                if str(e.get("name", "")).startswith(PREFIX)])
        cpu_ops = _complete(events, "cpu_op")
        nodes = [e for e in cpu_ops if str(e.get("name", "")).startswith(NODE)]
        self.nodes = _Timeline(nodes)
        self.launches = {}
        for e in events:
            corr = (e.get("args") or {}).get("correlation")
            if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver") \
                    and corr is not None:
                self.launches[corr] = (e["tid"], float(e["ts"]))
        self.kernels = _complete(events, "kernel")
        self.busy = profile.union(
            [iv for iv in (self._clip(e) for e in events if e.get("ph") == "X"
                           and e.get("cat") in profile.DEVICE_CATS) if iv])
        self.forward = self._forward_ops(cpu_ops)
        # a node's `Fwd thread id` is the profiler's own number for the
        # thread of its forward op; with one thread making forward ops,
        # every node's is that thread (with more, none is linked)
        threads = {tid for tid, _ in self.forward}
        self.fwd_thread = threads.pop() if len(threads) == 1 else None

    def _clip(self, e):
        a, b = _interval(e)
        a, b = max(a, self.w0), min(b, self.w1)
        return (a, b) if b > a else None

    def _forward_ops(self, cpu_ops):
        """(host thread, sequence number) -> (start, the op) of the last
        forward op that recorded it: the op that made the node (ops before
        it on the thread may record the same number, none after it)."""
        forward = {}
        for e in cpu_ops:
            args = e.get("args") or {}
            seq = args.get("Sequence number")
            if seq is None or str(e["name"]).startswith(NODE) \
                    or self.nodes.at(e["tid"], float(e["ts"])) is not None:
                continue
            key = (e["tid"], seq)
            if key not in forward or forward[key][0] <= float(e["ts"]):
                forward[key] = (float(e["ts"]), e)
        return forward

    def span_at(self, tid, t) -> str:
        e = self.spans.at(tid, t)
        return e["name"] if e is not None else NONE

    def forward_span(self, node) -> str:
        """The innermost span around the forward op that made `node`."""
        seq = (node.get("args") or {}).get("Sequence number")
        op = self.forward.get((self.fwd_thread, seq))
        return UNLINKED if op is None else self.span_at(self.fwd_thread, op[0])

    def kernels_in_window(self):
        """(seconds inside the window, (thread, time) of the launch or None)
        of each kernel."""
        for k in self.kernels:
            iv = self._clip(k)
            if iv:
                yield (iv[1] - iv[0]) / 1e6, \
                    self.launches.get((k.get("args") or {}).get("correlation"))


def _add(table, key, value):
    table[key] = table.get(key, 0.0) + value


def program_idle(events, trace: ProgramTrace | None = None) -> dict:
    """Idle seconds of the window by the innermost `mitsuba.*` span of the
    window's thread ("none" outside every span)."""
    tr = trace or ProgramTrace(events)
    gaps, cursor = [], tr.w0
    for s0, s1 in tr.busy + [[tr.w1, tr.w1]]:
        if s0 > cursor:
            gaps.append((cursor, s0))
        cursor = max(cursor, s1)
    out = {}
    for g0, g1 in gaps:
        for a, b, e in tr.spans.segments(tr.window_tid, g0, g1):
            _add(out, e["name"] if e is not None else NONE, (b - a) / 1e6)
    return out


def program_device(events, trace: ProgramTrace | None = None) -> dict:
    """Kernel seconds inside the window by the innermost `mitsuba.*` span
    around each kernel's host launch ("none": outside every span, or no
    launch found)."""
    tr = trace or ProgramTrace(events)
    out = {}
    for s, launch in tr.kernels_in_window():
        _add(out, tr.span_at(*launch) if launch else NONE, s)
    return out


def backward_device(events, trace: ProgramTrace | None = None, by_node: bool = False) -> dict:
    """Seconds of the backward's kernels inside the window, by the
    innermost `mitsuba.*` span around the forward op of each one's node;
    `by_node`: by that span and the node's name ("mitsuba.shading
    IndexBackward0")."""
    tr = trace or ProgramTrace(events)
    engine = set(tr.nodes.pieces) - {tid for tid, _ in tr.forward}
    out = {}
    for s, launch in tr.kernels_in_window():
        node = tr.nodes.at(*launch) if launch else None
        if node is not None:
            key = tr.forward_span(node)
            _add(out, f"{key} {node['name'][len(NODE):]}" if by_node else key, s)
        elif launch and launch[0] in engine:
            _add(out, UNLINKED, s)
    return out


def top(table: dict, n: int = 10) -> list:
    """The n largest entries, as breakdown() lists them."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]
