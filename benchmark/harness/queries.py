"""The bytes a trace kernel must move for the queries it was asked: the
yardstick of `trace_roofline.*`.

Each file `benchmark/kernels/<entry>.json` describes one kernel entry of
the program: its `module` and `entry` function, the groups of arguments
that hold its rays (origin, direction, limit) with the bytes of the hit it
writes per ray, and the profiler's name of the kernel it launches
(`kernel`). A launch is counted as every ray it was handed, read once
(the ray tensors' bytes), its hits written once, and the scene's triangles
read once (TRI_BYTES each): what the queries need, not how the kernel
answers them (no launch grid, no node fetches).

While a `Tally` is installed, each entry is wrapped. A call made while a
CUDA graph captures is kept with that graph (`utils/graphs.capture`), and
each replay of the graph counts it again: a replay repeats its capture's
launches exactly.
"""
from __future__ import annotations

import importlib

TRI_BYTES = 36      # 9 float32 a triangle


def query_bytes(spec: dict, args, n_tris: int) -> int:
    """Bytes of one launch of `spec`'s entry called with `args`."""
    total = TRI_BYTES * n_tris
    for group in spec["rays"]:
        rays = [args[i] for i in group["args"]]
        n = rays[0].shape[0]
        total += sum(r.numel() * r.element_size() for r in rays) + n * group["hit_bytes"]
    return total


def _capturing(args) -> bool:
    import torch

    dev = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    return dev is not None and dev.type == "cuda" and torch.cuda.is_current_stream_capturing()


class Tally:
    """Bytes and launches of the trace kernels' entries since `reset`."""

    def __init__(self, specs, n_tris: int = 0):
        self.specs = specs
        self.n_tris = n_tris
        self.bytes = 0
        self.launches = 0
        self._pending = []
        self._undo = []

    def reset(self):
        self.bytes = 0
        self.launches = 0

    @property
    def kernels(self):
        return sorted({s["kernel"] for s in self.specs})

    def _count(self, b):
        self.bytes += b
        self.launches += 1

    def _wrap(self, spec, fn):
        def counted(*args, **kw):
            b = query_bytes(spec, args, self.n_tris)
            if _capturing(args):
                self._pending.append(b)
            else:
                self._count(b)
            return fn(*args, **kw)
        return counted

    def install(self):
        for spec in self.specs:
            mod = importlib.import_module(spec["module"])
            fn = getattr(mod, spec["entry"])
            setattr(mod, spec["entry"], self._wrap(spec, fn))
            self._undo.append((mod, spec["entry"], fn))
        from mitsuba_tpu_torch.utils import graphs

        capture, replay = graphs.capture, graphs.Graph.replay

        def counted_capture(fn, generators=()):
            self._pending = []
            graph = capture(fn, generators)
            graph.bench_query_bytes = list(self._pending)
            self._pending = []
            return graph

        def counted_replay(graph):
            replay(graph)
            for b in getattr(graph, "bench_query_bytes", ()):
                self._count(b)

        graphs.capture = counted_capture
        graphs.Graph.replay = counted_replay
        self._undo += [(graphs, "capture", capture), (graphs.Graph, "replay", replay)]

    def uninstall(self):
        for obj, name, fn in reversed(self._undo):
            setattr(obj, name, fn)
        self._undo = []
