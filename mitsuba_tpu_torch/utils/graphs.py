"""CUDA-graph capture and replay of the renderers' fixed-shape work: what
`common.render_jit` and `wavefront.render_jit` are built on (the port of
the JAX package's `jax.jit` caches, `integrators/common.py:127-140`,
`wavefront.py:314-322`).

A jitted JAX function is traced once per static configuration and replayed
with its arguments passed by value. Here the first piece of work of a
configuration (the first spp chunk of the film, the first wavefront step
at a lane width) runs eagerly as part of the render, which settles what
is settled at first use (the kernels' launch plans, library loads, cached
tables); the same work is then captured into a `torch.cuda.CUDAGraph`
that reads its inputs from static tensors, and every later piece replays
it. `Statics` holds private copies of a scene's and a camera's tensor
leaves, and each call copies the caller's leaves into them first.
`static_key` is what fixes a graph: the trees' structure, their
plain-Python fields and every tensor's shape, dtype and device.

A capture or replay that fails raises; nothing here falls back to the
eager code. The kernel wrappers count a launch recorded during a capture
in `CAPTURED_LAUNCHES` and its rays in `CAPTURED_RAYS`, not in
`KERNEL_LAUNCHES` and `KERNEL_RAYS`; a `Graph` keeps the launches and rays
it holds and adds them to those on every replay, so a path's launch and
ray counts are the same eager or replayed. The trace kernels and the
samplers' draw kernel (`core/rng`, launches only) are counted so.

Work that draws from a `torch.Generator` (the Metropolis chains' uniforms)
captures with that generator registered (`capture(..., generators=)`):
each replay then draws at the generator's current offset and advances it
by what the captured draws take, as the same draws made eagerly would, so
a replayed chain draws the numbers of the eager chain of the same seed.
`Piece` is the pattern every entry point follows: a piece of work that
runs eagerly the first time, is captured right after, and replays from
then on.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import threading

import torch

STATS = {"captures": 0, "replays": 0}
# each cache keeps at most this many graphs: a graph holds its work's
# memory pool (a Cornell chunk of 524,288 rays, or a wavefront step at
# full width, pins its intermediates), and four cover a progressive render
# beside one-shot renders of the same scene in two films
CACHE_SIZE = 4


def reset_counts():
    for k in STATS:
        STATS[k] = 0


# ---------------------------------------------------------------------------
# Scene and camera trees
# ---------------------------------------------------------------------------

def _walk(obj, leaves):
    """obj's static structure; its tensor leaves are appended to `leaves`
    in a fixed order. Dataclasses, named tuples, tuples and lists are
    walked; any other value is static and must be hashable."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("tensor", tuple(obj.shape), obj.dtype, obj.device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj), tuple((f.name, _walk(getattr(obj, f.name), leaves))
                                 for f in dataclasses.fields(obj)))
    if isinstance(obj, (tuple, list)):
        return (type(obj), tuple(_walk(x, leaves) for x in obj))
    hash(obj)   # an unhashable static field cannot key a graph: raise
    return obj


def _rebuild(obj, leaves):
    """obj with its tensor leaves taken in order from the iterator."""
    if isinstance(obj, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _rebuild(getattr(obj, f.name), leaves)
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_rebuild(x, leaves) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_rebuild(x, leaves) for x in obj)
    return obj


def static_key(*trees):
    """The key of a graph over these trees: structure, static fields and
    each tensor's shape, dtype and device."""
    return tuple(_walk(t, []) for t in trees)


def refuse_grad(entry: str, *trees):
    """Raise where a tensor leaf requires grad: a graph replays the forward
    pass only."""
    for t in trees:
        leaves = []
        _walk(t, leaves)
        if any(x.requires_grad for x in leaves):
            raise NotImplementedError(
                f"{entry} has no gradients: differentiate common.render or "
                "boundary.render_grad (ROADMAP A: gradients through render_jit)")


class Statics:
    """Private copies of some trees' tensor leaves, which a graph reads:
    `trees` is the trees rebuilt over the copies, `load` copies another
    set of trees of the same key into them."""

    def __init__(self, *trees):
        leaves = []
        _walk(trees, leaves)
        self.leaves = [x.detach().clone() for x in leaves]
        self.trees = _rebuild(trees, iter(self.leaves))

    def load(self, *trees):
        copy_leaves(self.leaves, trees)


def copy_leaves(dst, src):
    """Copy src's tensor leaves into dst's, a tree of the same structure
    (a captured prologue writes its outputs into the eager run's)."""
    into, leaves = [], []
    _walk(dst, into)
    _walk(src, leaves)
    for d, x in zip(into, leaves, strict=True):
        d.copy_(x.detach())


# ---------------------------------------------------------------------------
# Capture and replay
# ---------------------------------------------------------------------------

def _kernel_modules():
    from ..core import rng
    from ..ops import brute_kernel, bvh_kernel

    return (brute_kernel, bvh_kernel, rng)


def _captured():
    """Each kernel module's (launches, rays) counted in captures so far; a
    module that counts no rays (rng's draw) holds none."""
    return [(dict(mod.CAPTURED_LAUNCHES), dict(getattr(mod, "CAPTURED_RAYS", {})))
            for mod in _kernel_modules()]


def _add(counters, held):
    """Add each kernel module's held counts to its counter of that name."""
    for mod, counts in zip(_kernel_modules(), held):
        for entry, n in counts.items():
            getattr(mod, counters)[entry] += n


class Graph:
    """A captured graph and the kernel launches and rays it holds (per
    kernel module and entry point)."""

    def __init__(self, graph, launches, rays=()):
        self.graph = graph
        self.launches = launches
        self.rays = rays

    def replay(self):
        self.graph.replay()
        _add("KERNEL_LAUNCHES", self.launches)
        _add("KERNEL_RAYS", self.rays)
        STATS["replays"] += 1


_COLLECTOR = {"captures": 0, "enabled": False}
_COLLECTOR_LOCK = threading.Lock()


@contextlib.contextmanager
def _collector_off():
    """Python's cyclic collector off while any thread captures: an entry
    dropped from a cache holds its graphs in reference cycles, and the
    collector destroying one during a capture would end the capture."""
    with _COLLECTOR_LOCK:
        if _COLLECTOR["captures"] == 0:
            _COLLECTOR["enabled"] = gc.isenabled()
            gc.disable()
        _COLLECTOR["captures"] += 1
    try:
        yield
    finally:
        with _COLLECTOR_LOCK:
            _COLLECTOR["captures"] -= 1
            if _COLLECTOR["captures"] == 0 and _COLLECTOR["enabled"]:
                gc.enable()


def capture(fn, generators=()) -> Graph:
    """Capture fn() into a CUDA graph on the current device. fn takes no
    arguments, works on static tensors only, and has run eagerly on the
    same shapes before (the caller's first piece of work, which settles
    the kernels' plans and every table built at first use); what it
    returns is dropped. `generators`: the torch.Generators fn draws from,
    registered with the graph before the capture (the card's default
    generator always is), so that each replay draws where the generator
    stands and moves it on as the eager draws would. Raises RuntimeError
    where the capture fails (a host read, a copy from pageable host
    memory); nothing is counted then."""
    before = _captured()
    stream = torch.cuda.current_stream()
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    try:
        # thread_local: another thread's scene loads and eager renders
        # (the CLI's -j pool) may run while this thread captures
        with _collector_off(), torch.no_grad(), \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            fn()
    except Exception as e:
        # a failed capture leaves the capture's side stream current
        torch.cuda.set_stream(stream)
        raise RuntimeError(f"CUDA graph capture failed: {e}") from e
    # per kernel module: (the launches, the rays) recorded in the capture
    held = [[{k: a[k] - w[k] for k in a if a[k] != w[k]} for w, a in zip(was, after)]
            for was, after in zip(before, _captured())]
    launches, rays = zip(*held)
    STATS["captures"] += 1
    return Graph(graph, launches, rays)


class Piece:
    """A piece of work of fixed shapes that an entry point repeats: `run()`
    runs fn eagerly the first time, captures it right after (with its
    `generators`), and replays the graph from then on."""

    def __init__(self, fn, generators=()):
        self.fn = fn
        self.generators = tuple(generators)
        self.graph = None

    def run(self):
        if self.graph is None:
            with torch.no_grad():
                self.fn()
            self.graph = capture(self.fn, self.generators)
        else:
            self.graph.replay()


def refuse_hook(entry: str, **hooks):
    """Raise ValueError where a draws hook is given to a render_jit on the
    card: its tensors are made on the host per call, which a graph cannot
    replay (render takes it)."""
    for name, hook in hooks.items():
        if hook is not None:
            raise ValueError(f"{entry}: `{name}` is drawn on the host per call and cannot "
                             "be replayed by a CUDA graph; pass it to render instead")


class Cache:
    """The graphs of one entry point, by key, least recently used first
    out beyond CACHE_SIZE."""

    def __init__(self):
        self.entries = collections.OrderedDict()
        # a render holds it from its lookup to its last replay: the CLI's
        # -j renders scenes from a thread pool, and two renders must not
        # load and replay one graph's static tensors at once
        self.lock = threading.Lock()

    def get(self, key, make):
        entry = self.entries.pop(key, None)
        if entry is None:
            entry = make()
        self.entries[key] = entry
        while len(self.entries) > CACHE_SIZE:
            self.entries.popitem(last=False)
        return entry

    def clear(self):
        self.entries.clear()
