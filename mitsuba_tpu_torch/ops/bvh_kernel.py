"""Big-mesh closest hit and any-hit: the CUDA BVH walk and its plain twin.

Replaces the TPU kernel `mitsuba_tpu/ops/binned_intersect.py:
_make_kernel(n_groups)._kernel` (launched by `_dispatch_tiles`, reached
from `closest_hit`, `any_hit` and `closest_and_any`), with those three
entry points' signatures and `Intersection` contract. The TPU kernel ran
bf16x3 GEMM tiles over Morton clusters, with a noise band, top-2
candidates and an exact f32 re-test after it, because f32 on the MXU is
emulated and per-lane gathers are slow there; its ray sort, sub-row mask,
tile list and chunking served the same tiles. None of that is carried
over. `csrc/bvh_intersect.cu` walks the 4-wide BVH of `scene/bvh.py`
(`wide`, collapsed from the binary heap) one ray per thread, in exact
f32, so there are no candidates to re-test.

What bounds it on Hopper: the latency of the dependent node and leaf loads
along each ray's walk, and the divergence of a warp's rays; not bytes or
flops (the tables sit in L2). Its design: one 128-byte record per wide
node (four child boxes tested side by side), nearest-first traversal with
a per-thread stack and the closest hit's cull at every pop, and persistent
warps that take rays from an atomic counter and refill idle lanes.
`closest_and_any` is one launch over [closest rays | shadow rays], the
wavefront's fused step.

Contract of both routes:
  closest_key(bvh, o, d, tmax) -> (key int32 (N,), base int32 (N,))
  blocked(bvh, o, d, limit) -> bool (N,)
with key = (t_bits & ~127) | slot-in-leaf, base = leaf * LEAF_SIZE (miss:
MISS_BITS, 0); `bvh_traverse.decode` turns them into an Intersection.
The kernel is built with --fmad=false and repeats the twin's operations, so
the two agree bit for bit.

A CPU tensor takes the plain version (`bvh_traverse.walk`); a CUDA tensor
launches the kernel or raises, with or without autograd. Neither route has
a backward: the entry points below hand both of them detached rays
(`intersect.search_inputs`; the twin writes into tensors in place), and the
tables are built detached (`scene/bvh.attach`). KERNEL_LAUNCHES and
PLAIN_CALLS count each route per entry point, and KERNEL_RAYS the rays
handed to an entry on either route (closest and shadow rays together for
the fused entry).

Inside a CUDA graph (utils/graphs.py): a launch recorded while the stream
captures counts in CAPTURED_LAUNCHES and its rays in CAPTURED_RAYS, and
each replay adds the graph's launches and rays to KERNEL_LAUNCHES and
KERNEL_RAYS. The walk's resident-block count (a carveout
attribute and an occupancy query) is measured at the first launch on a
device and kept, so the eager run before a capture measures it. Each
launch's ray counter is a `torch.zeros` of its own: in a graph it is a
fill node at a fixed address of the graph's pool, re-run before the walk
on every replay, so no replay finds it non-zero.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import math as m
from . import bvh_traverse as BT
from . import intersect as I

KERNEL_LAUNCHES = {"closest": 0, "any_hit": 0, "closest_and_any": 0}
CAPTURED_LAUNCHES = {"closest": 0, "any_hit": 0, "closest_and_any": 0}
PLAIN_CALLS = {"closest": 0, "any_hit": 0, "closest_and_any": 0}
KERNEL_RAYS = {"closest": 0, "any_hit": 0, "closest_and_any": 0}
CAPTURED_RAYS = {"closest": 0, "any_hit": 0, "closest_and_any": 0}
# stack entries of the kernel's walk (csrc/bvh_intersect.cu STACK)
KERNEL_STACK = 32


def reset_counts():
    for counts in (KERNEL_LAUNCHES, CAPTURED_LAUNCHES, PLAIN_CALLS, KERNEL_RAYS, CAPTURED_RAYS):
        for k in counts:
            counts[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    """Build (at first use) and bind the kernel library."""
    from .. import _build

    lib = ctypes.CDLL(str(_build.build("bvh_intersect")))
    P, I32 = ctypes.c_void_p, ctypes.c_int
    tables = [P, P, P, P]   # wide, leaf_tris, leaf_opaque, counter
    lib.bvh_closest.argtypes = [P, P, P, I32, *tables, P, P, P, P]
    lib.bvh_any_hit.argtypes = [P, P, P, I32, *tables, P, P, P]
    lib.bvh_closest_and_any.argtypes = [P, P, P, I32, P, P, P, I32, *tables, P, P, P, P, P]
    for fn in (lib.bvh_closest, lib.bvh_any_hit, lib.bvh_closest_and_any):
        fn.restype = I32
    return lib


def _check(bvh, rays):
    """rays: (name, o, d, tmax) groups. Raises on what the kernel does not
    take."""
    dev = rays[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"bvh kernel: rays on {dev}, expected a CUDA device")
    if sum(o.shape[0] for _, o, _, _ in rays) >= 2 ** 31 or \
            bvh.wide is None or bvh.wide.shape[0] >= 2 ** 30:
        raise ValueError("bvh kernel: 2^31 rays or more, 2^30 wide nodes or more, "
                         "or no kernel tables (scene/bvh.attach builds them)")
    if BT.stack_depth(bvh) > KERNEL_STACK:
        raise ValueError(f"bvh kernel: the walk needs {BT.stack_depth(bvh)} stack "
                         f"entries, the kernel has {KERNEL_STACK}")
    n_leaves = bvh.leaf_tris.shape[0]
    tables = (("wide", bvh.wide, torch.float32, (bvh.wide.shape[0], 32)),
              ("leaf_tris", bvh.leaf_tris, torch.float32, (n_leaves, 9, 4)),
              ("leaf_opaque", bvh.leaf_opaque, torch.bool, (4 * n_leaves,)))
    for name, o, d, tm in rays:
        n = o.shape[0]
        tables += ((f"{name} o", o, torch.float32, (n, 3)),
                   (f"{name} d", d, torch.float32, (n, 3)),
                   (f"{name} tmax", tm, torch.float32, (n,)))
    for name, x, dtype, shape in tables:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"bvh kernel: {name} must be a contiguous {dtype} {shape} tensor "
                f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    for name, x in (("wide", bvh.wide), ("leaf_tris", bvh.leaf_tris),
                    ("leaf_opaque", bvh.leaf_opaque)):
        if x.data_ptr() % 16:
            raise ValueError(f"bvh kernel: {name} is not 16-byte aligned")


def _tables(bvh, dev):
    """The tables' arguments, with a fresh zero ray counter for one launch."""
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    return (bvh.wide.data_ptr(), bvh.leaf_tris.data_ptr(), bvh.leaf_opaque.data_ptr(),
            counter.data_ptr()), counter


def _launch(entry, *args, dev, rays):
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        capturing = torch.cuda.is_current_stream_capturing()
        (CAPTURED_LAUNCHES if capturing else KERNEL_LAUNCHES)[entry] += 1
        (CAPTURED_RAYS if capturing else KERNEL_RAYS)[entry] += rays
        fn = getattr(_lib(), "bvh_" + entry)
        rc = fn(*args, ctypes.byref(grid), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bvh kernel {entry}: CUDA error {rc} at launch")


def _empty(n, dtype, dev):
    return torch.empty((n,), dtype=dtype, device=dev)


def closest_key(bvh, o, d, tmax):
    """Packed closest-hit keys of rays (o, d) with t < tmax."""
    if o.device.type == "cpu":
        PLAIN_CALLS["closest"] += 1
        KERNEL_RAYS["closest"] += o.shape[0]
        key, base, _ = BT.walk(bvh, o, d, tmax, o.shape[0])
        return key, base
    _check(bvh, [("closest", o, d, tmax)])
    n = o.shape[0]
    key, base = _empty(n, torch.int32, o.device), _empty(n, torch.int32, o.device)
    tables, _counter = _tables(bvh, o.device)
    _launch("closest", o.data_ptr(), d.data_ptr(), tmax.data_ptr(), n, *tables,
            key.data_ptr(), base.data_ptr(), dev=o.device, rays=n)
    return key, base


def blocked(bvh, o, d, limit):
    """True where an opaque triangle is hit with SHADOW_EPS < t < limit."""
    if o.device.type == "cpu":
        PLAIN_CALLS["any_hit"] += 1
        KERNEL_RAYS["any_hit"] += o.shape[0]
        return BT.walk(bvh, o, d, limit, 0)[2]
    _check(bvh, [("shadow", o, d, limit)])
    n = o.shape[0]
    out = _empty(n, torch.bool, o.device)
    tables, _counter = _tables(bvh, o.device)
    _launch("any_hit", o.data_ptr(), d.data_ptr(), limit.data_ptr(), n, *tables,
            out.data_ptr(), dev=o.device, rays=n)
    return out


def closest_and_any_key(bvh, o_c, d_c, tmax_c, o_s, d_s, limit_s):
    """Both queries in one walk: (key, base) of the closest rays and
    blocked of the shadow rays."""
    n_c, n_s = o_c.shape[0], o_s.shape[0]
    if o_c.device.type == "cpu":
        PLAIN_CALLS["closest_and_any"] += 1
        KERNEL_RAYS["closest_and_any"] += n_c + n_s
        key, base, blk = BT.walk(bvh, torch.cat([o_c, o_s]), torch.cat([d_c, d_s]),
                                 torch.cat([tmax_c, limit_s]), n_c)
        return key[:n_c], base[:n_c], blk[n_c:]
    _check(bvh, [("closest", o_c, d_c, tmax_c), ("shadow", o_s, d_s, limit_s)])
    dev = o_c.device
    key, base = _empty(n_c, torch.int32, dev), _empty(n_c, torch.int32, dev)
    blk = _empty(n_s, torch.bool, dev)
    tables, _counter = _tables(bvh, dev)
    _launch("closest_and_any", o_c.data_ptr(), d_c.data_ptr(), tmax_c.data_ptr(), n_c,
            o_s.data_ptr(), d_s.data_ptr(), limit_s.data_ptr(), n_s, *tables,
            key.data_ptr(), base.data_ptr(), blk.data_ptr(), dev=dev, rays=n_c + n_s)
    return key, base, blk


# ---------------------------------------------------------------------------
# binned_intersect's entry points
# ---------------------------------------------------------------------------

def _tmax(o, tmax):
    if tmax is None:
        return torch.full((o.shape[0],), m.INF, dtype=torch.float32, device=o.device)
    return tmax


def closest_hit(scene, bvh, o, d, tmax=None) -> I.Intersection:
    key, base = closest_key(bvh, *I.search_inputs(o, d, _tmax(o, tmax)))
    return BT.decode(bvh, key, base)


def any_hit(scene, bvh, o, d, tmax) -> torch.Tensor:
    """Shadow query: True if an opaque triangle blocks
    (SHADOW_EPS, tmax*(1-SHADOW_EPS))."""
    return blocked(bvh, *I.search_inputs(o, d, tmax * (1.0 - I.SHADOW_EPS)))


def closest_and_any(scene, bvh, o_c, d_c, tmax_c, o_s, d_s, tmax_s):
    """Closest hit of (o_c, d_c) below tmax_c and shadow any-hit of
    (o_s, d_s) below tmax_s*(1-SHADOW_EPS), in one launch. Retired rays
    (tmax 0) neither hit nor block."""
    key, base, blk = closest_and_any_key(bvh, *I.search_inputs(
        o_c, d_c, _tmax(o_c, tmax_c), o_s, d_s, tmax_s * (1.0 - I.SHADOW_EPS)))
    return BT.decode(bvh, key, base), blk
