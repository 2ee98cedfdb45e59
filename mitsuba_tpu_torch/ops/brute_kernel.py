"""Brute-force ray-triangle closest hit and any-hit: the CUDA kernel and
its plain PyTorch twin.

Replaces the TPU kernel `mitsuba_tpu/ops/pallas_intersect.py:_kernel`
(launched by `_run`, reached from `closest_key` and `any_hit`). That kernel
recast Moller-Trumbore as a GEMM only to feed the TPU's matrix unit; this
one, `csrc/brute_intersect.cu`, tests each (ray, triangle) pair directly in
f32, in the operation order of the JAX package's VPU form
(`intersect._chunk_hits`).

What bounds it on Hopper: f32 ALU work on O(N*T) triangle tests, about 40
flops per pair, with the division as the costliest single op. A block
stages the whole scene (9 floats per triangle, SoA, plus the opacity
bytes) in dynamic shared memory once, or, above ~5,900 triangles, in tiles
as large as shared memory allows; its rays come in through shared memory
with coalesced loads. Each ray is split over L lanes of a warp (1, 2, 4 or
8, chosen by the launcher so that the grid fills the card), each lane
scanning every L-th triangle in index order; the lanes combine by the
lexicographic min of (key, chunk_base), which is exact (see the .cu note).
The any-hit entry ORs a ray's lanes with a warp ballot and a warp leaves
once every ray in it is blocked.

Contract shared by both routes (the Pallas kernel's):
  closest_key(tris, o, d, tmax) -> (key int32 (N,), chunk_base int32 (N,))
  any_hit(tris, opaque, o, d, limit) -> blocked bool (N,)
with key = (t_bits & ~127) | (prim mod 128), chunk_base = prim & ~127 and
key = MISS_BITS, chunk_base = 0 for a miss. Walking the triangles in index
order and replacing on a strictly smaller key reproduces the chunked
reduction exactly, ties included. The kernel is built with --fmad=false,
so it rounds each op as the plain version does and the two agree bit for
bit.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises, with or without autograd. Neither route has a backward: the trace
entry points hand both of them detached inputs (`intersect.search_inputs`).
KERNEL_LAUNCHES and PLAIN_CALLS count each route per entry point, and
KERNEL_RAYS the rays handed to an entry on either route (the ray tensors'
first dimension); LAST_CONFIG holds each entry's last launch configuration
(lanes per ray, block size, triangles per tile, shared memory bytes).

Inside a CUDA graph (utils/graphs.py): a launch recorded while the stream
captures counts in CAPTURED_LAUNCHES and its rays in CAPTURED_RAYS, and
each replay of the graph adds the launches and rays it holds to
KERNEL_LAUNCHES and KERNEL_RAYS. The launcher's plan (a
`cudaFuncSetAttribute` and occupancy queries) is made at the first launch
of a scene size and kept, so the eager run before a capture makes it and
the capture itself records the kernel launch alone.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import intersect as I

KERNEL_LAUNCHES = {"closest": 0, "any_hit": 0}
CAPTURED_LAUNCHES = {"closest": 0, "any_hit": 0}
PLAIN_CALLS = {"closest": 0, "any_hit": 0}
KERNEL_RAYS = {"closest": 0, "any_hit": 0}
CAPTURED_RAYS = {"closest": 0, "any_hit": 0}
LAST_CONFIG = {"closest": None, "any_hit": None}
# lanes per ray the kernel takes; None lets its launcher choose
LANES = (1, 2, 4, 8)


def reset_counts():
    for counts in (KERNEL_LAUNCHES, CAPTURED_LAUNCHES, PLAIN_CALLS, KERNEL_RAYS, CAPTURED_RAYS):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version: the VPU form over 128-triangle chunks, which bounds
# the working set at (N, 128).
# ---------------------------------------------------------------------------

def _chunks(n_tris):
    # the last chunk is cut to the real triangles: the JAX package pads it
    # with triangles that always miss, whose keys (MISS | lane > 0) never
    # beat the chunk's lane-0 key, so the result is the same
    for base in range(0, n_tris, I.CHUNK):
        yield base, min(base + I.CHUNK, n_tris)


def closest_key_plain(tris, o, d, tmax):
    n = o.shape[0]
    oc, dc = I._ray_comps(o, d)
    lanes = torch.arange(I.CHUNK, dtype=torch.int32, device=o.device)
    best_key = torch.full((n,), I.MISS_BITS | I.LANE_MASK, dtype=torch.int32,
                          device=o.device)
    best_base = torch.zeros((n,), dtype=torch.int32, device=o.device)
    for base, end in _chunks(tris.shape[1]):
        t = I._chunk_hits(oc, dc, tris[:, base:end], tmax[:, None], I.MISS)
        key = (t.view(torch.int32) & ~I.LANE_MASK) | lanes[:end - base]
        ckey = torch.amin(key, dim=1)
        better = ckey < best_key
        best_key = torch.where(better, ckey, best_key)
        best_base = torch.where(better, base, best_base)
    return best_key, best_base


def any_hit_plain(tris, opaque, o, d, limit):
    oc, dc = I._ray_comps(o, d)
    lim = limit[:, None]
    blocked = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for base, end in _chunks(tris.shape[1]):
        t = I._chunk_hits(oc, dc, tris[:, base:end], lim, lim)
        hits = (t < I.MISS) & opaque[None, base:end]
        blocked = blocked | torch.any(hits, dim=1)
    return blocked


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(tris, o, d, ray_f, opaque=None):
    n = o.shape[0]
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"brute kernel: rays on {dev}, expected a CUDA device")
    if n >= 2 ** 31 or tris.shape[1] >= 2 ** 31:
        raise ValueError("brute kernel: more than 2^31 rays or triangles")
    for name, x, shape in (("tris", tris, (9, tris.shape[1])), ("o", o, (n, 3)),
                           ("d", d, (n, 3)), ("tmax", ray_f, (n,))):
        if x.device != dev or x.dtype != torch.float32 or \
                tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"brute kernel: {name} must be a contiguous float32 {shape} "
                f"tensor on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if tris.shape[1] == 0:
        raise ValueError("brute kernel: the scene has no triangles")
    if opaque is not None and (opaque.device != dev or opaque.dtype != torch.bool
                               or tuple(opaque.shape) != (tris.shape[1],)
                               or not opaque.is_contiguous()):
        raise ValueError("brute kernel: opaque must be a contiguous bool (T,) "
                         f"tensor on {dev}")


@functools.lru_cache(maxsize=None)
def _lib():
    """Build (at first use) and bind the kernel library."""
    from .. import _build

    lib = ctypes.CDLL(str(_build.build("brute_intersect")))
    P, I32 = ctypes.c_void_p, ctypes.c_int
    lib.brute_closest.argtypes = [P, P, P, P, I32, I32, P, P, I32, P, P]
    lib.brute_closest.restype = I32
    lib.brute_any_hit.argtypes = [P, P, P, P, P, I32, I32, P, I32, P, P]
    lib.brute_any_hit.restype = I32
    return lib


def _launch(entry, *args, dev, lanes, rays):
    """Launch one entry on the current stream for `rays` rays; raise on a
    refused launch (shared memory, block size) or a bad lane count."""
    if lanes is not None and lanes not in LANES:
        raise ValueError(f"brute kernel: lanes must be one of {LANES}, got {lanes}")
    config = (ctypes.c_int * 4)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        (CAPTURED_LAUNCHES if capturing else KERNEL_LAUNCHES)[entry] += 1
        (CAPTURED_RAYS if capturing else KERNEL_RAYS)[entry] += rays
        rc = getattr(_lib(), "brute_" + entry)(*args, lanes or 0, config, stream)
    if rc != 0:
        raise RuntimeError(f"brute kernel {entry}: CUDA error {rc} at launch")
    LAST_CONFIG[entry] = dict(zip(("lanes", "block", "tile", "smem_bytes"), config))


def closest_key(tris, o, d, tmax, lanes=None):
    """Packed closest-hit keys of rays (o, d) with t < tmax against the
    (9, T) triangle rows. Returns (key, chunk_base), each int32 (N,).
    `lanes` (1, 2, 4 or 8) fixes the kernel's lanes per ray; by default
    its launcher chooses."""
    if o.device.type == "cpu":
        PLAIN_CALLS["closest"] += 1
        KERNEL_RAYS["closest"] += o.shape[0]
        return closest_key_plain(tris, o, d, tmax)
    _check(tris, o, d, tmax)
    n = o.shape[0]
    key = torch.empty((n,), dtype=torch.int32, device=o.device)
    base = torch.empty((n,), dtype=torch.int32, device=o.device)
    if n == 0:
        return key, base
    _launch("closest", o.data_ptr(), d.data_ptr(), tmax.data_ptr(), tris.data_ptr(),
            n, tris.shape[1], key.data_ptr(), base.data_ptr(), dev=o.device, lanes=lanes,
            rays=n)
    return key, base


def any_hit(tris, opaque, o, d, limit, lanes=None):
    """True where an opaque triangle is hit with SHADOW_EPS < t < limit."""
    if o.device.type == "cpu":
        PLAIN_CALLS["any_hit"] += 1
        KERNEL_RAYS["any_hit"] += o.shape[0]
        return any_hit_plain(tris, opaque, o, d, limit)
    _check(tris, o, d, limit, opaque)
    n = o.shape[0]
    blocked = torch.empty((n,), dtype=torch.bool, device=o.device)
    if n == 0:
        return blocked
    _launch("any_hit", o.data_ptr(), d.data_ptr(), limit.data_ptr(), tris.data_ptr(),
            opaque.data_ptr(), n, tris.shape[1], blocked.data_ptr(), dev=o.device,
            lanes=lanes, rays=n)
    return blocked
