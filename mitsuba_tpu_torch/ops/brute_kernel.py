"""Brute-force ray-triangle closest hit and any-hit: the CUDA kernel and
its plain PyTorch twin.

Replaces the TPU kernel `mitsuba_tpu/ops/pallas_intersect.py:_kernel`
(launched by `_run`, reached from `closest_key` and `any_hit`). That kernel
recast Moller-Trumbore as a GEMM only to feed the TPU's matrix unit; this
one, `csrc/brute_intersect.cu`, tests each (ray, triangle) pair directly in
f32, in the operation order of the JAX package's VPU form
(`intersect._chunk_hits`).

What bounds it on Hopper: f32 ALU work on O(N*T) triangle tests, about 40
flops per pair, with the division as the costliest single op. One thread
owns one ray and keeps its running key in a register; a block stages the
triangles through shared memory in tiles (9 floats per triangle, SoA), so
device memory is read once per block rather than once per ray. The any-hit
entry stops testing once its ray is blocked, and the block leaves the
tile loop when every ray in it is.

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
raises. KERNEL_LAUNCHES and PLAIN_CALLS count each route per entry point.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import intersect as I

KERNEL_LAUNCHES = {"closest": 0, "any_hit": 0}
PLAIN_CALLS = {"closest": 0, "any_hit": 0}


def reset_counts():
    for counts in (KERNEL_LAUNCHES, PLAIN_CALLS):
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
    lib.brute_closest.argtypes = [P, P, P, P, I32, I32, P, P, P]
    lib.brute_closest.restype = I32
    lib.brute_any_hit.argtypes = [P, P, P, P, P, I32, I32, P, P]
    lib.brute_any_hit.restype = I32
    return lib


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"brute kernel {name}: CUDA error {rc} at launch")


def closest_key(tris, o, d, tmax):
    """Packed closest-hit keys of rays (o, d) with t < tmax against the
    (9, T) triangle rows. Returns (key, chunk_base), each int32 (N,)."""
    if o.device.type == "cpu":
        PLAIN_CALLS["closest"] += 1
        return closest_key_plain(tris, o, d, tmax)
    _check(tris, o, d, tmax)
    n = o.shape[0]
    key = torch.empty((n,), dtype=torch.int32, device=o.device)
    base = torch.empty((n,), dtype=torch.int32, device=o.device)
    if n == 0:
        return key, base
    lib = _lib()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL_LAUNCHES["closest"] += 1
        rc = lib.brute_closest(o.data_ptr(), d.data_ptr(), tmax.data_ptr(),
                               tris.data_ptr(), n, tris.shape[1],
                               key.data_ptr(), base.data_ptr(), stream)
    _raise_on(rc, "closest")
    return key, base


def any_hit(tris, opaque, o, d, limit):
    """True where an opaque triangle is hit with SHADOW_EPS < t < limit."""
    if o.device.type == "cpu":
        PLAIN_CALLS["any_hit"] += 1
        return any_hit_plain(tris, opaque, o, d, limit)
    _check(tris, o, d, limit, opaque)
    n = o.shape[0]
    blocked = torch.empty((n,), dtype=torch.bool, device=o.device)
    if n == 0:
        return blocked
    lib = _lib()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL_LAUNCHES["any_hit"] += 1
        rc = lib.brute_any_hit(o.data_ptr(), d.data_ptr(), limit.data_ptr(),
                               tris.data_ptr(), opaque.data_ptr(), n,
                               tris.shape[1], blocked.data_ptr(), stream)
    _raise_on(rc, "any_hit")
    return blocked
