"""Stackless threaded-BVH walk over ray batches: the plain PyTorch twin of
`csrc/bvh_intersect.cu` (port of ops/bvh_traverse.py).

Each ray carries one node cursor; visiting a node either descends (cursor
= left child 2i+1) when the slab test passes, or jumps to the node's miss
link. Leaves test their LEAF_SIZE triangles in one step. The closest hit
keeps the brute path's packed key (t_bits & ~127) | slot, culled by the
key's quantised t, so the decode is the same; the any-hit walk stops at its
first opaque hit.

The operations and their order are the JAX walk's (`_slab_test` with its
validity term, `_tri_hits`, the packed min-reduce), and the CUDA kernel
repeats them, so kernel and twin agree bit for bit. Two things differ from
the JAX loop and change no result: the key starts at MISS_BITS with base 0,
which is what the JAX loop's first visit leaves in it; and a ray whose
limit is <= 0 (a retired wavefront lane) keeps that miss result without
walking, since no t > SHADOW_EPS is below it. Rays leave the working set as
they finish: each ray's result depends only on its own walk.

`walk` serves all three queries: rays [0, n_closest) take the closest hit
below their tmax, the rest the any-hit below their limit, as the kernel's
fused entry does. It reads the kernel's own tables (`nodes`, `leaf_tris`,
`leaf_opaque` of `scene/bvh.attach`). The query entry points, with
binned_intersect's signatures, are `ops/bvh_kernel.py`'s; on CPU tensors
they come here.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..scene.bvh import LEAF_SIZE
from . import intersect as I


def safe_inv(d):
    """1/d with |d| < 1e-12 replaced by +-1e-12 (bvh_traverse.py:89)."""
    return 1.0 / torch.where(torch.abs(d) < 1e-12,
                             torch.where(d >= 0, 1e-12, -1e-12), d)


def _slab(lo, hi, o, inv_d, cull):
    """Ray-box slab test, (k,3) boxes against (k,3) rays. The per-axis
    min/max erase a box's inversion, so the validity term culls pad nodes
    (min +big, max -big) explicitly."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_enter = torch.amax(torch.minimum(t0, t1), -1)
    t_exit = torch.amin(torch.maximum(t0, t1), -1)
    return ((t_enter <= t_exit) & (t_exit > I.SHADOW_EPS) & (t_enter < cull)
            & (lo[:, 0] <= hi[:, 0]))


def walk(bvh, o, d, tm, n_closest, stats=None):
    """Returns (key, base, blocked): key/base for rays [0, n_closest)
    (closest hit with t < tm), blocked for the rest (an opaque hit with
    t < tm, tm being the shadow limit). `stats`, a dict, gets the work
    the kernel does on these rays added to it: node visits ("visits") and
    triangle tests ("tri_tests", LEAF_SIZE per leaf whose box is hit)."""
    n = o.shape[0]
    dev = o.device
    key = torch.full((n,), I.MISS_BITS, dtype=torch.int32, device=dev)
    base = torch.zeros((n,), dtype=torch.int32, device=dev)
    blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
    n_int = bvh.n_internal
    lanes = torch.arange(LEAF_SIZE, dtype=torch.int32, device=dev)
    lanes64 = lanes.long()

    idx = torch.nonzero(~(tm <= 0)).squeeze(1)
    node = torch.zeros_like(idx)
    ray = dict(o=o[idx], d=d[idx], inv=safe_inv(d)[idx], tm=tm[idx],
               any=idx >= n_closest, key=key[idx], base=base[idx],
               blocked=blocked[idx])
    while idx.numel():
        best_t = (ray["key"] & ~I.LANE_MASK).view(torch.float32)
        rec = bvh.nodes[node]   # the kernel's node record: min, max, miss link
        box = _slab(rec[:, 0:3], rec[:, 3:6], ray["o"], ray["inv"],
                    torch.where(ray["any"], ray["tm"], best_t))
        is_leaf = node >= n_int
        at = torch.nonzero(box & is_leaf).squeeze(1)
        if stats is not None:
            stats["visits"] = stats.get("visits", 0) + idx.numel()
            stats["tri_tests"] = stats.get("tri_tests", 0) + LEAF_SIZE * at.numel()
        if at.numel():
            leaf = node[at] - n_int
            slots = leaf[:, None] * LEAF_SIZE + lanes64
            ro, rd = ray["o"][at], ray["d"][at]
            t, hit = I.tri_test([ro[:, c:c + 1] for c in range(3)],
                                [rd[:, c:c + 1] for c in range(3)],
                                bvh.leaf_tris[:, slots])
            is_any = ray["any"][at]
            hit = (hit & (t < ray["tm"][at, None])
                   & (is_any[:, None] | (t < best_t[at, None])))
            ray["blocked"][at] |= is_any & torch.any(hit & bvh.leaf_opaque[slots], 1)
            ckey = torch.amin((torch.where(hit, t, I.MISS).view(torch.int32)
                               & ~I.LANE_MASK) | lanes, 1)
            old = ray["key"][at]
            better = ~is_any & (ckey < old)
            ray["key"][at] = torch.where(better, ckey, old)
            ray["base"][at] = torch.where(better, (leaf * LEAF_SIZE).int(), ray["base"][at])
        nxt = torch.where(box & ~is_leaf, 2 * node + 1,
                          rec[:, 6].view(torch.int32).long())
        node = torch.where(ray["any"] & ray["blocked"], -1, nxt)
        walking = node >= 0
        if not bool(walking.all()):
            done = idx[~walking]
            key[done] = ray["key"][~walking]
            base[done] = ray["base"][~walking]
            blocked[done] = ray["blocked"][~walking]
            idx, node = idx[walking], node[walking]
            ray = {k: v[walking] for k, v in ray.items()}
    return key, base, blocked


def decode(bvh, key, base) -> I.Intersection:
    """(key, base) -> Intersection; t is the key's quantised t, as the JAX
    walk returns it (surface_interaction recomputes the barycentrics)."""
    best_t = (key & ~I.LANE_MASK).view(torch.float32)
    valid = best_t < I.MISS
    slot = torch.clamp(base + (key & I.LANE_MASK), 0, bvh.tri_order.shape[0] - 1)
    prim = bvh.tri_order[slot.long()]
    prim = torch.where(valid & (prim >= 0), prim, 0)
    z = torch.zeros_like(best_t)
    return I.Intersection(valid=valid, t=torch.where(valid, best_t, m.INF),
                          prim=prim, b1=z, b2=z)
