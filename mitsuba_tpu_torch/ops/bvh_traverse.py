"""Ordered walk of the 4-wide BVH over ray batches: the plain PyTorch twin
of `csrc/bvh_intersect.cu`.

Each ray keeps a stack of (node reference, t_enter) entries, which starts
with the wide root. One step pops the top entry; an entry whose t_enter is
not below the ray's cull (the closest hit's quantised best t, or the
shadow ray's limit) is dropped. A wide node tests its four child boxes
(the slab test with its validity term, which culls pad and empty slots)
and pushes the children it hits, farthest first (rank: larger t_enter, then
the lower slot, goes deeper), so the nearest is popped next. A leaf tests
its LEAF_SIZE triangles in one step. The closest hit keeps the brute
path's packed key (t_bits & ~127) | slot, with the cull's quantised t
taken once per leaf, so the decode is the same; the any-hit walk stops at
its first opaque hit. The stack needs at most 3 * wide_depth + 1 entries.

The box and triangle arithmetic are the JAX walk's (`_slab_test` with its
validity term, `_tri_hits`, the packed min-reduce), and the CUDA kernel
repeats this walk operation for operation, so kernel and twin agree bit
for bit. The JAX walk visits the binary tree in fixed left-first order;
this one visits the wide tree nearest first. The any-hit answer does not
depend on the order (its cull is the fixed limit), and the closest hit's
only where two hits tie in quantised t (or a hit lies on its box's face
to within rounding), where the first one found wins. A ray whose limit is
<= 0 (a retired wavefront lane) keeps the miss result without walking,
since no t > SHADOW_EPS is below it. Rays leave the working set as they
finish: each ray's result depends only on its own walk.

`walk` serves all three queries: rays [0, n_closest) take the closest hit
below their tmax, the rest the any-hit below their limit, as the kernel's
fused entry does. It reads the kernel's own tables (`wide`, `leaf_tris`,
`leaf_opaque` of `scene/bvh.attach`). The query entry points, with
binned_intersect's signatures, are `ops/bvh_kernel.py`'s; on CPU tensors
they come here.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..scene.bvh import LEAF_SIZE, WIDE
from . import intersect as I


def safe_inv(d):
    """1/d with |d| < 1e-12 replaced by +-1e-12 (bvh_traverse.py:89)."""
    return 1.0 / torch.where(torch.abs(d) < 1e-12,
                             torch.where(d >= 0, 1e-12, -1e-12), d)


def stack_depth(bvh) -> int:
    """Stack entries the walk can need: every wide level but the last
    leaves at most three siblings behind, the last pushes four."""
    return 3 * bvh.wide_depth + 1


def _slab4(rec, o, inv_d, cull):
    """Slab test of (k,3) rays against the four child boxes of their (k,32)
    wide records. Returns (hit (k,4), t_enter (k,4)). The per-axis min/max
    erase a box's inversion, so the validity term culls pad and empty
    slots (min +big, max -big) explicitly."""
    lo = rec[:, 0:12].reshape(-1, 3, WIDE).transpose(1, 2)
    hi = rec[:, 12:24].reshape(-1, 3, WIDE).transpose(1, 2)
    t0 = (lo - o[:, None, :]) * inv_d[:, None, :]
    t1 = (hi - o[:, None, :]) * inv_d[:, None, :]
    t_enter = torch.amax(torch.minimum(t0, t1), -1)
    t_exit = torch.amin(torch.maximum(t0, t1), -1)
    hit = ((t_enter <= t_exit) & (t_exit > I.SHADOW_EPS) & (t_enter < cull[:, None])
           & (lo[..., 0] <= hi[..., 0]))
    return hit, t_enter


def _push_rank(hit, t_enter):
    """Stack offset of each hit child above the current top: the number of
    hit children pushed before it, those with a larger t_enter or an equal
    one in a lower slot. The nearest child lands on top."""
    slot = torch.arange(WIDE, device=hit.device)
    before = ((t_enter[:, None, :] > t_enter[:, :, None])
              | ((t_enter[:, None, :] == t_enter[:, :, None])
                 & (slot[None, :] < slot[:, None])[None]))
    return (before & hit[:, None, :]).sum(-1)


def _bump(stats, name, n):
    if stats is not None:
        stats[name] = stats.get(name, 0) + n


def walk(bvh, o, d, tm, n_closest, stats=None):
    """Returns (key, base, blocked): key/base for rays [0, n_closest)
    (closest hit with t < tm), blocked for the rest (an opaque hit with
    t < tm, tm being the shadow limit). `stats`, a dict, gets the work the
    kernel does on these rays added to it: wide-node fetches ("visits"),
    child box tests ("box_tests", four per fetch), triangle tests
    ("tri_tests", LEAF_SIZE per leaf tested), stack pops ("pops") and the
    deepest stack ("max_stack")."""
    n = o.shape[0]
    dev = o.device
    key = torch.full((n,), I.MISS_BITS, dtype=torch.int32, device=dev)
    base = torch.zeros((n,), dtype=torch.int32, device=dev)
    blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
    lanes = torch.arange(LEAF_SIZE, dtype=torch.int32, device=dev)
    lanes64 = lanes.long()
    depth = stack_depth(bvh)

    idx = torch.nonzero(~(tm <= 0)).squeeze(1)
    k = idx.numel()
    # every stack starts with the wide root (reference 0), never culled
    stack_ref = torch.zeros((k, depth), dtype=torch.int32, device=dev)
    stack_t = torch.full((k, depth), -m.INF, dtype=torch.float32, device=dev)
    ray = dict(o=o[idx], d=d[idx], inv=safe_inv(d)[idx], tm=tm[idx],
               any=idx >= n_closest, key=key[idx], base=base[idx],
               blocked=blocked[idx], sp=torch.ones((k,), dtype=torch.int64, device=dev),
               stack_ref=stack_ref, stack_t=stack_t)
    while idx.numel():
        rows = torch.arange(idx.numel(), device=dev)
        best_t = (ray["key"] & ~I.LANE_MASK).view(torch.float32)
        cull = torch.where(ray["any"], ray["tm"], best_t)
        sp = ray["sp"] - 1
        ref = ray["stack_ref"][rows, sp]
        t_enter = ray["stack_t"][rows, sp]
        keep = t_enter < cull
        _bump(stats, "pops", idx.numel())

        at = torch.nonzero(keep & (ref >= 0)).squeeze(1)
        if at.numel():
            rec = bvh.wide[ref[at].long()]
            hit, t_child = _slab4(rec, ray["o"][at], ray["inv"][at], cull[at])
            pos = sp[at, None] + _push_rank(hit, t_child)
            r, c = torch.nonzero(hit, as_tuple=True)
            ray["stack_ref"][at[r], pos[r, c]] = rec[:, 24:28].view(torch.int32)[r, c]
            ray["stack_t"][at[r], pos[r, c]] = t_child[r, c]
            sp[at] += hit.sum(1)
            _bump(stats, "visits", at.numel())
            _bump(stats, "box_tests", WIDE * at.numel())

        at = torch.nonzero(keep & (ref < 0)).squeeze(1)
        if at.numel():
            leaf = (-1 - ref[at]).long()
            slots = leaf[:, None] * LEAF_SIZE + lanes64
            ro, rd = ray["o"][at], ray["d"][at]
            t, hit = I.tri_test([ro[:, c:c + 1] for c in range(3)],
                                [rd[:, c:c + 1] for c in range(3)],
                                bvh.leaf_tris[leaf].transpose(0, 1))
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
            _bump(stats, "tri_tests", LEAF_SIZE * at.numel())

        ray["sp"] = sp
        if stats is not None:
            stats["max_stack"] = max(stats.get("max_stack", 0), int(sp.max()))
        walking = (sp > 0) & ~(ray["any"] & ray["blocked"])
        if not bool(walking.all()):
            done = idx[~walking]
            key[done] = ray["key"][~walking]
            base[done] = ray["base"][~walking]
            blocked[done] = ray["blocked"][~walking]
            idx = idx[walking]
            ray = {name: v[walking] for name, v in ray.items()}
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
