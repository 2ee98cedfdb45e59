"""Ray-triangle intersection over ray batches (port of ops/intersect.py).

`intersect_brute` and `occluded_brute` test every ray against every
triangle through `ops/brute_kernel.py`: a hand-written CUDA kernel for
tensors on the GPU, its plain PyTorch twin (the JAX package's "vpu" form,
`_chunk_hits` below, scanned over 128-triangle chunks) for tensors on the
CPU. Both return the packed (key, chunk_base) pair that `_finish_closest`
decodes, so the two routes share one decoder.

The key is (t_bits & ~127) | (prim mod 128): positive floats order like
their int32 bit patterns, so one integer min finds both the closest t and
its triangle. Stealing 7 mantissa bits costs ~1e-5 relative t resolution,
and ties break toward the lower lane, then the lower chunk.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m

SHADOW_EPS = 1e-3
# barycentric slack: rays through shared edges cannot slip between both
# triangles (double hits at seams resolve via closest-t)
BARY_EPS = 1e-6
# triangle-chunk width of the key packing
CHUNK = 128
# miss sentinel 2^127: low mantissa bits zero, so lane packing keeps it
MISS = 2.0 ** 127
MISS_BITS = 0x7F000000
LANE_BITS = 7
LANE_MASK = (1 << LANE_BITS) - 1


class Intersection(NamedTuple):
    """Batched hit record."""

    valid: torch.Tensor   # (N,) bool
    t: torch.Tensor       # (N,)
    prim: torch.Tensor    # (N,) int32 triangle id (0 if invalid)
    b1: torch.Tensor      # (N,) barycentric (zeros: computed lazily)
    b2: torch.Tensor      # (N,)


def tri_soa(scene) -> torch.Tensor:
    """Triangle data as one contiguous (9, T) float32 tensor, rows
    p0x p0y p0z e1x e1y e1z e2x e2y e2z: the layout of both routes."""
    p0, e1, e2 = scene.tri_vertices()
    return torch.cat([p0, e1, e2], dim=1).T.contiguous()


def _chunk_hits(o, d, tri, tmax, best_t):
    """Hit tests of every ray against one chunk of triangles.

    o, d: ray components as 6 (N, 1) tensors; tri: (9, C) triangle rows;
    tmax, best_t: (N, 1) or scalar. Returns t (N, C) with MISS on misses. The
    operation order is the JAX package's, which the CUDA kernel repeats.
    """
    ox, oy, oz, dx, dy, dz = o + d  # list concat: 6 tensors
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (r[None, :] for r in tri)

    # pvec = d x e2  (outer: (N,1) x (1,C) -> (N,C))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    bad = torch.abs(det) < 1e-12
    inv_det = torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, det))
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = ((u >= -BARY_EPS) & (v >= -BARY_EPS) & (u + v <= 1.0 + BARY_EPS)
           & (t > SHADOW_EPS) & (t < best_t) & (t < tmax) & ~bad)
    return torch.where(hit, t, MISS)


def _ray_comps(o, d):
    return ([o[:, 0:1], o[:, 1:2], o[:, 2:3]],
            [d[:, 0:1], d[:, 1:2], d[:, 2:3]])


def intersect_brute(scene, o: torch.Tensor, d: torch.Tensor,
                    tmax=None) -> Intersection:
    """Closest-hit Moller-Trumbore over every triangle.
    o, d: (N,3). Returns an Intersection with t=INF where nothing is hit."""
    from . import brute_kernel

    n = o.shape[0]
    if tmax is None:
        tmax = torch.full((n,), m.INF, dtype=torch.float32, device=o.device)
    key, base = brute_kernel.closest_key(tri_soa(scene), o.contiguous(),
                                         d.contiguous(), tmax.contiguous())
    return _finish_closest(scene, key, base, n)


def _finish_closest(scene, best_key, best_base, n) -> Intersection:
    """Unpack (key, chunk_base) into an Intersection; t is the key's
    truncated t, which the shading uses too."""
    best_t = (best_key & ~LANE_MASK).view(torch.float32)
    valid = best_t < MISS
    prim_raw = best_base + (best_key & LANE_MASK)
    prim = torch.where(valid & (prim_raw < scene.num_triangles), prim_raw, 0)
    z = torch.zeros((n,), dtype=best_t.dtype, device=best_t.device)
    return Intersection(valid=valid, t=torch.where(valid, best_t, m.INF),
                        prim=prim, b1=z, b2=z)


def occluded_brute(scene, o: torch.Tensor, d: torch.Tensor,
                   tmax: torch.Tensor) -> torch.Tensor:
    """Any-hit shadow query: (N,) bool, True if an opaque triangle blocks
    (SHADOW_EPS, tmax*(1-SHADOW_EPS)). Null-interface triangles
    (`scene.tri_opaque` False) never block."""
    from . import brute_kernel

    limit = tmax * (1.0 - SHADOW_EPS)
    return brute_kernel.any_hit(tri_soa(scene), scene.tri_opaque.contiguous(),
                                o.contiguous(), d.contiguous(), limit)


def surface_interaction(scene, o, d, its: Intersection):
    """Expand a hit record into shading data (position, frames, uv,
    material, emitter). Invalid lanes hold harmless defaults.

    Barycentrics are recomputed from the winning triangle's vertices, since
    the brute-force search returns only (t, prim). Perturbed normals, mip
    footprints, ray differentials, vertex colours and wireframes are not
    ported.
    """
    vi = scene.indices[its.prim]
    v0 = scene.vertices[vi[:, 0]]
    v1 = scene.vertices[vi[:, 1]]
    v2 = scene.vertices[vi[:, 2]]
    n0 = scene.normals[vi[:, 0]]
    n1 = scene.normals[vi[:, 1]]
    n2 = scene.normals[vi[:, 2]]
    t0 = scene.uvs[vi[:, 0]]
    t1 = scene.uvs[vi[:, 1]]
    t2 = scene.uvs[vi[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    ngv = m.cross(e1, e2)
    ng = ngv / m.length(ngv, keepdims=True)

    # barycentrics via Moller-Trumbore on the winning triangle
    pv = m.cross(d, e2)
    det = m.dot(e1, pv)
    bad = torch.abs(det) < 1e-12
    inv_det = torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, det))
    tv = o - v0
    b1 = torch.clamp(m.dot(tv, pv) * inv_det, 0.0, 1.0)
    qv = m.cross(tv, e1)
    b2 = torch.clamp(m.dot(d, qv) * inv_det, 0.0, 1.0)

    # The JAX package re-attaches d(t)/d(vertices) to its.t here with a
    # zero-primal term; rendering is primal only so far, so t is used as
    # is until gradients land.
    # Invalid lanes carry t = INF: cap the shading position so masked-out
    # math (NEE dist^2, MIS pdf ratios) stays finite.
    t_pos = torch.where(its.valid, its.t, 1.0e6)
    p = o + t_pos[:, None] * d
    # trust intersector-provided barycentrics when present
    has_bary = (its.b1 + its.b2) != 0.0
    b1 = torch.where(has_bary, its.b1, b1)
    b2 = torch.where(has_bary, its.b2, b2)

    w0 = (1.0 - b1 - b2)[:, None]
    ns = m.normalize(n0 * w0 + n1 * b1[:, None] + n2 * b2[:, None])
    # flip the shading normal to the geometric side
    ns = torch.where(m.dot(ns, ng, keepdims=True) < 0.0, -ns, ns)
    uv = t0 * w0 + t1 * b1[:, None] + t2 * b2[:, None]
    return {
        "p": p,
        "ng": ng,
        "ns": ns,
        "uv": uv,
        "mat": scene.tri_material[its.prim],
        "emitter": scene.tri_emitter[its.prim],
        "wi_world": -d,
    }
