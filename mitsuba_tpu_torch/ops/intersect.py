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
from ..models import texture as tex
from .gather import gather_rows

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


def search_inputs(*xs):
    """Detached, contiguous copies of a search's float inputs. The search
    is stopped as the JAX package stops it (intersect.py:317,
    pallas_intersect.py:119-120, binned_intersect.py:566-569): gradients
    reach the hit only through `surface_interaction`'s recomputation, and
    neither route records autograd history. The one place the search is
    stopped: every trace entry point passes its rays and triangle rows
    through here before either route sees them."""
    return tuple(x.detach().contiguous() for x in xs)


def tri_test(o, d, tri):
    """Moller-Trumbore of rays against triangles, all broadcastable.

    o, d: 3 ray components each; tri: the 9 rows p0x p0y p0z e1x e1y e1z
    e2x e2y e2z. Returns (t, hit), hit being the geometric test (barycentric
    slack, t > SHADOW_EPS, det not tiny). The operation order is the JAX
    package's (jnp.cross, then sums left to right), which the CUDA kernels
    repeat.
    """
    ox, oy, oz = o
    dx, dy, dz = d
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri

    # pvec = d x e2
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
           & (t > SHADOW_EPS) & ~bad)
    return t, hit


def _chunk_hits(o, d, tri, tmax, best_t):
    """Hit tests of every ray against one chunk of triangles.

    o, d: 3 (N, 1) ray components each; tri: (9, C) triangle rows;
    tmax, best_t: (N, 1) or scalar. Returns t (N, C) with MISS on misses.
    """
    t, hit = tri_test(o, d, [r[None, :] for r in tri])
    return torch.where(hit & (t < best_t) & (t < tmax), t, MISS)


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
    key, base = brute_kernel.closest_key(*search_inputs(tri_soa(scene), o, d, tmax))
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

    tris, o, d, limit = search_inputs(tri_soa(scene), o, d, tmax * (1.0 - SHADOW_EPS))
    return brute_kernel.any_hit(tris, scene.tri_opaque.contiguous(), o, d, limit)


def _perturb_normal(scene, mat, uv, t0, t1, t2, e1, e2, ns, ng):
    """Normal and bump mapping (the normalmap/bumpmap adapters folded into
    the hit, JAX intersect.py:394-458): perturb the interpolated shading
    normal once here, and every integrator picks it up through si["ns"].

    normalmap (kind 1): tangent-space RGB in [0,1], n = 2c - 1 in the
    (dpdu, dpdv, ns) frame. bumpmap (kind 2): height h(u,v); the displaced
    partials dp/du + dh/du ns and dp/dv + dh/dv ns give the new normal.
    """
    mats = scene.materials
    tid = mats.tex_perturb[mat]
    kind = mats.perturb_kind[mat]
    tsafe = torch.clamp_min(tid, 0)

    # uv-space tangent solve on the winning triangle: dp/du, dp/dv
    duv1 = t1 - t0
    duv2 = t2 - t0
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    bad = torch.abs(det) < 1e-12
    inv = torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, det))[:, None]
    dpdu = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv
    dpdv = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv
    # degenerate uvs: any orthonormal tangent frame will do
    fu, fv = m.coordinate_system(ns)
    dpdu = torch.where(bad[:, None], fu, dpdu)
    dpdv = torch.where(bad[:, None], fv, dpdv)

    # normal map: the tangent-space normal rotated into world space
    ntex = 2.0 * tex.sample_bilinear(scene, tsafe, uv) - 1.0
    t_hat = m.normalize(dpdu - ns * m.dot(ns, dpdu, keepdims=True))
    b_hat = m.cross(ns, t_hat)
    # respect the uv handedness, so maps baked either way shade correctly
    b_hat = b_hat * torch.where(m.dot(b_hat, dpdv, keepdims=True) < 0.0, -1.0, 1.0)
    n_nm = m.normalize(t_hat * ntex[:, 0:1] + b_hat * ntex[:, 1:2]
                       + ns * torch.clamp_min(ntex[:, 2:3], 1e-3))

    # bump map: central differences of the height one texel out
    hw = scene.tex_size[tsafe].to(torch.float32)      # (N,2) = (h, w)
    du = 1.0 / torch.clamp_min(hw[:, 1], 1.0)
    dv = 1.0 / torch.clamp_min(hw[:, 0], 1.0)

    def hgt(uv_):
        return torch.mean(tex.sample_bilinear(scene, tsafe, uv_), dim=-1)

    eu = torch.stack([du, torch.zeros_like(du)], dim=-1)
    ev = torch.stack([torch.zeros_like(dv), dv], dim=-1)
    dhdu = (hgt(uv + eu) - hgt(uv - eu)) / (2.0 * du)
    dhdv = (hgt(uv + ev) - hgt(uv - ev)) / (2.0 * dv)
    n_bm = m.normalize(m.cross(dpdu + dhdu[:, None] * ns, dpdv + dhdv[:, None] * ns))
    n_bm = n_bm * torch.where(m.dot(n_bm, ns, keepdims=True) < 0.0, -1.0, 1.0)

    new = torch.where((kind == 1)[:, None], n_nm,
                      torch.where((kind == 2)[:, None], n_bm, ns))
    new = torch.where(((kind > 0) & (tid >= 0))[:, None], new, ns)
    # keep the geometric-side agreement of the unperturbed path
    return torch.where(m.dot(new, ng, keepdims=True) < 0.0, -new, new)


def surface_interaction(scene, o, d, its: Intersection, dd_dx=None, dd_dy=None):
    """Expand a hit record into shading data (position, frames, uv,
    material, emitter). Invalid lanes hold harmless defaults.

    Barycentrics are recomputed from the winning triangle's vertices, since
    the brute-force search returns only (t, prim); so are the derivatives
    of p, ng, ns and uv with respect to `scene.vertices`. Normal and bump
    maps perturb ns where the scene has them. With mips, "footprint" is the
    texel footprint (t x the triangle's uv density); dd_dx/dd_dy, the ray
    direction differentials of a 1-pixel raster step
    (sensor.ray_differentials), add the uv partials "duvdx"/"duvdy" that
    drive EWA. Scenes with vertex colours or wireframe materials add
    "vcolor" (the interpolated vertex colour) or "wirecolor" (the edge
    highlight), which gather_shade_point reads.
    """
    vi = scene.indices[its.prim]
    v0 = gather_rows(scene.vertices, vi[:, 0])
    v1 = gather_rows(scene.vertices, vi[:, 1])
    v2 = gather_rows(scene.vertices, vi[:, 2])
    n0 = gather_rows(scene.normals, vi[:, 0])
    n1 = gather_rows(scene.normals, vi[:, 1])
    n2 = gather_rows(scene.normals, vi[:, 2])
    t0 = gather_rows(scene.uvs, vi[:, 0])
    t1 = gather_rows(scene.uvs, vi[:, 1])
    t2 = gather_rows(scene.uvs, vi[:, 2])
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

    # Differentiable hit distance (intersect.py:512-527): the search's t is
    # detached and quantised, so t is recomputed from the winning
    # triangle's plane and only its derivative is attached to its.t (a
    # zero-primal term): the primal stays the search's bit for bit, and
    # d t / d vertices flows.
    t_mt = m.dot(e2, qv) * inv_det
    t_attach = torch.where(its.valid & ~bad, t_mt, its.t)
    t_diff = its.t + (t_attach - t_attach.detach())
    # Invalid lanes carry t = INF: cap the shading position so masked-out
    # math (NEE dist^2, MIS pdf ratios) stays finite, in the primal and in
    # backward (0 * inf cotangents would give NaN).
    t_pos = torch.where(its.valid, t_diff, 1.0e6)
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
    mat = scene.tri_material[its.prim]
    if scene.has_perturb:
        ns = _perturb_normal(scene, mat, uv, t0, t1, t2, e1, e2, ns, ng)
    out = {
        "p": p,
        "ng": ng,
        "ns": ns,
        "uv": uv,
        "mat": mat,
        "emitter": scene.tri_emitter[its.prim],
        "wi_world": -d,
    }
    if scene.tex_mips is not None and scene.tri_uv_density is not None:
        # texel footprint for the trilinear level: the pixel's width at
        # distance t (the camera factor is in tri_uv_density)
        out["footprint"] = its.t * scene.tri_uv_density[its.prim]
    if dd_dx is not None and scene.tex_mips is not None:
        # the pixel's footprint on the hit plane: p(s) = o + t(s) d(s) on
        # the plane gives dp = t (dd - d (dd.ng)/(d.ng))
        dng = m.dot(d, ng)
        safe = torch.abs(dng) > 1e-7
        inv_dng = torch.where(safe, 1.0 / torch.where(safe, dng, 1.0), 0.0)
        # barycentric derivatives through the edges' Gram system, mapped
        # through the uv edges
        a11 = m.dot(e1, e1)
        a12 = m.dot(e1, e2)
        a22 = m.dot(e2, e2)
        det_g = torch.clamp_min(a11 * a22 - a12 * a12, 1e-20)
        # a miss carries t = INF, where the JAX package's partials overflow
        # to NaN; zero partials (the trilinear lookup) keep the masked lane
        # finite, so its NaN neither indexes a texel nor reaches a gradient
        t_hit = torch.where(its.valid, its.t, 0.0)

        def duv_of(dd):
            dp = t_hit[:, None] * (dd - d * (m.dot(dd, ng) * inv_dng)[:, None])
            r1 = m.dot(dp, e1)
            r2 = m.dot(dp, e2)
            db1 = (a22 * r1 - a12 * r2) / det_g
            db2 = (a11 * r2 - a12 * r1) / det_g
            return db1[:, None] * (t1 - t0) + db2[:, None] * (t2 - t0)

        out["duvdx"] = duv_of(dd_dx)
        out["duvdy"] = duv_of(dd_dy)
    if scene.has_vtx_colors:
        vc = scene.vertex_colors
        out["vcolor"] = vc[vi[:, 0]] * w0 + vc[vi[:, 1]] * b1[:, None] + vc[vi[:, 2]] * b2[:, None]
    if scene.has_wireframe:
        # edge distance approximated in barycentric space (wireframe.cpp)
        wp = scene.wire_params
        edge = torch.minimum(torch.minimum(b1, b2), 1.0 - b1 - b2)
        t_edge = torch.clamp(edge / torch.clamp_min(wp[6], 1e-6), 0.0, 1.0)
        out["wirecolor"] = wp[3:6][None, :] + (wp[0:3] - wp[3:6])[None, :] * t_edge[:, None]
    return out
