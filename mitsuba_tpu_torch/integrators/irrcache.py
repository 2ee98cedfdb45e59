"""Irradiance caching (port of integrators/irrcache.py; the reference's
src/librender/irrcache.cpp:44 HierarchicalIrradianceCache and
src/integrators/misc/irrcache).

The reference's lazily filled octree, with per-query insertion, is
pointer-chasing and order-dependent; here the cache is built eagerly as a
flat point cloud: area-weighted surface points, each with a hemispherical
MC estimate of the indirect irradiance and the harmonic-mean gather
distance, stored in a hash grid. Shading interpolates with Ward's weights
   w_i = 1 / (|x - x_i| / R_i + sqrt(1 - n.n_i))
(irrcache.cpp:269) and adds exact direct lighting (the irrcache
integrator's split). Gather rays return the direct lighting at their hit
(a one-bounce cache, the reference's default single-level mode).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import math as m
from ..core import warp
from ..core.rng import SampleStream, uniform
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..ops import hashgrid, trace
from .common import RenderConfig

RAY_EPS = 1e-3


def _norm(v: torch.Tensor) -> torch.Tensor:
    """The Euclidean norm over the last axis, as sqrt(sum(v^2)) (the JAX
    package's jnp.linalg.norm)."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _direct_at(scene, p, ns, sp, wi_local, u3, families):
    """One-sample NEE direct lighting (no MIS partner: the gather rays that
    produced these points never count emitters)."""
    ds = emitterlib.sample_direct(scene, p, u3)
    wo_local = m.to_local(ns, ds.d)
    f, _ = bsdflib.eval_pdf(sp, wi_local, wo_local, families)
    blocked = trace.any_hit(scene, p, ds.d, ds.dist)
    ok = (ds.pdf > 0.0) & ~blocked
    return torch.where(ok[:, None], f * ds.radiance * m.safe_div(1.0, ds.pdf)[:, None], 0.0)


def triangle_cdf(scene) -> torch.Tensor:
    """The normalised cumulative triangle areas (area-weighted point
    placement)."""
    v, i = scene.vertices, scene.indices.to(torch.int64)
    p0 = v[i[:, 0]]
    areas = 0.5 * _norm(m.cross(v[i[:, 1]] - p0, v[i[:, 2]] - p0))
    cdf = torch.cumsum(areas, 0)
    return cdf / cdf[-1]


def build_cache(scene, cfg: RenderConfig, n_points: int = 4096, n_hemi: int = 64,
                seed: int = 77):
    """Returns the cache, a tuple (positions (M,3), normals (M,3), E (M,3)
    indirect irradiance, R (M,) harmonic-mean distance, grid, cell size,
    rotational and translational gradients (M,3,3))."""
    families = scene.bsdf_families
    dev = scene.device
    v, i = scene.vertices, scene.indices.to(torch.int64)
    p0 = v[i[:, 0]]
    e1 = v[i[:, 1]] - p0
    e2 = v[i[:, 2]] - p0
    cdf = triangle_cdf(scene)
    lanes = torch.arange(n_points, dtype=torch.int64, device=dev)

    def u(dim):
        return uniform(seed, lanes, 0, dim)

    tri = torch.searchsorted(cdf, u(0).contiguous())
    tri = torch.clamp_max(tri, cdf.shape[0] - 1)
    b1 = u(1)
    b2 = u(2)
    flip = b1 + b2 > 1.0
    b1 = torch.where(flip, 1.0 - b1, b1)
    b2 = torch.where(flip, 1.0 - b2, b2)
    pos = p0[tri] + e1[tri] * b1[:, None] + e2[tri] * b2[:, None]
    ngv = m.cross(e1[tri], e2[tri])
    nrm = ngv / m.length(ngv, keepdims=True)

    # the hemispherical gather: K cosine rays a cache point. Beside E, the
    # Ward-Heckbert irradiance gradients (irrcache.h:148) in MC form:
    #   rotational: dE/d(rot about a) = (pi/N) sum L_k (a.(n x w_k))/cos
    #   translational: the gradient of the area-form measure factor
    #     (n.w) cos_y / r^2 of each sample's fixed hit point y_k:
    #     g_k = 4w/r - n/(r cos) + n_y/(r cos_y)
    #     (cosines clamped to 0.1 against grazing blow-up).
    E = torch.zeros((n_points, 3), device=dev)
    g_rot = torch.zeros((n_points, 3, 3), device=dev)   # (point, channel, axis)
    g_tr = torch.zeros((n_points, 3, 3), device=dev)
    inv_dist = torch.zeros((n_points,), device=dev)
    hits_n = torch.zeros((n_points,), device=dev)
    for k in range(n_hemi):
        local = warp.square_to_cosine_hemisphere(torch.stack([u(10 + 4 * k), u(11 + 4 * k)], -1))
        d = m.to_world(nrm, local)
        o = pos + nrm * RAY_EPS
        its = trace.closest_hit(scene, o, d)
        si = trace.surface_interaction(scene, o, d, its)
        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"], aux=si)
        wi_local = m.to_local(si["ns"], si["wi_world"])
        u3 = torch.stack([u(12 + 4 * k), u(13 + 4 * k), u(1000 + k)], -1)
        ld = _direct_at(scene, si["p"], si["ns"], sp, wi_local, u3, families)
        # radiance back toward the cache point (one-bounce indirect;
        # emitter hits contribute nothing); the cosine pdf cancels the
        # cosine: E += pi mean(L)
        L = torch.where(its.valid[:, None], ld, 0.0)
        E = E + L
        cos_l = torch.clamp_min(torch.sum(d * nrm, -1), 0.1)
        axis = m.cross(nrm, d) / cos_l[:, None]
        g_rot = g_rot + L[:, :, None] * axis[:, None, :]
        r_k = torch.clamp_min(its.t, 1e-3)
        cos_y = torch.clamp_min(-torch.sum(d * si["ng"], -1), 0.1)
        gfac = (4.0 * d / r_k[:, None] - nrm / (r_k * cos_l)[:, None]
                + si["ng"] / (r_k * cos_y)[:, None])
        gfac = torch.where(its.valid[:, None], gfac, 0.0)
        g_tr = g_tr + L[:, :, None] * gfac[:, None, :]
        inv_dist = inv_dist + torch.where(its.valid, 1.0 / torch.clamp_min(its.t, 1e-4), 0.0)
        hits_n = hits_n + its.valid

    E = E * (math.pi / n_hemi)
    g_rot = g_rot * (math.pi / n_hemi)
    g_tr = g_tr * (math.pi / n_hemi)
    # harmonic mean distance; open hemispheres get a large R, clamped to
    # the scene's size
    R = torch.where(hits_n > 0, hits_n / torch.clamp_min(inv_dist, 1e-6), 1e6)
    diag = float(_norm(torch.amax(v, 0) - torch.amin(v, 0)))
    R = torch.clamp(R, 0.01 * diag, 0.5 * diag)
    cell = 0.1 * diag
    grid = hashgrid.build(pos, torch.ones((n_points,), dtype=torch.bool, device=dev), cell)
    return pos, nrm, E, R, grid, cell, g_rot, g_tr


def cache_from_jax(cache, device="cuda"):
    """A JAX package cache (build_cache's tuple) on `device`, its hash grid
    included."""
    def t(x):
        return torch.as_tensor(np.array(x), device=device)

    pos, nrm, E, R, jgrid, cell, g_rot, g_tr = cache
    grid = hashgrid.HashGrid(order=t(jgrid.order).to(torch.int64),
                             sorted_hash=t(jgrid.sorted_hash),
                             cell_size=t(jgrid.cell_size), table_size=int(jgrid.table_size))
    return t(pos), t(nrm), t(E), t(R), grid, float(cell), t(g_rot), t(g_tr)


def interpolate(cache, p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Ward-weighted irradiance at (p, n) with first-order gradient
    extrapolation (irrcache.h:148): each record contributes E_i + (n_i x
    n).G_rot,i + (p - p_i).G_tr,i."""
    pos, nrm, E, R, grid, cell, g_rot, g_tr = cache

    def reduce_fn(carry, pidx, mask):
        acc_e, acc_w = carry
        dvec = p[:, None, :] - pos[pidx]
        dist = _norm(dvec)
        ndot = torch.clamp(torch.sum(nrm[pidx] * n[:, None, :], -1), -1.0, 1.0)
        w = 1.0 / (dist / R[pidx] + torch.sqrt(torch.clamp_min(1.0 - ndot, 0.0)) + 1e-3)
        w = torch.where(mask & (ndot > 0.1), w, 0.0)
        rot_axis = m.cross(nrm[pidx], n[:, None, :])
        e_ext = (E[pidx] + torch.einsum("qwca,qwa->qwc", g_rot[pidx], rot_axis)
                 + torch.einsum("qwca,qwa->qwc", g_tr[pidx], dvec))
        e_ext = torch.clamp_min(e_ext, 0.0)
        return (acc_e + torch.einsum("qw,qwc->qc", w, e_ext), acc_w + torch.sum(w, -1))

    q = p.shape[0]
    (acc_e, acc_w), _ = hashgrid.query_sum(
        grid, pos, p, torch.full((q,), cell, device=p.device), reduce_fn,
        (torch.zeros((q, 3), device=p.device), torch.zeros((q,), device=p.device)))
    return m.safe_div(acc_e, acc_w[:, None])


def li_factory(cache):
    """A Li function (scene, cam, o, d, stream, cfg) rendering direct + the
    cached indirect light (the irrcache integrator's split)."""
    from . import direct as directlib

    def li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig):
        L = directlib.li(scene, cam, o, d, stream, cfg)
        its = trace.closest_hit(scene, o, d)
        si = trace.surface_interaction(scene, o, d, its)
        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"], aux=si)
        ind = sp.reflectance / math.pi * interpolate(cache, si["p"], si["ns"])
        return L + torch.where(its.valid[:, None], ind, 0.0)

    return li


def render(scene, cam, cfg: RenderConfig, n_points: int = 4096,
           n_hemi: int = 64) -> torch.Tensor:
    """Two-pass irradiance-cached render -> (H, W, 3): the cache built
    eagerly, then the film through common.render_jit, as the JAX package
    renders it. Its Li is a new closure over this call's cache, so on the
    card each call captures its own chunk graph (JAX compiles per call
    alike); the graph's cache entry holds the closure, and with it the
    cache's tensors the graph reads."""
    from . import common

    cache = build_cache(scene, cfg, n_points, n_hemi, seed=cfg.seed + 77)
    return common.render_jit(scene, cam, li_factory(cache), cfg)
