"""Emitter sampling: area lights, the environment (constant or a lat-long
map) and delta lights (port of the parts of models/emitter.py the path
tracers call).

NEE draws an emissive triangle from a luminance-weighted CDF, a uniform
point on it, and converts the area pdf to solid angle; the environment
branch importance-samples `scene.envmap` (scene/envmap.py) where the scene
has one, else the sphere uniformly; the delta branch picks one of
`scene.delta_emitters` (point, spot, directional) uniformly and flags the
sample `is_delta` (MIS weight 1). The three groups split the first
uniform by `scene.group_probs` (compute_group_probs: by power), else
evenly. Row fetches are plain indexing: the JAX package's one-hot matmul
(ops/gather.py) exists only because row gathers are slow on a TPU.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core import warp
from ..scene import envmap as envlib
from ..scene import ir as _ir


class DirectSample(NamedTuple):
    """A direction sampled toward an emitter from a reference point."""

    d: torch.Tensor          # (N,3) unit direction ref -> light
    dist: torch.Tensor       # (N,)
    radiance: torch.Tensor   # (N,3)
    pdf: torch.Tensor        # (N,) solid-angle pdf x selection prob (0=invalid)
    is_env: torch.Tensor     # (N,) bool
    is_delta: torch.Tensor   # (N,) bool
    # (N,3) the light's surface normal at the sampled point (area lights;
    # zeros for the environment and delta lights)
    n_l: torch.Tensor = None


def _group_probs(scene):
    """Static selection probabilities of the (area, env, delta) groups:
    the scene's precomputed ones, else uniform over present groups."""
    gp = scene.group_probs
    if gp:
        return gp
    has_delta = scene.delta_emitters is not None
    groups = int(scene.has_area) + int(scene.has_env) + int(has_delta)
    p = 1.0 / max(groups, 1)
    return (p if scene.has_area else 0.0, p if scene.has_env else 0.0,
            p if has_delta else 0.0)


_LUM = (0.2126, 0.7152, 0.0722)


def _np(x):
    return x.detach().cpu().numpy()


def compute_group_probs(scene):
    """The scene with power-weighted (area, env, delta) selection
    probabilities in `group_probs`, computed on the host: area lights by
    area x luminance x pi, the environment by its mean luminance x 4 pi x
    the scene's bounding disk, delta lights by intensity x solid angle
    (spot: its cone; directional: the disk). A present group keeps at
    least 0.05 before renormalising."""
    lum = np.asarray(_LUM, np.float32)
    p_area = p_env = p_delta = 0.0
    if scene.has_area:
        em = scene.emitters
        v, i, tri = _np(scene.vertices), _np(scene.indices), _np(em.tri_index)
        p0 = v[i[tri, 0]]
        e1 = v[i[tri, 1]] - p0
        e2 = v[i[tri, 2]] - p0
        areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        rad = _np(em.radiance)[_np(em.tri_emitter)]
        p_area = float(np.sum(areas * (rad @ lum)) * np.pi)
    _, r = (_np(x) for x in scene_bsphere(scene))
    disk = float(np.pi * r * r)
    if scene.has_env:
        if scene.envmap is not None:
            mean_l = (float((_np(scene.envmap.image).reshape(-1, 3) @ lum).mean())
                      * float(_np(scene.envmap.scale)))
        else:
            mean_l = float(_np(scene.env_radiance) @ lum)
        p_env = mean_l * 4.0 * np.pi * disk
    de = scene.delta_emitters
    if de is not None:
        kind = _np(de.kind)
        cut = _np(de.cutoff)
        solid = np.where(
            kind == _ir.DELTA_SPOT, 2.0 * np.pi * (1.0 - cut[:, 0]),
            np.where(kind == _ir.DELTA_DIRECTIONAL, disk,
                     np.where(kind == _ir.DELTA_COLLIMATED, 1.0, 4.0 * np.pi)))
        p_delta = float(np.sum((_np(de.intensity) @ lum) * solid))
    total = p_area + p_env + p_delta
    if total <= 0.0:
        return scene
    present = (scene.has_area, scene.has_env, de is not None)
    probs = tuple(max(p / total, 0.05) if on else 0.0
                  for p, on in zip((p_area, p_env, p_delta), present))
    s = sum(probs)
    return scene.replace(group_probs=tuple(p / s for p in probs))


def scene_bsphere(scene):
    """The scene's bounding sphere (centre (3,), radius ()), 1.1x the
    vertices' box: where infinite emitters place ray origins."""
    vmin = torch.amin(scene.vertices, dim=0)
    vmax = torch.amax(scene.vertices, dim=0)
    c = 0.5 * (vmin + vmax)
    return c, torch.clamp_min(m.length(vmax - c), 1e-3) * 1.1


def sample_direct(scene, ref_p: torch.Tensor, u3: torch.Tensor) -> DirectSample:
    """u3: (N,3) uniforms -> (emitter choice, point on the emitter)."""
    n = ref_p.shape[0]
    dev = ref_p.device
    em = scene.emitters
    pg_area, env_p, p_delta = _group_probs(scene)
    # slot layout over u3[...,0]: [0, env_p) env | rest area
    u0 = u3[..., 0]
    if scene.has_env:
        pick_env = u0 < env_p
    else:
        pick_env = torch.zeros((n,), dtype=torch.bool, device=dev)
    de = scene.delta_emitters
    # [env_p, env_p + p_delta): delta lights
    pick_delta = ((u0 >= env_p) & (u0 < env_p + p_delta) if de is not None
                  else torch.zeros((n,), dtype=torch.bool, device=dev))
    u_sel = torch.clamp((u0 - env_p - p_delta) / max(pg_area, 1e-9), 0.0, 1.0)

    # --- area emitter branch -------------------------------------------
    idx = torch.clamp(torch.searchsorted(em.tri_cdf, u_sel, right=False),
                      0, em.tri_cdf.shape[0] - 1)
    p0_all, e1_all, e2_all = scene.tri_vertices()
    tri = em.tri_index[idx]
    p0t, e1t, e2t = p0_all[tri], e1_all[tri], e2_all[tri]
    radt = em.radiance[em.tri_emitter[idx]]
    sel_pdf = em.tri_pdf[idx]
    b = warp.square_to_uniform_triangle(u3[..., 1:3])
    pos = p0t + e1t * b[..., 0:1] + e2t * b[..., 1:2]
    ngv = m.cross(e1t, e2t)
    two_a = m.length(ngv)
    ng = ngv / two_a[:, None]
    area = 0.5 * two_a
    to_light = pos - ref_p
    dist = m.length(to_light)
    d = to_light / dist[:, None]
    cos_l = m.dot(ng, -d)
    # area pdf -> solid angle
    p_area = m.safe_div(sel_pdf, area)
    pdf_area_sa = m.safe_div(p_area * dist * dist, torch.abs(cos_l))
    # one-sided area emitters: only the front face emits
    front = cos_l > 1e-6
    pdf_area_sa = torch.where(front, pdf_area_sa, 0.0)
    rad = torch.where(front[:, None], radt, 0.0)

    pdf = pdf_area_sa * pg_area
    is_delta = pick_delta

    # --- delta branch: point, spot, directional ------------------------
    if de is not None:
        k = de.kind.shape[0]
        which = torch.clamp_max((u3[..., 1] * k).to(torch.int64), k - 1)
        kind = de.kind[which]
        ldir = de.direction[which]
        inten = de.intensity[which]
        cut = de.cutoff[which]
        to_l = de.position[which] - ref_p
        dist_d = m.length(to_l)
        d_pos = to_l / torch.clamp_min(dist_d, 1e-12)[:, None]
        inv_d2 = m.safe_div(1.0, dist_d * dist_d)
        # spot falloff: 1 inside the beam width, linear to 0 at the cutoff
        cos_spot = m.dot(-d_pos, ldir)
        fall = torch.clamp(m.safe_div(cos_spot - cut[..., 0],
                                      torch.clamp_min(cut[..., 1] - cut[..., 0], 1e-6)),
                           0.0, 1.0)
        rad_point = inten * inv_d2[:, None]
        rad_spot = rad_point * fall[:, None]
        is_dirl = kind == _ir.DELTA_DIRECTIONAL
        d_delta = torch.where(is_dirl[:, None], -ldir, d_pos)
        dist_delta = torch.where(is_dirl, m.INF * 0.1, dist_d)
        rad_delta = torch.where((kind == _ir.DELTA_SPOT)[:, None], rad_spot,
                                torch.where(is_dirl[:, None], inten, rad_point))
        # a collimated beam meets a surface point with probability zero
        rad_delta = torch.where((kind == _ir.DELTA_COLLIMATED)[:, None], 0.0, rad_delta)
        d = torch.where(pick_delta[:, None], d_delta, d)
        dist = torch.where(pick_delta, dist_delta, dist)
        rad = torch.where(pick_delta[:, None], rad_delta, rad)
        pdf = torch.where(pick_delta, p_delta / k, pdf)

    # --- environment branch -------------------------------------------
    if scene.has_env:
        if scene.envmap is not None:
            d_env, pdf_env, rad_env = envlib.sample_direction(scene.envmap, u3[..., 1:3])
        else:
            d_env = warp.square_to_uniform_sphere(u3[..., 1:3])
            pdf_env = torch.full_like(pdf, warp.square_to_uniform_sphere_pdf())
            rad_env = scene.env_radiance.expand(n, 3)
        d = torch.where(pick_env[:, None], d_env, d)
        dist = torch.where(pick_env, m.INF * 0.1, dist)
        rad = torch.where(pick_env[:, None], rad_env, rad)
        pdf = torch.where(pick_env, pdf_env * env_p, pdf)
    n_l = torch.where((is_delta | pick_env)[:, None], 0.0, ng)
    return DirectSample(d=d, dist=dist, radiance=rad, pdf=pdf,
                        is_env=pick_env, is_delta=is_delta, n_l=n_l)


def pdf_direct_area(scene, ref_p, d, dist, prim, cos_l) -> torch.Tensor:
    """Solid-angle pdf that sample_direct would have produced direction `d`
    hitting triangle `prim` at distance `dist` (MIS on BSDF samples)."""
    em = scene.emitters
    _, e1, e2 = scene.tri_vertices()
    area_all = 0.5 * m.length(m.cross(e1, e2))   # (T,)
    p_area = m.safe_div(em.select_pdf_full[prim], area_all[prim])
    pdf = m.safe_div(p_area * dist * dist, torch.abs(cos_l))
    pg_area, _, _ = _group_probs(scene)
    return pdf * pg_area


def pdf_direct_env(scene, d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of sample_direct's env branch for direction d."""
    if not scene.has_env:
        return torch.zeros(d.shape[:-1], dtype=torch.float32, device=d.device)
    _, env_p, _ = _group_probs(scene)
    if scene.envmap is not None:
        return envlib.pdf_direction(scene.envmap, d) * env_p
    return torch.full(d.shape[:-1], warp.square_to_uniform_sphere_pdf() * env_p,
                      dtype=torch.float32, device=d.device)


def env_radiance(scene, d: torch.Tensor) -> torch.Tensor:
    """Environment emission for escaped rays."""
    if not scene.has_env:
        return torch.zeros(d.shape[:-1] + (3,), dtype=d.dtype, device=d.device)
    if scene.envmap is not None:
        return envlib.eval_radiance(scene.envmap, d)
    return scene.env_radiance.expand(d.shape[:-1] + (3,))
