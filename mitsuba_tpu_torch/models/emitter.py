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

The emitter ray API (`sample_emitter_ray` and the connection and pdf
helpers below it) starts the light subpaths of the particle tracer and
the bidirectional integrators from every emitter kind.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core import warp
from ..ops.gather import gather_rows
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
    p0t, e1t, e2t = (gather_rows(p0_all, tri), gather_rows(e1_all, tri),
                     gather_rows(e2_all, tri))
    radt = gather_rows(em.radiance, em.tri_emitter[idx])
    sel_pdf = gather_rows(em.tri_pdf, idx)
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
        fall = _falloff(m.dot(-d_pos, ldir), cut)
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


# ---------------------------------------------------------------------------
# Emitter rays (light-path starts): Scene::sampleEmitterRay (scene.cpp:1103)
# over area, point, spot, directional and constant/envmap emitters.
# ---------------------------------------------------------------------------

# emitter-vertex kind codes carried by light subpaths (per lane)
EV_AREA = 0
EV_ENV = 1
EV_POINT = 2
EV_SPOT = 3
EV_DIR = 4


class EmitterRaySample(NamedTuple):
    """A sampled light-path origin: the ray and the pdfs BDPT's MIS needs.

    z0 is the emitter vertex.
      beta     = the full ray weight Le/(sel pdf_pos pdf_dir): the power a
                 particle carries.
      beta_pos = the weight of z0 alone, for s=1 connections: area Le/pdf_pos;
                 point and spot I/sel (the falloff is applied when
                 connecting); env L(d)/(pdf_dir sel); directional E/sel.
      pdf_pos  = the pdf of z0 in its own measure: area lights sel/area; env
                 sel pdf_dir (solid angle: the direction is the env vertex);
                 delta-position lights sel.
      pdf_dir  = the pdf of the direction given z0: area cos/pi; point
                 1/4pi; spot the cone's; env and directional the bounding
                 disk's 1/(pi r^2) (area measure: infinite lights swap the
                 roles of position and direction).
    """

    o: torch.Tensor          # (N,3) ray origin (offset)
    d: torch.Tensor          # (N,3) ray direction
    beta: torch.Tensor       # (N,3)
    ng: torch.Tensor         # (N,3) normal at the origin (delta, infinite: the ray direction)
    pos: torch.Tensor        # (N,3) emitter vertex (not offset)
    beta_pos: torch.Tensor   # (N,3)
    pdf_pos: torch.Tensor    # (N,)
    pdf_dir: torch.Tensor    # (N,)
    kind: torch.Tensor       # (N,) int32 EV_*
    tri: torch.Tensor        # (N,) area triangle id (0 where not an area light)
    aux_dir: torch.Tensor    # (N,3) spot axis / infinite light's ray direction
    cutoff: torch.Tensor     # (N,2) spot (cos cutoff, cos beam)
    delta_pos: torch.Tensor  # (N,) bool
    delta_dir: torch.Tensor  # (N,) bool
    is_env: torch.Tensor     # (N,) bool
    is_area: torch.Tensor    # (N,) bool


def sample_emitter_ray(scene, u_sel, u_pos, u_dir) -> EmitterRaySample:
    """A ray leaving an emitter, every kind in one masked computation: the
    group by u_sel (as sample_direct), then a point and a direction."""
    n = u_sel.shape[0]
    dev = u_sel.device
    em = scene.emitters
    pg_area, env_p, p_delta = _group_probs(scene)
    ray_eps = 1e-3

    def falses():
        return torch.zeros((n,), dtype=torch.bool, device=dev)

    pick_env = (u_sel < env_p) if scene.has_env else falses()
    de = scene.delta_emitters
    pick_delta = (u_sel >= env_p) & (u_sel < env_p + p_delta) if de is not None else falses()
    is_area = ~(pick_env | pick_delta)

    # --- area branch ----------------------------------------------------
    u_area = torch.clamp((u_sel - env_p - p_delta) / max(pg_area, 1e-9), 0.0, 1.0)
    idx = torch.clamp(torch.searchsorted(em.tri_cdf, u_area, right=False),
                      0, em.tri_cdf.shape[0] - 1)
    tri = em.tri_index[idx]
    sel_area = gather_rows(em.tri_pdf, idx) * max(pg_area, 1e-9)
    p0, e1, e2 = scene.tri_vertices()
    p0t, e1t, e2t = gather_rows(p0, tri), gather_rows(e1, tri), gather_rows(e2, tri)
    b = warp.square_to_uniform_triangle(u_pos)
    pos = p0t + e1t * b[..., 0:1] + e2t * b[..., 1:2]
    ngv = m.cross(e1t, e2t)
    two_a = m.length(ngv)
    ng = ngv / torch.clamp_min(two_a, 1e-20)[:, None]
    area = 0.5 * two_a
    d = m.to_world(ng, warp.square_to_cosine_hemisphere(u_dir))
    le = gather_rows(em.radiance, em.tri_emitter[idx])
    pdf_pos = m.safe_div(sel_area, area)
    pdf_dir = torch.clamp_min(m.dot(d, ng), 0.0) * (1.0 / math.pi)
    beta_pos = le / torch.clamp_min(pdf_pos, 1e-20)[:, None]
    beta = le * (math.pi * m.safe_div(area, sel_area))[:, None]
    o = pos + ng * ray_eps
    kind = torch.full((n,), EV_AREA, dtype=torch.int32, device=dev)
    aux_dir = d
    cutoff = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    delta_pos = falses()
    delta_dir = falses()

    c_bs, r_bs = scene_bsphere(scene)
    disk_pdf = 1.0 / (math.pi * r_bs * r_bs)

    # --- delta branch: point, spot, directional -------------------------
    if de is not None:
        k = de.kind.shape[0]
        u_d = torch.clamp((u_sel - env_p) / max(p_delta, 1e-9), 0.0, 1.0 - 1e-7)
        which = torch.clamp_max((u_d * k).to(torch.int64), k - 1)
        dkind = de.kind[which]
        lp = de.position[which]
        ldir = de.direction[which]
        inten = de.intensity[which]
        cut = de.cutoff[which]
        sel = max(p_delta, 1e-9) / k

        is_spot = dkind == _ir.DELTA_SPOT
        is_dirl = dkind == _ir.DELTA_DIRECTIONAL
        is_coll = dkind == _ir.DELTA_COLLIMATED

        d_sphere = warp.square_to_uniform_sphere(u_dir)
        d_cone = m.to_world(ldir, warp.square_to_uniform_cone(u_dir, cut[..., 0]))
        pdf_cone = warp.square_to_uniform_cone_pdf(cut[..., 0])
        fall = _falloff(m.dot(d_cone, ldir), cut)
        # directional: the origin on the bounding sphere's disk across the beam
        off = warp.square_to_uniform_disk_concentric(u_pos) * r_bs
        t1, t2 = m.coordinate_system(ldir)
        o_disk = c_bs - ldir * r_bs + t1 * off[..., 0:1] + t2 * off[..., 1:2]

        d_delta = torch.where((is_dirl | is_coll)[:, None], ldir,
                              torch.where(is_spot[:, None], d_cone, d_sphere))
        pos_delta = torch.where(is_dirl[:, None], o_disk, lp)
        pdf_dir_delta = torch.where(
            is_dirl | is_coll, 1.0,
            torch.where(is_spot, pdf_cone, warp.square_to_uniform_sphere_pdf()))
        beta_delta = torch.where(
            is_dirl[:, None], inten * (math.pi * r_bs * r_bs) / sel,
            torch.where(is_spot[:, None], inten * m.safe_div(fall, pdf_cone)[:, None] / sel,
                        torch.where(is_coll[:, None], inten / sel,
                                    inten * (4.0 * math.pi / sel))))
        kind_delta = torch.where(is_dirl, EV_DIR,
                                 torch.where(is_spot, EV_SPOT, EV_POINT)).to(torch.int32)

        o = torch.where(pick_delta[:, None], pos_delta + d_delta * ray_eps, o)
        d = torch.where(pick_delta[:, None], d_delta, d)
        pos = torch.where(pick_delta[:, None], pos_delta, pos)
        ng = torch.where(pick_delta[:, None], d_delta, ng)
        beta = torch.where(pick_delta[:, None], beta_delta, beta)
        beta_pos = torch.where(pick_delta[:, None], inten / sel, beta_pos)
        pdf_pos = torch.where(pick_delta, sel, pdf_pos)
        pdf_dir = torch.where(pick_delta, torch.where(is_dirl, disk_pdf, pdf_dir_delta), pdf_dir)
        kind = torch.where(pick_delta, kind_delta, kind)
        aux_dir = torch.where(pick_delta[:, None], ldir, aux_dir)
        cutoff = torch.where(pick_delta[:, None], cut, cutoff)
        delta_pos = torch.where(pick_delta, ~is_dirl, delta_pos)
        delta_dir = torch.where(pick_delta, is_dirl | is_coll, delta_dir)

    # --- environment branch ---------------------------------------------
    if scene.has_env:
        if scene.envmap is not None:
            d_out, pdf_env, rad_env = envlib.sample_direction(scene.envmap, u_dir)
        else:
            d_out = warp.square_to_uniform_sphere(u_dir)
            pdf_env = torch.full((n,), warp.square_to_uniform_sphere_pdf(),
                                 dtype=torch.float32, device=dev)
            rad_env = scene.env_radiance.expand(n, 3)
        d_in = -d_out                      # the ray travels into the scene
        off = warp.square_to_uniform_disk_concentric(u_pos) * r_bs
        t1, t2 = m.coordinate_system(d_in)
        o_env = c_bs - d_in * r_bs + t1 * off[..., 0:1] + t2 * off[..., 1:2]
        sel = max(env_p, 1e-9)
        beta_env = rad_env * m.safe_div(math.pi * r_bs * r_bs, pdf_env * sel)[:, None]
        beta_pos_env = rad_env / torch.clamp_min(pdf_env * sel, 1e-20)[:, None]

        o = torch.where(pick_env[:, None], o_env, o)
        d = torch.where(pick_env[:, None], d_in, d)
        pos = torch.where(pick_env[:, None], o_env, pos)
        ng = torch.where(pick_env[:, None], d_in, ng)
        beta = torch.where(pick_env[:, None], beta_env, beta)
        beta_pos = torch.where(pick_env[:, None], beta_pos_env, beta_pos)
        pdf_pos = torch.where(pick_env, pdf_env * sel, pdf_pos)
        pdf_dir = torch.where(pick_env, disk_pdf, pdf_dir)
        kind = torch.where(pick_env, EV_ENV, kind)
        aux_dir = torch.where(pick_env[:, None], d_in, aux_dir)
        delta_dir = torch.where(pick_env, False, delta_dir)

    return EmitterRaySample(
        o=o, d=d, beta=beta, ng=ng, pos=pos, beta_pos=beta_pos, pdf_pos=pdf_pos,
        pdf_dir=pdf_dir, kind=kind, tri=tri, aux_dir=aux_dir, cutoff=cutoff,
        delta_pos=delta_pos, delta_dir=delta_dir, is_env=pick_env, is_area=is_area)


def _falloff(cos_ax, cutoff):
    """A spot's falloff: 1 inside the beam width, linear to 0 at the cutoff."""
    return torch.clamp(m.safe_div(cos_ax - cutoff[..., 0],
                                  torch.clamp_min(cutoff[..., 1] - cutoff[..., 0], 1e-6)),
                       0.0, 1.0)


def connect_emitter_vertex(scene, p, kind, pos, ng, aux_dir, cutoff):
    """The geometry of connecting surface points p to light-path origins z0
    (the s=1 connection). Returns (cdir, dist, g, finite); the contribution
    is beta_eye f_eye(cdir) g beta_pos(z0), where g folds the measure
    conversion: cos_z/d^2 for area lights, falloff/d^2 for spots, 1/d^2 for
    points, 1 for the environment and directional lights (a delta
    direction: only -aux_dir transports)."""
    to_l = pos - p
    d2 = torch.clamp_min(m.dot(to_l, to_l), 1e-12)
    dist_f = torch.sqrt(d2)
    cdir_f = to_l / dist_f[:, None]
    inv_d2 = 1.0 / d2
    g_area = torch.clamp_min(m.dot(ng, -cdir_f), 0.0) * inv_d2
    # the spot's falloff toward p (light -> p is -cdir)
    fall = _falloff(m.dot(-cdir_f, aux_dir), cutoff)
    g = torch.where(kind == EV_AREA, g_area,
                    torch.where(kind == EV_SPOT, fall * inv_d2,
                                torch.where(kind == EV_POINT, inv_d2, 1.0)))
    infinite = (kind == EV_ENV) | (kind == EV_DIR)
    cdir = torch.where(infinite[:, None], -aux_dir, cdir_f)
    dist = torch.where(infinite, m.INF * 0.1, dist_f)
    return cdir, dist, g, ~infinite


def emitter_dir_pdf_area(kind, pos, ng, aux_dir, cutoff, disk_pdf, y_p, y_ng) -> torch.Tensor:
    """Area-measure pdf of the emitter vertex z0 sending a ray through the
    surface point y (the light side's term in the MIS sums): area cos0/pi
    cos_y/d^2; point 1/(4 pi) cos_y/d^2; spot the cone's pdf inside the
    cone; env and directional the parallel-ray density disk_pdf |cos_y|."""
    to_y = y_p - pos
    d2 = torch.clamp_min(m.dot(to_y, to_y), 1e-12)
    w = to_y * torch.rsqrt(d2)[:, None]
    cos_y_fin = torch.abs(m.dot(w, y_ng)) / d2
    pdf_area = torch.clamp_min(m.dot(w, ng), 0.0) * (1.0 / math.pi)
    pdf_point = 1.0 / (4.0 * math.pi)
    pdf_spot = torch.where(m.dot(w, aux_dir) > cutoff[..., 0],
                           warp.square_to_uniform_cone_pdf(cutoff[..., 0]), 0.0)
    cos_y_inf = torch.abs(m.dot(aux_dir, y_ng))
    return torch.where(
        kind == EV_AREA, pdf_area * cos_y_fin,
        torch.where(kind == EV_POINT, pdf_point * cos_y_fin,
                    torch.where(kind == EV_SPOT, pdf_spot * cos_y_fin, disk_pdf * cos_y_inf)))


def emitter_hit_pdf(kind, pos, ng, from_p, bsdf_pdf_sa) -> torch.Tensor:
    """The pdf, in z0's own measure, of the eye side reaching the emitter
    vertex z0 by scattering from `from_p` with solid-angle pdf
    `bsdf_pdf_sa`: area lights convert to area, the environment stays in
    solid angle, delta lights are never hit (0)."""
    to_z = pos - from_p
    d2 = torch.clamp_min(m.dot(to_z, to_z), 1e-12)
    w = to_z * torch.rsqrt(d2)[:, None]
    conv = torch.abs(m.dot(w, ng)) / d2
    return torch.where(kind == EV_AREA, bsdf_pdf_sa * conv,
                       torch.where(kind == EV_ENV, bsdf_pdf_sa, 0.0))


def pdf_direct_area(scene, ref_p, d, dist, prim, cos_l) -> torch.Tensor:
    """Solid-angle pdf that sample_direct would have produced direction `d`
    hitting triangle `prim` at distance `dist` (MIS on BSDF samples)."""
    em = scene.emitters
    _, e1, e2 = scene.tri_vertices()
    area_all = 0.5 * m.length(m.cross(e1, e2))   # (T,)
    p_area = m.safe_div(gather_rows(em.select_pdf_full, prim), gather_rows(area_all, prim))
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
