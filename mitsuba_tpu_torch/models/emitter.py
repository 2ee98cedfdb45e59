"""Emitter sampling: area lights and a constant environment (port of the
parts of models/emitter.py the path tracer calls).

NEE draws an emissive triangle from a luminance-weighted CDF, a uniform
point on it, and converts the area pdf to solid angle. Delta emitters and
environment maps are not ported: the port's Scene has no field for them
(`scene.ir.from_jax` refuses a scene that carries one). Row fetches are plain
indexing: the JAX package's one-hot matmul (ops/gather.py) exists only
because row gathers are slow on a TPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m
from ..core import warp


class DirectSample(NamedTuple):
    """A direction sampled toward an emitter from a reference point."""

    d: torch.Tensor          # (N,3) unit direction ref -> light
    dist: torch.Tensor       # (N,)
    radiance: torch.Tensor   # (N,3)
    pdf: torch.Tensor        # (N,) solid-angle pdf x selection prob (0=invalid)
    is_env: torch.Tensor     # (N,) bool
    is_delta: torch.Tensor   # (N,) bool


def _group_probs(scene):
    """Static selection probabilities of the (area, env, delta) groups:
    the scene's precomputed ones, else uniform over present groups."""
    gp = scene.group_probs
    if gp:
        return gp
    groups = int(scene.has_area) + int(scene.has_env)
    p = 1.0 / max(groups, 1)
    return (p if scene.has_area else 0.0, p if scene.has_env else 0.0, 0.0)


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
    is_delta = torch.zeros((n,), dtype=torch.bool, device=dev)

    # --- constant environment branch -----------------------------------
    if scene.has_env:
        d_env = warp.square_to_uniform_sphere(u3[..., 1:3])
        rad_env = scene.env_radiance.expand(n, 3)
        d = torch.where(pick_env[:, None], d_env, d)
        dist = torch.where(pick_env, m.INF * 0.1, dist)
        rad = torch.where(pick_env[:, None], rad_env, rad)
        pdf = torch.where(pick_env,
                          torch.full_like(pdf, warp.square_to_uniform_sphere_pdf())
                          * env_p, pdf)
    return DirectSample(d=d, dist=dist, radiance=rad, pdf=pdf,
                        is_env=pick_env, is_delta=is_delta)


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
    return torch.full(d.shape[:-1], warp.square_to_uniform_sphere_pdf() * env_p,
                      dtype=torch.float32, device=d.device)


def env_radiance(scene, d: torch.Tensor) -> torch.Tensor:
    """Environment emission for escaped rays."""
    if not scene.has_env:
        return torch.zeros(d.shape[:-1] + (3,), dtype=d.dtype, device=d.device)
    return scene.env_radiance.expand(d.shape[:-1] + (3,))
