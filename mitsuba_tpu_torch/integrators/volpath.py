"""Volumetric path tracer over a scene-global medium (port of
integrators/volpath.py, the analog of volpath_simple.cpp).

Each bounce samples a free-flight distance against the medium: lanes with
a medium event do phase-function NEE and scatter, the others do path.li's
surface NEE and BSDF sampling, both in one pass with lane masks. NEE
through the medium applies its transmittance (closed form, or ratio
tracking in grid media); MIS uses the power heuristic with the phase pdf
in the BSDF pdf's place on medium lanes. Without a medium it is path.li.

Sampler dims: the surface lanes read path.py's window (8 per bounce above
the 4 sensor dims), so a zero-density medium renders path.li's image bit
for bit; medium events read 4 dims per bounce above SENSOR_DIMS +
max_depth * 8; grid tracking reads 3 * TRACK_STEPS per bounce above both.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.rng import SampleStream
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..models import medium as medlib
from ..models import phase as phaselib
from ..ops import trace
from ..ops.gather import gather_rows
from . import path
# the surface lanes share path.py's sample window and ray offset
from .path import DIMS_PER_BOUNCE, RAY_EPS, SENSOR_DIMS
from .common import RenderConfig, power_heuristic

MEDIUM_DIMS = 4


def li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> torch.Tensor:
    med = scene.medium
    if med is None:
        return path.li(scene, cam, o, d, stream, cfg)

    n = o.shape[0]
    dev = o.device
    families = scene.bsdf_families
    is_grid = med.kind in (medlib.MEDIUM_GRID, medlib.MEDIUM_HGRID)
    track = medlib.TRACK_STEPS
    medium_base = SENSOR_DIMS + cfg.max_depth * DIMS_PER_BOUNCE
    track_base = medium_base + cfg.max_depth * MEDIUM_DIMS

    def bounce_u(bounce, k):
        return stream.at_dim(SENSOR_DIMS + bounce * DIMS_PER_BOUNCE + k)

    def medium_u(bounce, j):
        return stream.at_dim(medium_base + bounce * MEDIUM_DIMS + j)

    def track_u(bounce, j):
        """2 * TRACK dims for delta tracking, then TRACK for NEE's ratio
        tracking."""
        return stream.at_dim(track_base + bounce * 3 * track + j)

    def nee(p, beta, wi_world, ns, sp, t, active_mask, on_medium: bool):
        """NEE from medium lanes (on_medium: the phase function) or surface
        lanes (the BSDF in the frame of ns); the shadow ray leaves the raw
        point p."""
        u_nee = torch.stack([bounce_u(t, 0), bounce_u(t, 1), bounce_u(t, 2)], -1)
        ds = emitterlib.sample_direct(scene, p, u_nee)
        if on_medium:
            # the phase function's wi points toward the previous vertex,
            # as wi_world does
            ph_v, pdf_fwd = phaselib.eval_pdf(med.phase, med.g, wi_world, ds.d,
                                              med.phase_params, medlib.phase_axis(med, p))
            f = ph_v[:, None].expand(n, 3)
        else:
            f, pdf_fwd = bsdflib.eval_pdf(sp, m.to_local(ns, wi_world), m.to_local(ns, ds.d),
                                          families)
        # beta > 0: a zero-throughput lane (a near-vacuum medium event far
        # out) can carry an infinite pdf, and 0 * inf would poison the sample
        ok = (active_mask & (ds.pdf > 0.0) & (torch.amax(f, -1) > 0.0)
              & (torch.amax(beta, -1) > 0.0))
        blocked = trace.any_hit(scene, p, ds.d, ds.dist)
        if is_grid:
            tr = medlib.transmittance_track(
                med, lambda j: track_u(t, 2 * track + j), p, ds.d,
                torch.clamp_max(ds.dist, 1e7))
        else:
            tr = medlib.transmittance(med, ds.dist)
        w = torch.where(ds.is_delta, 1.0, power_heuristic(ds.pdf, pdf_fwd))
        contrib = beta * f * tr * ds.radiance * m.safe_div(w, ds.pdf)[:, None]
        return torch.where((ok & ~blocked)[:, None], contrib, 0.0)

    def body(t, state):
        o, d, L, beta, active, prev_pdf, prev_delta = state

        its = trace.closest_hit(scene, o, d)
        t_surf = torch.where(its.valid, its.t, 1e30)
        if is_grid:
            t_m, is_med, w_med, w_surf = medlib.sample_distance_grid(
                med, lambda j: track_u(t, j), o, d, t_surf)
        else:
            t_m, is_med, w_med, w_surf = medlib.sample_distance(
                med, medium_u(t, 0), medium_u(t, 1), t_surf)
        # keep p_m in float32 range in the near-vacuum limit (such events
        # carry w_med ~ 0)
        t_m = torch.clamp_max(t_m, 3e7)
        medium_lane = active & is_med
        surface_lane = active & ~is_med & its.valid
        escaped = active & ~is_med & ~its.valid

        # --- escaped: the environment through the transmittance ----------
        if scene.has_env:
            env_le = emitterlib.env_radiance(scene, d)
            w_env = torch.where(prev_delta, 1.0,
                                power_heuristic(prev_pdf, emitterlib.pdf_direct_env(scene, d)))
            L = L + torch.where(escaped[:, None], beta * w_surf * env_le * w_env[:, None], 0.0)

        # --- surface emission through the transmittance -------------------
        si = trace.surface_interaction(scene, o, d, its)
        ns, ng, p_s = si["ns"], si["ng"], si["p"]
        em_id = si["emitter"]
        cos_l = m.dot(si["wi_world"], ng)
        le = gather_rows(scene.emitters.radiance, torch.clamp_min(em_id, 0))
        le = torch.where(((em_id >= 0) & (cos_l > 0.0))[:, None], le, 0.0)
        pdf_em = emitterlib.pdf_direct_area(scene, o, d, its.t, its.prim, cos_l)
        w_hit = torch.where(prev_delta, 1.0, power_heuristic(prev_pdf, pdf_em))
        L = L + torch.where(surface_lane[:, None], beta * w_surf * le * w_hit[:, None], 0.0)

        can_continue = t < (cfg.max_depth - 1)

        # === medium event ==================================================
        p_m = o + d * t_m[:, None]
        beta_m = beta * w_med
        L = L + nee(p_m, beta_m, -d, None, None, t, medium_lane & can_continue, True)
        ph_ax = medlib.phase_axis(med, p_m)
        wo_m, pdf_ph = phaselib.sample(med.phase, med.g, -d,
                                       torch.stack([medium_u(t, 2), medium_u(t, 3)], -1),
                                       med.phase_params, ph_ax)
        w_ph = phaselib.sample_weight(med.phase, med.g, -d, wo_m, pdf_ph,
                                      med.phase_params, ph_ax)
        beta_m_cont = beta_m * w_ph[:, None]

        # === surface event =================================================
        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"], aux=si)
        wi_local = m.to_local(ns, si["wi_world"])
        beta_s = beta * w_surf
        L = L + nee(p_s, beta_s, si["wi_world"], ns, sp, t, surface_lane & can_continue, False)
        wo_s, weight_s, pdf_b, is_delta = bsdflib.sample(
            sp, wi_local, bounce_u(t, 3), torch.stack([bounce_u(t, 4), bounce_u(t, 5)], -1),
            families)
        d_s = m.to_world(ns, wo_s)

        # === merged continuation ===========================================
        new_o = torch.where(
            medium_lane[:, None], p_m,
            p_s + ng * torch.where(m.dot(d_s, ng) > 0, RAY_EPS, -RAY_EPS)[:, None])
        new_d = torch.where(medium_lane[:, None], wo_m, d_s)
        new_beta = torch.where(medium_lane[:, None], beta_m_cont, beta_s * weight_s)
        new_pdf = torch.where(medium_lane, pdf_ph, pdf_b)
        new_delta = torch.where(medium_lane, False, is_delta)
        alive = ((medium_lane | surface_lane) & can_continue & (new_pdf > 0.0)
                 & (torch.amax(new_beta, -1) > 0.0))

        # Russian roulette: the survival probability is a sampling decision,
        # its gradient stopped
        if t >= cfg.rr_depth - 1:
            q = torch.clamp(torch.amax(new_beta, -1), 0.05, 0.95).detach()
            alive = alive & (bounce_u(t, 6) < q)
            new_beta = new_beta / q[:, None]

        return (torch.where(alive[:, None], new_o, o),
                torch.where(alive[:, None], new_d, d),
                L,
                torch.where(alive[:, None], new_beta, 0.0),
                alive,
                torch.where(alive, new_pdf, prev_pdf),
                torch.where(alive, new_delta, prev_delta))

    def f32(fill, *shape):
        return torch.full(shape, fill, dtype=torch.float32, device=dev)

    state = (o, d, f32(0.0, n, 3), f32(1.0, n, 3),
             torch.ones((n,), dtype=torch.bool, device=dev), f32(1.0, n),
             torch.ones((n,), dtype=torch.bool, device=dev))
    for t in range(cfg.max_depth):
        state = body(t, state)
    return state[2]
