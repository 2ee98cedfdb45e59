"""Wavefront MIS path tracer, fixed depth (port of integrators/path.py).

The canonical path loop (src/integrators/path/path.cpp:119-280):
intersect, add emitted radiance (MIS-weighted against NEE), next-event
estimation with MIS, BSDF sampling, Russian roulette. The whole ray batch
stays live for max_depth bounces with active-lane masks. It is the
unrolled twin of the regenerative wavefront renderer, and it counts the
useful rays of the rays/s benchmark.

Sampler dims: 4 are consumed by the sensor (common.py); each bounce
consumes a fixed window of 8 dims: NEE 0-2, the BSDF lobe 3, its direction
4-5, Russian roulette 6 and the blend adapter's choice 7.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.rng import SampleStream
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..models import sensor as sensorlib
from ..ops import trace
from ..scene import ir as _ir
from .common import RenderConfig, mis_weight

SENSOR_DIMS = 4
DIMS_PER_BOUNCE = 8
RAY_EPS = 1e-3


def li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> torch.Tensor:
    return _li(scene, cam, o, d, stream, cfg, with_stats=False)


def li_with_stats(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig):
    """Like li() but also returns the number of useful rays traced (active
    closest-hit lanes + NEE shadow rays), as an int64 tensor."""
    return _li(scene, cam, o, d, stream, cfg, with_stats=True)


def _li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig,
        with_stats: bool):
    n = o.shape[0]
    dev = o.device
    families = scene.bsdf_families

    def bounce_u(bounce, k):
        return stream.at_dim(SENSOR_DIMS + bounce * DIMS_PER_BOUNCE + k)

    def body(t, state):
        o, d, L, beta, active, prev_pdf, prev_delta, eta_scale, rays = state
        rays = rays + active.sum()

        its = trace.closest_hit(scene, o, d)
        if scene.tex_mips is not None and t == 0:
            # EWA's uv partials on the primary hit; later bounces keep the
            # isotropic trilinear footprint (the JAX package zeroes their
            # differentials, which selects the same lookup)
            ddx, ddy = sensorlib.ray_differentials(cam, d)
            si = trace.surface_interaction(scene, o, d, its, dd_dx=ddx, dd_dy=ddy)
        else:
            si = trace.surface_interaction(scene, o, d, its)
        ns, ng, p = si["ns"], si["ng"], si["p"]
        wi_local = m.to_local(ns, si["wi_world"])

        # --- escaped rays: environment emission ---------------------------
        env_le = emitterlib.env_radiance(scene, d)
        if scene.has_env:
            w_env = torch.where(
                prev_delta, 1.0,
                mis_weight(cfg.mis_mode, prev_pdf, emitterlib.pdf_direct_env(scene, d)))
            if cfg.hide_emitters and t == 0:
                w_env = torch.zeros_like(w_env)
            L = L + torch.where((active & ~its.valid)[:, None],
                                beta * env_le * w_env[:, None], 0.0)
        active = active & its.valid

        # --- emitted radiance at the hit ----------------------------------
        em_id = si["emitter"]
        hit_emitter = em_id >= 0
        le = scene.emitters.radiance[torch.clamp_min(em_id, 0)]
        cos_l = m.dot(si["wi_world"], ng)   # emitters are one-sided (front = +ng)
        le = torch.where((hit_emitter & (cos_l > 0.0))[:, None], le, 0.0)
        pdf_em = emitterlib.pdf_direct_area(scene, o, d, its.t, its.prim, cos_l)
        w_bsdf = torch.where(prev_delta, 1.0, mis_weight(cfg.mis_mode, prev_pdf, pdf_em))
        if cfg.hide_emitters and t == 0:
            w_bsdf = torch.zeros_like(w_bsdf)
        L = L + torch.where(active[:, None], beta * le * w_bsdf[:, None], 0.0)

        # vertex t+1 just handled; continuing needs t + 2 <= max_depth edges
        can_continue = t < (cfg.max_depth - 1)

        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"],
                                        u_blend=bounce_u(t, 7), aux=si)

        # --- next event estimation ----------------------------------------
        u_nee = torch.stack([bounce_u(t, 0), bounce_u(t, 1), bounce_u(t, 2)], -1)
        ds = emitterlib.sample_direct(scene, p, u_nee)
        wo_local = m.to_local(ns, ds.d)
        f_nee, pdf_bsdf_nee = bsdflib.eval_pdf(sp, wi_local, wo_local, families)
        nee_possible = active & can_continue & (ds.pdf > 0.0) & (
            torch.amax(f_nee, dim=-1) > 0.0)
        if cfg.strict_normals:
            same_side = (m.dot(ds.d, ng) * m.cos_theta(wo_local)) > 0.0
            nee_possible = nee_possible & same_side
        # shadow ray from the raw point with t in (eps, dist*(1-eps))
        blocked = trace.shadow_blocked(scene, p, ds.d, ds.dist, cfg.occupancy_shadows)
        rays = rays + nee_possible.sum()
        w_nee = torch.where(ds.is_delta, 1.0,
                            mis_weight(cfg.mis_mode, ds.pdf, pdf_bsdf_nee))
        contrib = beta * f_nee * ds.radiance * m.safe_div(w_nee, ds.pdf)[:, None]
        L = L + torch.where((nee_possible & ~blocked)[:, None], contrib, 0.0)

        # --- BSDF sampling --------------------------------------------------
        u_lobe = bounce_u(t, 3)
        u2 = torch.stack([bounce_u(t, 4), bounce_u(t, 5)], -1)
        wo, weight, pdf, is_delta = bsdflib.sample(sp, wi_local, u_lobe, u2, families)
        d_new = m.to_world(ns, wo)
        # relative IOR bookkeeping for RR
        eta_r = torch.where(
            (sp.type == _ir.BSDF_DIELECTRIC)
            & (m.cos_theta(wi_local) * m.cos_theta(wo) < 0),
            torch.where(m.cos_theta(wi_local) > 0, sp.eta[..., 0],
                        1.0 / sp.eta[..., 0]),
            1.0)
        eta_scale = eta_scale * eta_r
        beta_new = beta * weight
        alive = (active & can_continue & (pdf > 0.0)
                 & (torch.amax(beta_new, dim=-1) > 0.0))
        off_sign = torch.where(m.dot(d_new, ng) > 0, RAY_EPS, -RAY_EPS)
        o_new = p + ng * off_sign[:, None]

        # --- Russian roulette -----------------------------------------------
        # the survival probability is a sampling decision, not part of the
        # integrand: its gradient is stopped (path.py:154-155)
        q = torch.clamp_max(torch.amax(beta_new, dim=-1) * eta_scale * eta_scale, 0.95)
        q = torch.clamp_min(q, 0.05).detach()
        if t >= cfg.rr_depth - 1:
            survive = bounce_u(t, 6) < q
            beta_new = beta_new / q[:, None]
            alive = alive & survive

        beta_out = torch.where(alive[:, None], beta_new, 0.0)
        return (
            torch.where(alive[:, None], o_new, o),
            torch.where(alive[:, None], d_new, d),
            L,
            beta_out,
            alive,
            torch.where(alive, pdf, prev_pdf),
            torch.where(alive, is_delta, prev_delta),
            eta_scale,
            rays,
        )

    def f32(fill, *shape):
        return torch.full(shape, fill, dtype=torch.float32, device=dev)

    state = (
        o, d,
        f32(0.0, n, 3),
        f32(1.0, n, 3),
        torch.ones((n,), dtype=torch.bool, device=dev),
        f32(1.0, n),
        torch.ones((n,), dtype=torch.bool, device=dev),  # camera rays are "delta" for MIS
        f32(1.0, n),
        torch.zeros((), dtype=torch.int64, device=dev),
    )
    for t in range(cfg.max_depth):
        state = body(t, state)
    if with_stats:
        return state[2], state[8]
    return state[2]
