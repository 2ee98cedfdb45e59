"""Hero-wavelength spectral path tracer (port of integrators/spectral.py).

The runtime analog of the reference's compile-time SPECTRUM_SAMPLES=N
build (include/mitsuba/core/spectrum.h): each camera sample draws N_LAMBDA
hero-rotated wavelengths (core/spectrum.py), the path carries a spectral
throughput row, every RGB quantity is lifted by the calibrated upsampler
where it is used, and contributions resolve to RGB through the camera
response. With cfg.cauchy_b > 0 a dielectric refracts with the hero
wavelength's Cauchy IOR; the first dispersive refraction collapses the path
to the hero wavelength (throughput x N_LAMBDA on the surviving lane, the
hero-wavelength pdf adjustment).

path.py's loop (path.cpp:119-280) with its sampler dims, plus one trailing
dim for the hero wavelength.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core import spectrum as spec
from ..core.rng import SampleStream
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..ops import trace
from ..scene import envmap as envlib
from ..scene import ir as _ir
from .common import RenderConfig, mis_weight
from .path import DIMS_PER_BOUNCE, RAY_EPS, SENSOR_DIMS


def li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> torch.Tensor:
    n = o.shape[0]
    dev = o.device
    K = spec.N_LAMBDA
    families = scene.bsdf_families
    spectral_env = scene.envmap is not None and scene.envmap.spectral is not None

    def bounce_u(bounce, k):
        return stream.at_dim(SENSOR_DIMS + bounce * DIMS_PER_BOUNCE + k)

    lam = spec.sample_lambdas(stream.at_dim(SENSOR_DIMS + cfg.max_depth * DIMS_PER_BOUNCE))
    # the path's fixed response row: spectral contributions -> rgb
    resp = spec.rgb_response(lam) / (spec.LAMBDA_PDF * K)            # (n, K, 3)

    def add(L, contrib_spec, mask):
        c = torch.sum(resp * contrib_spec[..., None], dim=-2)
        return L + torch.where(mask[:, None], c, 0.0)

    L = torch.zeros((n, 3), device=dev)
    beta = torch.ones((n, K), device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.ones((n,), device=dev)
    prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)
    eta_scale = torch.ones((n,), device=dev)
    collapsed = torch.zeros((n,), dtype=torch.bool, device=dev)
    for t in range(cfg.max_depth):
        its = trace.closest_hit(scene, o, d)
        si = trace.surface_interaction(scene, o, d, its)
        ns, ng, p = si["ns"], si["ng"], si["p"]
        wi_local = m.to_local(ns, si["wi_world"])

        # --- escaped rays: environment emission ----------------------------
        if scene.has_env:
            if spectral_env:
                # the true spectral sky (a band stack baked at load)
                env_le = envlib.eval_radiance_spectral(scene.envmap, d, lam)
            else:
                env_le = spec.upsample(emitterlib.env_radiance(scene, d), lam)
            w_env = torch.where(prev_delta, 1.0,
                                mis_weight(cfg.mis_mode, prev_pdf,
                                           emitterlib.pdf_direct_env(scene, d)))
            if cfg.hide_emitters and t == 0:
                w_env = torch.zeros_like(w_env)
            L = add(L, beta * env_le * w_env[:, None], active & ~its.valid)
        active = active & its.valid

        # --- emitted radiance at the hit -------------------------------------
        em_id = si["emitter"]
        cos_l = m.dot(si["wi_world"], ng)
        le = spec.upsample(scene.emitters.radiance[torch.clamp_min(em_id, 0)], lam)
        le = torch.where(((em_id >= 0) & (cos_l > 0.0))[:, None], le, 0.0)
        pdf_em = emitterlib.pdf_direct_area(scene, o, d, its.t, its.prim, cos_l)
        w_bsdf = torch.where(prev_delta, 1.0, mis_weight(cfg.mis_mode, prev_pdf, pdf_em))
        if cfg.hide_emitters and t == 0:
            w_bsdf = torch.zeros_like(w_bsdf)
        L = add(L, beta * le * w_bsdf[:, None], active)

        can_continue = t < (cfg.max_depth - 1)
        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"], u_blend=bounce_u(t, 7),
                                        aux=si)

        # --- next event estimation -------------------------------------------
        u_nee = torch.stack([bounce_u(t, 0), bounce_u(t, 1), bounce_u(t, 2)], -1)
        ds = emitterlib.sample_direct(scene, p, u_nee)
        wo_local = m.to_local(ns, ds.d)
        f_rgb, pdf_bsdf_nee = bsdflib.eval_pdf(sp, wi_local, wo_local, families)
        f_nee = spec.upsample_reflectance(f_rgb, lam)
        nee_possible = active & can_continue & (ds.pdf > 0.0) & (torch.amax(f_rgb, -1) > 0.0)
        blocked = trace.shadow_blocked(scene, p, ds.d, ds.dist, cfg.occupancy_shadows)
        w_nee = torch.where(ds.is_delta, 1.0, mis_weight(cfg.mis_mode, ds.pdf, pdf_bsdf_nee))
        rad = spec.upsample(ds.radiance, lam)
        if spectral_env:
            # env NEE samples carry the true sky spectrum too
            rad = torch.where(ds.is_env[:, None],
                              envlib.eval_radiance_spectral(scene.envmap, ds.d, lam), rad)
        contrib = beta * f_nee * rad * m.safe_div(w_nee, ds.pdf)[:, None]
        L = add(L, contrib, nee_possible & ~blocked)

        # --- BSDF sampling (dispersive dielectrics take the hero IOR) ---------
        is_diel = sp.type == _ir.BSDF_DIELECTRIC
        if cfg.cauchy_b > 0.0:
            eta_hero = spec.cauchy_eta(sp.eta[..., 0],
                                       torch.full((), cfg.cauchy_b, dtype=torch.float32,
                                                  device=dev), lam[:, 0])
            eta = sp.eta.clone()
            eta[..., 0] = torch.where(is_diel, eta_hero, sp.eta[..., 0])
            sp = sp._replace(eta=eta)
        u2 = torch.stack([bounce_u(t, 4), bounce_u(t, 5)], -1)
        wo, weight_rgb, pdf, is_delta = bsdflib.sample(sp, wi_local, bounce_u(t, 3), u2,
                                                       families)
        d_new = m.to_world(ns, wo)
        transmitted = m.cos_theta(wi_local) * m.cos_theta(wo) < 0
        eta_r = torch.where(is_diel & transmitted,
                            torch.where(m.cos_theta(wi_local) > 0, sp.eta[..., 0],
                                        1.0 / sp.eta[..., 0]),
                            1.0)
        eta_scale = eta_scale * eta_r
        beta_new = beta * spec.upsample_reflectance(weight_rgb, lam)
        if cfg.cauchy_b > 0.0:
            # the hero-wavelength collapse on the first dispersive refraction
            disperse = is_diel & transmitted & ~collapsed
            hero_only = torch.zeros((n, K), device=dev)
            hero_only[:, 0] = float(K)
            beta_new = torch.where(disperse[:, None], beta_new * hero_only, beta_new)
            collapsed = collapsed | disperse
        alive = active & can_continue & (pdf > 0.0) & (torch.amax(beta_new, -1) > 0.0)
        o_new = p + ng * torch.where(m.dot(d_new, ng) > 0, RAY_EPS, -RAY_EPS)[:, None]

        # --- Russian roulette: q is a sampling decision, its gradient stopped
        q = torch.clamp_max(torch.amax(beta_new, -1) * eta_scale * eta_scale, 0.95)
        q = torch.clamp_min(q, 0.05).detach()
        if t >= cfg.rr_depth - 1:
            alive = alive & (bounce_u(t, 6) < q)
            beta_new = beta_new / q[:, None]

        beta = torch.where(alive[:, None], beta_new, 0.0)
        o = torch.where(alive[:, None], o_new, o)
        d = torch.where(alive[:, None], d_new, d)
        prev_pdf = torch.where(alive, pdf, prev_pdf)
        prev_delta = torch.where(alive, is_delta, prev_delta)
        active = alive
    return L
