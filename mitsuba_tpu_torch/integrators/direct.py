"""MIS direct illumination integrator (port of integrators/direct.py).

One visible-surface intersection, its emitted radiance, then both
direct-lighting strategies, emitter sampling and BSDF sampling, combined
with the power heuristic (the analog of src/integrators/direct/direct.cpp;
JAX direct.py:23-89, line for line).
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.rng import SampleStream
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..ops import trace
from .common import RenderConfig, power_heuristic

SENSOR_DIMS = 4
RAY_EPS = 1e-3


def li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> torch.Tensor:
    families = scene.bsdf_families

    def u(k):
        return stream.at_dim(SENSOR_DIMS + k)

    its = trace.closest_hit(scene, o, d)
    si = trace.surface_interaction(scene, o, d, its)
    ns, ng, p = si["ns"], si["ng"], si["p"]
    wi_local = m.to_local(ns, si["wi_world"])
    active = its.valid

    L = torch.where(active[:, None], 0.0, emitterlib.env_radiance(scene, d))

    # visible emitter (direct.cpp:166)
    em_id = si["emitter"]
    cos_l = m.dot(si["wi_world"], ng)
    le = scene.emitters.radiance[torch.clamp_min(em_id, 0)]
    vis = active & (em_id >= 0) & (cos_l > 0.0)
    if not cfg.hide_emitters:
        L = L + torch.where(vis[:, None], le, 0.0)

    sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"], u_blend=u(6), aux=si)

    # --- strategy 1: emitter sampling ---------------------------------
    ds = emitterlib.sample_direct(scene, p, torch.stack([u(0), u(1), u(2)], -1))
    wo_local = m.to_local(ns, ds.d)
    f, pdf_b = bsdflib.eval_pdf(sp, wi_local, wo_local, families)
    # raw-origin shadow ray, t in (eps, dist*(1-eps)), as in path.py
    blocked = trace.shadow_blocked(scene, p, ds.d, ds.dist, cfg.occupancy_shadows)
    ok = active & (ds.pdf > 0.0) & ~blocked
    w = torch.where(ds.is_delta, 1.0, power_heuristic(ds.pdf, pdf_b))
    L = L + torch.where(ok[:, None], f * ds.radiance * m.safe_div(w, ds.pdf)[:, None], 0.0)

    # --- strategy 2: BSDF sampling (direct.cpp:186+) --------------------
    wo, weight, pdf, is_delta = bsdflib.sample(
        sp, wi_local, u(3), torch.stack([u(4), u(5)], -1), families)
    d2 = m.to_world(ns, wo)
    o2 = p + ng * torch.where(m.dot(d2, ng) > 0, RAY_EPS, -RAY_EPS)[:, None]
    its2 = trace.closest_hit(scene, o2, d2)
    si2 = trace.surface_interaction(scene, o2, d2, its2)
    em2 = si2["emitter"]
    cos2 = m.dot(-d2, si2["ng"])
    hit_light = its2.valid & (em2 >= 0) & (cos2 > 0.0)
    le2 = scene.emitters.radiance[torch.clamp_min(em2, 0)]
    pdf_em = emitterlib.pdf_direct_area(scene, o2, d2, its2.t, its2.prim, cos2)
    w2 = torch.where(is_delta, 1.0, power_heuristic(pdf, pdf_em))
    contrib2 = weight * le2 * w2[:, None]
    L = L + torch.where((active & hit_light & (pdf > 0.0))[:, None], contrib2, 0.0)
    # environment hit through the BSDF sample
    if scene.has_env:
        w2e = torch.where(is_delta, 1.0,
                          power_heuristic(pdf, emitterlib.pdf_direct_env(scene, d2)))
        env_le = emitterlib.env_radiance(scene, d2)
        L = L + torch.where((active & ~its2.valid & (pdf > 0.0))[:, None],
                            weight * env_le * w2e[:, None], 0.0)
    return L
