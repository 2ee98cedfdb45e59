"""Discontinuity-aware vertex-position gradients by warped-area
reparameterization of ray directions (port of integrators/reparam.py).

The interior term of d(image)/d(vertices) flows through the renderer
already; the boundary term, where visibility jumps across silhouettes that
move with the vertices, does not. Following Loubet et al. 2019
("Reparameterizing discontinuous integrands") with Bangaru et al. 2020's
divergence handling, each ray direction omega gets a velocity field from K
auxiliary rays in a vMF cone around it,

    Vbar(omega, theta) = sum_k w_k u_k(theta) / sum_k w_k,
    u_k = normalize(x_k(theta) - o)   (x_k: the aux hit, attached),

and the ray is evaluated at T(omega) = normalize(omega + Vbar - sg(Vbar)),
which equals omega in the primal but moves with the discontinuity under
d/dtheta. The change of variables' factor 1 + div Vbar brings its own
derivative (the divergence term).

The JAX package computes div Vbar with two forward-mode JVPs of the field
(reparam.py:253-254). The field is closed form in the direction and the
trace stays outside it, so the port writes that JVP out: with
w_k = exp(kappa (dd . w_k - base_k)) g_k and dw_k = kappa (s . w_k) w_k,

    J(dd) s = sum_k dw_k u_k / sum_k w_k - Vbar(dd) sum_k dw_k / sum_k w_k

(the JAX package's max(sum w, 1e-20) never binds: at the primal every
weight is g_k > 0). Autograd then differentiates that expression in theta,
which is the mixed partial the JAX package takes.

Accuracy (JAX reparam.py:36-46, measured there): consistent in shape but
biased at practical sample counts (55-70% of the true occlusion gradient
on the quad-blocker scene); integrators/boundary.py is the exact estimator.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import math as m
from ..core.rng import SampleStream
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..ops import trace
from ..ops.gather import gather_rows
from ..scene import ir as _ir
from .common import RenderConfig, mis_weight
from .path import DIMS_PER_BOUNCE, RAY_EPS, SENSOR_DIMS


class ReparamConfig(NamedTuple):
    """The JAX package's ReparamConfig (reparam.py:70-80), same defaults."""

    n_aux: int = 8          # auxiliary rays per reparameterized ray
    kappa: float = 3.0e3    # vMF concentration of the aux cone
    edge_eps: float = 0.03  # harmonic-weight softening, in cone-width units
    edge_cap: float = 1.0   # boundary-distance cap (radians)
    edge_pow: float = 1.0   # harmonic-weight exponent 1/B^p
    stratified: bool = True  # Fibonacci-stratified aux cone
    warp_primary: bool = True
    warp_nee: bool = True
    warp_bsdf: bool = True
    aux_dim_base: int = 1024  # sampler dims reserved for aux directions


def _diff_hit_point(scene, o, d, its):
    """Surface-attached world position of a (detached) search result
    (JAX reparam.py:83-118): the hit is frozen in the winning triangle's
    barycentric frame, x(theta) = sum_i b_i v_i(theta), so vertex motion
    carries it with the surface. The barycentrics come from the detached
    vertices but the live ray, keeping their omega-dependence (the
    divergence term is the mixed partial). Misses return a far point
    attached to the ray. Returns (x, t)."""
    vi = scene.indices[its.prim]
    v0 = gather_rows(scene.vertices, vi[:, 0])
    v1 = gather_rows(scene.vertices, vi[:, 1])
    v2 = gather_rows(scene.vertices, vi[:, 2])
    v0s = v0.detach()
    e1s = v1.detach() - v0s
    e2s = v2.detach() - v0s
    pv = m.cross(d, e2s)
    det = m.dot(e1s, pv)
    bad = torch.abs(det) < 1e-12
    inv_det = torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, det))
    tv = o - v0s
    qv = m.cross(tv, e1s)
    b1 = m.dot(tv, pv) * inv_det
    b2 = m.dot(d, qv) * inv_det
    t_mt = m.dot(e2s, qv) * inv_det
    # jnp.clip's max/min pair (its gradient splits at ties as torch's does)
    zero = torch.zeros_like(b1)
    b1 = torch.minimum(torch.maximum(b1, zero), zero + 1.0)
    b2 = torch.minimum(torch.maximum(b2, zero), 1.0 - b1)
    x_surf = ((1.0 - b1 - b2)[:, None] * v0 + b1[:, None] * v1
              + b2[:, None] * v2)
    ok = its.valid & ~bad
    t = torch.where(ok, t_mt, 1.0e4)
    x_ray = o + t[:, None] * d
    return torch.where(ok[:, None], x_surf, x_ray), torch.where(its.valid, t, 1.0e4)


def _boundary_test(scene, wf, its, x, t_hit, cap):
    """Angular distance of each aux hit to the nearest silhouette edge of
    its own triangle (JAX reparam.py:121-153): an edge is a silhouette for
    the ray where it is open or its neighbour's facing differs. Misses and
    edge-free hits give `cap`. Detached: it only shapes the weights."""
    sc = scene.detach()
    wf, x = wf.detach(), x.detach()
    prim = its.prim
    vi = sc.indices[prim]
    v = [sc.vertices[vi[:, j]] for j in range(3)]
    front = m.dot(m.cross(v[1] - v[0], v[2] - v[0]), wf) < 0.0
    adj = sc.face_adj[prim]
    t_safe = torch.clamp_min(t_hit.detach(), 1e-6)
    best = torch.full(prim.shape, cap, dtype=torch.float32, device=x.device)
    for j in range(3):
        nb = adj[:, j]
        vin = sc.indices[torch.clamp_min(nb, 0)]
        w0 = sc.vertices[vin[:, 0]]
        ngn = m.cross(sc.vertices[vin[:, 1]] - w0, sc.vertices[vin[:, 2]] - w0)
        sil = (nb < 0) | ((m.dot(ngn, wf) < 0.0) != front)
        a = v[j]
        e = v[(j + 1) % 3] - a
        tt = torch.clamp(m.dot(x - a, e) / torch.clamp_min(m.dot(e, e), 1e-20), 0.0, 1.0)
        foot = x - (a + tt[:, None] * e)
        dj = torch.where(sil, torch.sqrt(m.dot(foot, foot)) / t_safe, cap)
        best = torch.minimum(best, dj)
    return torch.where(its.valid, torch.clamp_max(best, cap), cap)


def _cos_theta_vmf(u1, kappa):
    # Jakob's vMF inversion; exp(-2 kappa) in float32, as the JAX package
    # evaluates it
    e = torch.exp(torch.full((), -2.0 * kappa, dtype=torch.float32, device=u1.device))
    return 1.0 + torch.log1p((e - 1.0) * u1) / kappa


def _cone(cos_t, phi):
    sin_t = m.safe_sqrt(1.0 - cos_t * cos_t)
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)


def _vmf_offsets(u2, kappa):
    """Local-frame vMF directions around +z: (..., K, 3) from (..., K, 2)
    uniforms (JAX reparam.py:156-165)."""
    return _cone(_cos_theta_vmf(u2[..., 0], kappa), 2.0 * math.pi * u2[..., 1])


def _vmf_offsets_stratified(u2, kappa, k):
    """Stratified vMF cone (JAX reparam.py:168-182): Fibonacci-spiral strata
    in (radius, angle) with one random rotation and radial jitter per ray,
    from the first sample's two uniforms."""
    golden = 0.6180339887498949
    idx = torch.arange(k, dtype=torch.float32, device=u2.device)
    u1 = (idx + u2[..., 0:1, 0]) / k
    phi = 2.0 * math.pi * ((idx * golden + u2[..., 0:1, 1]) % 1.0)
    return _cone(_cos_theta_vmf(u1, kappa), phi)


def field_jvps(d, w_dirs, base_lk, g, u, kappa, tangents):
    """The velocity field at directions d (N,3) and its JVPs along each
    tangent (N,3), in closed form (JAX reparam.py:245-254 takes them with
    jax.jvp). w_dirs, u: (N,K,3) aux directions and their attached unit
    vectors; base_lk, g: (N,K) the exponent's base and the harmonic
    weights. Returns (vbar (N,3), [J(d) tangent (N,3), ...])."""
    wgt = torch.exp(kappa * (m.dot(d[:, None], w_dirs) - base_lk)) * g
    total = torch.clamp_min(torch.sum(wgt, 1), 1e-20)
    vbar = torch.sum(wgt[..., None] * u, 1) / total[:, None]

    def jvp(tangent):
        dw = kappa * m.dot(tangent[:, None], w_dirs) * wgt
        return (torch.sum(dw[..., None] * u, 1) / total[:, None]
                - vbar * (torch.sum(dw, 1) / total)[:, None])

    return vbar, [jvp(tan) for tan in tangents]


def reparam_ray(scene, o, d, u_aux, rp: ReparamConfig, active=None):
    """Warped direction and divergence weight of a batch of rays (JAX
    reparam.py:185-263). Returns (d_warp (N,3), w_div (N,)), whose primal
    values are (d, 1); their theta-derivatives carry the silhouettes'
    motion. u_aux: (N, K, 2) uniforms; lanes where `active` is False keep
    (d, 1).

    The K aux directions are drawn once around the primal direction and
    held fixed; the field at a direction omega reweights them with the vMF
    kernel divided by their sampling pdf, so its transition across a
    silhouette lives in smooth weights that the JVP sees, and the one aux
    trace happens outside it."""
    n = o.shape[0]
    k = rp.n_aux
    d0 = d.detach()
    s0, t0 = m.coordinate_system(d0)
    if rp.stratified:
        offs = _vmf_offsets_stratified(u_aux, rp.kappa, k)      # (N,K,3)
    else:
        offs = _vmf_offsets(u_aux, rp.kappa)
    w_dirs = (offs[..., 0:1] * s0[:, None] + offs[..., 1:2] * t0[:, None]
              + offs[..., 2:3] * d0[:, None])                   # (N,K,3)

    # one aux trace; u_k surface-attached (theta-live)
    of = o[:, None].expand(n, k, 3).reshape(n * k, 3)
    wf = w_dirs.reshape(n * k, 3)
    its = trace.closest_hit(scene, of, wf)
    x, t_hit = _diff_hit_point(scene, of, wf, its)
    u = m.normalize(x - of).reshape(n, k, 3)
    # harmonic silhouette weights: samples near their own surface's
    # silhouette dominate, so near a boundary the field follows the edge
    B = _boundary_test(scene, wf, its, x, t_hit, rp.edge_cap)
    sigma = 1.0 / math.sqrt(rp.kappa)
    g = ((1.0 / (B + rp.edge_eps * sigma)) ** rp.edge_pow).reshape(n, k)

    # the kernel divided by the samples' own vMF pdf: a difference in the
    # exponent (the field is then independent of the cloud's centre)
    base_lk = m.dot(d0[:, None], w_dirs)                       # (N,K)
    # divergence of the tangential field (the final normalize kills the
    # radial component)
    vbar, (jv_s, jv_t) = field_jvps(d, w_dirs, base_lk, g, u, rp.kappa, (s0, t0))
    div = m.dot(jv_s, s0) + m.dot(jv_t, t0)

    d_warp = m.normalize(d + (vbar - vbar.detach()))
    w_div = 1.0 + div - div.detach()
    if active is not None:
        d_warp = torch.where(active[:, None], d_warp, d)
        w_div = torch.where(active, w_div, 1.0)
    return d_warp, w_div


def li_reparam(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig,
               rp: ReparamConfig = ReparamConfig()) -> torch.Tensor:
    """MIS path tracer with reparameterized rays (JAX reparam.py:266-400):
    path.li's estimator and sample layout, with the camera, NEE and BSDF
    directions warped so that the gradient with respect to scene.vertices
    includes the visibility boundary terms."""
    n = o.shape[0]
    dev = o.device
    families = scene.bsdf_families

    def bounce_u(bounce, k):
        return stream.at_dim(SENSOR_DIMS + bounce * DIMS_PER_BOUNCE + k)

    def aux_u(tag, bounce):
        # dedicated high dims, so aux rays never alias path samples
        base = rp.aux_dim_base + (bounce * 3 + tag) * (2 * rp.n_aux)
        us = [stream.at_dim(base + i) for i in range(2 * rp.n_aux)]
        return torch.stack(us, -1).reshape(n, rp.n_aux, 2)

    def f32(fill, *shape):
        return torch.full(shape, fill, dtype=torch.float32, device=dev)

    L = f32(0.0, n, 3)
    beta_thr = f32(1.0, n, 3)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = f32(1.0, n)
    prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)
    eta_scale = f32(1.0, n)

    if rp.warp_primary:
        d, w_div = reparam_ray(scene, o, d, aux_u(0, 0), rp)
        beta_thr = beta_thr * w_div[:, None]

    for t in range(cfg.max_depth):
        its = trace.closest_hit(scene, o, d)
        si = trace.surface_interaction(scene, o, d, its)
        ns, ng, p = si["ns"], si["ng"], si["p"]
        wi_local = m.to_local(ns, si["wi_world"])

        env_le = emitterlib.env_radiance(scene, d)
        if scene.has_env:
            w_env = torch.where(prev_delta, 1.0,
                                mis_weight(cfg.mis_mode, prev_pdf,
                                           emitterlib.pdf_direct_env(scene, d)))
            if cfg.hide_emitters and t == 0:
                w_env = torch.zeros_like(w_env)
            L = L + torch.where((active & ~its.valid)[:, None],
                                beta_thr * env_le * w_env[:, None], 0.0)
        active = active & its.valid

        em_id = si["emitter"]
        le = gather_rows(scene.emitters.radiance, torch.clamp_min(em_id, 0))
        cos_l = m.dot(si["wi_world"], ng)
        le = torch.where(((em_id >= 0) & (cos_l > 0.0))[:, None], le, 0.0)
        pdf_em = emitterlib.pdf_direct_area(scene, o, d, its.t, its.prim, cos_l)
        w_bsdf = torch.where(prev_delta, 1.0, mis_weight(cfg.mis_mode, prev_pdf, pdf_em))
        if cfg.hide_emitters and t == 0:
            w_bsdf = torch.zeros_like(w_bsdf)
        L = L + torch.where(active[:, None], beta_thr * le * w_bsdf[:, None], 0.0)

        can_continue = t < (cfg.max_depth - 1)
        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"],
                                        u_blend=bounce_u(t, 7), aux=si)

        # --- NEE with a warped shadow direction ---------------------------
        u_nee = torch.stack([bounce_u(t, 0), bounce_u(t, 1), bounce_u(t, 2)], -1)
        ds = emitterlib.sample_direct(scene, p, u_nee)
        nee_cand = active & can_continue & (ds.pdf > 0.0)
        if rp.warp_nee:
            d_nee, w_div_nee = reparam_ray(scene, p, ds.d, aux_u(1, t), rp,
                                           active=nee_cand)
        else:
            d_nee, w_div_nee = ds.d, f32(1.0, n)
        wo_local = m.to_local(ns, d_nee)
        f_nee, pdf_bsdf_nee = bsdflib.eval_pdf(sp, wi_local, wo_local, families)
        nee_possible = nee_cand & (torch.amax(f_nee, dim=-1) > 0.0)
        if cfg.strict_normals:
            same_side = (m.dot(ds.d, ng) * m.cos_theta(wo_local)) > 0.0
            nee_possible = nee_possible & same_side
        blocked = trace.shadow_blocked(scene, p, ds.d, ds.dist, cfg.occupancy_shadows)
        w_nee = torch.where(ds.is_delta, 1.0,
                            mis_weight(cfg.mis_mode, ds.pdf, pdf_bsdf_nee))
        contrib = beta_thr * f_nee * ds.radiance \
            * (m.safe_div(w_nee, ds.pdf) * w_div_nee)[:, None]
        L = L + torch.where((nee_possible & ~blocked)[:, None], contrib, 0.0)

        # --- BSDF sampling with a warped continuation ----------------------
        u2 = torch.stack([bounce_u(t, 4), bounce_u(t, 5)], -1)
        wo, weight, pdf, is_delta = bsdflib.sample(sp, wi_local, bounce_u(t, 3), u2,
                                                   families)
        d_new = m.to_world(ns, wo)
        cont = active & can_continue & (pdf > 0.0)
        if rp.warp_bsdf and t + 1 < cfg.max_depth:
            # warp from the offset origin the continuation actually uses
            off_sign0 = torch.where(m.dot(d_new, ng) > 0, RAY_EPS, -RAY_EPS)
            d_new, w_div_b = reparam_ray(scene, p + ng * off_sign0[:, None], d_new,
                                         aux_u(2, t), rp, active=cont & ~is_delta)
        else:
            w_div_b = f32(1.0, n)
        eta_r = torch.where(
            (sp.type == _ir.BSDF_DIELECTRIC)
            & (m.cos_theta(wi_local) * m.cos_theta(wo) < 0),
            torch.where(m.cos_theta(wi_local) > 0, sp.eta[..., 0], 1.0 / sp.eta[..., 0]),
            1.0)
        eta_scale = eta_scale * eta_r
        beta_new = beta_thr * weight * w_div_b[:, None]
        alive = cont & (torch.amax(beta_new, dim=-1) > 0.0)
        off_sign = torch.where(m.dot(d_new, ng) > 0, RAY_EPS, -RAY_EPS)
        o_new = p + ng * off_sign[:, None]

        # Russian roulette; the survival probability's gradient is stopped
        q = torch.clamp_max(torch.amax(beta_new, dim=-1) * eta_scale * eta_scale, 0.95)
        q = torch.clamp_min(q, 0.05).detach()
        if t >= cfg.rr_depth - 1:
            alive = alive & (bounce_u(t, 6) < q)
            beta_new = beta_new / q[:, None]

        beta_thr = torch.where(alive[:, None], beta_new, 0.0)
        o = torch.where(alive[:, None], o_new, o)
        d = torch.where(alive[:, None], d_new, d)
        active = alive
        prev_pdf = torch.where(alive, pdf, prev_pdf)
        prev_delta = torch.where(alive, is_delta, prev_delta)
    return L
