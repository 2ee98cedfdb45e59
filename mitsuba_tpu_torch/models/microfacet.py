"""Microfacet distributions, Beckmann and GGX, anisotropic, with Smith
shadowing and GGX visible-normal sampling (port of models/microfacet.py).

All functions are batched over local-frame directions; the distribution
code `dist` is a per-ray integer (0 Beckmann, 1 GGX) selected with masks.
GGX samples visible normals (Heitz 2018); Beckmann samples D cos. `pdf`
matches whichever sampler `sample` uses. The expressions and their order
are the JAX package's, clamps included: several exist only to keep the
reverse-mode adjoint finite on lanes a mask discards.
"""
from __future__ import annotations

import math

import torch

from ..core import math as m


def _split_alpha(alpha_u, alpha_v=None):
    au = torch.clamp_min(alpha_u, 1e-4)
    av = au if alpha_v is None else torch.clamp_min(alpha_v, 1e-4)
    return au, torch.where(av > 0, av, au)


def d_eval(dist, alpha_u, h, alpha_v=None):
    """Normal distribution function D(h)."""
    au, av = _split_alpha(alpha_u, alpha_v)
    ct = m.cos_theta(h)
    ct2 = ct * ct
    x2 = h[..., 0] * h[..., 0]
    y2 = h[..., 1] * h[..., 1]
    # grazing h: the clamp keeps the Beckmann tangent's adjoint finite
    ct2b = torch.clamp_min(ct2, 1e-8)
    beck = m.safe_div(
        torch.exp(-m.safe_div(x2 / (au * au) + y2 / (av * av), ct2b)),
        math.pi * au * av * ct2b * ct2b)
    root = x2 / (au * au) + y2 / (av * av) + ct2
    ggx = m.safe_div(1.0, math.pi * au * av * root * root)
    d = torch.where(dist == 1, ggx, beck)
    return torch.where(ct > 0.0, d, 0.0)


def _proj_alpha(au, av, v):
    """Projected roughness along v's azimuth."""
    inv_st2 = m.safe_div(1.0, torch.clamp_min(1.0 - m.cos_theta(v) ** 2, 1e-12))
    c2 = v[..., 0] * v[..., 0] * inv_st2
    s2 = v[..., 1] * v[..., 1] * inv_st2
    iso = torch.abs(1.0 - m.cos_theta(v) ** 2) < 1e-12
    a2 = torch.where(iso, au * au, c2 * au * au + s2 * av * av)
    return torch.sqrt(a2)


def smith_g1(dist, alpha_u, v, h, alpha_v=None):
    """Smith masking term G1(v, h)."""
    au, av = _split_alpha(alpha_u, alpha_v)
    alpha = _proj_alpha(au, av, v)
    cv = m.cos_theta(v)
    chi = (m.dot(v, h) * cv) > 0.0
    # grazing v: tan clamped so the roughness adjoint stays finite
    tan_t = torch.clamp_max(torch.abs(m.tan_theta(v)), 1e8)
    a = m.safe_div(1.0, alpha * tan_t)
    beck = torch.where(
        a < 1.6,
        (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a),
        1.0)
    at2 = (alpha * tan_t) ** 2
    ggx = 2.0 / (1.0 + torch.sqrt(1.0 + at2))
    g = torch.where(dist == 1, ggx, beck)
    g = torch.where(tan_t < 1e-9, 1.0, g)
    return torch.where(chi, g, 0.0)


def g_eval(dist, alpha_u, wi, wo, h, alpha_v=None):
    """Separable Smith G(wi, wo, h) = G1(wi) G1(wo)."""
    return smith_g1(dist, alpha_u, wi, h, alpha_v) * smith_g1(dist, alpha_u, wo, h, alpha_v)


def _ggx_vndf_sample(au, av, wi, u):
    """Heitz 2018 visible-normal sampling; wi must have z > 0."""
    vh = m.normalize(torch.stack([au * wi[..., 0], av * wi[..., 1], wi[..., 2]], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1_raw = torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)], -1) \
        / torch.sqrt(torch.clamp_min(lensq, 1e-12))[..., None]
    ex = m.const([1.0, 0.0, 0.0], vh.device)
    t1 = torch.where((lensq > 1e-12)[..., None], t1_raw, ex)
    t2 = m.cross(vh, t1)
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    return m.normalize(torch.stack(
        [au * nh[..., 0], av * nh[..., 1], torch.clamp_min(nh[..., 2], 1e-6)], -1))


def _beckmann_sample_aniso(au, av, u):
    """Anisotropic Beckmann D cos sampling."""
    phi_iso = 2.0 * math.pi * u[..., 1]
    phi = torch.atan2(av * torch.sin(phi_iso), au * torch.cos(phi_iso))
    cp, sp = torch.cos(phi), torch.sin(phi)
    a2 = m.safe_div(1.0, (cp / au) ** 2 + (sp / av) ** 2)
    t2 = -a2 * torch.log(torch.clamp_min(1.0 - u[..., 0], 1e-20))
    ct = 1.0 / torch.sqrt(1.0 + t2)
    st = m.safe_sqrt(1.0 - ct * ct)
    return torch.stack([st * cp, st * sp, ct], -1)


def sample(dist, alpha_u, wi, u, alpha_v=None):
    """Sample a microfacet normal: (h, pdf). GGX lanes sample the visible
    normals of wi (upper hemisphere: callers flip by sign(cos_i) first),
    Beckmann lanes D cos."""
    au, av = _split_alpha(alpha_u, alpha_v)
    hb = _beckmann_sample_aniso(au, av, u)
    hg = _ggx_vndf_sample(au, av, wi, u)
    h = torch.where((dist == 1)[..., None], hg, hb)
    return h, pdf(dist, alpha_u, wi, h, alpha_v)


def pdf(dist, alpha_u, wi, h, alpha_v=None):
    """pdf of `sample` in solid angle of h: G1(wi) D(h) |wi.h| / |cos_i|
    for GGX, D(h) cos(h) for Beckmann."""
    d = d_eval(dist, alpha_u, h, alpha_v)
    ci = torch.abs(m.cos_theta(wi))
    vndf = m.safe_div(smith_g1(dist, alpha_u, wi, h, alpha_v) * d
                      * torch.abs(m.dot(wi, h)), ci)
    dcos = d * torch.clamp_min(m.cos_theta(h), 0.0)
    return torch.where(dist == 1, vndf, dcos)
