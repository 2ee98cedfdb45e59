"""BSDF framework: masked dispatch over material families (port of
models/bsdf.py).

Every ray batch gathers its material record into a ShadePoint SoA and each
family present in the scene is evaluated for all rays, with lane masks
selecting the right result. Every family of the JAX package is ported.
The Hanrahan-Krueger slab (BSDF_HK) scatters with the HG phase function of
models/phase.py; Irawan's woven cloth (BSDF_IRAWAN) packs its yarn
parameters into the generic fields at gather time (models/cloth.py). The
blend adapter resolves to a child in `gather_shade_point`; the coating
adapter dispatches its nested record's families with bent directions.

Masked dispatch evaluates every family on every lane, so a NaN on a lane
that a `torch.where` discards still poisons the gradient: the JAX
expressions, their order and their guards (`_safe_half`, `m.safe_div`,
the clamps) are kept as they are.

Conventions: directions in the local shading frame (z = shading normal);
`wi` toward the viewer, `wo` toward the light; eval returns f * |cos wo|;
pdf in solid angle; delta lobes report eval = pdf = 0 and are reached only
through sample, which returns (wo, weight = f*cos/pdf, pdf, is_delta).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..core import math as m
from ..core import warp
from ..ops.gather import gather_rows
from ..scene import ir
from . import microfacet as mf
from . import phase as phaselib
from . import texture as tex

INV_PI = 1.0 / math.pi


class ShadePoint(NamedTuple):
    """Per-ray gathered material record (SoA)."""

    type: torch.Tensor          # (N,) int32
    reflectance: torch.Tensor   # (N,3) texture-resolved
    specular: torch.Tensor      # (N,3)
    eta: torch.Tensor           # (N,3)
    k: torch.Tensor             # (N,3)
    alpha: torch.Tensor         # (N,2)
    extra: torch.Tensor         # (N,4)
    # one-level nested child record (coating adapters); None unless the
    # scene holds BSDF_COATING rows
    nested: Optional["ShadePoint"] = None


def map_tensors(fn, sp: ShadePoint) -> ShadePoint:
    """`sp` with `fn` applied to every tensor field, the nested record's
    included (the JAX package's tree_map over a ShadePoint)."""
    return ShadePoint(*(fn(a) for a in sp[:-1]),
                      nested=None if sp.nested is None else map_tensors(fn, sp.nested))


def _check_families(families):
    for fam in families:
        if fam not in _EVAL and fam not in (ir.BSDF_BLEND, ir.BSDF_COATING):
            raise NotImplementedError(
                f"BSDF family {ir.BSDF_NAMES.get(fam, fam)!r} is not ported")


def _gather(scene, mat, uv, footprint=None, duvdx=None, duvdy=None):
    mats = scene.materials
    refl = tex.resolve(scene, mats.tex_reflectance[mat], uv, gather_rows(mats.reflectance, mat),
                       footprint=footprint, duvdx=duvdx, duvdy=duvdy)
    return ShadePoint(type=mats.type[mat], reflectance=refl,
                      specular=gather_rows(mats.specular, mat), eta=gather_rows(mats.eta, mat),
                      k=gather_rows(mats.k, mat), alpha=gather_rows(mats.alpha, mat),
                      extra=gather_rows(mats.extra, mat))


def gather_shade_point(scene, mat: torch.Tensor, uv: torch.Tensor,
                       u_blend=None, aux=None) -> ShadePoint:
    """Gather material rows for each ray and resolve reflectance textures.

    A BLEND row redirects to child A with probability extra[0] (else child
    B) using `u_blend`: the selection probability cancels against the
    mixture weight in expectation. A textured blend weight is the blend
    row's `tex_reflectance` texture, averaged over its channels. `aux` is
    surface_interaction's dict: its mip footprint and uv partials, where
    present, drive the trilinear and EWA lookups, and its "vcolor" and
    "wirecolor" replace the reflectance of TEX_VERTEXCOLOR and TEX_WIREFRAME
    rows. Woven-cloth lanes take their yarn segment's packed parameters
    from `scene.cloth` (models/cloth.py gather_yarn)."""
    _check_families(scene.bsdf_families)
    mats = scene.materials
    if ir.BSDF_BLEND in scene.bsdf_families:
        is_blend = mats.type[mat] == ir.BSDF_BLEND
        wgt = mats.extra[mat, 0]
        btex = torch.where(is_blend, mats.tex_reflectance[mat], -1)
        if scene.textures.shape[0] > 1 or scene.textures.shape[1] > 1:
            wtex = tex.resolve(scene, btex, uv, wgt[..., None].expand(*wgt.shape, 3))
            wgt = torch.mean(wtex, dim=-1)
        u = u_blend if u_blend is not None else torch.full_like(wgt, 0.5)
        child = torch.where(u < wgt, mats.nested[mat, 0], mats.nested[mat, 1])
        mat = torch.where(is_blend, torch.clamp_min(child, 0), mat)
    aux = aux or {}
    sp = _gather(scene, mat, uv, aux.get("footprint"), aux.get("duvdx"), aux.get("duvdy"))
    for has, key, tex_id in ((scene.has_vtx_colors, "vcolor", ir.TEX_VERTEXCOLOR),
                             (scene.has_wireframe, "wirecolor", ir.TEX_WIREFRAME)):
        if has and key in aux:
            on = (mats.tex_reflectance[mat] == tex_id)[..., None]
            sp = sp._replace(reflectance=torch.where(on, aux[key], sp.reflectance))
    if ir.BSDF_COATING in scene.bsdf_families:
        # one-level child gather for coating adapters (coating.cpp m_nested)
        sp = sp._replace(nested=_gather(scene, torch.clamp_min(mats.nested[mat, 0], 0), uv))
    if ir.BSDF_IRAWAN in scene.bsdf_families and scene.cloth is not None:
        from . import cloth as clothlib

        over = clothlib.gather_yarn(scene.cloth, mat, uv)
        is_cloth = (sp.type == ir.BSDF_IRAWAN)[:, None]
        sp = sp._replace(**{k: torch.where(is_cloth, over[k], getattr(sp, k))
                            for k in ("reflectance", "specular", "eta", "k", "alpha", "extra")})
    return sp


# ---------------------------------------------------------------------------
# Families: eval returns (f_cos (N,3), pdf (N,)); sample returns (wo,
# weight, pdf, is_delta). Invalid configurations give zeros.
# ---------------------------------------------------------------------------

def _both_sides_pos(wi, wo):
    return (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)


def _dist(sp):
    return sp.extra[..., 3].to(torch.int32)


def _diffuse_eval(sp, wi, wo):
    """Smooth diffuse (src/bsdfs/diffuse.cpp)."""
    ok = _both_sides_pos(wi, wo)
    f = sp.reflectance * (INV_PI * torch.clamp_min(m.cos_theta(wo), 0.0))[..., None]
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


def _diffuse_sample(sp, wi, u_lobe, u2):
    wo = warp.square_to_cosine_hemisphere(u2)
    ok = m.cos_theta(wi) > 0.0
    weight = torch.where(ok[..., None], sp.reflectance, 0.0)
    pdf = torch.where(ok, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)
    return wo, weight, pdf, torch.zeros_like(ok)


def _diffuse_transmitter_eval(sp, wi, wo):
    """src/bsdfs/difftrans.cpp: diffuse transmission to the other side."""
    ok = (m.cos_theta(wi) * m.cos_theta(wo)) < 0.0
    f = sp.reflectance * (INV_PI * m.abs_cos_theta(wo))[..., None]
    pdf = INV_PI * m.abs_cos_theta(wo)
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


def _diffuse_transmitter_sample(sp, wi, u_lobe, u2):
    wo = warp.square_to_cosine_hemisphere(u2)
    sign = torch.where(m.cos_theta(wi) > 0.0, -1.0, 1.0)
    wo = wo * torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign], -1)
    pdf = INV_PI * m.abs_cos_theta(wo)
    return wo, sp.reflectance, pdf, torch.zeros(wi.shape[:-1], dtype=torch.bool,
                                                device=wi.device)


def _safe_half(v):
    """Half-vector with a degenerate guard: wi + wo can be the zero vector
    on masked lanes, and normalize(0) would be a NaN primal whose adjoint
    poisons the roughness gradients. Degenerate lanes get +z."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    ok = n2 > 1e-18
    safe = v * torch.rsqrt(torch.where(ok, n2, 1.0))
    return torch.where(ok, safe, m.const([0.0, 0.0, 1.0], v.device))


def _conductor_sample(sp, wi, u_lobe, u2):
    """src/bsdfs/conductor.cpp: smooth mirror with conductor Fresnel."""
    wo = m.reflect_local(wi)
    ci = m.cos_theta(wi)
    f = m.fresnel_conductor(ci, sp.eta, sp.k) * sp.specular
    ok = ci > 0.0
    return wo, torch.where(ok[..., None], f, 0.0), torch.where(ok, 1.0, 0.0), torch.ones_like(ok)


def _rough_conductor_eval(sp, wi, wo):
    """src/bsdfs/roughconductor.cpp (anisotropic alphaU/alphaV)."""
    ok = _both_sides_pos(wi, wo)
    h = _safe_half(wi + wo)
    dist = _dist(sp)
    au, av = sp.alpha[..., 0], sp.alpha[..., 1]
    d = mf.d_eval(dist, au, h, av)
    g = mf.g_eval(dist, au, wi, wo, h, av)
    fr = m.fresnel_conductor(m.dot(wi, h), sp.eta, sp.k) * sp.specular
    ci = torch.clamp_min(m.cos_theta(wi), 1e-8)
    f_cos = fr * (d * g / (4.0 * ci))[..., None]
    pdf = m.safe_div(mf.pdf(dist, au, wi, h, av), 4.0 * torch.abs(m.dot(wo, h)))
    return torch.where(ok[..., None], f_cos, 0.0), torch.where(ok, pdf, 0.0)


def _rough_conductor_sample(sp, wi, u_lobe, u2):
    dist = _dist(sp)
    au, av = sp.alpha[..., 0], sp.alpha[..., 1]
    h, _ = mf.sample(dist, au, wi, u2, av)
    wo = 2.0 * m.dot(wi, h, keepdims=True) * h - wi
    f_cos, pdf = _rough_conductor_eval(sp, wi, wo)
    weight = m.safe_div(f_cos, pdf[..., None])
    ok = (pdf > 1e-12) & (m.cos_theta(wi) > 0.0)
    return (wo, torch.where(ok[..., None], weight, 0.0), torch.where(ok, pdf, 0.0),
            torch.zeros_like(ok))


def _dielectric_sample(sp, wi, u_lobe, u2):
    """src/bsdfs/dielectric.cpp: smooth dielectric, two delta lobes;
    transmission carries the 1/eta^2 radiance compression."""
    eta = sp.eta[..., 0]
    fr, cos_t, _, eta_ti = m.fresnel_dielectric(m.cos_theta(wi), eta)
    pick_reflect = u_lobe <= fr
    wo = torch.where(pick_reflect[..., None], m.reflect_local(wi),
                     m.refract_local(wi, eta, cos_t))
    weight = torch.where(pick_reflect[..., None], sp.specular,
                         sp.reflectance * (eta_ti * eta_ti)[..., None])
    pdf = torch.where(pick_reflect, fr, 1.0 - fr)
    return wo, weight, pdf, torch.ones_like(pick_reflect)


def _thin_dielectric_sample(sp, wi, u_lobe, u2):
    """src/bsdfs/thindielectric.cpp: thin slab, R' = 2R/(1+R), pass-through."""
    fr, _, _, _ = m.fresnel_dielectric(torch.abs(m.cos_theta(wi)), sp.eta[..., 0])
    fr = m.safe_div(2.0 * fr, 1.0 + fr)
    pick_reflect = u_lobe <= fr
    wo = torch.where(pick_reflect[..., None], m.reflect_local(wi), -wi)
    weight = torch.where(pick_reflect[..., None], sp.specular, sp.reflectance)
    pdf = torch.where(pick_reflect, fr, 1.0 - fr)
    return wo, weight, pdf, torch.ones_like(pick_reflect)


def _plastic_diffuse(sp, wi, wo, eta):
    """Internal diffuse lobe with the internal-scattering compensation
    (plastic.cpp:142-170), f * cos_o; also returns Fresnel at wi."""
    fi, _, _, _ = m.fresnel_dielectric(m.cos_theta(wi), eta)
    fo, _, _, _ = m.fresnel_dielectric(m.cos_theta(wo), eta)
    fdr = m.fresnel_diffuse_reflectance(1.0 / sp.eta[..., 0])
    refl = sp.reflectance
    denom = 1.0 - refl * fdr[..., None]
    inv_eta2 = (1.0 / eta) ** 2
    diff = refl / torch.clamp_min(denom, 1e-6) * (
        (1.0 - fi) * (1.0 - fo) * inv_eta2 * INV_PI
        * torch.clamp_min(m.cos_theta(wo), 0.0))[..., None]
    return diff, fi


def _plastic_spec_prob(sp, wi):
    """Specular selection probability (plastic.cpp specularSamplingWeight)."""
    fi, _, _, _ = m.fresnel_dielectric(m.cos_theta(wi), sp.eta[..., 0])
    return torch.clamp(fi, 0.05, 0.95)


def _plastic_eval(sp, wi, wo):
    """src/bsdfs/plastic.cpp: delta coat + internal diffuse; eval covers the
    diffuse part only."""
    ok = _both_sides_pos(wi, wo)
    f, _ = _plastic_diffuse(sp, wi, wo, sp.eta[..., 0])
    pdf = (1.0 - _plastic_spec_prob(sp, wi)) * warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


def _plastic_sample(sp, wi, u_lobe, u2):
    spec_p = _plastic_spec_prob(sp, wi)
    pick_spec = u_lobe <= spec_p
    fi, _, _, _ = m.fresnel_dielectric(m.cos_theta(wi), sp.eta[..., 0])
    w_s = sp.specular * m.safe_div(fi, spec_p)[..., None]
    wo_d = warp.square_to_cosine_hemisphere(u2)
    f_d, pdf_d = _plastic_eval(sp, wi, wo_d)
    w_d = m.safe_div(f_d, pdf_d[..., None])
    wo = torch.where(pick_spec[..., None], m.reflect_local(wi), wo_d)
    weight = torch.where(pick_spec[..., None], w_s, w_d)
    pdf = torch.where(pick_spec, spec_p, pdf_d)
    ok = m.cos_theta(wi) > 0.0
    return wo, torch.where(ok[..., None], weight, 0.0), torch.where(ok, pdf, 0.0), pick_spec


def _spec_weight(sp):
    """Specular lobe's share by the mean tints (phong.cpp, ward.cpp)."""
    kd = torch.mean(sp.reflectance, -1)
    ks = torch.mean(sp.specular, -1)
    return m.safe_div(ks, kd + ks)


def _phong_lobe_pdf(axis, wo, exponent):
    cos_a = torch.clamp_min(m.dot(axis, wo), 0.0)
    return (exponent + 1.0) * (0.5 * INV_PI) * torch.pow(cos_a, exponent)


def _phong_eval(sp, wi, wo):
    """src/bsdfs/phong.cpp: modified Phong (diffuse + cos^n lobe)."""
    ok = _both_sides_pos(wi, wo)
    exponent = sp.extra[..., 0]
    refl_r = m.reflect_local(wi)
    cos_a = torch.clamp_min(m.dot(refl_r, wo), 0.0)
    spec = sp.specular * ((exponent + 2.0) * INV_PI * 0.5
                          * torch.pow(cos_a, exponent))[..., None]
    diff = sp.reflectance * INV_PI
    f_cos = (diff + spec) * torch.clamp_min(m.cos_theta(wo), 0.0)[..., None]
    w_spec = _spec_weight(sp)
    pdf = (w_spec * _phong_lobe_pdf(refl_r, wo, exponent)
           + (1.0 - w_spec) * warp.square_to_cosine_hemisphere_pdf(wo))
    return torch.where(ok[..., None], f_cos, 0.0), torch.where(ok, pdf, 0.0)


def _sample_phong_lobe(u2, exponent):
    ct = torch.pow(torch.clamp_min(u2[..., 0], 1e-20), 1.0 / (exponent + 1.0))
    st = m.safe_sqrt(1.0 - ct * ct)
    phi = 2.0 * math.pi * u2[..., 1]
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)


def _phong_sample(sp, wi, u_lobe, u2):
    pick_spec = u_lobe <= _spec_weight(sp)
    wo_s = m.to_world(m.reflect_local(wi), _sample_phong_lobe(u2, sp.extra[..., 0]))
    wo = torch.where(pick_spec[..., None], wo_s, warp.square_to_cosine_hemisphere(u2))
    f_cos, pdf = _phong_eval(sp, wi, wo)
    weight = m.safe_div(f_cos, pdf[..., None])
    ok = (pdf > 1e-12) & (m.cos_theta(wo) > 0.0) & (m.cos_theta(wi) > 0.0)
    return (wo, torch.where(ok[..., None], weight, 0.0), torch.where(ok, pdf, 0.0),
            torch.zeros_like(ok))


def _rough_diffuse_eval(sp, wi, wo):
    """src/bsdfs/roughdiffuse.cpp: Oren-Nayar (the fast variant)."""
    ok = _both_sides_pos(wi, wo)
    sigma = sp.alpha[..., 0] * (math.pi / 2.0) * 0.7978845608
    s2 = sigma * sigma
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    ci, co = m.cos_theta(wi), m.cos_theta(wo)
    si, so = m.sin_theta(wi), m.sin_theta(wo)
    cos_dphi = torch.clamp(m.cos_phi(wi) * m.cos_phi(wo) + m.sin_phi(wi) * m.sin_phi(wo),
                           -1.0, 1.0)
    sin_alpha = torch.where(ci > co, so, si)
    tan_beta = torch.where(ci > co, m.safe_div(si, ci), m.safe_div(so, co))
    f = sp.reflectance * (INV_PI * torch.clamp_min(co, 0.0) * (
        a + b * torch.clamp_min(cos_dphi, 0.0) * sin_alpha * tan_beta))[..., None]
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


def _rough_diffuse_sample(sp, wi, u_lobe, u2):
    wo = warp.square_to_cosine_hemisphere(u2)
    f_cos, pdf = _rough_diffuse_eval(sp, wi, wo)
    weight = m.safe_div(f_cos, pdf[..., None])
    ok = pdf > 1e-12
    return wo, torch.where(ok[..., None], weight, 0.0), pdf, torch.zeros_like(ok)


def _rough_dielectric_eval(sp, wi, wo):
    """src/bsdfs/roughdielectric.cpp: microfacet reflection and refraction
    (Walter et al. 2007), radiance transport."""
    eta = sp.eta[..., 0]
    dist = _dist(sp)
    alpha = sp.alpha[..., 0]
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    reflect = ci * co > 0.0
    eta_it = torch.where(ci >= 0, eta, 1.0 / eta)

    # half vectors (Walter eq. 13/16), oriented to the +z hemisphere
    h_r = _safe_half(wi + wo)
    h_t = _safe_half(-(wi + wo * eta_it[..., None]))
    h = torch.where(reflect[..., None], h_r, h_t)
    h = h * torch.sign(m.cos_theta(h) + 1e-20)[..., None]

    wi_up = wi * torch.sign(ci)[..., None]
    d_h = mf.d_eval(dist, alpha, h)
    g = mf.g_eval(dist, alpha, wi_up, wo * torch.sign(co)[..., None], h)
    wi_dot_h = m.dot(wi, h)
    wo_dot_h = m.dot(wo, h)
    fr, _, _, _ = m.fresnel_dielectric(wi_dot_h, eta)

    val_r = fr * d_h * g / torch.clamp_min(4.0 * torch.abs(ci), 1e-8)
    sqrt_denom = wi_dot_h + eta_it * wo_dot_h
    val_t = ((1.0 - fr) * d_h * g * torch.abs(wi_dot_h * wo_dot_h)
             / torch.clamp_min(torch.abs(ci) * sqrt_denom * sqrt_denom, 1e-10))
    tint = torch.where(reflect[..., None], sp.specular, sp.reflectance)
    f_cos = tint * torch.where(reflect, val_r, val_t)[..., None]

    pdf_h = mf.pdf(dist, alpha, wi_up, h)
    jac_r = m.safe_div(1.0, 4.0 * torch.abs(wo_dot_h))
    jac_t = m.safe_div((eta_it * eta_it) * torch.abs(wo_dot_h), sqrt_denom * sqrt_denom)
    pdf = torch.where(reflect, pdf_h * jac_r * fr, pdf_h * jac_t * (1.0 - fr))
    # Walter's chi+ side consistency: else the sampler never makes this pair
    side_ok = (wi_dot_h * torch.sign(ci) > 0.0) & (wo_dot_h * torch.sign(co) > 0.0)
    ok = (d_h > 0.0) & (torch.abs(ci) > 1e-8) & side_ok
    return torch.where(ok[..., None], f_cos, 0.0), torch.where(ok, pdf, 0.0)


def _rough_dielectric_sample(sp, wi, u_lobe, u2):
    eta = sp.eta[..., 0]
    alpha = sp.alpha[..., 0]
    wi_up = wi * torch.sign(m.cos_theta(wi))[..., None]
    h, _ = mf.sample(_dist(sp), alpha, wi_up, u2)
    wi_dot_h = m.dot(wi, h)
    fr, _, _, eta_ti = m.fresnel_dielectric(wi_dot_h, eta)
    pick_reflect = u_lobe <= fr
    wo_r = 2.0 * wi_dot_h[..., None] * h - wi
    # refraction about h (Walter eq. 40)
    c = wi_dot_h
    root = torch.sqrt(torch.clamp_min(1.0 + eta_ti * eta_ti * (c * c - 1.0), 0.0))
    wo_t = (eta_ti * c - torch.sign(c) * root)[..., None] * h - eta_ti[..., None] * wi
    wo = torch.where(pick_reflect[..., None], wo_r, wo_t)
    f_cos, pdf = _rough_dielectric_eval(sp, wi, wo)
    # reject side-mismatched outputs, clamp grazing-microfacet weights
    ci = m.cos_theta(wi)
    co = m.cos_theta(wo)
    side_ok = torch.where(pick_reflect, ci * co > 0.0, ci * co < 0.0)
    weight = torch.clamp(m.safe_div(f_cos, pdf[..., None]), 0.0, 4.0)
    ok = (pdf > 1e-10) & side_ok
    return (wo, torch.where(ok[..., None], weight, 0.0), torch.where(ok, pdf, 0.0),
            torch.zeros_like(ok))


def _rough_plastic_eval(sp, wi, wo):
    """src/bsdfs/roughplastic.cpp: microfacet coat + internal diffuse."""
    ok = _both_sides_pos(wi, wo)
    dist = _dist(sp)
    alpha = sp.alpha[..., 0]
    eta = sp.eta[..., 0]
    h = _safe_half(wi + wo)
    d_h = mf.d_eval(dist, alpha, h)
    g = mf.g_eval(dist, alpha, wi, wo, h)
    fr_h, _, _, _ = m.fresnel_dielectric(m.dot(wi, h), eta)
    spec_cos = sp.specular * (fr_h * d_h * g
                              / torch.clamp_min(4.0 * m.cos_theta(wi), 1e-8))[..., None]
    pdf_h = mf.pdf(dist, alpha, wi, h)
    diff_cos, fi = _plastic_diffuse(sp, wi, wo, eta)
    f_cos = spec_cos + diff_cos
    spec_p = torch.clamp(fi, 0.05, 0.95)
    pdf_spec = m.safe_div(pdf_h, 4.0 * torch.abs(m.dot(wo, h)))
    pdf = spec_p * pdf_spec + (1.0 - spec_p) * warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(ok[..., None], f_cos, 0.0), torch.where(ok, pdf, 0.0)


def _rough_plastic_sample(sp, wi, u_lobe, u2):
    fi, _, _, _ = m.fresnel_dielectric(m.cos_theta(wi), sp.eta[..., 0])
    pick_spec = u_lobe <= torch.clamp(fi, 0.05, 0.95)
    h, _ = mf.sample(_dist(sp), sp.alpha[..., 0], wi, u2)
    wo_s = 2.0 * m.dot(wi, h, keepdims=True) * h - wi
    wo = torch.where(pick_spec[..., None], wo_s, warp.square_to_cosine_hemisphere(u2))
    f_cos, pdf = _rough_plastic_eval(sp, wi, wo)
    weight = torch.clamp(m.safe_div(f_cos, pdf[..., None]), 0.0, 4.0)
    ok = (pdf > 1e-10) & (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)
    return (wo, torch.where(ok[..., None], weight, 0.0), torch.where(ok, pdf, 0.0),
            torch.zeros_like(ok))


def _ward_eval(sp, wi, wo):
    """src/bsdfs/ward.cpp (balanced): anisotropic Gaussian lobe + diffuse."""
    ok = _both_sides_pos(wi, wo)
    ax = torch.clamp_min(sp.alpha[..., 0], 1e-4)
    ay = torch.clamp_min(sp.alpha[..., 1], 1e-4)
    hn = m.normalize(wi + wo)
    ci, co = m.cos_theta(wi), m.cos_theta(wo)
    exp_arg = -((hn[..., 0] / ax) ** 2 + (hn[..., 1] / ay) ** 2) \
        / torch.clamp_min(hn[..., 2] ** 2, 1e-8)
    spec_f = sp.specular * (torch.exp(exp_arg) / torch.clamp_min(
        4.0 * math.pi * ax * ay * torch.sqrt(torch.clamp_min(ci * co, 1e-8)), 1e-8))[..., None]
    f_cos = (sp.reflectance * INV_PI + spec_f) * torch.clamp_min(co, 0.0)[..., None]
    w_spec = _spec_weight(sp)
    # half-vector pdf exp/(pi ax ay cos^3), jacobian 1/(4 wo.h)
    p_h = m.safe_div(torch.exp(exp_arg),
                     math.pi * ax * ay * torch.clamp_min(hn[..., 2] ** 3, 1e-8))
    p_spec = m.safe_div(p_h, 4.0 * torch.abs(m.dot(wo, hn)))
    pdf = w_spec * p_spec + (1.0 - w_spec) * warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(ok[..., None], f_cos, 0.0), torch.where(ok, pdf, 0.0)


def _ward_sample(sp, wi, u_lobe, u2):
    ax = torch.clamp_min(sp.alpha[..., 0], 1e-4)
    ay = torch.clamp_min(sp.alpha[..., 1], 1e-4)
    pick_spec = u_lobe <= _spec_weight(sp)
    phi = torch.atan2(ay * torch.sin(2 * math.pi * u2[..., 1]),
                      ax * torch.cos(2 * math.pi * u2[..., 1]))
    cp, sp_ = torch.cos(phi), torch.sin(phi)
    t2 = -torch.log(torch.clamp_min(u2[..., 0], 1e-20)) / ((cp / ax) ** 2 + (sp_ / ay) ** 2)
    ct = 1.0 / torch.sqrt(1.0 + t2)
    st = m.safe_sqrt(1.0 - ct * ct)
    hv = torch.stack([st * cp, st * sp_, ct], -1)
    wo_s = 2.0 * m.dot(wi, hv, keepdims=True) * hv - wi
    wo = torch.where(pick_spec[..., None], wo_s, warp.square_to_cosine_hemisphere(u2))
    f_cos, pdf = _ward_eval(sp, wi, wo)
    weight = torch.clamp(m.safe_div(f_cos, pdf[..., None]), 0.0, 8.0)
    ok = (pdf > 1e-10) & (m.cos_theta(wo) > 0.0) & (m.cos_theta(wi) > 0.0)
    return (wo, torch.where(ok[..., None], weight, 0.0), torch.where(ok, pdf, 0.0),
            torch.zeros_like(ok))


def _mask_sample(sp, wi, u_lobe, u2):
    """src/bsdfs/mask.cpp: opacity extra[0]; with probability 1 - opacity
    pass straight through, else diffuse with `reflectance`."""
    opacity = torch.clamp(sp.extra[..., 0], 0.0, 1.0)
    pass_through = u_lobe > opacity
    wo_d, w_d, pdf_d, _ = _diffuse_sample(sp, wi, u_lobe / torch.clamp_min(opacity, 1e-6), u2)
    wo = torch.where(pass_through[..., None], -wi, wo_d)
    weight = torch.where(pass_through[..., None], torch.ones_like(w_d), w_d)
    pdf = torch.where(pass_through, 1.0 - opacity, opacity * pdf_d)
    return wo, weight, pdf, pass_through


def _mask_eval(sp, wi, wo):
    opacity = torch.clamp(sp.extra[..., 0], 0.0, 1.0)
    f, pdf = _diffuse_eval(sp, wi, wo)
    return f * opacity[..., None], pdf * opacity


def _null_sample(sp, wi, u_lobe, u2):
    """src/bsdfs/null.cpp: pass-through (mask and medium boundaries)."""
    n = wi.shape[:-1]
    return (-wi, torch.ones(n + (3,), dtype=wi.dtype, device=wi.device),
            torch.ones(n, dtype=wi.dtype, device=wi.device),
            torch.ones(n, dtype=torch.bool, device=wi.device))


def _zero_eval(sp, wi, wo):
    return (torch.zeros(wi.shape[:-1] + (3,), dtype=wi.dtype, device=wi.device),
            torch.zeros(wi.shape[:-1], dtype=wi.dtype, device=wi.device))


# ---------------------------------------------------------------------------
# Hanrahan-Krueger single-scattering slab (src/bsdfs/hk.cpp). Layout:
# reflectance = sigmaS * thickness (tau_s), specular = sigmaA * thickness
# (tau_a), extra[0] = the HG asymmetry g. Glossy reflection and
# transmission by single scattering, and an attenuated delta transmission.
# ---------------------------------------------------------------------------

def _hk_terms(sp, wi):
    tau_s = torch.clamp_min(sp.reflectance, 0.0)
    tau_d = tau_s + torch.clamp_min(sp.specular, 0.0)
    albedo = m.safe_div(tau_s, torch.clamp_min(tau_d, 1e-20))
    aci = torch.clamp_min(m.abs_cos_theta(wi), 1e-6)
    p_dt = torch.mean(torch.exp(-tau_d / aci[..., None]), -1)
    return tau_d, albedo, aci, p_dt


def _hk_eval(sp, wi, wo):
    tau_d, albedo, aci, p_dt = _hk_terms(sp, wi)
    aco = torch.clamp_min(m.abs_cos_theta(wo), 1e-6)
    phase_val, phase_pdf = phaselib.eval_pdf(phaselib.PHASE_HG, sp.extra[..., 0], wi, wo)
    # reflection from a single-scattering slab (Hanrahan and Krueger 93)
    f_r = albedo * (phase_val * m.safe_div(aci, aci + aco))[..., None] * (
        1.0 - torch.exp(-tau_d * (1.0 / aci + 1.0 / aco)[..., None]))
    # transmission, with the removable singularity at |ci| == |co| guarded
    near = torch.abs(aci - aco) < 1e-4
    e_i = torch.exp(-tau_d / aci[..., None])
    e_o = torch.exp(-tau_d / aco[..., None])
    f_t = albedo * phase_val[..., None] * torch.where(
        near[..., None], tau_d / aco[..., None] * e_o,
        m.safe_div(aci, aci - aco)[..., None] * (e_i - e_o))
    reflect = m.cos_theta(wi) * m.cos_theta(wo) > 0.0
    f = torch.where(reflect[..., None], f_r, f_t) * aco[..., None]
    pdf = phase_pdf * (1.0 - p_dt)
    return torch.clamp_min(f, 0.0), torch.clamp_min(pdf, 0.0)


def _hk_sample(sp, wi, u_lobe, u2):
    tau_d, albedo, aci, p_dt = _hk_terms(sp, wi)
    pick_dt = u_lobe < p_dt
    # delta transmission: the attenuated pass-through
    w_dt = torch.exp(-tau_d / aci[..., None]) / torch.clamp_min(p_dt, 1e-6)[..., None]
    # single scattering: a phase-function direction
    wo_p, _ = phaselib.sample(phaselib.PHASE_HG, sp.extra[..., 0], wi, u2)
    f_p, pdf_p = _hk_eval(sp, wi, wo_p)
    w_p = m.safe_div(f_p, pdf_p[..., None])
    ok_p = pdf_p > 1e-10
    wo = torch.where(pick_dt[..., None], -wi, wo_p)
    weight = torch.where(pick_dt[..., None], w_dt,
                         torch.where(ok_p[..., None], torch.clamp(w_p, 0.0, 16.0), 0.0))
    return wo, weight, torch.where(pick_dt, p_dt, pdf_p), pick_dt


# ---------------------------------------------------------------------------
# Coating adapter (src/bsdfs/coating.cpp, smooth dielectric coat;
# roughcoating.cpp where alpha[0] > 0) over the one-level nested record
# sp.nested. Layout: reflectance = sigmaA * thickness, specular = coat tint,
# eta[0] = coat eta, alpha[0] = coat roughness (0: a delta coat), extra[0] =
# specularSamplingWeight, extra[3] = the coat's microfacet distribution.
# ---------------------------------------------------------------------------

def _coat_refract_in(wi, eta):
    """coating.cpp refractIn: bend into the layer, keep the hemisphere;
    returns (wi', R12). Lanes in TIR get z' = 0 and R = 1."""
    fr, cos_t, _, _ = m.fresnel_dielectric(torch.abs(m.cos_theta(wi)), eta)
    inv_eta = 1.0 / eta
    sign = torch.where(m.cos_theta(wi) >= 0.0, 1.0, -1.0)
    wip = torch.stack([inv_eta * wi[..., 0], inv_eta * wi[..., 1],
                       sign * torch.abs(cos_t)], -1)
    return wip, fr


def _coat_refract_out(wop, eta):
    """coating.cpp refractOut: bend out of the layer; returns (wo, R21)."""
    fr, cos_t, _, _ = m.fresnel_dielectric(torch.abs(m.cos_theta(wop)), 1.0 / eta)
    sign = torch.where(m.cos_theta(wop) >= 0.0, 1.0, -1.0)
    wo = torch.stack([eta * wop[..., 0], eta * wop[..., 1], sign * torch.abs(cos_t)], -1)
    return wo, fr


def _coat_prob_specular(sp, r12):
    w_s = torch.clamp(sp.extra[..., 0], 1e-3, 1.0 - 1e-3)
    return torch.clamp(m.safe_div(r12 * w_s, r12 * w_s + (1.0 - r12) * (1.0 - w_s)),
                       0.0, 1.0 - 1e-4)


def _nested_families(families):
    return tuple(f for f in families if f != ir.BSDF_COATING)


def _coating_eval(sp, wi, wo, families):
    eta = sp.eta[..., 0]
    inv_eta = 1.0 / eta
    wip, r12 = _coat_refract_in(wi, eta)
    wop, r21 = _coat_refract_in(wo, eta)
    f_n, pdf_n = eval_pdf(sp.nested, wip, wop, _nested_families(families))
    aci_p = torch.clamp_min(torch.abs(m.cos_theta(wip)), 1e-6)
    aco_p = torch.clamp_min(torch.abs(m.cos_theta(wop)), 1e-6)
    absorb = torch.exp(-sp.reflectance * (1.0 / aci_p + 1.0 / aco_p)[..., None])
    compression = inv_eta * inv_eta * m.safe_div(torch.abs(m.cos_theta(wo)), aco_p)
    no_tir = (r12 < 1.0 - 1e-6) & (r21 < 1.0 - 1e-6)
    f = f_n * ((1.0 - r12) * (1.0 - r21) * compression)[..., None] * absorb
    prob_spec = _coat_prob_specular(sp, r12)
    pdf = pdf_n * compression * (1.0 - prob_spec)
    f = torch.where(no_tir[..., None], f, 0.0)
    pdf = torch.where(no_tir, pdf, 0.0)

    # glossy coat lobe of roughcoating lanes (alpha[0] > 0)
    alpha_c = sp.alpha[..., 0]
    rough = alpha_c > 1e-5
    same_side = m.cos_theta(wi) * m.cos_theta(wo) > 0.0
    sgn = torch.where(m.cos_theta(wi) >= 0.0, 1.0, -1.0)[..., None]
    wi_up, wo_up = wi * sgn, wo * sgn
    h = _safe_half(wi_up + wo_up)
    dist = _dist(sp)
    d_h = mf.d_eval(dist, alpha_c, h)
    g_h = mf.g_eval(dist, alpha_c, wi_up, wo_up, h)
    fr_h, _, _, _ = m.fresnel_dielectric(m.dot(wi_up, h), eta)
    f_coat = sp.specular * m.safe_div(
        fr_h * d_h * g_h, 4.0 * torch.clamp_min(m.cos_theta(wi_up), 1e-6))[..., None]
    pdf_coat = prob_spec * m.safe_div(mf.pdf(dist, alpha_c, wi_up, h),
                                      4.0 * torch.abs(m.dot(wo_up, h)))
    add = rough & same_side
    return (f + torch.where(add[..., None], f_coat, 0.0),
            pdf + torch.where(add, pdf_coat, 0.0))


def _coating_sample(sp, wi, u_lobe, u2, families):
    eta = sp.eta[..., 0]
    alpha_c = sp.alpha[..., 0]
    rough = alpha_c > 1e-5
    wip, r12 = _coat_refract_in(wi, eta)
    prob_spec = _coat_prob_specular(sp, r12)
    pick_spec = u_lobe < prob_spec

    # --- specular coat: a delta mirror, or VNDF reflection when rough ----
    sgn = torch.where(m.cos_theta(wi) >= 0.0, 1.0, -1.0)[..., None]
    wi_up = wi * sgn
    h, _ = mf.sample(_dist(sp), torch.clamp_min(alpha_c, 1e-4), wi_up, u2)
    wo_rough = (2.0 * m.dot(wi_up, h, keepdims=True) * h - wi_up) * sgn
    wo_s = torch.where(rough[..., None], wo_rough, m.reflect_local(wi))
    w_smooth = sp.specular * m.safe_div(r12, prob_spec)[..., None]
    f_r, pdf_r = _coating_eval(sp, wi, wo_rough, families)
    w_rough = m.safe_div(f_r, pdf_r[..., None])
    rough_ok = (pdf_r > 1e-10) & (m.cos_theta(wi) * m.cos_theta(wo_rough) > 0)
    w_s = torch.where(rough[..., None],
                      torch.where(rough_ok[..., None], torch.clamp(w_rough, 0.0, 8.0), 0.0),
                      w_smooth)
    pdf_s = torch.where(rough, pdf_r, prob_spec)
    delta_s = ~rough

    # --- nested branch ----------------------------------------------------
    u_n = m.safe_div(u_lobe - prob_spec, 1.0 - prob_spec)
    wop, w_n, pdf_n, delta_n = sample(sp.nested, wip, u_n, u2, _nested_families(families))
    aci_p = torch.clamp_min(torch.abs(m.cos_theta(wip)), 1e-6)
    aco_p = torch.clamp_min(torch.abs(m.cos_theta(wop)), 1e-6)
    absorb = torch.exp(-sp.reflectance * (1.0 / aci_p + 1.0 / aco_p)[..., None])
    wo_n, r21 = _coat_refract_out(wop, eta)
    ok_n = (r12 < 1.0 - 1e-6) & (r21 < 1.0 - 1e-6) & (torch.amax(w_n, -1) > 0)
    # delta-nested lanes (a coat over a smooth base): branch weighting
    w_delta = w_n * absorb * ((1.0 - r12) * (1.0 - r21)
                              / torch.clamp_min(1.0 - prob_spec, 1e-6))[..., None]
    pdf_delta = pdf_n * (1.0 - prob_spec)
    # other lanes: one-sample MIS over the combined lobes, f/pdf from the
    # same eval that the MIS pdf queries use
    f_e, pdf_e = _coating_eval(sp, wi, wo_n, families)
    w_eval = m.safe_div(f_e, pdf_e[..., None])
    w_nested = torch.where(delta_n[..., None], w_delta,
                           torch.where((pdf_e > 1e-12)[..., None],
                                       torch.clamp(w_eval, 0.0, 16.0), 0.0))
    pdf_nested = torch.where(delta_n, pdf_delta, pdf_e)
    w_nested = torch.where(ok_n[..., None], w_nested, 0.0)
    pdf_nested = torch.where(ok_n, pdf_nested, 0.0)

    wo = torch.where(pick_spec[..., None], wo_s, wo_n)
    weight = torch.where(pick_spec[..., None], w_s, w_nested)
    pdf = torch.where(pick_spec, pdf_s, pdf_nested)
    return wo, weight, pdf, torch.where(pick_spec, delta_s, delta_n)


def _irawan_eval(sp, wi, wo):
    """src/bsdfs/irawan.cpp: woven cloth; its parameters were packed into
    the generic fields at gather time (models/cloth.py gather_yarn)."""
    from . import cloth as clothlib

    return clothlib.eval_packed(sp, wi, wo)


def _irawan_sample(sp, wi, u_lobe, u2):
    """Cosine-hemisphere sampling, weight = eval/pdf (irawan.cpp:354)."""
    wo = warp.square_to_cosine_hemisphere(u2)
    f, pdf = _irawan_eval(sp, wi, wo)
    weight = torch.where(pdf[..., None] > 1e-9,
                         f / torch.clamp_min(pdf[..., None], 1e-9), 0.0)
    return wo, weight, pdf, torch.zeros(pdf.shape, dtype=torch.bool, device=pdf.device)


_EVAL = {
    ir.BSDF_DIFFUSE: _diffuse_eval,
    ir.BSDF_ROUGH_CONDUCTOR: _rough_conductor_eval,
    ir.BSDF_PLASTIC: _plastic_eval,
    ir.BSDF_ROUGH_PLASTIC: _rough_plastic_eval,
    ir.BSDF_ROUGH_DIELECTRIC: _rough_dielectric_eval,
    ir.BSDF_PHONG: _phong_eval,
    ir.BSDF_ROUGH_DIFFUSE: _rough_diffuse_eval,
    ir.BSDF_DIFFUSE_TRANSMITTER: _diffuse_transmitter_eval,
    ir.BSDF_WARD: _ward_eval,
    ir.BSDF_MASK: _mask_eval,
    ir.BSDF_HK: _hk_eval,
    ir.BSDF_CONDUCTOR: _zero_eval,
    ir.BSDF_DIELECTRIC: _zero_eval,
    ir.BSDF_THIN_DIELECTRIC: _zero_eval,
    ir.BSDF_NULL: _zero_eval,
    ir.BSDF_IRAWAN: _irawan_eval,
}

_SAMPLE = {
    ir.BSDF_DIFFUSE: _diffuse_sample,
    ir.BSDF_ROUGH_CONDUCTOR: _rough_conductor_sample,
    ir.BSDF_PLASTIC: _plastic_sample,
    ir.BSDF_ROUGH_PLASTIC: _rough_plastic_sample,
    ir.BSDF_ROUGH_DIELECTRIC: _rough_dielectric_sample,
    ir.BSDF_PHONG: _phong_sample,
    ir.BSDF_ROUGH_DIFFUSE: _rough_diffuse_sample,
    ir.BSDF_DIFFUSE_TRANSMITTER: _diffuse_transmitter_sample,
    ir.BSDF_WARD: _ward_sample,
    ir.BSDF_MASK: _mask_sample,
    ir.BSDF_HK: _hk_sample,
    ir.BSDF_CONDUCTOR: _conductor_sample,
    ir.BSDF_DIELECTRIC: _dielectric_sample,
    ir.BSDF_THIN_DIELECTRIC: _thin_dielectric_sample,
    ir.BSDF_NULL: _null_sample,
    ir.BSDF_IRAWAN: _irawan_sample,
}

# Families whose sample() is (partly) a delta lobe.
DELTA_FAMILIES = frozenset(
    [ir.BSDF_CONDUCTOR, ir.BSDF_DIELECTRIC, ir.BSDF_THIN_DIELECTRIC, ir.BSDF_NULL,
     ir.BSDF_PLASTIC, ir.BSDF_COATING, ir.BSDF_HK])

# Families that can transmit (frame flipping must keep both sides).
TRANSMISSIVE = frozenset(
    [ir.BSDF_DIELECTRIC, ir.BSDF_THIN_DIELECTRIC, ir.BSDF_NULL,
     ir.BSDF_DIFFUSE_TRANSMITTER, ir.BSDF_ROUGH_DIELECTRIC, ir.BSDF_HK])


def _apply_twosided(sp: ShadePoint, wi):
    """extra[:,2] > 0.5 marks a twosided adapter: flip the frame when hit
    from behind."""
    flip = (sp.extra[..., 2] > 0.5) & (m.cos_theta(wi) < 0.0)
    s = torch.where(flip, -1.0, 1.0)
    return torch.stack([torch.ones_like(s), torch.ones_like(s), s], dim=-1)


def eval_pdf(sp: ShadePoint, wi: torch.Tensor, wo: torch.Tensor, families: tuple):
    """Masked dispatch of eval+pdf over the scene's static family set."""
    _check_families(families)
    flip = _apply_twosided(sp, wi)
    wi = wi * flip
    wo = wo * flip
    f = torch.zeros(wi.shape[:-1] + (3,), dtype=wi.dtype, device=wi.device)
    pdf = torch.zeros(wi.shape[:-1], dtype=wi.dtype, device=wi.device)
    for fam in families:
        if fam == ir.BSDF_BLEND:
            continue  # adapter: resolved to a child in gather_shade_point
        if fam == ir.BSDF_COATING:
            fe, fp = _coating_eval(sp, wi, wo, families)
        else:
            fe, fp = _EVAL[fam](sp, wi, wo)
        mask = sp.type == fam
        f = torch.where(mask[..., None], fe, f)
        pdf = torch.where(mask, fp, pdf)
    return f, pdf


def sample(sp: ShadePoint, wi: torch.Tensor, u_lobe: torch.Tensor,
           u2: torch.Tensor, families: tuple):
    """Masked dispatch of sample(). Returns (wo, weight, pdf, is_delta)."""
    _check_families(families)
    flip = _apply_twosided(sp, wi)
    wi_f = wi * flip
    wo = torch.zeros_like(wi)
    weight = torch.zeros(wi.shape[:-1] + (3,), dtype=wi.dtype, device=wi.device)
    pdf = torch.zeros(wi.shape[:-1], dtype=wi.dtype, device=wi.device)
    is_delta = torch.zeros(wi.shape[:-1], dtype=torch.bool, device=wi.device)
    for fam in families:
        if fam == ir.BSDF_BLEND:
            continue
        if fam == ir.BSDF_COATING:
            fwo, fw, fp, fd = _coating_sample(sp, wi_f, u_lobe, u2, families)
        else:
            fwo, fw, fp, fd = _SAMPLE[fam](sp, wi_f, u_lobe, u2)
        mask = sp.type == fam
        wo = torch.where(mask[..., None], fwo, wo)
        weight = torch.where(mask[..., None], fw, weight)
        pdf = torch.where(mask, fp, pdf)
        is_delta = torch.where(mask, fd, is_delta)
    return wo * flip, weight, pdf, is_delta
