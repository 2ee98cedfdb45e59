"""BSDF framework: masked dispatch over material families (port of
models/bsdf.py).

Every ray batch gathers its material record into a ShadePoint SoA and each
family present in the scene is evaluated for all rays, with lane masks
selecting the right result. Only the diffuse family is ported; any other
family in `scene.bsdf_families` raises NotImplementedError naming it.

Conventions: directions in the local shading frame (z = shading normal);
`wi` toward the viewer, `wo` toward the light; eval returns f * |cos wo|;
pdf in solid angle; sample returns (wo, weight = f*cos/pdf, pdf, is_delta).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import math as m
from ..core import warp
from ..scene import ir

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


def _check_families(families):
    for fam in families:
        if fam not in _EVAL:
            raise NotImplementedError(
                f"BSDF family {ir.BSDF_NAMES.get(fam, fam)!r} is not ported")


def gather_shade_point(scene, mat: torch.Tensor, uv: torch.Tensor) -> ShadePoint:
    """Gather material rows for each ray and resolve reflectance textures.
    (The JAX package's blend-adapter and procedural-texture inputs are not
    ported.)"""
    from . import texture as tex

    _check_families(scene.bsdf_families)
    mats = scene.materials
    refl = tex.resolve(scene, mats.tex_reflectance[mat], uv,
                       mats.reflectance[mat])
    return ShadePoint(
        type=mats.type[mat],
        reflectance=refl,
        specular=mats.specular[mat],
        eta=mats.eta[mat],
        k=mats.k[mat],
        alpha=mats.alpha[mat],
        extra=mats.extra[mat],
    )


def _both_sides_pos(wi, wo):
    return (m.cos_theta(wi) > 0.0) & (m.cos_theta(wo) > 0.0)


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


_EVAL = {ir.BSDF_DIFFUSE: _diffuse_eval}
_SAMPLE = {ir.BSDF_DIFFUSE: _diffuse_sample}


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
        fwo, fw, fp, fd = _SAMPLE[fam](sp, wi_f, u_lobe, u2)
        mask = sp.type == fam
        wo = torch.where(mask[..., None], fwo, wo)
        weight = torch.where(mask[..., None], fw, weight)
        pdf = torch.where(mask, fp, pdf)
        is_delta = torch.where(mask, fd, is_delta)
    wo = wo * flip
    return wo, weight, pdf, is_delta
