"""Texture lookup over the scene's padded texture stack (port of
models/texture.py).

All bitmaps live in one (K, TH, TW, 3) tensor, so a per-ray lookup is a
gather; procedural checkerboards are tiny nearest-filtered bitmaps. With
a mip strip (`scene.tex_mips`) and a texel footprint, lookups are
trilinear; with the uv partials of a raster step they use the fixed-tap
EWA filter. Lookups are differentiable with respect to `scene.textures`
(the mip strip is a constant built from them at scene assembly).

Integer semantics follow the JAX package's: wrapping is a floor-mod
(`torch.remainder`), float to int conversion truncates toward zero.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as m

EWA_TAPS = 8          # fixed anisotropic tap count
EWA_MAX_ANISO = 8.0   # max major/minor ratio (mipmap.h m_maxAnisotropy)


def resolve(scene, tex_id: torch.Tensor, uv: torch.Tensor, fallback: torch.Tensor,
            footprint=None, duvdx=None, duvdy=None) -> torch.Tensor:
    """Per-ray reflectance: the texture's value where tex_id >= 0, else
    `fallback`. tex_id (N,) int32, uv (N,2), fallback (N,3). `footprint`
    (N,) (world pixel footprint x the triangle's uv density) selects the
    trilinear level where the scene has mips; duvdx/duvdy (N,2) turn on EWA
    on the lanes where they are nonzero."""
    if scene.textures.shape[0] == 1 and scene.textures.shape[1] == 1:
        return fallback   # no real textures in this scene
    tid = torch.clamp_min(tex_id, 0)
    value = sample_bilinear(scene, tid, uv)
    if scene.tex_mips is not None and footprint is not None:
        tri = _trilinear_at(scene, tid, uv, _lod_from_footprint(scene, tid, footprint), value)
        if duvdx is not None and duvdy is not None:
            ewa, has_grad = _ewa(scene, tid, uv, duvdx, duvdy)
            value = torch.where(has_grad[..., None], ewa, tri)
        else:
            value = tri
    return torch.where((tex_id >= 0)[..., None], value, fallback)


def _lod_from_footprint(scene, tid, footprint):
    """Isotropic lod = log2(texels per pixel) from the scalar footprint."""
    w_tex = scene.tex_size[tid, 1].to(torch.float32)
    xf = scene.tex_transform[tid]
    tile = torch.maximum(torch.abs(xf[..., 0]), torch.abs(xf[..., 1]))
    return torch.log2(torch.clamp_min(footprint * w_tex * tile, 1e-8))


def _clip_lod(scene, tid, lod):
    size = torch.minimum(scene.tex_size[tid, 0], scene.tex_size[tid, 1]).to(torch.float32)
    max_l = torch.floor(torch.log2(torch.clamp_min(size, 1.0)))
    return torch.clamp(torch.clamp_min(lod, 0.0), max=max_l - 1.0)


def _taps(t, k, y0, y1, x0, x1, fx, fy):
    """Bilinear blend of the four texels (k, y, x) of stack t."""
    return (t[k, y0, x0] * ((1 - fx) * (1 - fy))[..., None]
            + t[k, y0, x1] * (fx * (1 - fy))[..., None]
            + t[k, y1, x0] * ((1 - fx) * fy)[..., None]
            + t[k, y1, x1] * (fx * fy)[..., None])


def _mip_bilinear(scene, tid, uv, level):
    """Bilinear from the mip strip at integer level >= 1 (per lane). Level
    l of texture k sits at x offset W (1 - 2^(1-l)), size (h>>l, w>>l)."""
    xf = scene.tex_transform[tid]
    lvl = torch.clamp_min(level, 1.0)
    hf = scene.tex_size[tid, 0].to(torch.float32)
    wf = scene.tex_size[tid, 1].to(torch.float32)
    h = torch.clamp_min((hf / torch.exp2(lvl)).to(torch.int32), 1)
    w = torch.clamp_min((wf / torch.exp2(lvl)).to(torch.int32), 1)
    x_off = (wf * (1.0 - torch.exp2(1.0 - lvl))).to(torch.int32)
    u = uv[..., 0] * xf[..., 0] + xf[..., 2]
    v = uv[..., 1] * xf[..., 1] + xf[..., 3]
    x = u * w.to(torch.float32) - 0.5
    y = (1.0 - v) * h.to(torch.float32) - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    xi = x0f.to(torch.int32)
    yi = y0f.to(torch.int32)
    x0 = torch.remainder(xi, w)
    x1 = torch.remainder(xi + 1, w)
    y0 = torch.remainder(yi, h)
    y1 = torch.remainder(yi + 1, h)
    return _taps(scene.tex_mips, tid, y0, y1, x_off + x0, x_off + x1, x - x0f, y - y0f)


def _trilinear_at(scene, tid, uv, lod, level0=None):
    """Trilinear sample at an explicit lod; level0 is the base level's
    bilinear value at uv, where the caller has it."""
    lod = _clip_lod(scene, tid, lod)
    l0 = torch.floor(lod)
    frac = lod - l0
    if level0 is None:
        level0 = sample_bilinear(scene, tid, uv)
    lo = torch.where((l0 < 1.0)[..., None], level0, _mip_bilinear(scene, tid, uv, l0))
    hi = _mip_bilinear(scene, tid, uv, l0 + 1.0)
    return lo * (1.0 - frac)[..., None] + hi * frac[..., None]


def _ewa(scene, tid, uv, duvdx, duvdy):
    """Fixed-tap EWA (mipmap.h:161 evalEWA in the hardware-anisotropic
    form): EWA_TAPS Gaussian-weighted trilinear probes along the ellipse's
    major axis at the lod of its clamped minor axis. Returns (value,
    has_gradients)."""
    xf = scene.tex_transform[tid]
    h = scene.tex_size[tid, 0].to(torch.float32)
    w = scene.tex_size[tid, 1].to(torch.float32)
    # gradients in texel units (the v flip leaves magnitudes alone)
    gx = torch.stack([duvdx[..., 0] * xf[..., 0] * w, duvdx[..., 1] * xf[..., 1] * h], -1)
    gy = torch.stack([duvdy[..., 0] * xf[..., 0] * w, duvdy[..., 1] * xf[..., 1] * h], -1)
    lx = _length2(gx)
    ly = _length2(gy)
    has_grad = (lx + ly) > 1e-8
    l_maj = torch.maximum(lx, ly)
    l_min = torch.minimum(lx, ly)
    aniso = torch.clamp(m.safe_div(l_maj, torch.clamp_min(l_min, 1e-8)), 1.0, EWA_MAX_ANISO)
    lod = torch.log2(torch.clamp_min(l_maj / aniso, 1e-8))
    major_uv = torch.where((lx >= ly)[..., None], duvdx, duvdy)
    acc = 0.0
    wsum = 0.0
    for i in range(EWA_TAPS):
        s = (i + 0.5) / EWA_TAPS - 0.5
        wgt = float(np.exp(np.float32(-2.0 * (2.0 * s) ** 2)))   # Gaussian lobe
        acc = acc + wgt * _trilinear_at(scene, tid, uv + s * major_uv, lod)
        wsum = wsum + wgt
    return acc / wsum, has_grad


def _length2(v):
    """m.length of (..., 2) vectors (the JAX package sums over the last
    axis whatever its width)."""
    return torch.sqrt(torch.clamp_min(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1], 1e-30))


def sample_bilinear(scene, tid: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Repeat-wrapped bilinear (or nearest) lookup. tid (N,), uv (N,2)."""
    xf = scene.tex_transform[tid]
    u = uv[..., 0] * xf[..., 0] + xf[..., 2]
    v = uv[..., 1] * xf[..., 1] + xf[..., 3]
    hn = scene.tex_size[tid, 0]
    wn = scene.tex_size[tid, 1]
    # uv -> continuous pixel coordinates, v flipped (row 0 = top, v = 1)
    x = u * wn.to(torch.float32) - 0.5
    y = (1.0 - v) * hn.to(torch.float32) - 0.5
    hw = torch.clamp_min(hn, 1)
    ww = torch.clamp_min(wn, 1)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    xi = x0f.to(torch.int32)
    yi = y0f.to(torch.int32)
    t = scene.textures
    bil = _taps(t, tid, torch.remainder(yi, hw), torch.remainder(yi + 1, hw),
                torch.remainder(xi, ww), torch.remainder(xi + 1, ww), x - x0f, y - y0f)
    # nearest: round (half to even, as jnp.round) instead of blending
    xn = torch.remainder(torch.round(x).to(torch.int32), ww)
    yn = torch.remainder(torch.round(y).to(torch.int32), hw)
    return torch.where((scene.tex_nearest[tid] == 1)[..., None], t[tid, yn, xn], bil)


def checkerboard(color0, color1) -> dict:
    """Procedural checkerboard as a 2x2 nearest bitmap (checkerboard.cpp
    semantics under repeat tiling)."""
    c0 = np.asarray(color0, np.float32)
    c1 = np.asarray(color1, np.float32)
    data = np.stack([np.stack([c0, c1]), np.stack([c1, c0])])
    return {"data": data, "nearest": True, "transform": (2.0, 2.0, 0.0, 0.0)}
