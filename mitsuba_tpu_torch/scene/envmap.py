"""Lat-long environment emitter with 2D CDF importance sampling (port of
scene/envmap.py).

A marginal row CDF and per-row conditional CDFs are built on the host in
numpy (the JAX package's build, copied here) and sampled with two batched
searches. The radiance lookup is bilinear and differentiable with respect
to `image`.

Direction convention (envmap.cpp dirToUV): y up,
u = (1 + atan2(dx, -dz) / pi) / 2,  v = acos(clamp(dy)) / pi.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core import math as m
from .ir import _Replace


@dataclasses.dataclass
class EnvMap(_Replace):
    image: torch.Tensor      # (H, W, 3) radiance
    row_cdf: torch.Tensor    # (H,) inclusive marginal CDF over rows
    cond_cdf: torch.Tensor   # (H, W) inclusive conditional CDF per row
    pdf_map: torch.Tensor    # (H, W) discrete selection probability (sums to 1)
    scale: torch.Tensor      # () overall scale
    # (H, W, B) spectral radiance for the spectral integrator, which is not
    # ported (eval_radiance_spectral raises)
    spectral: Optional[torch.Tensor] = None


def build_envmap(image: np.ndarray, scale: float = 1.0, device="cuda") -> EnvMap:
    image = np.asarray(image, np.float32)
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, -1)
    h = image.shape[0]
    lum = image @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
    # solid-angle weight per row: sin(theta)
    theta = (np.arange(h) + 0.5) / h * np.pi
    weight = lum * np.sin(theta)[:, None] + 1e-12
    pdf_map = weight / weight.sum()
    row = pdf_map.sum(1)
    row_cdf = np.cumsum(row)
    row_cdf[-1] = 1.0
    cond_cdf = np.cumsum(pdf_map / row[:, None], axis=1)
    cond_cdf[:, -1] = 1.0

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return EnvMap(image=t(image), row_cdf=t(row_cdf), cond_cdf=t(cond_cdf),
                  pdf_map=t(pdf_map), scale=t(scale))


def attach_envmap(scene, image: np.ndarray, scale: float = 1.0):
    """The scene lit by the lat-long map `image` (built on the scene's
    device)."""
    return scene.replace(envmap=build_envmap(image, scale, scene.device), has_env=True)


def eval_radiance_spectral(em: EnvMap, d, lam):
    raise NotImplementedError("envmap.eval_radiance_spectral is not ported: it belongs "
                              "to the spectral integrator (ROADMAP A12)")


def dir_to_uv(d: torch.Tensor):
    """Direction -> (u, v) in [0,1)^2, y-up lat-long."""
    u = (1.0 + torch.atan2(d[..., 0], -d[..., 2]) / math.pi) * 0.5
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def uv_to_dir(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    phi = (2.0 * u - 1.0) * math.pi
    theta = v * math.pi
    st = torch.sin(theta)
    return torch.stack([st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi)], -1)


def eval_radiance(em: EnvMap, d: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of the radiance arriving along -d (an escaped ray's
    direction d)."""
    h, w = em.image.shape[:2]
    u, v = dir_to_uv(d)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi = x0.to(torch.int32)
    yi = y0.to(torch.int32)
    x0i = torch.remainder(xi, w)
    x1i = torch.remainder(xi + 1, w)
    y0i = torch.clamp(yi, 0, h - 1)
    y1i = torch.clamp(yi + 1, 0, h - 1)
    img = em.image
    c = (img[y0i, x0i] * (1 - fx) * (1 - fy) + img[y0i, x1i] * fx * (1 - fy)
         + img[y1i, x0i] * (1 - fx) * fy + img[y1i, x1i] * fx * fy)
    return c * em.scale


def _lower_bound(cdf: torch.Tensor, row: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per-lane searchsorted(cdf[row], u, side="left"): the first column
    whose value is >= u (W if none), by bisection over the lane's own row
    (no (N, W) gather)."""
    w = cdf.shape[1]
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, w)
    for _ in range(max(w, 1).bit_length()):
        mid = (lo + hi) // 2
        go_right = (lo < hi) & (cdf[row, torch.clamp_max(mid, w - 1)] < u)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right | (lo >= hi), hi, mid)
    return lo


def sample_direction(em: EnvMap, u2: torch.Tensor):
    """Importance-sample a direction ~ luminance x sin(theta). u2 (N,2).
    Returns (d (N,3), solid-angle pdf (N,), radiance (N,3))."""
    h, w = em.image.shape[:2]
    row = torch.clamp(torch.searchsorted(em.row_cdf, u2[..., 0].contiguous(), right=False),
                      0, h - 1)
    # rescale u within the row's stratum
    lo_r = torch.where(row > 0, em.row_cdf[torch.clamp_min(row - 1, 0)], 0.0)
    du_r = m.safe_div(u2[..., 0] - lo_r, em.row_cdf[row] - lo_r)
    col = torch.clamp(_lower_bound(em.cond_cdf, row, u2[..., 1]), 0, w - 1)
    lo_c = torch.where(col > 0, em.cond_cdf[row, torch.clamp_min(col - 1, 0)], 0.0)
    du_c = m.safe_div(u2[..., 1] - lo_c, em.cond_cdf[row, col] - lo_c)

    v = (row.to(torch.float32) + torch.clamp(du_r, 0.0, 0.9999)) / h
    u = (col.to(torch.float32) + torch.clamp(du_c, 0.0, 0.9999)) / w
    d = uv_to_dir(u, v)
    sin_t = torch.clamp_min(torch.sin(v * math.pi), 1e-8)
    # discrete pixel probability -> solid-angle density
    pdf = em.pdf_map[row, col] * (h * w) / (2.0 * math.pi * math.pi * sin_t)
    return d, pdf, eval_radiance(em, d)


def pdf_direction(em: EnvMap, d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf with which sample_direction produces d (for MIS)."""
    h, w = em.image.shape[:2]
    u, v = dir_to_uv(d)
    x = torch.clamp((u * w).to(torch.int32), 0, w - 1)
    y = torch.clamp((v * h).to(torch.int32), 0, h - 1)
    sin_t = torch.clamp_min(torch.sin(v * math.pi), 1e-8)
    return em.pdf_map[y, x] * (h * w) / (2.0 * math.pi * math.pi * sin_t)


def rotate_latlong(image: np.ndarray, to_world: np.ndarray) -> np.ndarray:
    """Bake an envmap's toWorld rotation into the lat-long image (host
    side, bilinear): new(d_world) = old(latlong(R^-1 d_world))."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    r_inv = np.linalg.inv(np.asarray(to_world, np.float32)[:3, :3])
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi
    phi = (2.0 * u - 1.0) * np.pi
    st = np.sin(theta)[:, None]
    d = np.stack([
        np.broadcast_to(np.sin(phi)[None, :], (h, w)) * st,
        np.broadcast_to(np.cos(theta)[:, None], (h, w)),
        np.broadcast_to(-np.cos(phi)[None, :], (h, w)) * st,
    ], -1)
    dl = d @ r_inv.T
    ul = (1.0 + np.arctan2(dl[..., 0], -dl[..., 2]) / np.pi) / 2.0
    vl = np.arccos(np.clip(dl[..., 1], -1, 1)) / np.pi
    fx = ul * w - 0.5
    fy = vl * h - 0.5
    x0 = np.floor(fx).astype(np.int32)
    y0 = np.clip(np.floor(fy).astype(np.int32), 0, h - 1)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0w = np.mod(x0, w)
    x1w = np.mod(x0 + 1, w)
    y1 = np.minimum(y0 + 1, h - 1)
    out = (img[y0, x0w] * (1 - tx) * (1 - ty) + img[y0, x1w] * tx * (1 - ty)
           + img[y1, x0w] * (1 - tx) * ty + img[y1, x1w] * tx * ty)
    return out.astype(np.float32)
