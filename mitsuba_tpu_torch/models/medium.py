"""Participating media: homogeneous, dense grid and block-sparse grid (port
of models/medium.py).

A scene carries at most one medium (Scene.medium), filling all space. The
homogeneous medium has closed-form transmittance and per-channel distance
sampling; grid media scale sigma_t by a trilinear density lookup and are
walked by weighted delta tracking (distance sampling) and ratio tracking
(transmittance), each a fixed TRACK_STEPS-step loop, as in the JAX
package. `sigma_t`, `albedo` and `g` may require grad.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import math as m
from ..scene.ir import _Replace
from . import phase as phaselib

MEDIUM_HOMOGENEOUS = 0
MEDIUM_GRID = 1
MEDIUM_HGRID = 2       # block-sparse grid: a cell table over stacked blocks


@dataclasses.dataclass
class Medium(_Replace):
    sigma_t: torch.Tensor                     # (3,) extinction
    albedo: torch.Tensor                      # (3,) sigma_s / sigma_t
    g: torch.Tensor                           # () HG asymmetry
    # grid media: density scales sigma_t; (D,H,W), or (NB,bz,by,bx) blocks
    # for MEDIUM_HGRID; (1,1,1) ones for the homogeneous medium
    density: Optional[torch.Tensor] = None
    box_min: Optional[torch.Tensor] = None    # (3,)
    box_max: Optional[torch.Tensor] = None    # (3,)
    # MEDIUM_HGRID: (BZ,BY,BX) int32 cell -> block id, -1 = empty
    block_table: Optional[torch.Tensor] = None
    # optional (D,H,W,3) per-voxel fiber axis over the same box (an
    # orientation volume for the kkay and microflake phases)
    orientation: Optional[torch.Tensor] = None
    # static
    kind: int = MEDIUM_HOMOGENEOUS
    phase: int = phaselib.PHASE_HG
    phase_params: tuple = ()


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _rgb(x, device) -> torch.Tensor:
    return _f32(x, device) * torch.ones(3, device=device)


def make_homogeneous(sigma_s, sigma_a, g=0.0, phase: int = phaselib.PHASE_HG,
                     phase_params: tuple = (), device="cuda") -> Medium:
    sigma_s = _rgb(sigma_s, device)
    sigma_a = _rgb(sigma_a, device)
    sigma_t = sigma_s + sigma_a
    albedo = torch.where(sigma_t > 0, sigma_s / torch.clamp_min(sigma_t, 1e-20), 0.0)
    return Medium(sigma_t=sigma_t, albedo=albedo, g=_f32(g, device),
                  density=torch.ones((1, 1, 1), device=device),
                  box_min=torch.zeros(3, device=device), box_max=torch.ones(3, device=device),
                  kind=MEDIUM_HOMOGENEOUS, phase=phase, phase_params=phase_params)


def make_grid(density, sigma_t_scale, albedo, g=0.0, box_min=(0, 0, 0), box_max=(1, 1, 1),
              phase: int = phaselib.PHASE_HG, phase_params: tuple = (), orientation=None,
              device="cuda") -> Medium:
    """Heterogeneous medium: sigma_t(x) = density(x) * sigma_t_scale over
    the box, indexed [z, y, x]. `orientation`: an optional (D,H,W,3) fiber
    axis grid."""
    return Medium(sigma_t=_rgb(sigma_t_scale, device), albedo=_rgb(albedo, device),
                  g=_f32(g, device), density=_f32(density, device),
                  box_min=_f32(box_min, device), box_max=_f32(box_max, device),
                  orientation=None if orientation is None else _f32(orientation, device),
                  kind=MEDIUM_GRID, phase=phase, phase_params=phase_params)


def make_hgrid(block_table, block_data, sigma_t_scale, albedo, g=0.0,
               box_min=(0, 0, 0), box_max=(1, 1, 1), phase: int = phaselib.PHASE_HG,
               phase_params: tuple = (), device="cuda") -> Medium:
    """Block-sparse grid: empty cells are -1 in one int32 table, occupied
    blocks stack into one (NB,bz,by,bx) array; a lookup is two gathers."""
    return Medium(sigma_t=_rgb(sigma_t_scale, device), albedo=_rgb(albedo, device),
                  g=_f32(g, device), density=_f32(block_data, device),
                  box_min=_f32(box_min, device), box_max=_f32(box_max, device),
                  block_table=torch.as_tensor(np.asarray(block_table, np.int32), device=device),
                  kind=MEDIUM_HGRID, phase=phase, phase_params=phase_params)


def bake_dense(med: Medium, resolution) -> Medium:
    """Any medium's density evaluated onto a dense (D,H,W) grid at the voxel
    centres: a grid medium with the same box, coefficients and phase."""
    d, h, w = resolution
    dev = med.sigma_t.device

    def centres(k):
        return (torch.arange(k, dtype=torch.float32, device=dev) + 0.5) / k

    Z, Y, X = torch.meshgrid(centres(d), centres(h), centres(w), indexing="ij")
    rel = torch.stack([X, Y, Z], -1).reshape(-1, 3)
    pts = med.box_min + rel * (med.box_max - med.box_min)
    return Medium(sigma_t=med.sigma_t, albedo=med.albedo, g=med.g,
                  density=density_at(med, pts).reshape(d, h, w),
                  box_min=med.box_min, box_max=med.box_max,
                  kind=MEDIUM_GRID, phase=med.phase, phase_params=med.phase_params)


def _cell(rel, size):
    """(i0, i1, t): the trilinear corner indices along one axis of `size`
    samples spanning [0, 1], and the weight of i1."""
    f = rel * (size - 1)
    i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, max(size - 2, 0))
    t = torch.clamp(f - i0, 0.0, 1.0)
    return i0, torch.clamp_max(i0 + 1, size - 1), t


def _trilinear(fetch, x, y, z):
    """Sum of the 8 corner values fetch(zi, yi, xi) with their weights, in
    the JAX package's order. x, y, z: (i0, i1, t) of _cell; a trailing
    value axis (orientation) broadcasts when the weights carry [..., None]."""
    (x0, x1, tx), (y0, y1, ty), (z0, z1, tz) = x, y, z
    return (fetch(z0, y0, x0) * (1 - tx) * (1 - ty) * (1 - tz)
            + fetch(z0, y0, x1) * tx * (1 - ty) * (1 - tz)
            + fetch(z0, y1, x0) * (1 - tx) * ty * (1 - tz)
            + fetch(z0, y1, x1) * tx * ty * (1 - tz)
            + fetch(z1, y0, x0) * (1 - tx) * (1 - ty) * tz
            + fetch(z1, y0, x1) * tx * (1 - ty) * tz
            + fetch(z1, y1, x0) * (1 - tx) * ty * tz
            + fetch(z1, y1, x1) * tx * ty * tz)


def _rel(med: Medium, p):
    return (p - med.box_min) / torch.clamp_min(med.box_max - med.box_min, 1e-9)


def _inside(rel):
    return torch.all((rel >= 0.0) & (rel <= 1.0), dim=-1)


def _density_hgrid(med: Medium, p: torch.Tensor) -> torch.Tensor:
    """Block-sparse lookup: the cell's block id, then trilinear inside the
    block (0 in empty cells and outside the box)."""
    rel = _rel(med, p)
    BZ, BY, BX = med.block_table.shape

    def cell(r, n):
        c = torch.clamp((r * n).to(torch.int64), 0, n - 1)
        return c, torch.clamp(r * n - c, 0.0, 1.0)

    (cx, lx), (cy, ly), (cz, lz) = (cell(rel[..., 0], BX), cell(rel[..., 1], BY),
                                    cell(rel[..., 2], BZ))
    bid = med.block_table[cz, cy, cx]
    b = torch.clamp_min(bid, 0).to(torch.int64)
    _, bd, bh, bw = med.density.shape
    g = med.density
    c = _trilinear(lambda z, y, x: g[b, z, y, x], _cell(lx, bw), _cell(ly, bh), _cell(lz, bd))
    return torch.where(_inside(rel) & (bid >= 0), c, 0.0)


def orientation_at(med: Medium, p: torch.Tensor) -> torch.Tensor:
    """Trilinear fiber-axis lookup, then normalised; a degenerate
    interpolant (opposing axes cancelling) falls back to +z."""
    rel = _rel(med, p)
    o_ = med.orientation
    d_, h_, w_ = o_.shape[:3]

    def axis(r, n):
        i0, i1, t = _cell(r, n)
        return i0, i1, t[..., None]

    v = _trilinear(lambda z, y, x: o_[z, y, x], axis(rel[..., 0], w_), axis(rel[..., 1], h_),
                   axis(rel[..., 2], d_))
    ln = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fallback = m.const([0.0, 0.0, 1.0], v.device).expand(v.shape)
    return torch.where(ln > 1e-6, v / torch.clamp_min(ln, 1e-6), fallback)


def phase_axis(med: Medium, p: torch.Tensor):
    """Per-lane fiber axis at p, or None without an orientation volume."""
    if med.orientation is None:
        return None
    return orientation_at(med, p)


def density_at(med: Medium, p: torch.Tensor) -> torch.Tensor:
    """Trilinear density in the box, 0 outside."""
    if med.kind == MEDIUM_HGRID:
        return _density_hgrid(med, p)
    rel = _rel(med, p)
    d_, h_, w_ = med.density.shape
    g = med.density
    c = _trilinear(lambda z, y, x: g[z, y, x], _cell(rel[..., 0], w_), _cell(rel[..., 1], h_),
                   _cell(rel[..., 2], d_))
    return torch.where(_inside(rel), c, 0.0)


# ---------------------------------------------------------------------------
# homogeneous closed forms
# ---------------------------------------------------------------------------

def transmittance(med: Medium, dist: torch.Tensor) -> torch.Tensor:
    """Tr over straight segments of length dist: (N,3)."""
    return torch.exp(-med.sigma_t[None, :] * torch.clamp_max(dist, 1e30)[:, None])


def transmittance_grid(med: Medium, o, d, dist, u, steps: int = 32) -> torch.Tensor:
    """Jittered Riemann sum of the optical depth along each segment (u
    jitters the steps), for grid media."""
    dt = dist / steps
    ts = (torch.arange(steps, device=o.device)[None, :] + u[:, None]) * dt[:, None]
    pts = o[:, None, :] + d[:, None, :] * ts[..., None]
    dens = density_at(med, pts.reshape(-1, 3)).reshape(o.shape[0], steps)
    optical = (dens * dt[:, None]).sum(-1)
    return torch.exp(-med.sigma_t[None, :] * optical[:, None])


# ---------------------------------------------------------------------------
# grid media: weighted delta tracking and ratio tracking, each a fixed walk
# of TRACK_STEPS tentative collisions. A lane that exhausts the budget counts
# as reaching the surface with its weight so far (bias ~ P(more collisions
# than the budget), small when the budget covers several majorant
# mean free paths).
# ---------------------------------------------------------------------------

TRACK_STEPS = 48
MAJORANT_BOOST = 1.5


def _majorant(med: Medium):
    """Scalar majorant: max channel of sigma_t x max density x boost. The
    boost keeps the null-collision probability positive at the densest
    points, which the spectral history weights of the other channels need."""
    return torch.clamp_min(torch.max(med.sigma_t) * torch.max(med.density) * MAJORANT_BOOST,
                           1e-12)


def sample_distance_grid(med: Medium, u_fn, o, d, t_surface, steps: int = TRACK_STEPS):
    """Weighted delta tracking with spectral history weights; returns (t,
    is_medium, w_med (N,3), w_surf (N,3)) as sample_distance does. u_fn(j)
    gives (N,) uniforms, two per step. A tentative collision with density
    rho is real with probability sigma_ref rho / maj (sigma_ref: the mean
    channel); real collisions weight channel c by sigma_t_c / sigma_ref,
    null ones by (maj - sigma_t_c rho) / (maj - sigma_ref rho)."""
    n = o.shape[0]
    dev = o.device
    maj = _majorant(med)
    sigma_ref = torch.mean(med.sigma_t)
    t = torch.zeros((n,), device=dev)
    W = torch.ones((n, 3), device=dev)
    done_med = torch.zeros((n,), dtype=torch.bool, device=dev)
    done_surf = torch.zeros((n,), dtype=torch.bool, device=dev)
    for j in range(steps):
        step = -torch.log(torch.clamp_min(1.0 - u_fn(2 * j), 1e-38)) / maj
        t_new = t + step
        walking = ~(done_med | done_surf)
        reach_surf = walking & (t_new >= t_surface)
        done_surf = done_surf | reach_surf
        at = torch.minimum(t_new, t_surface)
        rho = density_at(med, o + d * at[:, None])
        p_real = torch.clamp(sigma_ref * rho / maj, 0.0, 1.0)
        real = walking & ~reach_surf & (u_fn(2 * j + 1) < p_real)
        w_real = m.safe_div(med.sigma_t[None, :] * rho[:, None],
                            torch.clamp_min(sigma_ref * rho, 1e-30)[:, None])
        denom = torch.clamp_min(maj - sigma_ref * rho, 1e-30)
        w_null = (maj - med.sigma_t[None, :] * rho[:, None]) / denom[:, None]
        upd = torch.where(real[:, None], w_real,
                          torch.where((walking & ~reach_surf)[:, None], w_null, 1.0))
        W = W * upd
        done_med = done_med | real
        t = torch.where(walking, at, t)
    sigma_s = med.sigma_t * med.albedo
    w_med = W * torch.where(med.sigma_t[None, :] > 0,
                            sigma_s[None, :] / torch.clamp_min(med.sigma_t[None, :], 1e-30), 0.0)
    return t, done_med, w_med, W


def transmittance_track(med: Medium, u_fn, o, d, dist, steps: int = TRACK_STEPS):
    """Ratio tracking: an unbiased spectral Tr estimate along each segment;
    u_fn(j) gives (N,) uniforms."""
    n = o.shape[0]
    dev = o.device
    maj = _majorant(med)
    t = torch.zeros((n,), device=dev)
    W = torch.ones((n, 3), device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    for j in range(steps):
        step = -torch.log(torch.clamp_min(1.0 - u_fn(j), 1e-38)) / maj
        t = t + torch.where(done, 0.0, step)
        done_new = done | (t >= dist)
        rho = density_at(med, o + d * torch.minimum(t, dist)[:, None])
        w_null = torch.clamp(1.0 - med.sigma_t[None, :] * rho[:, None] / maj, 0.0, 1.0)
        W = W * torch.where((~done_new)[:, None], w_null, 1.0)
        done = done_new
    return W


def sample_distance(med: Medium, u_chan: torch.Tensor, u_dist: torch.Tensor,
                    t_surface: torch.Tensor):
    """Spectral distance sampling with a uniformly chosen channel and the
    channel-averaged pdf; returns (t, is_medium, w_med (N,3), w_surf (N,3)):
    Tr sigma_s / pdf for a medium event, Tr / pdf for reaching the surface.

    The flight distance, the event split and both pdfs use the detached
    sigma_t, while Tr sigma_s stays attached: the pdf is then a pure
    importance weight, and the sigma_t and albedo gradients are unbiased
    with no boundary term from the event switch t < t_surface."""
    sig_d = med.sigma_t.detach()
    c = torch.clamp_max((u_chan * 3).to(torch.int64), 2)
    sig_c = sig_d[c]
    t = -torch.log(torch.clamp_min(1.0 - u_dist, 1e-38)) / torch.clamp_min(sig_c, 1e-20)
    is_medium = t < t_surface
    tr_t = torch.exp(-med.sigma_t[None, :] * t[:, None])
    # miss lanes carry t_surface ~ 1e30: the attached exponent is clamped so
    # its adjoint stays finite (their weight is 0 anyway)
    tr_s = torch.exp(-torch.clamp_max(med.sigma_t[None, :] * t_surface[:, None], 80.0))
    pdf_medium = torch.mean(sig_d[None, :] * tr_t.detach(), dim=-1)
    pdf_surface = torch.mean(tr_s.detach(), dim=-1)
    sigma_s = med.sigma_t * med.albedo
    w_med = tr_t * sigma_s[None, :] * (1.0 / torch.clamp_min(pdf_medium, 1e-30))[:, None]
    w_surf = tr_s * (1.0 / torch.clamp_min(pdf_surface, 1e-30))[:, None]
    return t, is_medium, w_med, w_surf
