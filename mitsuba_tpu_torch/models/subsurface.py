"""Dipole subsurface scattering, Jensen et al. 2001 (port of
models/subsurface.py).

The analog of src/subsurface/dipole.cpp: the irradiance cache is a flat
batch of area-weighted surface points (blue-noise darts on the host, as
bluenoise.cpp) whose irradiance is one NEE pass through ops/trace.py, and
the render-time gather sums the dipole profile over every cache point,
chunked over the query points so that the (queries, points, 3) profile
stays a few hundred MB.

Dipole BSSRDF:
  sigma_tr = sqrt(3 sigma_a sigma_t')
  z_r = 1/sigma_t';  z_v = z_r (1 + 4/3 A)
  Rd(r) = alpha'/(4 pi) * [ z_r (1+s_r d_r) e^{-s_r d_r} / d_r^3
                          + z_v (1+s_r d_v) e^{-s_r d_v} / d_v^3 ]
with d_r = sqrt(r^2 + z_r^2), d_v = sqrt(r^2 + z_v^2), s_r = sigma_tr.

The single-scattering term (singlescatter.cpp) connects a scatter point
below the surface to a light sample, classically along the straight ray
or, with exact_nee, through the refracted connection point on the local
tangent plane (a 28-step bisection) with the Jacobian of the bent path.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core.rng import uniform
from ..models import emitter as emitterlib
from ..ops import trace

# (query, cache point) pairs of one chunk of the gather: 2^22 pairs, ~50 MB
# a (pairs, 3) float32 temporary
GATHER_PAIRS = 1 << 22


class DipoleParams(NamedTuple):
    sigma_s: torch.Tensor   # (3,) scattering
    sigma_a: torch.Tensor   # (3,) absorption
    g: float                # phase asymmetry (reduces sigma_s)
    eta: float              # relative IOR


def _dipole_constants(p: DipoleParams):
    sigma_sp = p.sigma_s * (1.0 - p.g)
    sigma_tp = sigma_sp + p.sigma_a
    alpha_p = sigma_sp / torch.clamp_min(sigma_tp, 1e-9)
    sigma_tr = torch.sqrt(3.0 * p.sigma_a * sigma_tp)
    # internal diffuse Fresnel reflectance (dipole.cpp's Fdr fit)
    eta = p.eta
    fdr = -1.440 / (eta * eta) + 0.710 / eta + 0.668 + 0.0636 * eta
    a_coef = (1.0 + fdr) / (1.0 - fdr)
    z_r = 1.0 / torch.clamp_min(sigma_tp, 1e-9)
    z_v = z_r * (1.0 + 4.0 / 3.0 * a_coef)
    return alpha_p, sigma_tr, z_r, z_v


def rd_profile(p: DipoleParams, r: torch.Tensor) -> torch.Tensor:
    """Diffusion profile Rd(r): (N,) radii -> (N, 3)."""
    alpha_p, sigma_tr, z_r, z_v = _dipole_constants(p)
    r2 = (r * r)[:, None]
    d_r = torch.sqrt(r2 + z_r[None, :] ** 2)
    d_v = torch.sqrt(r2 + z_v[None, :] ** 2)
    s = sigma_tr[None, :]
    c1 = z_r[None, :] * (1.0 + s * d_r) * torch.exp(-s * d_r) / torch.clamp_min(d_r ** 3, 1e-12)
    c2 = z_v[None, :] * (1.0 + s * d_v) * torch.exp(-s * d_v) / torch.clamp_min(d_v ** 3, 1e-12)
    return alpha_p[None, :] / (4.0 * math.pi) * (c1 + c2)


def sample_surface_points(scene, tri_mask: np.ndarray, n_points: int, seed: int = 0,
                          blue_noise: bool = True):
    """Blue-noise points on the masked triangles, on the host
    (bluenoise.cpp blueNoisePointSet: dart throwing with a spatial hash
    against a Poisson-disk radius from the target density), the JAX
    package's numpy code: the same RandomState draws give the same points.
    Returns (points, normals, area_per_point), tensors on the scene's
    device; the count can fall a little under n_points (the darts that
    landed), which area_per_point accounts for. blue_noise=False takes
    plain area-stratified samples."""
    rs = np.random.RandomState(seed)
    verts = scene.vertices.detach().cpu().numpy()
    idx = scene.indices.cpu().numpy()[tri_mask]
    p0 = verts[idx[:, 0]]
    e1 = verts[idx[:, 1]] - p0
    e2 = verts[idx[:, 2]] - p0
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    total_area = areas.sum()
    probs = areas / total_area
    dev = scene.device

    def area_sample(k):
        tri = rs.choice(len(idx), size=k, p=probs)
        u = rs.rand(k, 2).astype(np.float32)
        su = np.sqrt(u[:, 0])
        b1 = (1 - su)
        b2 = u[:, 1] * su
        pts = p0[tri] + e1[tri] * b1[:, None] + e2[tri] * b2[:, None]
        n = np.cross(e1[tri], e2[tri])
        n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
        return pts, n

    if not blue_noise:
        pts, n = area_sample(n_points)
        return (torch.as_tensor(pts.astype(np.float32), device=dev),
                torch.as_tensor(n.astype(np.float32), device=dev),
                float(total_area / n_points))

    # Poisson-disk radius for n_points disks over total_area at ~70% of the
    # hexagonal-packing bound (bluenoise.cpp's density -> radius); greedy
    # darts over 4x oversampled area-stratified candidates, a cell hash
    r = 0.7 * np.sqrt(total_area / (2.0 * np.sqrt(3.0) * n_points))
    cand_pts, cand_n = area_sample(4 * n_points)
    cell = r / np.sqrt(3.0)
    keys = np.floor(cand_pts / cell).astype(np.int64)
    grid: dict = {}
    acc_pts, acc_n = [], []
    r2 = r * r
    for i in range(len(cand_pts)):
        c = keys[i]
        p = cand_pts[i]
        ok = True
        for dx in (-2, -1, 0, 1, 2):
            for dy in (-2, -1, 0, 1, 2):
                for dz in (-2, -1, 0, 1, 2):
                    for j in grid.get((c[0] + dx, c[1] + dy, c[2] + dz), ()):
                        dvec = p - acc_pts[j]
                        if dvec @ dvec < r2:
                            ok = False
                            break
                    if not ok:
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            grid.setdefault(tuple(c), []).append(len(acc_pts))
            acc_pts.append(p)
            acc_n.append(cand_n[i])
            if len(acc_pts) >= n_points:
                break
    pts = np.asarray(acc_pts, np.float32)
    n = np.asarray(acc_n, np.float32)
    return (torch.as_tensor(pts, device=dev), torch.as_tensor(n, device=dev),
            float(total_area / len(pts)))


def compute_irradiance(scene, pts, nrm, cfg, n_samples: int = 8):
    """NEE irradiance estimate at the cache points (dipole.cpp's irrtree
    fill pass): one emitter sample and one any-hit a point and sample."""
    npts = pts.shape[0]
    seed = cfg.seed ^ 0xD1901E
    E = torch.zeros((npts, 3), dtype=torch.float32, device=pts.device)
    pid = torch.arange(npts, dtype=torch.int64, device=pts.device)
    for k in range(n_samples):
        u3 = torch.stack([uniform(seed, pid, k, j) for j in range(3)], -1)
        ds = emitterlib.sample_direct(scene, pts, u3)
        cos_i = torch.clamp_min(m.dot(ds.d, nrm), 0.0)
        blocked = trace.any_hit(scene, pts, ds.d, ds.dist)
        ok = (ds.pdf > 0) & ~blocked & (cos_i > 0)
        E = E + torch.where(ok[:, None],
                            ds.radiance * (cos_i / torch.clamp_min(ds.pdf, 1e-12))[:, None],
                            0.0)
    return E / n_samples


def _eta(eta, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(eta, dtype=torch.float32, device=like.device)


def sss_exitant_radiance(params: DipoleParams, cache_pts, cache_E, area_per_point,
                         query_p, query_ns, wo_world):
    """Outgoing radiance at the query points from the dipole gather:
    Lo = (1 - Ft(wo))/pi * sum_i Rd(|x - x_i|) E_i A_i (dipole.cpp Lo).
    The (queries, points) pairs are formed GATHER_PAIRS at a time; each
    query's sum runs over all points at once, as in one dense gather."""
    ft_o, _, _, _ = m.fresnel_dielectric(
        torch.clamp_min(m.dot(wo_world, query_ns), 0.0), _eta(params.eta, query_p))
    p = cache_pts.shape[0]
    step = max(1, GATHER_PAIRS // max(p, 1))
    parts = []
    for q0 in range(0, query_p.shape[0], step):
        qp = query_p[q0:q0 + step]
        dvec = qp[:, None, :] - cache_pts[None, :, :]
        r = torch.sqrt(torch.clamp_min(torch.sum(dvec * dvec, -1), 1e-12))
        rd = rd_profile(params, r.reshape(-1)).reshape(qp.shape[0], p, 3)
        parts.append((rd * cache_E[None, :, :]).sum(1) * area_per_point)
    mo = torch.cat(parts) if parts else torch.zeros_like(query_p)
    return (1.0 - ft_o)[:, None] / math.pi * mo


def _refracted_connection(eta, h, H, d_xy, iters: int = 28):
    """The planar refracted-connection root (Walter et al. 2009 /
    singlescatter.cpp on the local tangent plane): the in-plane offset r
    of the exit point between the scatter point (depth h below the
    interface) and the light point (height H above, horizontal distance
    d_xy) with Snell's law

        eta * r / sqrt(r^2 + h^2) = (d_xy - r) / sqrt((d_xy-r)^2 + H^2).

    f is monotone on [0, d_xy] with f(0) <= 0 <= f(d_xy), so `iters`
    bisection steps (never fewer) converge; at the root sin(theta_out) =
    eta sin(theta_in) <= 1. Returns (r, df/dr at r): the derivative feeds
    the implicit-function Jacobian (bisection's own derivative is zero)."""

    def f(r):
        return (eta * r / torch.sqrt(r * r + h * h)
                - (d_xy - r) / torch.sqrt((d_xy - r) ** 2 + H * H))

    lo = torch.zeros_like(d_xy)
    hi = d_xy
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        neg = f(mid) < 0.0
        lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
    r = 0.5 * (lo + hi)
    df = (eta * h * h / torch.clamp_min((r * r + h * h) ** 1.5, 1e-20)
          + H * H / torch.clamp_min(((d_xy - r) ** 2 + H * H) ** 1.5, 1e-20))
    return r, df


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, -1))


def single_scatter_radiance(params: DipoleParams, scene, query_p, query_ns, wo_world, cfg,
                            n_samples: int = 4, seed_salt: int = 0x515C,
                            exact_nee: bool = True):
    """Single-scattering BSSRDF term (singlescatter.cpp; Jensen et al. 2001
    eq. 12): refract the outgoing ray into the medium, sample a scatter
    depth s' ~ exp(sigma_t), connect to a light, attenuate by
    exp(-sigma_t (s' + s_i)) and both Fresnel transmittances.

    exact_nee=True solves for the exact refracted connection point on the
    local tangent plane at the entry point (_refracted_connection) with the
    area-to-solid-angle Jacobian from implicit differentiation of Snell's
    condition. Samples fall back to Jensen's classical straight-ray
    connection for env and delta lights, lights below the interface and
    points where the real boundary departs >10% from the tangent plane."""
    n = query_p.shape[0]
    dev = query_p.device
    eta = params.eta
    eta_t = _eta(eta, query_p)
    sigma_t = params.sigma_s + params.sigma_a
    sig_mean = torch.mean(sigma_t)
    pid = torch.arange(n, dtype=torch.int64, device=dev)
    seed = cfg.seed ^ seed_salt

    # refract wo into the medium (entering: eta_ti = 1/eta)
    ci = torch.clamp_min(m.dot(wo_world, query_ns), 1e-4)
    ft_o, _, _, _ = m.fresnel_dielectric(ci, eta_t)
    sin2_t = (1.0 / eta) ** 2 * torch.clamp_min(1.0 - ci * ci, 0.0)
    cos_in = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    perp = m.normalize(wo_world - query_ns * ci[:, None])
    w_t = -(perp * torch.sqrt(sin2_t)[:, None] + query_ns * cos_in[:, None])

    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for k in range(n_samples):
        def u(j, _k=k):
            return uniform(seed, pid, _k, j)

        s_prime = -torch.log(torch.clamp_min(1.0 - u(0), 1e-20)) / sig_mean
        pdf_s = sig_mean * torch.exp(-sig_mean * s_prime)
        x_s = query_p + w_t * s_prime[:, None]
        u3 = torch.stack([u(1), u(2), u(3)], -1)
        ds = emitterlib.sample_direct(scene, x_s, u3)
        # the classical straight-ray connection (the fallback)
        its = trace.closest_hit(scene, x_s, ds.d)
        s_obs = torch.where(its.valid, its.t, 0.0)
        cos_l = torch.clamp_min(m.dot(ds.d, query_ns), 1e-4)
        denom = torch.sqrt(torch.clamp_min(
            1.0 - (1.0 / eta) ** 2 * (1.0 - cos_l * cos_l), 1e-6))
        s_in = s_obs * cos_l / denom
        ft_i, _, _, _ = m.fresnel_dielectric(cos_l, eta_t)
        exit_p = x_s + ds.d * (s_obs + 1e-3)[:, None]
        blocked = trace.any_hit(scene, exit_p, ds.d, torch.clamp_min(ds.dist - s_obs, 1e-3))
        # the isotropic phase function (g is folded into sigma_s' upstream)
        phase = 1.0 / (4.0 * math.pi)
        atten = torch.exp(-sigma_t[None, :] * (s_prime + s_in)[:, None])
        w = (params.sigma_s[None, :] * phase * atten
             * ((1.0 - ft_i) * (1.0 - ft_o)
                * m.safe_div(1.0, pdf_s * torch.clamp_min(ds.pdf, 1e-12)))[:, None])
        ok = (ds.pdf > 0) & ~blocked & its.valid
        contrib = torch.where(ok[:, None], w * ds.radiance, 0.0)

        if exact_nee:
            contrib_e, ok_e = _exact_nee_contrib(params, scene, query_p, query_ns, x_s, ds,
                                                 s_prime, pdf_s, ft_o, sigma_t, eta)
            contrib = torch.where(ok_e[:, None], contrib_e, contrib)
        L = L + contrib
    return L / n_samples


def _exact_nee_contrib(params, scene, query_p, query_ns, x_s, ds, s_prime, pdf_s, ft_o,
                       sigma_t, eta):
    """The exact refracted-connection NEE contribution of area-light
    samples (single_scatter_radiance). Returns (contrib (N,3), valid
    (N,))."""
    nrm = query_ns
    y = x_s + ds.d * ds.dist[:, None]
    h = torch.sum((query_p - x_s) * nrm, -1)
    H = torch.sum((y - query_p) * nrm, -1)
    rel = y - x_s
    vxy = rel - torch.sum(rel * nrm, -1, keepdim=True) * nrm
    d_xy = _norm(vxy)
    what = vxy / torch.clamp_min(d_xy, 1e-12)[:, None]
    h_s = torch.clamp_min(h, 1e-5)
    H_s = torch.clamp_min(H, 1e-5)
    r, dfdr = _refracted_connection(eta, h_s, H_s, d_xy)
    s_i = torch.sqrt(r * r + h_s * h_s)
    q = d_xy - r
    s_o = torch.sqrt(q * q + H_s * H_s)
    cos_o = H_s / s_o
    x_e = x_s + what * r[:, None] + nrm * h_s[:, None]
    w_in = (x_e - x_s) / torch.clamp_min(s_i, 1e-9)[:, None]
    w_out = (y - x_e) / torch.clamp_min(s_o, 1e-9)[:, None]

    # the real boundary along the bent inside leg must sit close to the
    # tangent plane, else the classical estimate stands
    its_b = trace.closest_hit(scene, x_s, w_in)
    planar_ok = its_b.valid & (torch.abs(its_b.t - s_i) < 0.1 * torch.clamp_min(s_i, 1e-4))
    blocked = trace.any_hit(scene, x_e + nrm * 1e-3, w_out, torch.clamp_min(s_o - 2e-3, 1e-3))

    ft_e, _, _, _ = m.fresnel_dielectric(torch.clamp_min(cos_o, 1e-4), _eta(eta, x_s))

    # |d omega_in / dA_y| by implicit differentiation of the Snell root: for
    # a light-plane tangent t_k,
    #   df = df/d(d_xy) * dd_xy + df/dH * dH;  dr = -df / (df/dr)
    #   dx_e = what * dr + dwhat * r;  domega = P_perp(dx_e) / s_i
    denom3 = torch.clamp_min((q * q + H_s * H_s) ** 1.5, 1e-20)
    df_ddxy = -(H_s * H_s) / denom3
    df_dH = q * H_s / denom3
    t1, t2 = m.coordinate_system(torch.where(_norm(ds.n_l)[:, None] > 0.5, ds.n_l, nrm))

    def domega(tk):
        dH = torch.sum(tk * nrm, -1)
        dvxy = tk - dH[:, None] * nrm
        dd_xy = torch.sum(what * dvxy, -1)
        dwhat = (dvxy - what * dd_xy[:, None]) / torch.clamp_min(d_xy, 1e-9)[:, None]
        dr = -(df_ddxy * dd_xy + df_dH * dH) / torch.clamp_min(dfdr, 1e-12)
        dx_e = what * dr[:, None] + dwhat * r[:, None]
        return ((dx_e - w_in * torch.sum(w_in * dx_e, -1, keepdim=True))
                / torch.clamp_min(s_i, 1e-9)[:, None])

    J = _norm(torch.linalg.cross(domega(t1), domega(t2)))

    cos_ly = torch.abs(torch.sum(ds.d * ds.n_l, -1))
    p_area = ds.pdf * cos_ly / torch.clamp_min(ds.dist * ds.dist, 1e-12)

    phase = 1.0 / (4.0 * math.pi)
    atten = torch.exp(-sigma_t[None, :] * (s_prime + s_i)[:, None])
    contrib = (params.sigma_s[None, :] * phase * atten * ds.radiance
               * ((1.0 - ft_e) * (1.0 - ft_o) * J
                  * m.safe_div(1.0, pdf_s * torch.clamp_min(p_area, 1e-14)))[:, None])
    valid = (~ds.is_env & ~ds.is_delta & (ds.pdf > 0)
             & (H > 1e-4) & (h > 1e-5) & (cos_ly > 1e-4)
             & planar_ok & ~blocked & torch.isfinite(J) & (J > 0))
    return contrib, valid
