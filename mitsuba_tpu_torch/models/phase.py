"""Phase functions: isotropic, Henyey-Greenstein, Rayleigh, Kajiya-Kay, a
two-component mixture and the fiber micro-flake (port of models/phase.py).

Directions follow the flow convention: `wi` points toward the previous
vertex (like a BSDF's wi), `wo` is the scattered direction; HG's cos theta
is taken between -wi and wo (forward scattering for g > 0). Every function
is batched and g is per lane (a 0-d tensor broadcasts).

The parameterised kinds read a static `params` tuple (Medium.phase_params):
  kkay:       (ax, ay, az, ks, kd, exponent), a constant fiber axis;
  mixture:    (kind_a, weight_a, g_a, kind_b, weight_b, g_b) of the analytic
              kinds;
  microflake: (ax, ay, az, stddev, norm, c1, sigma_t[16]) from
              make_microflake_params.
A per-lane `axis` (an orientation volume) overrides the static axis.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import math as m
from ..core.rng import uniform

INV_FOURPI = 1.0 / (4.0 * math.pi)

PHASE_ISOTROPIC = 0
PHASE_HG = 1
PHASE_RAYLEIGH = 2
PHASE_KKAY = 3
PHASE_MIXTURE = 4
PHASE_MICROFLAKE = 5

_MF_TABLE_N = 16          # sigma_t(cos theta) lookup resolution
_SQRT2 = np.float32(math.sqrt(2.0))


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return m.const(values, like.device)


def hg_eval(g, cos_theta: torch.Tensor) -> torch.Tensor:
    """HG density: (1 - g^2) / (4 pi (1 + g^2 - 2 g cos)^1.5)."""
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_theta
    return INV_FOURPI * (1.0 - g2) / torch.clamp_min(denom * torch.sqrt(denom), 1e-12)


def rayleigh_eval(cos_theta: torch.Tensor) -> torch.Tensor:
    return (3.0 / (16.0 * math.pi)) * (1.0 + cos_theta * cos_theta)


def _kkay_norm(exponent: float) -> float:
    """1 / (2 pi Int_0^pi sin^(e+1) theta dtheta), the closed form of the
    Wallis integral."""
    e = float(exponent)
    integral = (math.sqrt(math.pi) * math.gamma(0.5 * e + 1.0)
                / math.gamma(0.5 * e + 1.5))
    return 1.0 / (2.0 * math.pi * integral)


def kkay_eval(params, wi: torch.Tensor, wo: torch.Tensor, axis=None) -> torch.Tensor:
    """Kajiya-Kay fiber phase: kd / 4 pi plus a specular cone about the
    fiber axis (wo's component along the axis replaced by the mirrored -wi
    one, renormalised, raised to the exponent)."""
    ax, ay, az, ks, kd, exponent = params
    if axis is None:
        axis = m.normalize(_const([ax, ay, az], wi))
    wo_par = m.dot(wo, axis)
    perp = wo - wo_par[..., None] * axis
    refl_par = -m.dot(wi, axis)
    a = torch.sqrt(m.safe_div(1.0 - refl_par * refl_par,
                              torch.clamp_min(m.dot(perp, perp), 1e-12)))
    r_vec = perp * a[..., None] + refl_par[..., None] * axis
    spec = torch.clamp_min(m.dot(r_vec, wo), 0.0) ** exponent
    return spec * (_kkay_norm(exponent) * ks) + kd * INV_FOURPI


def make_microflake_params(stddev: float, axis=(0.0, 0.0, 1.0)) -> tuple:
    """The static parameter tuple of the Gaussian-fiber micro-flake phase
    (flake density D(m) = norm exp(-m_z^2 / 2 s^2) in the fiber frame): the
    projected area sigma_t(cos theta) integrated by quadrature on the host
    into a 16-entry table."""
    s = float(stddev)
    if not (0.01 <= s <= 1.0):
        raise ValueError("microflake stddev must be in [0.01, 1]")
    erf = math.erf(1.0 / (math.sqrt(2.0) * s))
    norm = 1.0 / ((2.0 * math.pi) ** 1.5 * s * erf)
    c1 = 1.0 / erf

    # sigma_t(cos theta_w) = Int_sphere D(m) |m . w| dm, azimuthally symmetric
    nq, nphi = 256, 256
    mu, wq = np.polynomial.legendre.leggauss(nq)       # m_z in (-1, 1)
    phi = (np.arange(nphi) + 0.5) * (2 * np.pi / nphi)
    sin_m = np.sqrt(np.maximum(1 - mu * mu, 0))
    d_density = norm * np.exp(-mu * mu / (2 * s * s))
    table = []
    for i in range(_MF_TABLE_N):
        ct = i / (_MF_TABLE_N - 1)
        st = np.sqrt(max(1 - ct * ct, 0.0))
        dots = np.abs(sin_m[:, None] * np.cos(phi)[None, :] * st + mu[:, None] * ct)
        table.append(float(np.sum(wq[:, None] * d_density[:, None] * dots)
                           * (2 * np.pi / nphi)))
    ax = np.asarray(axis, np.float64)
    ax = ax / max(np.linalg.norm(ax), 1e-12)
    return (float(ax[0]), float(ax[1]), float(ax[2]), s, norm, c1, *table)


def _mf_sigma_t(params, cos_theta: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of the projected-area table at |cos theta|."""
    tab = _const(params[6:6 + _MF_TABLE_N], cos_theta)
    x = torch.abs(cos_theta) * (_MF_TABLE_N - 1)
    i0 = torch.clamp(x.to(torch.int64), 0, _MF_TABLE_N - 2)
    f = x - i0
    return tab[i0] * (1.0 - f) + tab[i0 + 1] * f


def _mf_axis(params, wi, axis):
    if axis is None:
        return m.normalize(_const(params[0:3], wi)).expand(wi.shape)
    return axis


def _microflake_eval(params, wi, wo, axis=None):
    """0.5 D(cos theta_h) / sigma_t(cos theta_wi) in the fiber frame, which
    is also the sampling pdf."""
    s, norm = params[3], params[4]
    axis = _mf_axis(params, wi, axis)
    wi_l = m.to_local(axis, wi)
    wo_l = m.to_local(axis, wo)
    h = wi_l + wo_l
    hlen = m.length(h)
    cos_h = m.safe_div(h[..., 2], torch.clamp_min(hlen, 1e-9))
    d_h = norm * torch.exp(-cos_h * cos_h / (2.0 * s * s))
    sig = torch.clamp_min(_mf_sigma_t(params, wi_l[..., 2]), 1e-9)
    return torch.where(hlen > 1e-9, 0.5 * d_h / sig, 0.0)


def _microflake_sample(params, wi, u2, n_tries: int = 16, axis=None):
    """Flake-normal sampling: cos theta_m inverts the longitudinal CDF in
    closed form through erfinv, and the |wi . m| rejection runs as n_tries
    candidates, counter-hashed from the two uniforms, with the first
    accepted one kept."""
    s, c1 = params[3], params[5]
    axis = _mf_axis(params, wi, axis)
    wi_l = m.to_local(axis, wi)
    b0 = (u2[..., 0] * 16777216.0).to(torch.int64)
    b1 = (u2[..., 1] * 16777216.0).to(torch.int64)

    best_wo = torch.zeros(u2.shape[:-1] + (3,), dtype=wi.dtype, device=wi.device)
    accepted = torch.zeros(u2.shape[:-1], dtype=torch.bool, device=wi.device)
    sqrt2 = _const(_SQRT2, wi)
    for t in range(n_tries):
        xi = uniform(b0, b1, 3 * t)
        up = uniform(b0, b1, 3 * t + 1)
        ua = uniform(b0, b1, 3 * t + 2)
        arg = torch.clamp((1.0 - 2.0 * xi) / c1, -0.999999, 0.999999)
        ct = torch.clamp(sqrt2 * s * torch.special.erfinv(arg), -1.0, 1.0)
        st = m.safe_sqrt(1.0 - ct * ct)
        phi = 2.0 * math.pi * up
        h = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
        dp = m.dot(wi_l, h)
        ok = (ua < torch.abs(dp)) & ~accepted
        wo_l = h * (2.0 * dp)[..., None] - wi_l
        best_wo = torch.where(ok[..., None], wo_l, best_wo)
        accepted = accepted | ok

    wo = m.to_world(axis, best_wo)
    pdf = torch.where(accepted, _microflake_eval(params, wi, wo, axis), 0.0)
    return wo, pdf


def eval_pdf(kind: int, g, wi: torch.Tensor, wo: torch.Tensor,
             params: tuple = (), axis=None):
    """(value, pdf): equal for the exactly sampled kinds; kkay is sampled
    uniformly, so its pdf is 1 / 4 pi."""
    ct = m.dot(-wi, wo)
    if kind == PHASE_ISOTROPIC:
        v = torch.full(ct.shape, INV_FOURPI, dtype=ct.dtype, device=ct.device)
        return v, v
    if kind == PHASE_HG:
        v = hg_eval(g, ct)
        return v, v
    if kind == PHASE_RAYLEIGH:
        v = rayleigh_eval(ct)
        return v, v
    if kind == PHASE_KKAY:
        v = kkay_eval(params, wi, wo, axis)
        return v, torch.full(ct.shape, INV_FOURPI, dtype=ct.dtype, device=ct.device)
    if kind == PHASE_MICROFLAKE:
        v = _microflake_eval(params, wi, wo, axis)
        return v, v
    if kind == PHASE_MIXTURE:
        ka, wa, ga, kb, wb, gb = params
        va, pa = eval_pdf(int(ka), _const(ga, wi), wi, wo)
        vb, pb = eval_pdf(int(kb), _const(gb, wi), wi, wo)
        return va * wa + vb * wb, (pa * wa + pb * wb) / (wa + wb)
    raise ValueError(f"unknown phase kind {kind}")


def _uniform_sphere(u2):
    z = 1.0 - 2.0 * u2[..., 0]
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u2[..., 1]
    wo = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
    return wo, torch.full(u2.shape[:-1], INV_FOURPI, dtype=u2.dtype, device=u2.device)


def _about(wi, ct, u1):
    """The direction at cos theta = ct about -wi, azimuth 2 pi u1."""
    st = m.safe_sqrt(1.0 - ct * ct)
    phi = 2.0 * math.pi * u1
    local = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
    return m.to_world(-wi, local)


def sample(kind: int, g, wi: torch.Tensor, u2: torch.Tensor,
           params: tuple = (), axis=None):
    """wo ~ phase(-wi, .). Returns (wo, pdf); kkay and mixture callers apply
    value / pdf (sample_weight)."""
    if kind in (PHASE_KKAY, PHASE_ISOTROPIC):
        return _uniform_sphere(u2)
    if kind == PHASE_MICROFLAKE:
        return _microflake_sample(params, wi, u2, axis=axis)
    if kind == PHASE_MIXTURE:
        ka, wa, ga, kb, wb, gb = params
        p_a = wa / (wa + wb)
        pick_a = u2[..., 0] < p_a
        # the selection number, rescaled, is again uniform on [0, 1)
        u0 = torch.where(pick_a, u2[..., 0] / p_a,
                         (u2[..., 0] - p_a) / max(1.0 - p_a, 1e-9))
        u2r = torch.stack([u0, u2[..., 1]], -1)
        wo_a, _ = sample(int(ka), _const(ga, wi), wi, u2r)
        wo_b, _ = sample(int(kb), _const(gb, wi), wi, u2r)
        wo = torch.where(pick_a[..., None], wo_a, wo_b)
        _, pdf = eval_pdf(kind, g, wi, wo, params)
        return wo, pdf
    if kind == PHASE_HG:
        # exact inversion; the isotropic limit for |g| -> 0
        small = torch.abs(g) < 1e-4
        g_safe = torch.where(small, 1e-4, g)
        sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u2[..., 0])
        ct_hg = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
        ct = torch.clamp(torch.where(small, 1.0 - 2.0 * u2[..., 0], ct_hg), -1.0, 1.0)
        return _about(wi, ct, u2[..., 1]), hg_eval(g, ct)
    if kind == PHASE_RAYLEIGH:
        # z^3 + 3z = 4(1 - 2u) by Cardano
        z = 2.0 * (2.0 * u2[..., 0] - 1.0)
        w_ = z + torch.sqrt(z * z + 1.0)
        cbrt = torch.sign(w_) * torch.abs(w_) ** (1.0 / 3.0)
        ct = torch.clamp(cbrt - 1.0 / cbrt, -1.0, 1.0)
        return _about(wi, ct, u2[..., 1]), rayleigh_eval(ct)
    raise ValueError(f"unknown phase kind {kind}")


def sample_weight(kind: int, g, wi: torch.Tensor, wo: torch.Tensor,
                  pdf: torch.Tensor, params: tuple = (), axis=None) -> torch.Tensor:
    """The throughput factor value / pdf of a direction drawn by sample():
    1 for the exactly sampled kinds (microflake included: pdf == value, and
    a lane that rejected every candidate has pdf 0)."""
    if kind in (PHASE_ISOTROPIC, PHASE_HG, PHASE_RAYLEIGH, PHASE_MICROFLAKE):
        return torch.ones_like(pdf)
    v, _ = eval_pdf(kind, g, wi, wo, params, axis)
    return m.safe_div(v, torch.clamp_min(pdf, 1e-12))
