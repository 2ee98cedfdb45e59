"""Spectral support: hero-wavelength sampling, CIE conversion, RGB->spectrum
upsampling, blackbody SPDs, Cauchy dispersion (port of core/spectrum.py).

Each camera sample draws one hero wavelength plus K-1 rotated companions
(Wilkie et al. 2014), every RGB quantity is lifted to those wavelengths on
the fly, and contributions resolve to RGB through the camera response.
The scene loader reads `planck` and `rgb_response` for <blackbody>; the
spectral integrator (ROADMAP A12) reads the rest.

Component choices, all analytic (no data tables):
  * CIE 1931 colour matching functions: the multi-lobe Gaussian fits of
    Wyman, Sloan & Shirley 2013 (JCGT), max error ~1% of peak.
  * RGB->spectrum: three fixed smooth bases (sigmoid red/blue, Gaussian
    green) whose mixing matrix against the camera response is inverted
    once at import (in numpy, as the JAX package does), so upsample(rgb)
    integrates back to rgb for in-gamut colours.
  * Blackbody: Planck's law, peak-normalised.
  * Dispersion: Cauchy n(lambda) = A + B/lambda^2, anchored so that
    n(589.3nm) equals the material's nominal eta.
"""
from __future__ import annotations

import numpy as np
import torch

from . import math as m

LAMBDA_MIN = 400.0
LAMBDA_MAX = 700.0
LAMBDA_RANGE = LAMBDA_MAX - LAMBDA_MIN
N_LAMBDA = 4            # hero + 3 rotated companions

# linear sRGB (D65) <-> CIE XYZ
XYZ_TO_SRGB = np.asarray([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252]], np.float64)

# np.trapz was renamed np.trapezoid in numpy 2.0 (same rule)
trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _gauss(x, alpha, mu, s1, s2):
    t = (x - mu) / torch.where(x < mu, s1, s2)
    return alpha * torch.exp(-0.5 * t * t)


def xyz_cmf(lam: torch.Tensor) -> torch.Tensor:
    """CIE 1931 2-deg observer xbar/ybar/zbar at lam (nm) -> (..., 3)
    (Wyman et al. 2013, multi-lobe fits)."""
    x = (_gauss(lam, 1.056, 599.8, 37.9, 31.0)
         + _gauss(lam, 0.362, 442.0, 16.0, 26.7)
         + _gauss(lam, -0.065, 501.1, 20.4, 26.2))
    y = (_gauss(lam, 0.821, 568.8, 46.9, 40.5)
         + _gauss(lam, 0.286, 530.9, 16.3, 31.1))
    z = (_gauss(lam, 1.217, 437.0, 11.8, 36.0)
         + _gauss(lam, 0.681, 459.0, 26.0, 13.8))
    return torch.stack([x, y, z], -1)


def _np_cmf(lam):
    def g(x, alpha, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return alpha * np.exp(-0.5 * ((x - mu) / s) ** 2)
    x = (g(lam, 1.056, 599.8, 37.9, 31.0) + g(lam, 0.362, 442.0, 16.0, 26.7)
         + g(lam, -0.065, 501.1, 20.4, 26.2))
    y = g(lam, 0.821, 568.8, 46.9, 40.5) + g(lam, 0.286, 530.9, 16.3, 31.1)
    z = g(lam, 1.217, 437.0, 11.8, 36.0) + g(lam, 0.681, 459.0, 26.0, 13.8)
    return np.stack([x, y, z], -1)


def _np_basis(lam):
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))  # noqa: E731
    br = sig((lam - 575.0) / 22.0)
    bg = np.exp(-0.5 * ((lam - 535.0) / 65.0) ** 2)
    bb = sig((465.0 - lam) / 22.0)
    return np.stack([br, bg, bb], -1)


def _calibrate():
    """Response normalisation + basis mixing matrices, by quadrature: the
    response is scaled so the white illuminant integrates to rgb (1,1,1);
    K[i,j] = integral response_i * basis_j is inverted so the illuminant
    upsampler round-trips; K_w calibrates the reflectance upsampler against
    the response weighted by the white illuminant spectrum."""
    lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 1024)
    cmf = _np_cmf(lam)                                  # (Q, 3)
    resp = cmf @ XYZ_TO_SRGB.T                          # (Q, 3) rgb response
    scale = trapezoid(cmf[:, 1], lam)
    resp = resp / scale
    basis = _np_basis(lam)                              # (Q, 3)
    K = np.empty((3, 3))
    for i in range(3):
        for j in range(3):
            K[i, j] = trapezoid(resp[:, i] * basis[:, j], lam)
    k_inv = np.linalg.inv(K)
    # white illuminant spectrum = the basis mix mapping to (1,1,1)
    s_white = basis @ (k_inv @ np.ones(3))              # (Q,)
    Kw = np.empty((3, 3))
    for i in range(3):
        for j in range(3):
            Kw[i, j] = trapezoid(resp[:, i] * s_white * basis[:, j], lam)
    return (np.float32(scale), k_inv.astype(np.float32),
            np.linalg.inv(Kw).astype(np.float32))


_Y_SCALE, _K_INV, _KW_INV = _calibrate()


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return m.const(a, like.device)


def rgb_response(lam: torch.Tensor) -> torch.Tensor:
    """Per-wavelength camera response: rgb weight density (..., 3) such
    that integrating response * spectrum over lam yields linear sRGB."""
    return xyz_cmf(lam) @ _const(XYZ_TO_SRGB.T, lam) / float(_Y_SCALE)


def sample_lambdas(u: torch.Tensor) -> torch.Tensor:
    """Hero-wavelength set: u (...,) in [0,1) -> (..., N_LAMBDA) nm. The
    hero is uniform; companions are equally rotated (Wilkie 2014)."""
    k = torch.arange(N_LAMBDA, dtype=torch.float32, device=u.device) / N_LAMBDA
    frac = torch.remainder(u[..., None] + k, 1.0)
    return LAMBDA_MIN + frac * LAMBDA_RANGE


LAMBDA_PDF = 1.0 / LAMBDA_RANGE


def _basis(lam):
    br = torch.sigmoid((lam - 575.0) / 22.0)
    bg = torch.exp(-0.5 * ((lam - 535.0) / 65.0) ** 2)
    bb = torch.sigmoid((465.0 - lam) / 22.0)
    return br, bg, bb


def upsample(rgb: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Lift linear-sRGB EMISSION rgb (..., 3) to spectral values at lam
    (..., K) -> (..., K); round-trips through rgb_response for in-gamut
    colours, clamped at 0 outside."""
    coeff = rgb @ _const(_K_INV.T, rgb)
    br, bg, bb = _basis(lam)
    s = coeff[..., 0:1] * br + coeff[..., 1:2] * bg + coeff[..., 2:3] * bb
    return torch.clamp_min(s, 0.0)


def upsample_reflectance(rgb: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Lift linear-sRGB REFLECTANCE rgb (..., 3): the grey part becomes a
    flat spectrum (products of greys stay grey through any number of
    bounces), the chromatic residual uses the white-calibrated basis mix."""
    w = torch.amin(rgb, dim=-1, keepdim=True)
    coeff = (rgb - w) @ _const(_KW_INV.T, rgb)
    br, bg, bb = _basis(lam)
    s = w + coeff[..., 0:1] * br + coeff[..., 1:2] * bg + coeff[..., 2:3] * bb
    return torch.clamp_min(s, 0.0)


def to_rgb(spec: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """MC estimator: spectral contributions spec (..., K) at lam (..., K)
    -> linear sRGB (..., 3), divided by the wavelength pdf and averaged
    over the K companions."""
    resp = rgb_response(lam)                            # (..., K, 3)
    return torch.sum(resp * spec[..., None], dim=-2) / (LAMBDA_PDF * N_LAMBDA)


def planck(lam: torch.Tensor, temperature: float) -> torch.Tensor:
    """Peak-normalised Planck SPD at lam nm (blackbody emitters)."""
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    lm = lam * 1e-9
    val = 1.0 / (lm ** 5 * (torch.exp(h * c / (lm * kb * temperature)) - 1.0))
    # Wien's law peak
    lpeak = 2.897771955e-3 / temperature
    peak = 1.0 / (lpeak ** 5 * (np.exp(h * c / (lpeak * kb * temperature)) - 1.0))
    return val / float(np.float32(peak))


def cauchy_eta(eta_nominal: torch.Tensor, cauchy_b_um2, lam: torch.Tensor) -> torch.Tensor:
    """Dispersive IOR n(lambda) = A + B / lambda_um^2 with A chosen so
    n(589.3nm) = eta_nominal (the sodium-D anchor convention)."""
    lam_um2 = (lam * 1e-3) ** 2
    a = eta_nominal - cauchy_b_um2 / (0.5893 ** 2)
    return a + cauchy_b_um2 / lam_um2
