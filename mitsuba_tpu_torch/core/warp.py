"""Sample warping: [0,1)^2 -> triangles, disks, hemispheres, spheres,
cones and microfacet, vMF and Phong lobes, each with its pdf (port of
core/warp.py), so that `sample` and `pdf` can be chi-square tested
against each other (utils/chi2.py)."""
from __future__ import annotations

import math

import torch

from . import math as m

INV_PI = 1.0 / math.pi
INV_TWOPI = 0.5 / math.pi
INV_FOURPI = 0.25 / math.pi


def square_to_uniform_sphere(u: torch.Tensor) -> torch.Tensor:
    z = 1.0 - 2.0 * u[..., 0]
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_sphere_pdf():
    return INV_FOURPI


def square_to_uniform_hemisphere(u: torch.Tensor) -> torch.Tensor:
    z = u[..., 0]
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_hemisphere_pdf():
    return INV_TWOPI


def square_to_uniform_disk(u: torch.Tensor) -> torch.Tensor:
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_uniform_disk_concentric(u: torch.Tensor) -> torch.Tensor:
    """Shirley-Chiu concentric mapping, branchless."""
    x = 2.0 * u[..., 0] - 1.0
    y = 2.0 * u[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quad1 = torch.abs(x) > torch.abs(y)
    r = torch.where(quad1, x, y)
    safe_r = torch.where(is_zero, 1.0, r)
    phi = torch.where(
        quad1,
        (math.pi / 4.0) * m.safe_div(y, safe_r),
        (math.pi / 2.0) - (math.pi / 4.0) * m.safe_div(x, safe_r),
    )
    r = torch.where(is_zero, 0.0, r)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_cosine_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Concentric-disk lift."""
    d = square_to_uniform_disk_concentric(u)
    dx, dy = d[..., 0], d[..., 1]
    z = m.safe_sqrt(1.0 - dx * dx - dy * dy)
    return torch.stack([dx, dy, z], dim=-1)


def square_to_cosine_hemisphere_pdf(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(v[..., 2], 0.0) * INV_PI


def square_to_uniform_cone(u: torch.Tensor, cos_cutoff) -> torch.Tensor:
    """Uniform direction inside a cone around +z."""
    z = 1.0 - u[..., 0] * (1.0 - cos_cutoff)
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_cone_pdf(cos_cutoff) -> torch.Tensor:
    return INV_TWOPI / (1.0 - cos_cutoff)


def square_to_uniform_triangle(u: torch.Tensor) -> torch.Tensor:
    """Barycentric warp: returns (b1, b2)."""
    a = m.safe_sqrt(1.0 - u[..., 0])
    return torch.stack([1.0 - a, a * u[..., 1]], dim=-1)


def square_to_std_normal(u: torch.Tensor) -> torch.Tensor:
    """Box-Muller."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(1.0 - u[..., 0], 1e-20)))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_tent(u: torch.Tensor) -> torch.Tensor:
    """1D tent over [-1, 1] applied per component."""
    return torch.where(u < 0.5, torch.sqrt(2.0 * u) - 1.0, 1.0 - torch.sqrt(2.0 - 2.0 * u))


def square_to_beckmann(u: torch.Tensor, alpha) -> torch.Tensor:
    """Beckmann-distributed microfacet normal."""
    phi = 2.0 * math.pi * u[..., 1]
    tan2 = -alpha * alpha * torch.log(torch.clamp_min(1.0 - u[..., 0], 1e-20))
    ct = 1.0 / torch.sqrt(1.0 + tan2)
    st = m.safe_sqrt(1.0 - ct * ct)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def square_to_beckmann_pdf(v: torch.Tensor, alpha) -> torch.Tensor:
    ct = v[..., 2]
    t2 = m.safe_div(m.sin_theta2(v), ct * ct)
    pdf = INV_PI / (alpha * alpha * ct * ct * ct) * torch.exp(-t2 / (alpha * alpha))
    return torch.where(ct > 1e-9, pdf, 0.0)


def square_to_ggx(u: torch.Tensor, alpha) -> torch.Tensor:
    """GGX (Trowbridge-Reitz) distributed half vector."""
    phi = 2.0 * math.pi * u[..., 1]
    tan2 = alpha * alpha * u[..., 0] / torch.clamp_min(1.0 - u[..., 0], 1e-20)
    ct = 1.0 / torch.sqrt(1.0 + tan2)
    st = m.safe_sqrt(1.0 - ct * ct)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def square_to_ggx_pdf(v: torch.Tensor, alpha) -> torch.Tensor:
    ct = v[..., 2]
    a2 = alpha * alpha
    denom = ct * ct * (a2 - 1.0) + 1.0
    pdf = a2 * ct * INV_PI / torch.clamp_min(denom * denom, 1e-20)
    return torch.where(ct > 1e-9, pdf, 0.0)


def square_to_von_mises_fisher(u: torch.Tensor, kappa) -> torch.Tensor:
    """vMF around +z: w = 1 + log(max(u0 + (1 - u0) e^{-2 kappa}, 1e-30)) / kappa,
    in the JAX package's order of operations."""
    e = torch.exp(torch.as_tensor(-2.0 * kappa, dtype=torch.float32, device=u.device))
    w = 1.0 + torch.log(torch.clamp_min(u[..., 0] + (1.0 - u[..., 0]) * e, 1e-30)) / kappa
    r = m.safe_sqrt(1.0 - w * w)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), w], dim=-1)


def square_to_von_mises_fisher_pdf(v: torch.Tensor, kappa) -> torch.Tensor:
    """kappa / (2 pi (1 - e^{-2 kappa})) e^{kappa (cos - 1)}."""
    e = torch.exp(torch.as_tensor(-2.0 * kappa, dtype=torch.float32, device=v.device))
    norm = kappa / (2.0 * math.pi * (1.0 - e))
    return norm * torch.exp(kappa * (v[..., 2] - 1.0))


def square_to_phong_lobe(u: torch.Tensor, exponent) -> torch.Tensor:
    """cos^n lobe around +z (the phong BSDF's)."""
    ct = torch.pow(torch.clamp_min(u[..., 0], 1e-20), 1.0 / (exponent + 2.0))
    st = m.safe_sqrt(1.0 - ct * ct)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def square_to_phong_lobe_pdf(v: torch.Tensor, exponent) -> torch.Tensor:
    ct = torch.clamp_min(v[..., 2], 0.0)
    return (exponent + 2.0) * INV_TWOPI * torch.pow(ct, exponent + 1.0)
