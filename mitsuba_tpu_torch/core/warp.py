"""Sample warping: [0,1)^2 -> triangles, hemispheres, spheres and cones
(port of the parts of core/warp.py that the integrators call)."""
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
