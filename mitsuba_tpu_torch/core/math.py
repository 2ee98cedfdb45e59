"""Vector math for batched rays and shading frames (port of core/math.py).

Everything operates on trailing-dim-3 float32 tensors. Dot products and
cross products are written out component by component, in the order the
JAX package evaluates them, so the CPU path rounds like the reference.
"""
from __future__ import annotations

import torch

EPS = 1e-4
INF = 3.0e38


def dot(a: torch.Tensor, b: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    out = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return out[..., None] if keepdims else out


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length(v: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(dot(v, v, keepdims=keepdims), 1e-30))


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / length(v, keepdims=True)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(x, 0.0))


def safe_div(a, b: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """a / b with 0 where |b| is tiny."""
    tiny = torch.abs(b) < eps
    safe_b = torch.where(tiny, 1.0, b)
    return torch.where(tiny, 0.0, a / safe_b)


def coordinate_system(n: torch.Tensor):
    """Branchless orthonormal basis from a unit normal (Duff et al. 2017).
    n: (..., 3) -> (s, t), each (..., 3)."""
    n0, n1, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = n0 * n1 * a
    s = torch.stack([1.0 + sign * n0 * n0 * a, sign * b, -sign * n0], dim=-1)
    t = torch.stack([b, sign + n1 * n1 * a, -n1], dim=-1)
    return s, t


def to_local(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """World -> local frame where local z = n."""
    s, t = coordinate_system(n)
    return torch.stack([dot(v, s), dot(v, t), dot(v, n)], dim=-1)


def to_world(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Local -> world frame where local z = n."""
    s, t = coordinate_system(n)
    return s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]


def cos_theta(v):
    return v[..., 2]


def abs_cos_theta(v):
    return torch.abs(v[..., 2])


def sin_theta2(v):
    return torch.clamp_min(1.0 - v[..., 2] * v[..., 2], 0.0)


def sin_theta(v):
    return torch.sqrt(sin_theta2(v))


def tan_theta(v):
    return safe_div(sin_theta(v), v[..., 2])


def sin_phi(v):
    s = sin_theta(v)
    return torch.where(s < 1e-9, 0.0, torch.clamp(safe_div(v[..., 1], s), -1.0, 1.0))


def cos_phi(v):
    s = sin_theta(v)
    return torch.where(s < 1e-9, 1.0, torch.clamp(safe_div(v[..., 0], s), -1.0, 1.0))


def reflect_local(wi: torch.Tensor) -> torch.Tensor:
    """Mirror reflection in the local frame (z = normal)."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)


def reflect(wi: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect wi (pointing away from the surface) about n."""
    return 2.0 * dot(wi, n, keepdims=True) * n - wi


def refract_local(wi: torch.Tensor, eta: torch.Tensor, cos_theta_t: torch.Tensor):
    """Refraction in the local frame given the transmitted cosine; eta is
    the relative IOR of the actual transmission direction."""
    scale = torch.where(cos_theta_t < 0.0, 1.0 / eta, eta)
    return torch.stack([-wi[..., 0] * scale, -wi[..., 1] * scale, cos_theta_t], dim=-1)


def fresnel_dielectric(cos_theta_i: torch.Tensor, eta):
    """Exact unpolarised dielectric Fresnel. eta = int_ior / ext_ior,
    cos_theta_i signed (positive = outside). Returns (F, cos_theta_t,
    eta_it, eta_ti)."""
    outside = cos_theta_i >= 0.0
    eta_it = torch.where(outside, eta, 1.0 / eta)
    eta_ti = 1.0 / eta_it
    cti = torch.abs(cos_theta_i)
    sin2_t = eta_ti * eta_ti * torch.clamp_min(1.0 - cti * cti, 0.0)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    r_s = safe_div(cti - eta_it * cos_t, cti + eta_it * cos_t)
    r_p = safe_div(eta_it * cti - cos_t, eta_it * cti + cos_t)
    f = torch.where(tir, 1.0, 0.5 * (r_s * r_s + r_p * r_p))
    return f, torch.where(outside, -cos_t, cos_t), eta_it, eta_ti


def fresnel_conductor(cos_theta_i: torch.Tensor, eta: torch.Tensor, k: torch.Tensor):
    """Unpolarised conductor Fresnel; eta, k: (..., 3), cos_theta_i: (...)."""
    c2 = (cos_theta_i * cos_theta_i)[..., None]
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * torch.abs(cos_theta_i)[..., None]
    rs = safe_div(t1 - t2, t1 + t2)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * safe_div(t3 - t4, t3 + t4)
    return 0.5 * (rp + rs)


def fresnel_diffuse_reflectance(eta: torch.Tensor) -> torch.Tensor:
    """Polynomial fit of the diffuse Fresnel reflectance."""
    above = -1.4399 / (eta * eta) + 0.7099 / eta + 0.6681 + 0.0636 * eta
    inv_eta = 1.0 / eta
    inv_eta2 = inv_eta * inv_eta
    inv_eta3 = inv_eta2 * inv_eta
    inv_eta4 = inv_eta3 * inv_eta
    inv_eta5 = inv_eta4 * inv_eta
    below = (0.919317 - 3.4793 * inv_eta + 6.75335 * inv_eta2
             - 7.80989 * inv_eta3 + 4.98554 * inv_eta4 - 1.36881 * inv_eta5)
    return torch.where(eta < 1.0, below, above)
