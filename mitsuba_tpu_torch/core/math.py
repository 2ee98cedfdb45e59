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
