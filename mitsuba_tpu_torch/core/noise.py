"""Procedural noise (port of core/noise.py; include/mitsuba/render/noise.h,
pbrt-derived Perlin noise and its fBm and turbulence combinators).

The lattice hash is the counter-based `hash_u32` of core/rng.py in place of
the reference's 256-entry permutation table, as in the JAX package, so the
port draws the same lattice gradients. Gradients are Ken Perlin's improved
noise 12-vector set selected from the hash's low bits. Values lie in
[-1, 1] and are zero at lattice points.
"""
from __future__ import annotations

import torch

from .rng import hash_u32


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _grad(h, x, y, z):
    """Improved-noise gradient: one of 12 edge vectors picked by the hash's
    low 4 bits (Perlin 2002, noise.cpp Grad)."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return (torch.where(h & 1 == 0, u, -u)
            + torch.where(h & 2 == 0, v, -v))


def perlin_noise(p: torch.Tensor) -> torch.Tensor:
    """Perlin gradient noise at points p (..., 3) -> (...) in [-1, 1]
    (Noise::perlinNoise, noise.h:39)."""
    p = torch.as_tensor(p, dtype=torch.float32)
    pi = torch.floor(p)
    pf = p - pi
    # the JAX package hashes the int32 lattice coordinates as uint32;
    # hash_u32 wraps negative ones the same way
    ix, iy, iz = (pi[..., k].to(torch.int64) for k in range(3))
    x, y, z = pf[..., 0], pf[..., 1], pf[..., 2]
    u, v, w = _fade(x), _fade(y), _fade(z)

    def corner(dx, dy, dz):
        # only the hash's low 4 bits are read, which the JAX package's
        # int32 cast keeps
        h = hash_u32(ix + dx, iy + dy, iz + dz)
        return _grad(h, x - dx, y - dy, z - dz)

    n000 = corner(0, 0, 0)
    n100 = corner(1, 0, 0)
    n010 = corner(0, 1, 0)
    n110 = corner(1, 1, 0)
    n001 = corner(0, 0, 1)
    n101 = corner(1, 0, 1)
    n011 = corner(0, 1, 1)
    n111 = corner(1, 1, 1)
    nx00 = n000 + u * (n100 - n000)
    nx10 = n010 + u * (n110 - n010)
    nx01 = n001 + u * (n101 - n001)
    nx11 = n011 + u * (n111 - n011)
    nxy0 = nx00 + v * (nx10 - nx00)
    nxy1 = nx01 + v * (nx11 - nx01)
    return nxy0 + w * (nxy1 - nxy0)


def perlin_noise_1d(x: torch.Tensor) -> torch.Tensor:
    """The 1D slice perlinNoise(Point(x, 0, 0)) (irawan.cpp:267)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    z = torch.zeros_like(x)
    return perlin_noise(torch.stack([x, z, z], -1))


def fbm(p: torch.Tensor, omega: float = 0.5, octaves: int = 6) -> torch.Tensor:
    """Fractional Brownian motion: a sum of Perlin octaves (Noise::fbm,
    noise.h:43)."""
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    lam, o = 1.0, 1.0
    for _ in range(octaves):
        total = total + o * perlin_noise(p * lam)
        lam *= 1.99
        o *= omega
    return total


def turbulence(p: torch.Tensor, omega: float = 0.5, octaves: int = 6) -> torch.Tensor:
    """A sum of |Perlin| octaves (Noise::turbulence)."""
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    lam, o = 1.0, 1.0
    for _ in range(octaves):
        total = total + o * torch.abs(perlin_noise(p * lam))
        lam *= 1.99
        o *= omega
    return total
