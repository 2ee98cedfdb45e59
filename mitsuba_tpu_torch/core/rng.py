"""Stateless counter-based RNG for sample streams (port of core/rng.py).

Every sample is a pure function of (seed, pixel index, sample index,
dimension), so the port draws exactly the JAX package's numbers and
renders the same image. The hash is uint32 arithmetic; torch has no
wrapping uint32 multiply or logical right shift, so values live in int64
in [0, 2^32) and every multiply and add is reduced mod 2^32.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32): split x into 16-bit halves so
    no int64 product overflows."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _u32(p):
    """Reinterpret an int (Python or tensor, any int dtype) as uint32, the
    way `astype(uint32)` wraps negative int32 values."""
    if isinstance(p, torch.Tensor):
        return p.to(torch.int64) & _M32
    return int(p) & _M32


def _mix32(x):
    """splitmix32-style finalizer on uint32 values."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def hash_u32(*parts):
    """Combine integer arrays into one well-mixed uint32 value, held in an
    int64 tensor (or a Python int when every part is one)."""
    acc = 0x9E3779B9
    for p in parts:
        acc = _mix32((_u32(p) + _mul32(acc, 0x85EBCA6B) + 0xC2B2AE35) & _M32)
    return acc


def u32_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 in [0, 1) from the top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def uniform(seed, pixel, sample, dim) -> torch.Tensor:
    """One uniform float per element of the broadcast index tensors."""
    return u32_to_uniform(hash_u32(seed, pixel, sample, dim))


class SampleStream:
    """Functional per-ray sample stream; the independent sampler only
    (the QMC kinds of samplers/qmc.py are not ported)."""

    __slots__ = ("seed", "pixel", "sample", "dim", "kind", "spp")

    def __init__(self, seed, pixel, sample, dim: int = 0, kind: int = 0,
                 spp: int = 0):
        if kind != 0:
            raise NotImplementedError(
                f"sampler kind {kind}: only the independent sampler (0) "
                "is ported")
        self.seed = seed
        self.pixel = pixel
        self.sample = sample
        self.dim = dim
        self.kind = kind
        self.spp = spp

    def at_dim(self, dim):
        """Sample one dimension; `dim` may be an int tensor (a bounce
        counter)."""
        return uniform(self.seed, self.pixel, self.sample, dim)

    def next_1d(self):
        u = self.at_dim(self.dim)
        self.dim = self.dim + 1
        return u

    def next_2d(self):
        return torch.stack([self.next_1d(), self.next_1d()], dim=-1)
