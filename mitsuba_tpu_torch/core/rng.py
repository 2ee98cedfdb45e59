"""Stateless counter-based RNG for sample streams (port of core/rng.py).

Every sample is a pure function of (seed, pixel index, sample index,
dimension), so the port draws exactly the JAX package's numbers and
renders the same image. The hash is uint32 arithmetic; torch has no
wrapping uint32 multiply or logical right shift, so values live in int64
in [0, 2^32) and every multiply and add is reduced mod 2^32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.stats import span

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
    """Functional per-ray sample stream. `kind` selects the sampler family
    (samplers/qmc.py SAMPLER_*); `spp` is read by the stratified and
    Hammersley samplers."""

    __slots__ = ("seed", "pixel", "sample", "dim", "kind", "spp")

    def __init__(self, seed, pixel, sample, dim: int = 0, kind: int = 0,
                 spp: int = 0):
        self.seed = seed
        self.pixel = pixel
        self.sample = sample
        self.dim = dim
        self.kind = kind
        self.spp = spp

    def at_dim(self, dim):
        """Sample one dimension. `dim` may be an int tensor (a bounce
        counter): the QMC kinds need a Python-int dim and, as in the JAX
        package, fall back to hashing for a tensor one."""
        with span("sampler"):
            return self._draw(dim)

    def _draw(self, dim):
        if self.kind == 0 or not isinstance(dim, int):
            return uniform(self.seed, self.pixel, self.sample, dim)
        from ..samplers import qmc

        return qmc.sample_dim(self.kind, self.seed, self.pixel, self.sample,
                              dim, self.spp)

    def _next(self):
        u = self._draw(self.dim)
        self.dim = self.dim + 1
        return u

    def next_1d(self):
        with span("sampler"):
            return self._next()

    def next_2d(self):
        with span("sampler"):
            return torch.stack([self._next(), self._next()], dim=-1)


# ---------------------------------------------------------------------------
# A numpy copy of JAX's threefry draws, for the load-time estimates that the
# JAX package makes with jax.random (models/cloth.py compute_normalization):
# the same key gives the same uniforms bit for bit, so the port's load equals
# the JAX package's. It follows JAX's `jax_threefry_partitionable` mode (on
# in the JAX the tests run against): split and random_bits hash a 64-bit
# iota split into two uint32 words. Never used at render time: renders hash
# with `uniform` above.
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as
    jax._src.prng.threefry2x32: uint32 numpy arrays in and out."""
    k0, k1 = np.uint32(k0), np.uint32(k1)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _iota_words(shape):
    """jax._src.prng.iota_2x32_shape: a uint64 iota over `shape` as its high
    and low uint32 words."""
    i = np.arange(int(np.prod(shape)), dtype=np.uint64).reshape(shape)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(_M32)).astype(np.uint32)


def threefry_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for a seed in [0, 2^31): (2,) uint32."""
    if not 0 <= int(seed) < 1 << 31:
        raise ValueError(f"threefry_key: seed {seed} outside [0, 2^31)")
    return np.asarray([0, int(seed)], np.uint32)


def threefry_split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num): (num, 2) uint32 keys."""
    hi, lo = _iota_words((num,))
    b0, b1 = _threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b0, b1], axis=-1)


def threefry_uniform(key: np.ndarray, shape) -> np.ndarray:
    """jax.random.uniform(key, shape) in float32 on [0, 1): the top 23 bits
    of each word as the mantissa of a float in [1, 2), less one."""
    hi, lo = _iota_words(tuple(shape))
    b0, b1 = _threefry2x32(key[0], key[1], hi, lo)
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)
