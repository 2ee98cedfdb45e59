"""Sampler family: independent, stratified, Halton, (0,2) low-discrepancy,
Hammersley, Sobol' and Faure (port of samplers/qmc.py).

Every sampler is a pure function of (seed, pixel, sample index, dimension),
as in the JAX package, and draws its numbers: uint32 values live in int64
tensors in [0, 2^32) (core/rng.py's convention). The JAX package's bit
loops become tensor expressions with the same result:

- `sobol2` and the Sobol' rows: the XOR of the direction numbers selected by
  the sample index's bits is an (N, 32) bit mask against a constant row,
  reduced by a 5-level XOR tree (bit-equal to the 32-step loop);
- `radical_inverse`: the digits against precomputed powers of the base,
  capped where base^k exceeds 2^32 or at the loop's 20 digits, summed in
  one reduction (the JAX loop's sequential float32 sum may differ in the
  last bit);
- Faure: the 16 base-17 digits against powers in one tensor, then the
  float32 matmuls `digits @ c` and `y @ w` of the JAX code.

Dimensions wrap as in the JAX package: Halton and Hammersley modulo the 64
primes, Sobol' modulo its 1,024 tabulated dimensions (ROADMAP C4), Faure
modulo 16.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.rng import _M32, _u32, hash_u32, u32_to_uniform, uniform
from . import sobol as sobollib

SAMPLER_INDEPENDENT = 0
SAMPLER_STRATIFIED = 1
SAMPLER_HALTON = 2
SAMPLER_LD = 3
SAMPLER_HAMMERSLEY = 4
SAMPLER_SOBOL = 5
SAMPLER_FAURE = 6

SAMPLER_NAMES = {v: k[8:].lower() for k, v in list(globals().items())
                 if k.startswith("SAMPLER_")}

# the first 64 primes: the Halton bases
_PRIMES = np.array([
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149,
    151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227,
    229, 233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311,
], dtype=np.uint32)

_RADICAL_DIGITS = 20    # the JAX loop's fixed unroll: n < base^20 is exact
_FAURE_DIGITS = 16
_ONE_MINUS = np.float32(1.0 - 1e-7)


def _bit_reverse(n: torch.Tensor) -> torch.Tensor:
    n = ((n << 16) | (n >> 16)) & _M32
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    return ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)


def radical_inverse_base2(n) -> torch.Tensor:
    """Bit-reversed base-2 radical inverse: uint32 -> float32 in [0, 1)."""
    return u32_to_uniform(_bit_reverse(_u32(n)))


def van_der_corput(n, scramble) -> torch.Tensor:
    """Base-2 van der Corput with XOR scrambling (the (0,2) pair's first
    dimension)."""
    return u32_to_uniform(_bit_reverse(_u32(n)) ^ _u32(scramble))


@lru_cache(maxsize=None)
def _sobol2_row() -> np.ndarray:
    """The (0,2) pair's second-dimension direction numbers: v_0 = 2^31,
    v_{i+1} = v_i ^ (v_i >> 1)."""
    row = [1 << 31]
    for _ in range(31):
        row.append(row[-1] ^ (row[-1] >> 1))
    return np.asarray(row, np.int64)


@lru_cache(maxsize=16)
def _device_tables(device: torch.device):
    """The constant rows on `device`, moved there once: (the sobol2 row
    (32,), the Sobol' table (1024, 32), the 32 bit shifts), int64."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return (t(_sobol2_row()), t(sobollib.direction_numbers()),
            t(np.arange(32)))


def xor_select(n: torch.Tensor, row: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """XOR of row[i] over the set bits i of each n (uint32 in int64): the
    (N, 32) mask of n's bits against the row, reduced by a 5-level XOR tree.
    Equal, bit for bit, to the JAX package's 32-step loop."""
    x = ((n[..., None] >> shifts) & 1) * row
    for half in (16, 8, 4, 2, 1):
        x = x[..., :half] ^ x[..., half:2 * half]
    return x[..., 0]


def sobol2(n, scramble) -> torch.Tensor:
    """Second dimension of the Sobol' (0,2)-sequence with XOR scrambling."""
    n = _u32(n)
    row, _, shifts = _device_tables(n.device)
    return u32_to_uniform(xor_select(n, row, shifts) ^ _u32(scramble))


@lru_cache(maxsize=256)
def _radical_tables(base: int, device: torch.device):
    """(powers base^k (K,) int64, inverse powers (K,) float32) on `device`
    for the digits k of a uint32 in this base that the JAX loop reads: at
    most 20, and none where base^k > 2^32 - 1 (that digit is 0). The
    inverse powers are the JAX loop's float32 running product of 1/base."""
    inv_base = np.float32(1.0) / np.float32(base)
    pows, invs = [], []
    p, inv = 1, inv_base
    for _ in range(_RADICAL_DIGITS):
        if p > _M32:
            break
        pows.append(p)
        invs.append(inv)
        p *= base
        inv = np.float32(inv * inv_base)
    return (torch.as_tensor(np.asarray(pows, np.int64), device=device),
            torch.as_tensor(np.asarray(invs, np.float32), device=device))


def radical_inverse(base: int, n) -> torch.Tensor:
    """General radical inverse of uint32 n in an integer base, clamped below
    1: the digits against the base's powers, each times its inverse power,
    summed."""
    n = _u32(n)
    pows, invs = _radical_tables(int(base), n.device)
    digits = ((n[..., None] // pows) % int(base)).to(torch.float32)
    return torch.clamp_max((digits * invs).sum(-1), float(_ONE_MINUS))


@lru_cache(maxsize=16)
def _faure_tables(device: torch.device):
    """(base 17, the 16 transposed digit matrices (16, D, D), the weights
    17^-k for k = 1..16, the powers 17^k for k = 0..15) on `device`."""
    b, mats = sobollib.faure_tables(16)
    w = np.power(np.float32(1.0 / b), np.arange(1, _FAURE_DIGITS + 1, dtype=np.float32))
    pows = np.asarray([b ** k for k in range(_FAURE_DIGITS)], np.int64)
    mats_t = np.ascontiguousarray(np.swapaxes(mats, 1, 2)).astype(np.float32)
    return (b, torch.as_tensor(mats_t, device=device),
            torch.as_tensor(w.astype(np.float32), device=device),
            torch.as_tensor(pows, device=device))


def _faure(sample: torch.Tensor, dim: int) -> torch.Tensor:
    """Generalised Faure in base 17: the 16 digits of the sample index (as
    the JAX package's int32) through the dimension's Pascal-power matrix
    (float32 matmul; exact, every sum < 2^12), weighted by 17^-k."""
    b, mats_t, w, pows = _faure_tables(sample.device)
    n0 = ((sample + (1 << 31)) & _M32) - (1 << 31)     # astype(int32)
    digits = torch.remainder(torch.div(n0[..., None], pows, rounding_mode="floor"),
                             b).to(torch.float32)
    y = torch.remainder(digits @ mats_t[dim % 16], float(b))
    return torch.clamp_max(y @ w, float(_ONE_MINUS))


def _rotated(v, seed, pixel, salt, dim):
    """Cranley-Patterson rotation of v by a per-(pixel, dim) hash, mod 1."""
    rot = uniform(seed, pixel, salt, dim)
    return torch.fmod(v + rot, 1.0)


def sample_dim(kind: int, seed, pixel, sample, dim: int, spp: int = 0) -> torch.Tensor:
    """One uniform float per element for dimension `dim` (a Python int) of
    the sampler family `kind`; pixel and sample are integer tensors."""
    if kind == SAMPLER_INDEPENDENT:
        return uniform(seed, pixel, sample, dim)
    sample = _u32(sample)
    if kind == SAMPLER_STRATIFIED:
        # 1D strata over spp samples + hashed jitter
        spp = max(spp, 1)
        jitter = uniform(seed, pixel, sample, dim)
        return (torch.fmod(sample.to(torch.float32), float(spp)) + jitter) / spp
    if kind == SAMPLER_HALTON:
        # global Halton index = sample, per-(pixel, dim) rotation
        v = radical_inverse(int(_PRIMES[int(dim) % len(_PRIMES)]), sample)
        return _rotated(v, seed, pixel, 0x9E37, dim)
    if kind == SAMPLER_LD:
        # pair dims: even -> van der Corput, odd -> sobol2, one scramble a pair
        scramble = hash_u32(seed, pixel, 0x51D, dim // 2)
        if dim % 2 == 0:
            return van_der_corput(sample, scramble)
        return sobol2(sample, scramble)
    if kind == SAMPLER_HAMMERSLEY:
        # dim 0 is the equispaced i/N axis, the rest follow Halton
        spp = max(spp, 1)
        if dim == 0:
            v = torch.fmod(sample.to(torch.float32), float(spp)) / spp
        else:
            v = radical_inverse(int(_PRIMES[int(dim - 1) % len(_PRIMES)]), sample)
        return _rotated(v, seed, pixel, 0x9E37, dim)
    if kind == SAMPLER_SOBOL:
        # the dimension's direction-number row (wrapped modulo 1,024: C4),
        # Owen-style XOR scrambling per (pixel, dim)
        _, table, shifts = _device_tables(sample.device)
        scramble = hash_u32(seed, pixel, 0x50B01, dim)
        row = table[int(dim) % sobollib.SOBOL_DIMS]
        return u32_to_uniform(xor_select(sample, row, shifts) ^ _u32(scramble))
    if kind == SAMPLER_FAURE:
        return _rotated(_faure(sample, int(dim)), seed, pixel, 0xFA4E, dim)
    raise ValueError(f"unknown sampler kind {kind}")
