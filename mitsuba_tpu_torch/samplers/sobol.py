"""High-dimensional Sobol' direction numbers and Faure digit matrices (a
numpy copy of mitsuba_tpu/samplers/sobol.py, which the port may not
import).

The direction numbers come from the JAX package's data file
(`mitsuba_tpu/samplers/data/sobol_dirs.npz`, read in place) when it is
present, else from the same construction: primitive polynomials over GF(2)
found by exhaustive primitivity testing, the classic Bratley-Fox initial
values for the first dimensions and deterministic randomised odd initial
values above them. The Faure tables are powers of the Pascal matrix mod a
prime base. Everything here is host-side numpy; samplers/qmc.py moves the
tables to the device once per device.
"""
from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

SOBOL_DIMS = 1024
_BITS = 32

# Classic initial direction numbers (Bratley & Fox, Algorithm 659 /
# Numerical Recipes sobseq table — published constants, not reference
# code): (degree, polynomial-interior-coefficient-bits, m-values).
_CLASSIC = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
    (5, 4, [1, 1, 5, 5, 5]),
    (5, 7, [1, 1, 7, 11, 19]),
]


def _factors(n: int):
    out = set()
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.add(d)
            n //= d
        d += 1
    if n > 1:
        out.add(n)
    return out


def _polymulmod(a: int, b: int, p: int, s: int) -> int:
    """(a*b) mod p over GF(2), deg p = s (bitmask encoding)."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> s & 1:
            a ^= p
    return r


def _is_primitive(p: int, s: int) -> bool:
    """p encodes x^s + ... + 1 (bit s and bit 0 set). Primitive iff x has
    order 2^s - 1 in GF(2)[x]/p."""
    order = (1 << s) - 1

    def powx(e: int) -> int:
        r, base = 1, 2
        while e:
            if e & 1:
                r = _polymulmod(r, base, p, s)
            base = _polymulmod(base, base, p, s)
            e >>= 1
        return r

    if powx(order) != 1:
        return False
    for q in _factors(order):
        if powx(order // q) == 1:
            return False
    return True


def _primitive_polys(count: int):
    """First `count` primitive polynomials ordered by degree, as
    (degree, interior-bits) with interior = coefficients of x^{s-1}..x^1."""
    out = []
    s = 1
    while len(out) < count:
        for interior in range(1 << max(s - 1, 0)):
            p = (1 << s) | (interior << 1) | 1
            if s == 1 and interior == 0:
                p = 0b11  # x + 1
            if _is_primitive(p, s):
                out.append((s, interior))
                if len(out) >= count:
                    break
        s += 1
    return out


def dim_row(s: int, interior: int, m) -> np.ndarray:
    """Expand s initial values through the Sobol' recurrence for
    polynomial (s, interior) -> the 32 direction numbers of one
    dimension (uint64, already shifted)."""
    m = list(m)
    # a[j] = a_{j+1} = coefficient of x^{s-1-j} (interior bit t is the
    # coefficient of x^{t+1})
    a = [(interior >> (s - 2 - j)) & 1 for j in range(s - 1)]
    for k in range(s, _BITS):
        mk = m[k - s] ^ (m[k - s] << s)
        for j in range(s - 1):
            if a[j]:
                mk ^= m[k - 1 - j] << (j + 1)
        m.append(mk & ((1 << (k + 1)) - 1))
    return np.asarray([m[k] << (_BITS - 1 - k) for k in range(_BITS)],
                      np.uint64)


# the JAX package's table, read in place
_DIRS_NPZ = str(Path(__file__).resolve().parents[2] / "mitsuba_tpu" / "samplers"
                / "data" / "sobol_dirs.npz")


@lru_cache(maxsize=None)
def direction_numbers(dims: int = SOBOL_DIMS) -> np.ndarray:
    """(dims, 32) uint32 Sobol' direction numbers V[d, k] (v_k << (32-k)).

    Prefers the projection-optimised table of the JAX package's data file
    (generated offline by tools/gen_sobol_dirs.py); falls back to the
    unsearched construction below when the file is absent."""
    import os
    if os.path.exists(_DIRS_NPZ):
        v = np.load(_DIRS_NPZ)["v"]
        if v.shape[0] >= dims:
            return v[:dims].astype(np.uint32)

    v = np.zeros((dims, _BITS), np.uint64)
    # dimension 0: van der Corput (identity matrix)
    for k in range(_BITS):
        v[0, k] = np.uint64(1) << np.uint64(_BITS - 1 - k)

    polys = _primitive_polys(dims - 1)
    rng = np.random.RandomState(20260817)
    for d in range(1, dims):
        s, interior = polys[d - 1]
        if d - 1 < len(_CLASSIC):
            s, interior, m = _CLASSIC[d - 1]
        else:
            # deterministic randomized odd initial values m_k < 2^k
            m = [int(rng.randint(0, 1 << k) * 2 + 1) % (1 << (k + 1))
                 for k in range(s)]
        v[d] = dim_row(s, interior, m)
    return v.astype(np.uint32)


@lru_cache(maxsize=None)
def faure_tables(dims: int = 16):
    """Generalized Faure: base = smallest prime >= dims, per-dimension
    digit matrix C_d = P^d mod b (P = upper-triangular Pascal matrix).
    Returns (base, (dims, D, D) uint32 matrices) with D=16 digits."""
    b = int(dims)
    while True:
        if b >= 2 and all(b % q for q in range(2, int(b ** 0.5) + 1)):
            break
        b += 1
    D = 16
    pascal = np.zeros((D, D), np.int64)
    for i in range(D):
        for j in range(i, D):
            # C(j, i) mod b via Pascal recurrence
            pascal[i, j] = 1 if i in (0, j) else (
                pascal[i - 1, j - 1] + pascal[i, j - 1]) % b
    mats = np.zeros((dims, D, D), np.int64)
    mats[0] = np.eye(D, dtype=np.int64)
    for d in range(1, dims):
        mats[d] = (mats[d - 1] @ pascal) % b
    return b, mats.astype(np.uint32)
