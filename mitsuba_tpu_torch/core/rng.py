"""Stateless counter-based RNG for sample streams (port of core/rng.py).

Every sample is a pure function of (seed, pixel index, sample index,
dimension), so the port draws exactly the JAX package's numbers and
renders the same image. The hash is uint32 arithmetic.

On the card a draw is one launch of the hand-written kernel of
`csrc/rng_draw.cu`, which runs the whole mix chain in uint32 registers.
Its plain twin, `hash_u32_plain` / `uniform_plain`, is the same chain in
PyTorch: torch has no wrapping uint32 multiply or logical right shift, so
values live in int64 in [0, 2^32) and every multiply and add is reduced
mod 2^32 (~96 elementwise ops a draw). `hash_u32` and `uniform` route by
what they can observe:
  - every part a Python int: hash_u32 gives a Python int (the twin);
  - tensor parts on the card: the kernel (a part of another dtype than
    int32 or int64 goes `.to(torch.int64)` first, as the twin's `_u32`
    does);
  - tensor parts on the CPU: the twin;
  - tensor parts on two devices (a CPU part beside a CUDA one): raise.
Both give the same bits for the same parts.

Counters, as the trace kernels': KERNEL_LAUNCHES["draw"] at each eager
launch and CAPTURED_LAUNCHES["draw"] at each launch inside a CUDA graph
capture (`utils/graphs` adds a graph's held launches at each replay),
KERNEL_LANES["draw"] the lanes of the eager launches, and
PLAIN_CALLS["draw"] each run of the twin on CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.stats import span

_M32 = 0xFFFFFFFF

KERNEL_LAUNCHES = {"draw": 0}
CAPTURED_LAUNCHES = {"draw": 0}
KERNEL_LANES = {"draw": 0}
PLAIN_CALLS = {"draw": 0}


def reset_counts():
    for counts in (KERNEL_LAUNCHES, CAPTURED_LAUNCHES, KERNEL_LANES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


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


def hash_u32_plain(*parts):
    """Combine integer arrays into one well-mixed uint32 value, held in an
    int64 tensor (or a Python int when every part is one): the kernel's
    plain twin."""
    acc = 0x9E3779B9
    for p in parts:
        acc = _mix32((_u32(p) + _mul32(acc, 0x85EBCA6B) + 0xC2B2AE35) & _M32)
    return acc


def u32_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 in [0, 1) from the top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def uniform_plain(*parts) -> torch.Tensor:
    """`uniform`'s plain twin."""
    return u32_to_uniform(hash_u32_plain(*parts))


def hash_u32(*parts):
    """hash_u32_plain's bits (int64 in [0, 2^32), or a Python int when
    every part is one), by the kernel for CUDA parts."""
    return _draw(parts, as_float=False)


def uniform(*parts) -> torch.Tensor:
    """One uniform float32 in [0, 1) per element of the broadcast parts
    (seed, pixel, sample, dim for a sample stream), by the kernel for
    CUDA parts."""
    return _draw(parts, as_float=True)


# The kernel's part kinds (csrc/rng_draw.cu, enum Kind); an int64 part's
# is the int32 one's plus one.
SCALAR, ONE_I32, FULL_I32 = 0, 1, 3
MAX_PARTS = 4


def _draw(parts, as_float):
    tensors = [p for p in parts if isinstance(p, torch.Tensor)]
    dev = tensors[0].device if tensors else None
    if any(t.device != dev for t in tensors):
        raise ValueError(f"rng draw: parts on {sorted({str(t.device) for t in tensors})}, "
                         "one device a draw")
    if dev is None or dev.type != "cuda":
        PLAIN_CALLS["draw"] += bool(tensors)
        return uniform_plain(*parts) if as_float else hash_u32_plain(*parts)
    shape = tensors[0].shape
    if any(t.shape != shape for t in tensors):
        shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    out = torch.empty(shape, dtype=torch.float32 if as_float else torch.int64, device=dev)
    n = out.numel()
    if n == 0:
        return out
    kinds, values, loads = kernel_parts(parts, shape)
    k = len(parts)
    ptr = (ctypes.c_void_p * k)(*(0 if t is None else t.data_ptr() for t in loads))
    capturing = torch.cuda.is_current_stream_capturing()
    (CAPTURED_LAUNCHES if capturing else KERNEL_LAUNCHES)["draw"] += 1
    if not capturing:
        KERNEL_LANES["draw"] += n
    # the raw handle of the device's current stream (what
    # torch.cuda.current_stream(dev).cuda_stream reads, without building a
    # Stream object a draw); the launch goes to the device the parts are on
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with torch.cuda.device(dev):
        rc = _lib().rng_draw(k, ptr, (ctypes.c_int * k)(*kinds), (ctypes.c_uint32 * k)(*values),
                             n, int(as_float), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"rng draw kernel: CUDA error {rc} at launch")
    return out


def kernel_parts(parts, shape):
    """The kernel's view of each part of a draw of `shape`: (kinds, values,
    loads). A Python int is a SCALAR of value int(p) mod 2^32 (load None);
    a tensor goes `.to(torch.int64)` unless int32 or int64 and is then one
    element (ONE_*) or `shape`'s elements, contiguous and aligned to a pair
    of them (FULL_*: broadcast parts expanded and copied)."""
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"rng draw: {len(parts)} parts, the kernel takes 1 to {MAX_PARTS}")
    kinds, values, loads = [], [], []
    for p in parts:
        if not isinstance(p, torch.Tensor):
            kinds.append(SCALAR)
            values.append(int(p) & _M32)
            loads.append(None)
            continue
        if p.dtype not in (torch.int32, torch.int64):
            p = p.to(torch.int64)
        wide = int(p.dtype == torch.int64)
        if p.numel() == 1:
            kinds.append(ONE_I32 + wide)
        else:
            if p.shape != shape or not p.is_contiguous():
                p = p.expand(shape).contiguous()
            if p.data_ptr() % (2 * p.element_size()):
                p = p.clone()       # a view at an odd offset: the kernel loads pairs
            kinds.append(FULL_I32 + wide)
        values.append(0)
        loads.append(p)
    return kinds, values, loads


@functools.lru_cache(maxsize=None)
def _lib():
    """Build (at first use) and bind the kernel library."""
    from .. import _build

    lib = ctypes.CDLL(str(_build.build("rng_draw")))
    P, I32 = ctypes.c_void_p, ctypes.c_int
    lib.rng_draw.argtypes = [I32, ctypes.POINTER(P), ctypes.POINTER(I32),
                             ctypes.POINTER(ctypes.c_uint32), ctypes.c_longlong, I32, P, P]
    lib.rng_draw.restype = ctypes.c_int
    return lib


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
