"""PIZ (wavelet + Huffman) decompressor for OpenEXR blocks (a numpy copy
of the JAX package's io/exr_piz.py).

Pure-Python port of the PIZ scheme (OpenEXR's ImfPizCompressor/ImfHuf/
ImfWav): per 32-scanline block — a 16-bit value bitmap + LUT compaction,
canonical Huffman coding with embedded run-lengths, and a 2D Haar-style
wavelet per channel. HALF channels only (the reference's hdrfilm default).
Slow-but-correct; PIZ files are read once at scene load.
"""
from __future__ import annotations

import struct

import numpy as np

BITMAP_SIZE = 1 << 13           # 65536 bits
HUF_ENCSIZE = (1 << 16) + 1


# ---------------------------------------------------------------------------
# Huffman
# ---------------------------------------------------------------------------

class _BitReader:
    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.c = 0
        self.lc = 0

    def get_bits(self, n: int) -> int:
        while self.lc < n:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


def _unpack_enc_table(br: _BitReader, im: int, iM: int) -> np.ndarray:
    """Code lengths (6-bit, with zero-run codes) -> canonical codes.
    Returns array of (code << 6 | length) like OpenEXR's hcode."""
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = br.get_bits(6)
        if l == 63:                      # LONG_ZEROCODE_RUN
            zerun = br.get_bits(8) + 6   # SHORTEST_LONG_RUN
            i += zerun
        elif l >= 59:                    # SHORT_ZEROCODE_RUN
            i += l - 59 + 2
        else:
            lengths[i] = l
            i += 1

    # canonical code assignment (hufCanonicalCodeTable)
    n = np.zeros(59, np.int64)
    for l in lengths[lengths > 0]:
        n[l] += 1
    c = 0
    base = np.zeros(59, np.int64)
    for i2 in range(58, 0, -1):
        nc = (c + n[i2]) >> 1
        base[i2] = c
        c = nc
    hcode = np.zeros(HUF_ENCSIZE, np.int64)
    counters = base.copy()
    nz = np.nonzero(lengths)[0]
    for sym in nz:
        l = lengths[sym]
        hcode[sym] = (counters[l] << 6) | l
        counters[l] += 1
    return hcode


def _huf_decode(hcode: np.ndarray, br: _BitReader, rlc: int, n_out: int,
                n_bits: int) -> np.ndarray:
    """Bit-serial canonical Huffman decode with RLE (hufDecode)."""
    # build (length, code) -> symbol dict
    table = {}
    nz = np.nonzero(hcode)[0]
    for sym in nz:
        e = int(hcode[sym])
        table[(e & 63, e >> 6)] = int(sym)

    out = np.zeros(n_out, np.uint16)
    oi = 0
    c = 0
    lc = 0
    consumed = 0
    while consumed < n_bits and oi < n_out:
        bit = br.get_bits(1)
        consumed += 1
        c = ((c << 1) | bit) & ((1 << 59) - 1)
        lc += 1
        sym = table.get((lc, c))
        if sym is None:
            continue
        c = 0
        lc = 0
        if sym == rlc:
            # run-length: repeat previous value
            if consumed + 8 > n_bits:
                break
            cs = br.get_bits(8)
            consumed += 8
            prev = out[oi - 1] if oi > 0 else 0
            out[oi:oi + cs] = prev
            oi += cs
        else:
            out[oi] = sym
            oi += 1
    return out


def huf_uncompress(data: bytes, n_out: int) -> np.ndarray:
    im, iM, _tab_len, n_bits, _room = struct.unpack_from("<IIIII", data, 0)
    br = _BitReader(data[20:])
    hcode = _unpack_enc_table(br, im, iM)
    # data bitstream starts at the next byte boundary
    br.c = 0
    br.lc = 0
    return _huf_decode(hcode, br, iM, n_out, n_bits)


# ---------------------------------------------------------------------------
# Wavelet (ImfWav.cpp wav2Decode)
# ---------------------------------------------------------------------------

_A_OFFSET = 1 << 15
_MOD_MASK = (1 << 16) - 1


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int64)
    hs = h.astype(np.int16).astype(np.int64)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai
    b = ai - hs
    return a.astype(np.uint16), b.astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def wav2_decode(buf: np.ndarray, mx: int) -> None:
    """In-place 2D wavelet decode; buf: (ny, nx) uint16."""
    ny, nx = buf.shape
    dec = _wdec14 if mx < (1 << 14) else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2) if ny - p2 >= 0 else np.arange(0)
        xs = np.arange(0, nx - p2 + 1, p2) if nx - p2 >= 0 else np.arange(0)
        if len(ys) and len(xs):
            Y, X = np.meshgrid(ys, xs, indexing="ij")
            v00 = buf[Y, X]
            v01 = buf[Y, X + p]
            v10 = buf[Y + p, X]
            v11 = buf[Y + p, X + p]
            i00, i10 = dec(v00, v10)
            i01, i11 = dec(v01, v11)
            a00, a01 = dec(i00, i01)
            a10, a11 = dec(i10, i11)
            buf[Y, X] = a00
            buf[Y, X + p] = a01
            buf[Y + p, X] = a10
            buf[Y + p, X + p] = a11
        # odd trailing column (the C loop's `if (nx & p)` branch)
        if nx & p and len(ys):
            x = (xs[-1] + p2) if len(xs) else 0
            if x < nx:
                v00 = buf[ys, x]
                v10 = buf[ys + p, x]
                a, b = dec(v00, v10)
                buf[ys, x] = a
                buf[ys + p, x] = b
        # odd trailing row
        if ny & p and len(xs):
            y = ys[-1] + p2 if len(ys) else 0
            if y < ny:
                v00 = buf[y, xs]
                v01 = buf[y, xs + p]
                a, b = dec(v00, v01)
                buf[y, xs] = a
                buf[y, xs + p] = b
        p2 = p
        p >>= 1


# ---------------------------------------------------------------------------
# PIZ block
# ---------------------------------------------------------------------------

def piz_uncompress(data: bytes, channels, width: int, rows: int):
    """Decompress one PIZ block.

    channels: list of (name, pixel_type) sorted as stored; HALF only.
    Returns dict name -> (rows, width) float32.
    """
    pos = 0
    min_nz, max_nz = struct.unpack_from("<HH", data, pos)
    pos += 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        nbytes = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(data, np.uint8, nbytes, pos)
        pos += nbytes
    (huf_len,) = struct.unpack_from("<I", data, pos)
    pos += 4

    # reverse LUT
    bits = np.unpackbits(bitmap, bitorder="little")
    lut = np.nonzero(bits)[0].astype(np.uint16)
    if len(lut) == 0:
        lut = np.zeros(1, np.uint16)
    max_value = len(lut) - 1

    n_total = width * rows * len(channels)
    decoded = huf_uncompress(data[pos:pos + huf_len], n_total)

    out = {}
    off = 0
    for name, ptype in channels:
        if ptype != 1:  # HALF
            raise NotImplementedError("PIZ with non-HALF channels")
        plane = decoded[off:off + width * rows].reshape(rows, width).copy()
        off += width * rows
        wav2_decode(plane, max_value)
        vals = np.ascontiguousarray(lut[np.minimum(plane, len(lut) - 1)])
        out[name] = vals.view(np.float16).astype(np.float32).reshape(rows, width)
    return out
