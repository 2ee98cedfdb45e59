"""Mitsuba hair-curve file loader (src/shapes/hair.cpp:641-760 format).

Two encodings:
  * ASCII: one "x y z" vertex per line; a '#' line or blank line starts a
    new fiber.
  * Binary: 11-byte "BINARY_HAIR" magic, uint32 vertex count, float32
    triples; a +inf x-value marks the first vertex of a new fiber (the
    actual position follows in the next three floats).

Returns a list of (V_i, 3) float32 polylines (one per fiber). The shape
layer tessellates them into triangle tubes — the replacement
for the reference's analytic cylinder kd-tree (HairKDTree, hair.cpp:109).
"""
from __future__ import annotations

import struct

import numpy as np


def read_hair(path) -> list:
    with open(path, "rb") as f:
        raw = f.read()
    strands: list = []
    if raw[:11] == b"BINARY_HAIR":
        (count,) = struct.unpack_from("<I", raw, 11)
        off = 15
        cur: list = []
        read = 0
        while read < count:
            (x,) = struct.unpack_from("<f", raw, off)
            off += 4
            if np.isinf(x):
                x, y, z = struct.unpack_from("<3f", raw, off)
                off += 12
                if cur:
                    strands.append(cur)
                cur = [(x, y, z)]
            else:
                y, z = struct.unpack_from("<2f", raw, off)
                off += 8
                cur.append((x, y, z))
            read += 1
        if cur:
            strands.append(cur)
    else:
        cur = []
        for line in raw.decode("ascii", errors="replace").splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                if cur:
                    strands.append(cur)
                cur = []
                continue
            parts = line.split()
            if len(parts) >= 3:
                cur.append(tuple(float(v) for v in parts[:3]))
        if cur:
            strands.append(cur)
    return [np.asarray(s, np.float32) for s in strands if len(s) >= 2]


def write_hair_ascii(path, strands):
    with open(path, "w") as f:
        for s in strands:
            for p in np.asarray(s):
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
            f.write("#\n")
