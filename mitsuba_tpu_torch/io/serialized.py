"""Mitsuba `.serialized` mesh format: reader + writer (a copy of the JAX
package's io/serialized.py).

Format parity with src/shapes/serialized.cpp (doc block at
serialized.cpp:75-145): each sub-mesh is a 4-byte uncompressed header
(uint16 magic 0x041C, uint16 version) followed by a zlib stream holding
  uint32 flags,
  [v4+] null-terminated utf-8 shape name,
  uint64 vertex count, uint64 triangle count,
  positions (+normals/uvs/colors per flags) in single or double
  precision per flags, then uint32 (or uint64 for >4G vertices) indices.
The file ends with a dictionary: one uint64 (v4; uint32 in older files)
offset per mesh plus a trailing uint32 mesh count.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from .mesh import MeshData

MAGIC = 0x041C
FLAG_NORMALS = 0x0001
FLAG_UVS = 0x0002
FLAG_COLORS = 0x0008
FLAG_FACE_NORMALS = 0x0010
FLAG_SINGLE = 0x1000
FLAG_DOUBLE = 0x2000


def _read_offsets(buf: bytes) -> list[int]:
    """End-of-file dictionary; falls back to [0] when absent/corrupt
    (serialized.cpp:234-236 does the same)."""
    n = len(buf)
    if n < 8:
        return [0]
    (count,) = struct.unpack_from("<I", buf, n - 4)
    for width, fmt in ((8, "<Q"), (4, "<I")):   # v4 uint64, old uint32
        start = n - 4 - count * width
        if count <= 0 or start < 0:
            continue
        offs = [struct.unpack_from(fmt, buf, start + i * width)[0]
                for i in range(count)]
        ok = all(0 <= o < n - 4 and o + 4 <= n
                 and struct.unpack_from("<H", buf, o)[0] == MAGIC
                 for o in offs)
        if ok and offs and offs[0] == 0:
            return offs
    return [0]


def read_serialized(path, shape_index: int | None = None):
    """Load one mesh (shape_index) or all meshes (None) as MeshData."""
    buf = Path(path).read_bytes()
    offsets = _read_offsets(buf)
    if shape_index is not None:
        if not 0 <= shape_index < len(offsets):
            raise ValueError(
                f"shape index {shape_index} out of range "
                f"(file has {len(offsets)} meshes)")
        offsets = [offsets[shape_index]]
    out = []
    for off in offsets:
        magic, version = struct.unpack_from("<HH", buf, off)
        if magic != MAGIC:
            raise ValueError(f"bad .serialized magic at offset {off}")
        # the zlib stream self-terminates; hand it the rest of the file
        raw = zlib.decompressobj().decompress(buf[off + 4:])
        pos = 0
        (flags,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        name = ""
        if version >= 4:
            end = raw.index(b"\x00", pos)
            name = raw[pos:end].decode("utf-8", "replace")
            pos = end + 1
        nv, nt = struct.unpack_from("<QQ", raw, pos)
        pos += 16
        ftype = np.float32 if flags & FLAG_SINGLE else np.float64

        def arr(count, width, dtype):
            nonlocal pos
            a = np.frombuffer(raw, dtype, count * width, pos)
            pos += a.nbytes
            return a.reshape(count, width)

        verts = arr(nv, 3, ftype)
        normals = arr(nv, 3, ftype) if flags & FLAG_NORMALS else None
        uvs = arr(nv, 2, ftype) if flags & FLAG_UVS else None
        if flags & FLAG_COLORS:
            arr(nv, 3, ftype)  # vertex colors parsed but unused
        itype = np.uint64 if nv > 0xFFFFFFFF else np.uint32
        faces = arr(nt, 3, itype)
        out.append(MeshData(verts, faces.astype(np.int64),
                            normals=normals, uvs=uvs))
        out[-1].name = name
    return out if shape_index is None else out[0]


def write_serialized(path, meshes):
    """Write MeshData (or a list of them) as a v4 .serialized file."""
    if isinstance(meshes, MeshData):
        meshes = [meshes]
    chunks, offsets = [], []
    pos = 0
    for md in meshes:
        flags = FLAG_SINGLE
        body = [struct.pack("<I", 0)]  # placeholder, rewritten below
        if md.normals is not None:
            flags |= FLAG_NORMALS
        if md.uvs is not None:
            flags |= FLAG_UVS
        name = getattr(md, "name", "") or ""
        body = [struct.pack("<I", flags), name.encode() + b"\x00",
                struct.pack("<QQ", len(md.vertices), len(md.indices)),
                np.asarray(md.vertices, np.float32).tobytes()]
        if md.normals is not None:
            body.append(np.asarray(md.normals, np.float32).tobytes())
        if md.uvs is not None:
            body.append(np.asarray(md.uvs, np.float32).tobytes())
        body.append(np.asarray(md.indices, np.uint32).tobytes())
        stream = struct.pack("<HH", MAGIC, 4) + zlib.compress(b"".join(body))
        offsets.append(pos)
        chunks.append(stream)
        pos += len(stream)
    tail = b"".join(struct.pack("<Q", o) for o in offsets)
    tail += struct.pack("<I", len(offsets))
    Path(path).write_bytes(b"".join(chunks) + tail)
