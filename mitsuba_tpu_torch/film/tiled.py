"""Tiled HDR film: stream scanline bands to disk while rendering (port of
film/tiled.py).

The film is rendered in row bands, each written into a pre-allocated
uncompressed scanline EXR by seek-writes, so the host holds one band and
the device one band's batch. Sample streams use global pixel ids, so the
image is the full-frame render's up to the float32 sum order of each
band's chunks (a band resolves its own spp chunk).

Box reconstruction only: a band cannot see its neighbours' splats, and the
tiled film of the reference is limited the same way.
"""
from __future__ import annotations

import struct
import sys

import numpy as np

_EXR_MAGIC = 20000630


def _exr_attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    """One EXR header attribute (a copy of io/image.py's)."""
    return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(data)) + data


class TiledEXRWriter:
    """Incremental uncompressed float32 RGB scanline EXR writer: header and
    offset table up front, rows seek-written as bands finish."""

    def __init__(self, path, width: int, height: int, metadata: dict | None = None):
        self.w, self.h = width, height
        chans = b""
        for c in (b"B", b"G", b"R"):
            chans += c + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
        chans += b"\x00"
        header = _exr_attr(b"channels", b"chlist", chans)
        for k, v in (metadata or {}).items():
            if isinstance(v, (int, float)):
                header += _exr_attr(k.encode(), b"float", struct.pack("<f", float(v)))
            else:
                header += _exr_attr(k.encode(), b"string", str(v).encode())
        header += _exr_attr(b"compression", b"compression", b"\x00")
        box = struct.pack("<iiii", 0, 0, width - 1, height - 1)
        header += _exr_attr(b"dataWindow", b"box2i", box)
        header += _exr_attr(b"displayWindow", b"box2i", box)
        header += _exr_attr(b"lineOrder", b"lineOrder", b"\x00")
        header += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        header += _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
        header += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        header += b"\x00"
        preamble = struct.pack("<ii", _EXR_MAGIC, 2) + header
        self._data_start = len(preamble) + 8 * height
        self._line_bytes = 8 + width * 4 * 3
        offsets = struct.pack("<" + "Q" * height,
                              *[self._data_start + y * self._line_bytes for y in range(height)])
        self._f = open(path, "wb")
        self._f.write(preamble + offsets)
        self._written = np.zeros(height, bool)

    def write_rows(self, y0: int, rows: np.ndarray) -> None:
        """rows: (bh, W, 3) float32, scanlines [y0, y0 + bh)."""
        rows = np.asarray(rows, np.float32)
        bh = rows.shape[0]
        self._f.seek(self._data_start + y0 * self._line_bytes)
        buf = bytearray()
        for i in range(bh):
            r = rows[i]
            data = np.concatenate([r[:, 2], r[:, 1], r[:, 0]]).astype(np.float32).tobytes()
            buf += struct.pack("<ii", y0 + i, len(data)) + data
        self._f.write(bytes(buf))
        self._written[y0:y0 + bh] = True

    def close(self):
        if not self._written.all():
            # zero-fill unwritten scanlines so the file stays readable
            blank = np.zeros((1, self.w, 3), np.float32)
            for y in np.nonzero(~self._written)[0]:
                self.write_rows(int(y), blank)
        self._f.close()


def render_tiled(scene, cam, li_fn, cfg, path, tile_rows: int = 64,
                 metadata: dict | None = None, progress: bool = False) -> float:
    """Render the film in bands of at most tile_rows rows (the largest
    divisor of the height up to it), streaming each into the EXR at `path`.
    Returns the mean radiance."""
    from ..integrators import common
    from . import film as filmlib

    if cfg.filter != filmlib.FILTER_BOX:
        raise ValueError("tiled film supports the box filter only "
                         "(tiledhdrfilm.cpp has the same radius<=0.5 restriction)")
    w, h = cam.width, cam.height
    bh = min(tile_rows, h)
    while h % bh:
        bh -= 1
    writer = TiledEXRWriter(path, w, h, metadata=metadata)
    total = 0.0
    try:
        for y0 in range(0, h, bh):
            img = common.render(scene, cam, li_fn, cfg, y0=y0, rows=bh).cpu().numpy()
            writer.write_rows(y0, img)
            total += float(img.sum(dtype=np.float64))
            if progress:
                print(f"[tiled] rows {y0 + bh}/{h}", file=sys.stderr)
    finally:
        writer.close()
    return total / (w * h * 3)
