"""Closed-mesh voxelization for per-shape interior media.

The replacement for the reference's per-shape interior/exterior
medium pointers (include/mitsuba/render/medium.h:103, shape.h interior
medium binding): instead of tracking "which medium am I in" per ray —
divergent state that breaks SIMD lanes — interior-bound media are
compiled at scene-load time into a *spatial density field* over the
shape's volume. Delta/ratio tracking then respects the shape boundary
with zero per-lane bookkeeping, shadow rays included. The boundary
surface itself becomes an index-matched null interface (or keeps its
explicit BSDF, e.g. a dielectric for absorbing glass).

The parity (crossing-count) test assumes a closed, watertight mesh —
the same restriction the reference places on shapes with interior media.
Bias from the binary voxel approximation is O(voxel size) at the
boundary; 2x supersampling gives fractional boundary coverage.
"""
from __future__ import annotations

import numpy as np


def voxelize(verts: np.ndarray, tris: np.ndarray, res: int = 64,
             supersample: int = 2, pad_voxels: int = 1):
    """Binary-inside occupancy of a closed triangle mesh.

    Returns (density (res,res,res) float32 in [0,1] z-major like
    gridvolume, box_min (3,), box_max (3,)). `supersample` columns per
    voxel axis give fractional boundary coverage.
    """
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64)
    lo = verts.min(0)
    hi = verts.max(0)
    extent = np.maximum(hi - lo, 1e-9)
    # pad so boundary voxels aren't clipped by the box
    pad = extent / res * pad_voxels
    lo, hi = lo - pad, hi + pad
    extent = hi - lo

    nss = res * supersample
    # supersampled column centers in xy, with distinct irrational offsets
    # per axis: meshes are full of symmetry planes (x=0, x=y, pole fans)
    # and an aligned lattice would drop every column lying exactly on a
    # projected edge (the strict edge test excludes both neighbors)
    cs_x = (np.arange(nss) + 0.5 + 0.07236067977) / nss
    cs_y = (np.arange(nss) + 0.5 - 0.05654321987) / nss
    xs = lo[0] + cs_x * extent[0]
    ys = lo[1] + cs_y * extent[1]
    gx, gy = np.meshgrid(xs, ys, indexing="ij")          # (nss, nss)
    cols = np.stack([gx.ravel(), gy.ravel()], -1)        # (C, 2)
    ncol = cols.shape[0]

    # z-bin edges (voxel boundaries, supersampled in z too)
    z_edges = lo[2] + (np.arange(nss + 1) / nss) * extent[2]

    # crossing histogram per column: counts[c, k] = #surface crossings
    # with z in bin k (top-anchored suffix parity gives inside-ness)
    counts = np.zeros((ncol, nss + 1), np.int64)

    a = verts[tris[:, 0]]
    b = verts[tris[:, 1]]
    c = verts[tris[:, 2]]
    chunk = max(1, int(4e7 // max(ncol, 1)))
    for s in range(0, len(tris), chunk):
        A, B, C = a[s:s + chunk], b[s:s + chunk], c[s:s + chunk]
        # 2D edge functions: column inside the xy projection?
        # signed areas (C,T) via broadcasting
        ax, ay = A[:, 0][None], A[:, 1][None]
        bx, by = B[:, 0][None], B[:, 1][None]
        cx, cy = C[:, 0][None], C[:, 1][None]
        px, py = cols[:, 0][:, None], cols[:, 1][:, None]
        w0 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        w1 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
        w2 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        # top-left-ish rule: strict one-sided to count shared edges once
        pos = (w0 > 0) & (w1 > 0) & (w2 > 0)
        neg = (w0 < 0) & (w1 < 0) & (w2 < 0)
        inside = np.where(area > 1e-18, pos,
                          np.where(area < -1e-18, neg, False))
        ci, ti = np.nonzero(inside)
        if len(ci) == 0:
            continue
        # plane z at the column point
        ar = area[0, ti]
        bar = np.stack([w1[ci, ti], w2[ci, ti], w0[ci, ti]], -1)
        bar = bar / np.maximum(np.abs(ar[:, None]), 1e-30) \
            * np.sign(ar[:, None])
        zc = (bar[:, 0] * A[ti, 2] + bar[:, 1] * B[ti, 2]
              + bar[:, 2] * C[ti, 2])
        k = np.clip(np.searchsorted(z_edges, zc), 0, nss)
        np.add.at(counts, (ci, k), 1)

    # suffix parity: inside at z-bin j if an odd number of crossings
    # lie strictly above the bin center
    above = counts[:, ::-1].cumsum(1)[:, ::-1]           # crossings >= bin k
    # crossings above center of bin j  ~ crossings in bins >= j+1 plus
    # half of bin j; approximate with bins > j (supersampling hides the
    # half-bin ambiguity)
    inside_ss = (above[:, 1:] % 2).astype(np.float32)    # (C, nss)
    inside_ss = inside_ss.reshape(res, supersample, res, supersample, -1)
    # reshape z: last axis nss -> (res, supersample)
    inside_ss = inside_ss.reshape(res, supersample, res, supersample,
                                  res, supersample)
    # average supersamples -> fractional occupancy, index order (x,y,z)
    occ_xyz = inside_ss.mean(axis=(1, 3, 5))
    # gridvolume layout is (z, y, x)
    density = np.ascontiguousarray(occ_xyz.transpose(2, 1, 0), np.float32)
    return density, lo.astype(np.float32), hi.astype(np.float32)
