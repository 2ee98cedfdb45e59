"""Occupancy-map approximate visibility (port of ops/occupancy.py; the
fork's OccupancyMap, src/integrators/testOM/myOM.h:10-33).

The scene is voxelized on the host into a dense uint8 grid, and a shadow
query marches a fixed number of steps along the segment: blocked where
an interior step lands in an occupied voxel. Biased (voxels fatten the
occluders) and independent of the triangle count; the myPath2_OM and
LVCBPT_OM variants take it through `RenderConfig.occupancy_shadows`.

The JAX package marches the steps in a loop of `res` iterations; here
every step of a lane chunk is one (lanes, steps) tensor, with the same
per-step arithmetic (t0 + dt (i + 0.5), truncation, then the clip).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..scene.ir import _Replace

# lanes marched at once: each chunk holds a few (lanes, res, 3) float32
# tensors, ~100 MB apiece at res 128
MARCH_LANES = 1 << 16


@dataclasses.dataclass
class OccupancyMap(_Replace):
    grid: torch.Tensor        # (R, R, R) uint8, 1 = occupied
    box_min: torch.Tensor     # (3,)
    inv_extent: torch.Tensor  # (3,) 1 / (box_max - box_min)
    res: int = 128


def build(vertices, indices, res: int = 128, samples_per_edge: int = 2,
          device="cuda") -> OccupancyMap:
    """Host-side voxelization in numpy, then one copy to `device`: each
    triangle is covered by a barycentric sample grid fine enough that
    adjacent samples land in neighbouring voxels."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    lo = vertices.min(0) - 1e-4
    hi = vertices.max(0) + 1e-4
    extent = np.maximum(hi - lo, 1e-9)
    voxel = extent / res

    grid = np.zeros((res, res, res), np.uint8)
    p0 = vertices[indices[:, 0]]
    e1 = vertices[indices[:, 1]] - p0
    e2 = vertices[indices[:, 2]] - p0
    # per-triangle sampling density ~ its size in voxels
    steps = np.maximum(
        np.ceil(np.maximum(np.linalg.norm(e1, axis=1), np.linalg.norm(e2, axis=1))
                / voxel.min()).astype(np.int64) * samples_per_edge,
        1)
    # triangles batched by their step count
    for s in np.unique(steps):
        sel = steps == s
        a = np.linspace(0, 1, int(s) + 1)
        bu, bv = np.meshgrid(a, a, indexing="ij")
        keep = bu + bv <= 1.0 + 1e-9
        bu, bv = bu[keep], bv[keep]
        pts = (p0[sel][:, None, :] + e1[sel][:, None, :] * bu[None, :, None]
               + e2[sel][:, None, :] * bv[None, :, None]).reshape(-1, 3)
        cell = np.clip(((pts - lo) / voxel).astype(np.int64), 0, res - 1)
        grid[cell[:, 0], cell[:, 1], cell[:, 2]] = 1

    def t(a):
        return torch.as_tensor(a, device=device)

    return OccupancyMap(grid=t(grid), box_min=t(lo), inv_extent=t(1.0 / extent), res=res)


def occluded(occ: OccupancyMap, o: torch.Tensor, d: torch.Tensor, tmax: torch.Tensor,
             skip_near_frac: float = 0.02) -> torch.Tensor:
    """Approximate any-hit: `res` fixed steps along (o, d) over the middle
    of [0, tmax]; blocked if a step lands inside the grid in an occupied
    voxel. skip_near_frac trims both ends (the voxels of the segment's own
    end surfaces)."""
    res = occ.res
    t0 = tmax * skip_near_frac
    t1 = tmax * (1.0 - skip_near_frac)
    dt = (t1 - t0) / res
    base = (o - occ.box_min[None, :]) * occ.inv_extent[None, :] * res
    step = d * occ.inv_extent[None, :] * res
    mid = torch.arange(res, dtype=torch.float32, device=o.device) + 0.5
    flat = occ.grid.reshape(-1) > 0
    out = []
    for s in range(0, o.shape[0], MARCH_LANES):
        sl = slice(s, s + MARCH_LANES)
        t = t0[sl, None] + dt[sl, None] * mid[None, :]                 # (L, res)
        pos = base[sl, None, :] + step[sl, None, :] * t[..., None]     # (L, res, 3)
        cell = torch.clamp(pos.to(torch.int32), 0, res - 1).to(torch.int64)
        inside = ((pos >= 0) & (pos < res)).all(-1)
        hit = flat[(cell[..., 0] * res + cell[..., 1]) * res + cell[..., 2]]
        out.append((hit & inside).any(-1))
    if not out:
        return torch.zeros((0,), dtype=torch.bool, device=o.device)
    return torch.cat(out)


def attach(scene, res: int = 128):
    """The scene with an occupancy map built from its geometry (read when
    cfg.occupancy_shadows)."""
    om = build(scene.vertices.detach().cpu().numpy(), scene.indices.cpu().numpy(), res=res,
               device=scene.device)
    return scene.replace(occupancy=om)
