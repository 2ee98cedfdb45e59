"""The plain reference's ray queries, in plain PyTorch: Moller-Trumbore of
every ray against every candidate triangle, in the dtype it is given.

A hit lies at t > EPS inside the triangle (barycentric slack BARY_EPS) on a
triangle whose determinant is not below 1e-12 in size: the renderer's
stated tests. Scenes of up to BRUTE_MAX triangles are tested whole; larger
ones are cut into clusters of CLUSTER triangles along a Morton curve of
their centroids, and a ray tests the triangles of the clusters whose
bounding box it crosses (the boxes are widened by a hair, so that
rounding never drops a triangle).
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-3
BARY_EPS = 1e-6
BRUTE_MAX = 4096
CLUSTER = 64
# rays boxed at once, and (ray, cluster) pairs tested at once
RAY_BLOCK = 1 << 14
PAIR_BLOCK = 1 << 16


def _morton(points):
    """30-bit Morton codes of points normalised to their bounding box."""
    lo, hi = points.min(0), points.max(0)
    q = ((points - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


class Triangles:
    """The scene's triangles on `device` in `dtype`, ready for queries."""

    def __init__(self, vertices, indices, device, dtype):
        v = torch.as_tensor(vertices, dtype=torch.float32)
        i = torch.as_tensor(indices, dtype=torch.int64)
        p0, p1, p2 = v[i[:, 0]], v[i[:, 1]], v[i[:, 2]]
        self.dtype = dtype
        self.device = device
        self.n = i.shape[0]
        rows = torch.cat([p0, p1 - p0, p2 - p0], 1)               # (T, 9)
        self.rows = rows.to(device, dtype)
        self.clustered = self.n > BRUTE_MAX
        if self.clustered:
            cent = ((p0 + p1 + p2) / 3).numpy().astype(np.float64)
            order = np.argsort(_morton(cent), kind="stable")
            n_c = -(-self.n // CLUSTER)
            pad = n_c * CLUSTER - self.n
            order = torch.as_tensor(np.concatenate([order, np.full(pad, -1)]), dtype=torch.int64)
            self.prim = order.view(n_c, CLUSTER)                  # -1: padding
            safe = order.clamp_min(0)
            tri = rows[safe].view(n_c, CLUSTER, 9)
            corners = torch.stack([p0[safe], p1[safe], p2[safe]], 1).view(n_c, CLUSTER * 3, 3)
            real = (order >= 0).view(n_c, CLUSTER).repeat_interleave(3, 1)[..., None]
            lo = torch.where(real, corners, torch.inf).amin(1)
            hi = torch.where(real, corners, -torch.inf).amax(1)
            widen = 1e-4 * (hi - lo).amax(1, keepdim=True) + 1e-6
            self.box_lo = (lo - widen).to(device, dtype)
            self.box_hi = (hi + widen).to(device, dtype)
            self.tri = tri.to(device, dtype)                      # (C, CLUSTER, 9)
            self.prim = self.prim.to(device)
        else:
            self.tri = self.rows

    # -- the triangle test -------------------------------------------------
    def _test(self, o, d, tri):
        """o, d (..., 3); tri (..., 9), broadcast. Returns (t, hit)."""
        e1, e2 = tri[..., 3:6], tri[..., 6:9]
        pv = torch.cross(d, e2, dim=-1)
        det = (e1 * pv).sum(-1)
        bad = det.abs() < 1e-12
        inv = 1.0 / torch.where(bad, torch.ones_like(det), det)
        tv = o - tri[..., 0:3]
        u = (tv * pv).sum(-1) * inv
        qv = torch.cross(tv, e1, dim=-1)
        v = (d * qv).sum(-1) * inv
        t = (e2 * qv).sum(-1) * inv
        hit = (u >= -BARY_EPS) & (v >= -BARY_EPS) & (u + v <= 1 + BARY_EPS) & (t > EPS) & ~bad
        return t, hit

    def barycentrics(self, o, d, prim):
        """(u, v) of each ray's hit on triangle `prim`, clamped to [0, 1]."""
        tri = self.rows[prim]
        e1, e2 = tri[:, 3:6], tri[:, 6:9]
        pv = torch.cross(d, e2, dim=-1)
        det = (e1 * pv).sum(-1)
        inv = 1.0 / torch.where(det.abs() < 1e-12, torch.ones_like(det), det)
        tv = o - tri[:, 0:3]
        u = ((tv * pv).sum(-1) * inv).clamp(0, 1)
        v = ((d * torch.cross(tv, e1, dim=-1)).sum(-1) * inv).clamp(0, 1)
        return u, v

    # -- queries -----------------------------------------------------------
    def closest(self, o, d):
        """(t, prim) of each ray's closest hit; t is inf on a miss."""
        if not self.clustered:
            best = torch.full((o.shape[0],), torch.inf, dtype=self.dtype, device=o.device)
            prim = torch.zeros((o.shape[0],), dtype=torch.int64, device=o.device)
            for lo in range(0, self.n, CLUSTER):
                t, hit = self._test(o[:, None, :], d[:, None, :], self.tri[None, lo:lo + CLUSTER])
                tmin, k = torch.where(hit, t, torch.inf).min(1)
                better = tmin < best
                best = torch.where(better, tmin, best)
                prim = torch.where(better, k + lo, prim)
            return best, prim
        return self._clustered(o, d, None)

    def occluded(self, o, d, limit):
        """True where a triangle is hit at EPS < t < limit."""
        if not self.clustered:
            blocked = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
            for lo in range(0, self.n, CLUSTER):
                t, hit = self._test(o[:, None, :], d[:, None, :], self.tri[None, lo:lo + CLUSTER])
                blocked |= (hit & (t < limit[:, None])).any(1)
            return blocked
        return self._clustered(o, d, limit)

    def _clustered(self, o, d, limit):
        outs = [self._clustered_block(o[lo:lo + RAY_BLOCK], d[lo:lo + RAY_BLOCK],
                                      None if limit is None else limit[lo:lo + RAY_BLOCK])
                for lo in range(0, o.shape[0], RAY_BLOCK)]
        if limit is not None:
            return torch.cat(outs)
        return torch.cat([b for b, _ in outs]), torch.cat([p for _, p in outs])

    def _clustered_block(self, o, d, limit):
        n = o.shape[0]
        inv = 1.0 / torch.where(d.abs() < 1e-30, torch.full_like(d, 1e-30), d)
        t0 = (self.box_lo[None] - o[:, None]) * inv[:, None]
        t1 = (self.box_hi[None] - o[:, None]) * inv[:, None]
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        cross = (far >= near) & (far > 0)
        if limit is not None:
            cross &= near < limit[:, None]
        ray, clu = cross.nonzero(as_tuple=True)
        best = torch.full((n,), torch.inf, dtype=self.dtype, device=o.device)
        prim = torch.zeros((n,), dtype=torch.int64, device=o.device)
        blocked = torch.zeros((n,), dtype=torch.bool, device=o.device)
        for lo in range(0, ray.shape[0], PAIR_BLOCK):
            r, c = ray[lo:lo + PAIR_BLOCK], clu[lo:lo + PAIR_BLOCK]
            t, hit = self._test(o[r][:, None], d[r][:, None], self.tri[c])
            hit &= self.prim[c] >= 0
            if limit is not None:
                blocked[r[(hit & (t < limit[r][:, None])).any(1)]] = True
                continue
            t = torch.where(hit, t, torch.inf)
            tmin, k = t.min(1)
            best.scatter_reduce_(0, r, tmin, "amin")
            win = (tmin == best[r]) & torch.isfinite(tmin)
            prim[r[win]] = self.prim[c[win], k[win]]
        return blocked if limit is not None else (best, prim)
