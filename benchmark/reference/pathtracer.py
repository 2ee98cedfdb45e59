"""The plain reference renderer: a path tracer in plain PyTorch over a scene
read by `reference/scene.py`, with independent uniform samples from a
seeded `torch.Generator`. It imports nothing of the renderer under test.

What it estimates is what the scene file states (Mitsuba 0.6's `path`):
the radiance reaching each pixel's reconstruction filter along paths of
at most maxDepth edges, from one-sided area emitters over diffuse
surfaces. Each vertex adds the emission its BSDF-sampled ray finds and an
emitter sample (next-event estimation), weighted by the power heuristic;
a path ends past maxDepth, on a miss, at a back face, or by Russian
roulette from rrDepth on. The camera is a pinhole; the film is the
Gaussian filter's weighted mean of the samples splatted into each
pixel's 5x5 neighbourhood, or the box filter's mean of a pixel's own.

The renderer's stated offsets hold here too: a hit lies at t > 1e-3, a
shadow ray tests (1e-3, dist (1 - 1e-3)) from the shading point, and a
continued ray starts 1e-3 off the surface along the geometric normal, on
the side it leaves to.

Everything is computed in `dtype` (float32 as the configuration states;
bfloat16 for the control).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import intersect as isect

RAY_EPS = 1e-3
SHADOW_EPS = 1e-3
GAUSS_ALPHA = 2.0     # exp(-x^2 / (2 stddev^2)), stddev 0.5
GAUSS_RADIUS = 2.0


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-20)


def _frame(n):
    """An orthonormal basis (s, t) around unit normals n (Duff et al.)."""
    sign = torch.where(n[:, 2] >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    s = torch.stack([1 + sign * n[:, 0] * n[:, 0] * a, sign * b, -sign * n[:, 0]], -1)
    t = torch.stack([b, sign + n[:, 1] * n[:, 1] * a, -n[:, 1]], -1)
    return s, t


def _gauss(x):
    floor = math.exp(-GAUSS_ALPHA * GAUSS_RADIUS * GAUSS_RADIUS)
    return (torch.exp(-GAUSS_ALPHA * x * x) - floor).clamp_min(0.0)


class Renderer:
    """The scene on `device` in `dtype`. `materials` (M, 3) and `radiances`
    (E, 3), tensors in `dtype` that may require grad, take the place of
    the scene file's bsdf reflectances and emitter radiances."""

    def __init__(self, scene, device, dtype=torch.float32, materials=None, radiances=None):
        self.scene = scene
        self.device = device
        self.dtype = dtype

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)

        self.tris = isect.Triangles(scene.vertices, scene.indices, device, dtype)
        v = scene.vertices.astype(np.float64)
        i = scene.indices
        p0, e1, e2 = v[i[:, 0]], v[i[:, 1]] - v[i[:, 0]], v[i[:, 2]] - v[i[:, 0]]
        cr = np.cross(e1, e2)
        area = 0.5 * np.linalg.norm(cr, axis=1)
        self.ng = t(cr / np.maximum(np.linalg.norm(cr, axis=1, keepdims=True), 1e-30))
        self.idx = torch.as_tensor(i, device=device)
        self.vn = t(scene.normals)
        emit = np.flatnonzero(scene.radiance.max(1) > 0)
        if len(emit) == 0:
            raise ValueError("the reference needs an area emitter")
        mats = t(scene.materials) if materials is None else materials
        rads = t(scene.radiances) if radiances is None else radiances
        tri_em = torch.as_tensor(scene.tri_emitter, device=device)
        self.refl = mats[torch.as_tensor(scene.tri_material, device=device)]
        self.le = torch.where((tri_em >= 0)[:, None], rads[tri_em.clamp_min(0)], 0.0)
        self.em_tri = torch.as_tensor(emit, device=device)
        cdf = np.cumsum(area[emit])
        self.em_area = float(cdf[-1])
        self.em_cdf = t(cdf / cdf[-1])
        self.em_p0, self.em_e1, self.em_e2 = t(p0[emit]), t(e1[emit]), t(e2[emit])
        self.em_ng = self.ng[self.em_tri]
        self.em_le = self.le[self.em_tri]
        cam = scene.to_world
        self.cam_axes = t(cam[:, :3].T)          # rows: right, up, dir
        self.cam_origin = t(cam[:, 3])
        self.tan_half = math.tan(math.radians(scene.fov_x) / 2)
        self.aspect = scene.height / scene.width

    # -- one batch of paths ------------------------------------------------
    def radiance(self, px, py, gen):
        """Radiance along the camera rays through film points (px, py)."""
        sc, dt, dev = self.scene, self.dtype, self.device
        n = px.shape[0]
        sx = 2.0 * px / sc.width - 1.0
        sy = 1.0 - 2.0 * py / sc.height
        d_cam = torch.stack([sx * self.tan_half, sy * self.tan_half * self.aspect,
                             torch.ones_like(sx)], -1)
        d = _normalize(d_cam @ self.cam_axes)
        o = self.cam_origin.expand(n, 3)
        L = torch.zeros((n, 3), dtype=dt, device=dev)
        beta = torch.ones((n, 3), dtype=dt, device=dev)
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        prev_pdf = torch.ones((n,), dtype=dt, device=dev)
        for depth in range(sc.max_depth):
            u = torch.rand((n, 7), generator=gen, device=dev).to(dt)
            t, prim = self.tris.closest(o, d)
            hit = torch.isfinite(t) & active
            tt = torch.where(hit, t, torch.zeros_like(t))
            p = o + tt[:, None] * d
            ng = self.ng[prim]
            b1, b2 = self.tris.barycentrics(o, d, prim)
            vi = self.idx[prim]
            ns = _normalize(self.vn[vi[:, 0]] * (1 - b1 - b2)[:, None]
                            + self.vn[vi[:, 1]] * b1[:, None] + self.vn[vi[:, 2]] * b2[:, None])
            ns = torch.where((_dot(ns, ng) < 0)[:, None], -ns, ns)
            wi = -d
            # emission found by the sampled ray, weighted against NEE
            cos_l = _dot(wi, ng)
            le = torch.where((hit & (cos_l > 0))[:, None], self.le[prim], 0.0)
            if depth > 0:
                pdf_l = tt * tt / (self.em_area * cos_l.clamp_min(1e-20))
                w = prev_pdf * prev_pdf / (prev_pdf * prev_pdf + pdf_l * pdf_l).clamp_min(1e-30)
            else:
                w = torch.ones_like(cos_l)
            L = L + beta * le * w[:, None]
            active = hit
            if depth == sc.max_depth - 1:
                break
            cos_i = _dot(wi, ns)
            refl = self.refl[prim]
            # next-event estimation: a triangle by area, a point on it
            j = torch.searchsorted(self.em_cdf, u[:, 0].contiguous()).clamp_max(len(self.em_cdf) - 1)
            su = torch.sqrt(u[:, 1])
            q = (self.em_p0[j] + self.em_e1[j] * ((1 - u[:, 2]) * su)[:, None]
                 + self.em_e2[j] * (u[:, 2] * su)[:, None])
            to = q - p
            dist = torch.linalg.vector_norm(to, dim=-1).clamp_min(1e-20)
            wl = to / dist[:, None]
            cos_q = -_dot(wl, self.em_ng[j])
            cos_o = _dot(wl, ns)
            pdf_nee = dist * dist / (self.em_area * cos_q.clamp_min(1e-20))
            pdf_b = cos_o.clamp_min(0) / math.pi
            ok = active & (cos_q > 0) & (cos_i > 0) & (cos_o > 0) & (refl.amax(-1) > 0)
            blocked = self.tris.occluded(p, wl, dist * (1 - SHADOW_EPS))
            w_nee = pdf_nee * pdf_nee / (pdf_nee * pdf_nee + pdf_b * pdf_b).clamp_min(1e-30)
            # the masked lanes' factor is set to 0 before it meets the leaves
            # (reflectance, radiance): a NaN there would reach their gradient
            fac = torch.where(ok & ~blocked, cos_o * w_nee / pdf_nee, 0.0)
            L = L + beta * refl / math.pi * fac[:, None] * self.em_le[j]
            # BSDF sampling: cosine-weighted about the shading normal
            r, phi = torch.sqrt(u[:, 3]), 2 * math.pi * u[:, 4]
            lx, ly = r * torch.cos(phi), r * torch.sin(phi)
            lz = torch.sqrt((1 - u[:, 3]).clamp_min(0))
            s, tv = _frame(ns)
            d_new = _normalize(s * lx[:, None] + tv * ly[:, None] + ns * lz[:, None])
            prev_pdf = lz / math.pi
            beta = beta * refl
            active = active & (cos_i > 0) & (prev_pdf > 0) & (beta.amax(-1) > 0)
            if depth >= sc.rr_depth - 1:
                # a sampling decision: no gradient flows through it
                q_rr = beta.amax(-1).clamp(0.05, 0.95).detach()
                active = active & (u[:, 5] < q_rr)
                beta = beta / q_rr[:, None]
            side = torch.where(_dot(d_new, ng) > 0, RAY_EPS, -RAY_EPS).to(dt)
            o = torch.where(active[:, None], p + ng * side[:, None], o)
            d = torch.where(active[:, None], d_new, d)
            beta = torch.where(active[:, None], beta, 0.0)
        return L

    # -- images --------------------------------------------------------------
    def image(self, spp, gen, batch=1 << 18):
        """One image of `spp` samples a pixel -> (H, W, 3) float32 on the
        host."""
        with torch.no_grad():
            return self.image_tensor(spp, gen, batch).float().cpu().numpy()

    def image_tensor(self, spp, gen, batch=1 << 18):
        """One image of `spp` samples a pixel -> (H, W, 3) in `dtype` on the
        device, differentiable with respect to `materials` and
        `radiances`."""
        sc, dt, dev = self.scene, self.dtype, self.device
        h, w = sc.height, sc.width
        n_pix = h * w
        acc = torch.zeros((n_pix, 3), dtype=dt, device=dev)
        wsum = torch.zeros((n_pix,), dtype=dt, device=dev)
        per = max(1, batch // n_pix)
        done = 0
        while done < spp:
            k = min(per, spp - done)
            pix = torch.arange(n_pix, device=dev).repeat_interleave(k)
            jit = torch.rand((pix.shape[0], 2), generator=gen, device=dev).to(dt)
            px = (pix % w).to(dt) + jit[:, 0]
            py = (pix // w).to(dt) + jit[:, 1]
            L = torch.nan_to_num(self.radiance(px, py, gen), nan=0.0, posinf=0.0, neginf=0.0)
            if sc.rfilter == "box":
                acc.index_add_(0, pix, L)
                wsum.index_add_(0, pix, torch.ones_like(px))
            else:
                off = torch.arange(-2, 3, device=dev)
                ix = torch.floor(px).long()[None] + off[:, None]        # (5, N)
                iy = torch.floor(py).long()[None] + off[:, None]
                wx = _gauss((ix.to(dt) + 0.5) - px[None])
                wy = _gauss((iy.to(dt) + 0.5) - py[None])
                inside = ((iy >= 0) & (iy < h))[:, None] & ((ix >= 0) & (ix < w))[None]
                wt = torch.where(inside, wy[:, None] * wx[None], 0.0).reshape(-1)
                target = (iy.clamp(0, h - 1) * w)[:, None] + ix.clamp(0, w - 1)[None]
                target = target.reshape(-1)
                acc.index_add_(0, target, (L[None, None] * wt.view(5, 5, -1, 1)).reshape(-1, 3))
                wsum.index_add_(0, target, wt)
            done += k
        img = acc / wsum.clamp_min(1e-8)[:, None]
        return img.reshape(h, w, 3)


def render(scene, spp, n_images, seed, device, dtype=torch.float32):
    """`n_images` independent images of `spp` samples a pixel, drawn from
    `seed` -> (n_images, H, W, 3) float32 numpy."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    r = Renderer(scene, device, dtype)
    return np.stack([r.image(spp, gen) for _ in range(n_images)])
