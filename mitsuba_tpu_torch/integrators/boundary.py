"""Edge-sampled visibility boundary gradients (port of
integrators/boundary.py).

Plain autograd through the renderer carries the interior term of
d(image)/d(vertices) (`ops/intersect.surface_interaction` recomputes the
hit differentiably), but visibility is a 0/1 function of the geometry: its
derivative is a line integral over silhouette edges (Reynolds transport;
Li et al. 2018, "Differentiable Monte Carlo Ray Tracing through Edge
Sampling"). This module adds that term explicitly. For each shading point
it samples points z on mesh edges (`scene.edge_table`), keeps silhouette
configurations and accumulates the zero-primal per-lane quantity

    -(g_far - g_near) * <n_hat, P_perp(dz/dtheta)> / dist * |P_perp(e)| * SumL

where g_far / g_near are the integrand just outside / inside the occluder,
n_hat the silhouette's direction-space normal toward the unoccluded side,
and dz/dtheta flows through the edge endpoints' vertex positions: the only
attached factor. The primal value of every added term is exactly 0, so
primal renders are untouched (JAX boundary.py:1-41 has the derivation and
the truncation notes: direct-lighting boundaries are exact; `lookahead=1`
adds an order-1 radiance difference for indirect shadows).

Autograd: everything but the edge point z is computed on `scene.detach()`
(the JAX package's stop_gradient sites), so the only graph these terms add
is z's. The replay walk of `li_grad` builds no graph at all: its
throughput multiplies a term whose primal is 0, so its own derivative
contributes nothing.

One divergence from the JAX package: `primary_boundary_image` takes its
uniforms as arguments, by default drawn from a `torch.Generator` seeded
with the same seed, where the JAX package draws them with `jax.random`
threefry (boundary.py:299-300, :328). The port's splat pass therefore uses
other edge samples for the same seed (ROADMAP C15).

Spans (utils/stats.span): `grad` is render_grad's whole forward,
`grad.edges` the NEE edge terms, `grad.splat` the splat pass; the BSDF and
emitter calls of the replay walk and the edge terms are `shading`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..models import sensor as sensorlib
from ..ops import trace
from ..ops.gather import gather_rows
from ..utils.stats import span
from .common import RenderConfig
from .path import DIMS_PER_BOUNCE, RAY_EPS, SENSOR_DIMS


class BoundaryConfig(NamedTuple):
    """The JAX package's BoundaryConfig (boundary.py:57-81), same defaults."""

    n_edge: int = 8            # edge samples per shading point
    edge_dim_base: int = 2048  # sampler dims reserved for edge sampling
    primary: bool = True       # camera-silhouette splat pass (render_grad)
    n_primary: int = 16384     # global edge samples for that pass
    importance: bool = True    # silhouette-importance edge CDF
    imp_floor: float = 0.05    # uniform mixture floor (unbiasedness)
    imp_primary: bool = False  # importance CDF for the splat pass too
    lookahead: int = 0         # 0: emission-only radiance difference; 1: plus
    #                            K-sample direct lighting on both sides
    n_la: int = 2              # K NEE samples of the lookahead
    la_dim_base: int = 4096    # sampler dims reserved for the lookahead


def _norm(v):
    return torch.sqrt(m.dot(v, v))


def _face_normals(sc, fid, normalize):
    vi = sc.indices[torch.clamp_min(fid, 0)]
    a = sc.vertices[vi[:, 0]]
    ng = m.cross(sc.vertices[vi[:, 1]] - a, sc.vertices[vi[:, 2]] - a)
    return m.normalize(ng) if normalize else ng


def _front(sc, fid, w):
    """Whether face `fid` faces against the directions w."""
    return m.dot(_face_normals(sc, fid, False), w) < 0.0


def _sample_edges(scene, sc, u0, u1, edge_w, origin):
    """Edge points for uniforms u0 (which edge) and u1 (where on it), seen
    from `origin`: (row, 1/pdf per unit length, z, z0, w, dist). The edge
    is drawn from the length-uniform CDF, or from `edge_w` (detached);
    z = (1-u1) v0 + u1 v1 is attached to scene.vertices (the one
    theta-live factor), z0 is z detached, and w, dist the unit direction
    and distance from `origin` to z0."""
    et = sc.edge_table
    lens = _norm(sc.vertices[et[:, 1]] - sc.vertices[et[:, 0]])
    w_imp = lens if edge_w is None else edge_w.detach()
    W = torch.sum(w_imp)
    cdf = torch.cumsum(w_imp, 0) / torch.clamp_min(W, 1e-20)
    inv_pdf = W * lens / torch.clamp_min(w_imp, 1e-20)
    eidx = torch.clamp(torch.searchsorted(cdf, u0.contiguous()), 0, et.shape[0] - 1)
    row = et[eidx]
    z = ((1.0 - u1[:, None]) * gather_rows(scene.vertices, row[:, 0])
         + u1[:, None] * gather_rows(scene.vertices, row[:, 1]))
    z0 = z.detach()
    r = z0 - origin
    dist = _norm(r)
    return row, inv_pdf[eidx], z, z0, r / torch.clamp_min(dist, 1e-12)[:, None], dist


def edge_importance(scene, anchor, tau: float = 0.05, floor: float = 0.05):
    """Detached per-edge sampling weights (E,) concentrating on the
    silhouettes seen from `anchor` (JAX boundary.py:84-121): an edge is an
    anchor silhouette where its two faces disagree about facing the anchor
    (margin tau), open edges always; mixed with a `floor` of uniform mass so
    every edge stays sampleable. w_e = len_e * (floor + (1-floor) * sil_e)."""
    sc = scene.detach()
    et = sc.edge_table
    v0 = sc.vertices[et[:, 0]]
    v1 = sc.vertices[et[:, 1]]
    lens = _norm(v1 - v0)
    dirs = m.normalize(anchor.detach()[None, :] - 0.5 * (v0 + v1))
    ca = m.dot(_face_normals(sc, et[:, 2], True), dirs)
    cb = m.dot(_face_normals(sc, et[:, 3], True), dirs)
    sil = (et[:, 3] < 0) | (ca * cb < tau)
    return lens * (floor + (1.0 - floor) * sil)


def emitter_anchor(scene):
    """Power-weighted mean position of the area emitters, the silhouette
    anchor of NEE shadow boundaries; the mesh centroid where there is no
    emitter (JAX boundary.py:124-142). Detached."""
    sc = scene.detach()
    vi = sc.indices
    a = sc.vertices[vi[:, 0]]
    b = sc.vertices[vi[:, 1]]
    c = sc.vertices[vi[:, 2]]
    cen = (a + b + c) / 3.0
    area = 0.5 * _norm(m.cross(b - a, c - a))
    em = sc.tri_emitter
    lum = torch.sum(sc.emitters.radiance[torch.clamp_min(em, 0)], -1)
    wt = torch.where(em >= 0, area * lum, 0.0)
    W = torch.sum(wt)
    anchor = torch.sum(cen * wt[:, None], 0) / torch.clamp_min(W, 1e-20)
    return torch.where(W > 1e-12, anchor, torch.mean(cen, 0))


def _emitted_radiance(scene, prim, d, valid):
    """Radiance emitted toward -d by triangle `prim` (front side only),
    the environment's for misses (JAX boundary.py:145-157)."""
    with span("shading"):
        em = scene.tri_emitter[prim]
        le = gather_rows(scene.emitters.radiance, torch.clamp_min(em, 0))
        le = torch.where((valid & (em >= 0) & _front(scene, prim, d))[:, None], le, 0.0)
        return torch.where(valid[:, None], le, emitterlib.env_radiance(scene, d))


def _edge_geometry(sc, row, z0, w, dist):
    """Direction-space geometry of the projected edge at z0 seen along w:
    (rate, n_hat), rate = |P_perp e_hat| / dist and n_hat the curve's
    normal oriented away from the occluder (the owning face's opposite
    vertex side; at a silhouette both faces fold onto one side)."""
    ehat = m.normalize(sc.vertices[row[:, 1]] - sc.vertices[row[:, 0]])
    t_perp = ehat - m.dot(ehat, w, keepdims=True) * w
    rate = _norm(t_perp) / torch.clamp_min(dist, 1e-12)
    n_hat = m.normalize(m.cross(w, t_perp))
    mvec = sc.vertices[row[:, 4]] - z0
    m_perp = mvec - m.dot(mvec, w, keepdims=True) * w
    n_hat = n_hat * torch.where(m.dot(n_hat, m_perp) > 0, -1.0, 1.0)[:, None]
    return rate, n_hat


def _normal_velocity(z, z0, w, n_hat, dist):
    """<n_hat, P_perp(z - z0)> / dist: primal 0, derivative the edge
    point's velocity normal to the silhouette curve."""
    zd = z - z0
    v_perp = zd - m.dot(zd, w, keepdims=True) * w
    return m.dot(v_perp, n_hat) / torch.clamp_min(dist, 1e-12)


def nee_boundary(scene, p, ns, sp, wi_local, families, u_edge, edge_w=None,
                 u_la=None):
    """(N,3) zero-primal boundary gradient of the direct-lighting integral
    at shading points p (JAX boundary.py:160-274). u_edge: (N, M, 2)
    uniforms; edge_w: optional (E,) importance weights (None: length-
    uniform); u_la: optional (N, M, K, 3) uniforms that turn on the order-1
    radiance lookahead (emission + K-sample direct lighting on both sides
    of the edge, not emission only)."""
    with span("grad.edges"):
        return _nee_boundary(scene, p, ns, sp, wi_local, families, u_edge, edge_w, u_la)


def _nee_boundary(scene, p, ns, sp, wi_local, families, u_edge, edge_w, u_la):
    sc = scene.detach()
    n, M, _ = u_edge.shape
    pf = torch.repeat_interleave(p.detach(), M, dim=0)      # (N*M,3)
    row, inv_pdf, z, z0, w, dist = _sample_edges(
        scene, sc, u_edge[..., 0].reshape(-1), u_edge[..., 1].reshape(-1), edge_w, pf)

    # silhouette test: the owning face's facing against the neighbour's
    f_own = row[:, 2]
    f_nbr = row[:, 3]
    own_front = _front(sc, f_own, w)
    sil = torch.where(f_nbr < 0, True, own_front != _front(sc, f_nbr, w))
    rate, n_hat = _edge_geometry(sc, row, z0, w, dist)

    # visibility p -> z (shortened so the edge's own faces do not count)
    # and the radiance difference across the edge
    occ_seg = trace.shadow_blocked(sc, pf, w, dist)
    o_far = z0 + w * RAY_EPS
    its_far = trace.closest_hit(sc, o_far, w)
    # near side: the face of the edge that fronts p (exactly one does at a
    # silhouette), whichever of the two is stored as the owner
    f_vis = torch.where((f_nbr >= 0) & ~own_front, f_nbr, f_own)
    vis_front = _front(sc, f_vis, w)
    if u_la is None:
        L_far = _emitted_radiance(sc, its_far.prim, w, its_far.valid)
        em_vis = sc.tri_emitter[f_vis]
        le_vis = sc.emitters.radiance[torch.clamp_min(em_vis, 0)]
        L_near = torch.where((em_vis >= 0) & vis_front, 1.0, 0.0)[:, None] * le_vis
    else:
        # order-1 lookahead. Near side: a synthetic hit on the visible
        # face at z (t = dist, zero barycentrics: surface_interaction
        # recomputes them), masked where no face fronts p
        u_flat = u_la.reshape(n * M, u_la.shape[2], 3)
        L_far = _radiance_direct(sc, o_far, w, its_far, u_flat)
        zero = torch.zeros_like(dist)
        its_near = trace.Intersection(valid=vis_front, t=dist, prim=f_vis, b1=zero, b2=zero)
        L_near = torch.where(vis_front[:, None],
                             _radiance_direct(sc, pf, w, its_near, u_flat), 0.0)
    dL = L_far - L_near

    # BSDF factor at p toward w (the receiver cosine included)
    wo_local = m.to_local(torch.repeat_interleave(ns.detach(), M, dim=0), w)
    sp_rep = bsdflib.map_tensors(lambda a: torch.repeat_interleave(a.detach(), M, dim=0), sp)
    with span("shading"):
        f_val, _ = bsdflib.eval_pdf(sp_rep, torch.repeat_interleave(wi_local.detach(), M, dim=0),
                                    wo_local, families)

    live = sil & ~occ_seg
    scale = torch.where(live, rate, 0.0) * inv_pdf
    vn = _normal_velocity(z, z0, w, n_hat, dist)
    contrib = -(dL * f_val) * (vn * scale)[:, None]        # (N*M,3)
    return torch.mean(contrib.reshape(n, M, 3), dim=1)


def primary_boundary_image(scene, cam, n_samples, seed, spp_lookahead=4,
                           edge_w=None, u=None, u_la=None):
    """Camera-silhouette boundary gradient as an image-space splat pass
    (the redner strategy; JAX boundary.py:277-362): sample edge points
    globally, project each to its pixel and scatter-add the zero-primal
    boundary contribution. Returns a zero-primal (H, W, 3) image to add to
    the rendered image before the loss; the radiance difference across the
    silhouette uses a direct-lighting lookahead.

    u: (n_samples, 2) edge uniforms and u_la: (n_samples, spp_lookahead, 3)
    lookahead uniforms; each not given is drawn from a torch.Generator
    seeded with `seed` (the JAX package draws both with jax.random from
    PRNGKey(seed))."""
    with span("grad.splat"):
        return _primary_boundary_image(scene, cam, n_samples, seed, spp_lookahead, edge_w, u,
                                       u_la)


def _primary_boundary_image(scene, cam, n_samples, seed, spp_lookahead, edge_w, u, u_la):
    sc = scene.detach()
    dev = sc.device
    if u is None or u_la is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        if u is None:
            u = torch.rand((n_samples, 2), generator=gen, device=dev)
        if u_la is None:
            u_la = torch.rand((n_samples, spp_lookahead, 3), generator=gen, device=dev)
    o = cam.to_world[:3, 3].detach().expand(n_samples, 3)
    row, inv_pdf, z, z0, w, dist = _sample_edges(scene, sc, u[:, 0], u[:, 1], edge_w, o)
    sil = torch.where(row[:, 3] < 0, True,
                      _front(sc, row[:, 2], w) != _front(sc, row[:, 3], w))
    occ_seg = trace.shadow_blocked(sc, o, w, dist)
    px, py, in_frame, _ = sensorlib.world_to_raster(cam, z0)

    # radiance difference across the edge (direct-lighting lookahead)
    o_far = z0 + w * RAY_EPS
    L_far = _radiance_direct(sc, o_far, w, trace.closest_hit(sc, o_far, w), u_la)
    L_near = _radiance_direct(sc, o, w, trace.closest_hit(sc, o, w), u_la)
    dL = L_far - L_near

    rate, n_hat = _edge_geometry(sc, row, z0, w, dist)
    vn = _normal_velocity(z, z0, w, n_hat, dist)

    # per-pixel mean-radiance normalisation: the pixel's solid angle from
    # the ray differentials at the sample's own direction
    ddx, ddy = sensorlib.ray_differentials(cam, w)
    omega_pix = torch.clamp_min(torch.abs(m.dot(m.cross(ddx, ddy), w)), 1e-12)

    live = sil & ~occ_seg & in_frame
    scale = torch.where(live, rate, 0.0) * inv_pdf / (omega_pix * n_samples)
    contrib = -dL * (vn * scale)[:, None]                    # (Ns,3)

    ix = torch.clamp(px.to(torch.int64), 0, cam.width - 1)
    iy = torch.clamp(py.to(torch.int64), 0, cam.height - 1)
    img = torch.zeros((cam.height, cam.width, 3), dtype=contrib.dtype, device=dev)
    return img.index_put((iy, ix), torch.where(live[:, None], contrib, 0.0),
                         accumulate=True)


def _radiance_direct(sc, o, d, its, u3s):
    """Emission + the mean of K NEE samples at a hit: the lookahead of the
    radiance difference (JAX boundary.py:365-377). u3s: (N, K, 3). On the
    detached scene `sc`, so detached."""
    si = trace.surface_interaction(sc, o, d, its)
    L = _emitted_radiance(sc, its.prim, d, its.valid)
    acc = torch.zeros_like(L)
    for kk in range(u3s.shape[1]):
        acc = acc + _nee_once(sc, si, its, u3s[:, kk], sc.bsdf_families)
    return L + acc / u3s.shape[1]


def _nee_once(sc, si, its, u3, families):
    """One NEE sample of direct lighting at the hit (JAX boundary.py:380-390)."""
    wi_l = m.to_local(si["ns"], si["wi_world"])
    with span("shading"):
        ds = emitterlib.sample_direct(sc, si["p"], u3)
        wo_l = m.to_local(si["ns"], ds.d)
        sp = bsdflib.gather_shade_point(sc, si["mat"], si["uv"], u_blend=u3[:, 2], aux=si)
        f_val, _ = bsdflib.eval_pdf(sp, wi_l, wo_l, families)
    blocked = trace.shadow_blocked(sc, si["p"], ds.d, ds.dist)
    nee = f_val * ds.radiance * m.safe_div(torch.ones_like(ds.pdf), ds.pdf)[:, None]
    return torch.where((its.valid & (ds.pdf > 0) & ~blocked)[:, None], nee, 0.0)


def li_grad(scene, cam, o, d, stream, cfg: RenderConfig,
            bc: BoundaryConfig = BoundaryConfig()) -> torch.Tensor:
    """Differentiable path radiance: path.li's estimator plus the
    edge-sampled NEE boundary term at every path vertex (JAX
    boundary.py:393-478). The primal equals path.li's exactly (every added
    term is zero-primal); differentiate it with respect to scene.vertices.
    Camera silhouettes are `primary_boundary_image`'s (see render_grad)."""
    from . import path as pathmod

    n = o.shape[0]
    families = scene.bsdf_families

    def bounce_u(bounce, k):
        return stream.at_dim(SENSOR_DIMS + bounce * DIMS_PER_BOUNCE + k)

    def edge_u(tag, bounce):
        base = bc.edge_dim_base + (bounce * 2 + tag) * (2 * bc.n_edge)
        us = [stream.at_dim(base + i) for i in range(2 * bc.n_edge)]
        return torch.stack(us, -1).reshape(n, bc.n_edge, 2)

    def la_u(bounce):
        if bc.lookahead <= 0:
            return None
        nd = bc.n_edge * bc.n_la * 3
        base = bc.la_dim_base + bounce * nd
        us = [stream.at_dim(base + i) for i in range(nd)]
        return torch.stack(us, -1).reshape(n, bc.n_edge, bc.n_la, 3)

    L = pathmod.li(scene, cam, o, d, stream, cfg)

    # silhouette-importance edge CDF, anchored at the emitters (shadow
    # silhouettes are light-view silhouettes)
    edge_w = (edge_importance(scene, emitter_anchor(scene), floor=bc.imp_floor)
              if bc.importance else None)

    # walk the path again (same sample stream, so the same vertices) and
    # add the NEE boundary term at each shading vertex, weighted by the
    # throughput up to it. RR here omits path.li's eta^2 scale: the replay
    # walk is its own estimator of the boundary sum.
    sc = scene.detach()
    beta = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    active = torch.ones((n,), dtype=torch.bool, device=o.device)
    o_c, d_c = o.detach(), d.detach()
    for t in range(cfg.max_depth):
        its = trace.closest_hit(sc, o_c, d_c)
        si = trace.surface_interaction(sc, o_c, d_c, its)
        active = active & its.valid
        ns = si["ns"]
        wi_local = m.to_local(ns, si["wi_world"])
        u_blend = bounce_u(t, 7)
        with span("shading"):
            sp = bsdflib.gather_shade_point(sc, si["mat"], si["uv"], u_blend=u_blend, aux=si)
        if t < cfg.max_depth - 1:
            bterm = nee_boundary(scene, si["p"], ns, sp, wi_local, families,
                                 edge_u(0, t), edge_w=edge_w, u_la=la_u(t))
            L = L + torch.where(active[:, None], beta * bterm, 0.0)
        # continue exactly as path.li's BSDF sampling does
        u_lobe = bounce_u(t, 3)
        u2 = torch.stack([bounce_u(t, 4), bounce_u(t, 5)], -1)
        with span("shading"):
            wo, weight, pdf, is_delta = bsdflib.sample(sp, wi_local, u_lobe, u2, families)
        d_new = m.to_world(ns, wo)
        beta_new = beta * weight
        alive = (active & (t < cfg.max_depth - 1) & (pdf > 0.0)
                 & (torch.amax(beta_new, -1) > 0.0))
        q = torch.clamp_min(torch.clamp_max(torch.amax(beta_new, -1), 0.95), 0.05)
        if t >= cfg.rr_depth - 1:
            alive = alive & (bounce_u(t, 6) < q)
            beta_new = beta_new / q[:, None]
        off = torch.where(m.dot(d_new, si["ng"]) > 0, RAY_EPS, -RAY_EPS)
        o_c = torch.where(alive[:, None], si["p"] + si["ng"] * off[:, None], o_c)
        d_c = torch.where(alive[:, None], d_new, d_c)
        beta = torch.where(alive[:, None], beta_new, 0.0)
        active = alive
    return L


def render_grad(scene, cam, cfg: RenderConfig,
                bc: BoundaryConfig = BoundaryConfig()) -> torch.Tensor:
    """Differentiable render (JAX boundary.py:481-498): the path image plus
    the per-vertex NEE boundary terms (li_grad) plus the camera-silhouette
    splat pass. Its primal equals the plain path render; the gradient of a
    loss of this image with respect to scene.vertices includes every
    visibility boundary term. A scene with a medium raises: the boundary
    terms are those of vacuum transport (its sigma_t and albedo gradients
    come from common.render(volpath.li))."""
    from . import common as commonmod

    if scene.medium is not None:
        raise NotImplementedError(
            "boundary.render_grad has no medium transport: differentiate "
            "common.render(scene, cam, volpath.li, cfg) instead")

    with span("grad"):
        img = commonmod.render(
            scene, cam, lambda s, c, o, d, st, cf: li_grad(s, c, o, d, st, cf, bc), cfg)
        if bc.primary and bc.n_primary > 0:
            edge_w = (edge_importance(scene, cam.to_world[:3, 3], floor=bc.imp_floor)
                      if bc.imp_primary else None)
            img = img + primary_boundary_image(scene, cam, bc.n_primary, cfg.seed ^ 0x5EED,
                                               edge_w=edge_w)
        return img
