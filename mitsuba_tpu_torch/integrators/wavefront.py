"""Regenerative wavefront path tracer — the fast primal renderer (port of
integrators/wavefront.py).

One lane per (pixel, lane slot). The moment a path terminates (miss, depth
cap, Russian roulette) its radiance is banked and the lane starts the
pixel's next sample in place, so the batch stays nearly full. The estimator
and the sample streams are path.li's: the same (pixel, sample, dim) hashing,
with the independent sampler. On scenes with texture mips that includes
path.li's EWA lookups at the primary hit, from the camera's ray
differentials (the JAX wavefront omits them and filters every hit
trilinearly; ROADMAP C26).

The JAX package runs the steps in one lax.while_loop; here a Python loop
reads one flag from the device per step to decide whether to go on.

`fuse` defers each step's NEE shadow ray into the next step's
`trace.closest_and_any`, one fused launch on the card's BVH path. `compact`
adds the compaction ladder: when the busy lanes fit a halved width, they
are gathered into it (lanes carry their pixel ids; the film becomes a
scatter-add). Both keep the estimator and the sample streams.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.rng import uniform
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..models import sensor as sensorlib
from ..ops import trace
from ..scene import ir as _ir
from .common import RenderConfig, mis_weight

SENSOR_DIMS = 4
DIMS_PER_BOUNCE = 8
RAY_EPS = 1e-3


def render(scene, cam, cfg: RenderConfig, lanes_per_pixel: int = 1,
           compact: bool = False, fuse: bool | None = None) -> torch.Tensor:
    """Full-frame render -> (H, W, 3) on the scene's device; primal only.

    fuse: defer the NEE shadow rays into the next step's fused dispatch
    (default: `trace.fuses(scene)`, where the dispatch is one launch;
    elsewhere it decomposes and fusing only adds state).
    compact: the compaction ladder over halving widths >= max(1024, n/16);
    it needs fuse and at least 4096 lanes, and raises without them rather
    than doing nothing. A scene with a medium raises: the wavefront has
    vacuum transport only (the JAX wavefront renders such a scene as
    vacuum without a word, ROADMAP C28)."""
    if scene.medium is not None:
        raise NotImplementedError(
            "wavefront.render has no medium transport: render a scene with a "
            "medium through common.render(scene, cam, volpath.li, cfg)")
    if fuse is None:
        fuse = trace.fuses(scene)
    if cfg.sampler != 0:
        # a lane's bounce dims depend on its data, which QMC's static dims
        # cannot express: the JAX wavefront hashes whatever cfg.sampler says
        raise ValueError("the wavefront needs the independent sampler (cfg.sampler=0); "
                         "render QMC samplers through common.render")
    if cfg.spp % lanes_per_pixel:
        raise ValueError(f"spp {cfg.spp} is not a multiple of lanes_per_pixel "
                         f"{lanes_per_pixel}")
    dev = scene.device
    w, h = cam.width, cam.height
    npix = w * h
    n = npix * lanes_per_pixel
    if compact and not (fuse and n >= 4 * 1024):
        raise ValueError(f"compact=True acts only with fuse and >= 4096 lanes "
                         f"(fuse={fuse}, {n} lanes)")
    spp_lane = cfg.spp // lanes_per_pixel
    families = scene.bsdf_families
    seed = cfg.seed

    pixel = torch.arange(npix, dtype=torch.int64, device=dev).repeat(lanes_per_pixel)
    lane_slot = torch.repeat_interleave(
        torch.arange(lanes_per_pixel, dtype=torch.int64, device=dev), npix)

    def camera_ray_at(pix, sample):
        jx = uniform(seed, pix, sample, 0)
        jy = uniform(seed, pix, sample, 1)
        u_lens = torch.stack([uniform(seed, pix, sample, 2),
                              uniform(seed, pix, sample, 3)], -1)
        o, d, _ = sensorlib.sample_rays(
            cam, (pix % w).to(torch.float32) + jx,
            (pix // w).to(torch.float32) + jy, u_lens)
        return o, d

    def f32(fill, *shape):
        return torch.full(shape, fill, dtype=torch.float32, device=dev)

    sample0 = lane_slot * spp_lane
    o0, d0 = camera_ray_at(pixel, sample0)
    state = dict(
        pix=pixel,                 # lane -> pixel id
        o=o0, d=d0,
        sample=sample0,            # current sample index per lane
        done=torch.zeros((n,), dtype=torch.int64, device=dev),  # finished samples
        bounce=torch.zeros((n,), dtype=torch.int64, device=dev),
        L_path=f32(0.0, n, 3),
        L_accum=f32(0.0, n, 3),
        beta=f32(1.0, n, 3),
        prev_pdf=f32(1.0, n),
        prev_delta=torch.ones((n,), dtype=torch.bool, device=dev),
        eta_scale=f32(1.0, n),
    )
    if fuse:
        # the previous step's NEE shadow ray, traced with this step's
        # closest-hit batch
        state.update(
            pend=torch.zeros((n,), dtype=torch.bool, device=dev),
            pend_o=f32(0.0, n, 3),
            pend_d=torch.tensor([[1.0, 0.0, 0.0]], device=dev).repeat(n, 1),
            pend_dist=f32(0.0, n),
            pend_contrib=f32(0.0, n, 3),
            # resolve into L_accum (the path completed) rather than L_path
            pend_accum=torch.zeros((n,), dtype=torch.bool, device=dev),
        )

    def busy_of(s):
        busy = s["done"] < spp_lane
        return busy | s["pend"] if fuse else busy

    def step(s):
        o, d = s["o"], s["d"]
        sample, t = s["sample"], s["bounce"]
        lane_live = s["done"] < spp_lane

        def bu(k):
            return uniform(seed, s["pix"], sample,
                           SENSOR_DIMS + t * DIMS_PER_BOUNCE + k)

        if fuse:
            # this step's closest batch and the last step's shadow batch in
            # one dispatch; retired lanes trace tmax = 0 rays
            tmax_c = torch.where(lane_live, 3e37, 0.0)
            its, blocked = trace.closest_and_any(
                scene, o, d, tmax_c, s["pend_o"], s["pend_d"],
                torch.where(s["pend"], s["pend_dist"], 0.0), cfg.occupancy_shadows)
            resolved = torch.where((s["pend"] & ~blocked)[:, None], s["pend_contrib"], 0.0)
            to_accum = s["pend_accum"][:, None]
            L_accum_in = s["L_accum"] + torch.where(to_accum, resolved, 0.0)
            L_path = s["L_path"] + torch.where(to_accum, 0.0, resolved)
        else:
            its = trace.closest_hit(scene, o, d)
            L_accum_in = s["L_accum"]
            L_path = s["L_path"]
        if scene.tex_mips is not None:
            # EWA's uv partials on the lanes at their primary hit, zero
            # (the trilinear footprint) elsewhere: path.li's lookups
            primary = (t == 0)[:, None]
            ddx, ddy = (torch.where(primary, dd, 0.0)
                        for dd in sensorlib.ray_differentials(cam, d))
            si = trace.surface_interaction(scene, o, d, its, dd_dx=ddx, dd_dy=ddy)
        else:
            si = trace.surface_interaction(scene, o, d, its)
        ns, ng, p = si["ns"], si["ng"], si["p"]
        wi_local = m.to_local(ns, si["wi_world"])
        beta = s["beta"]

        # escaped: environment
        env_le = emitterlib.env_radiance(scene, d)
        if scene.has_env:
            w_env = torch.where(
                s["prev_delta"], 1.0,
                mis_weight(cfg.mis_mode, s["prev_pdf"],
                           emitterlib.pdf_direct_env(scene, d)))
            if cfg.hide_emitters:
                w_env = torch.where(t == 0, 0.0, w_env)
            L_path = L_path + torch.where((lane_live & ~its.valid)[:, None],
                                          beta * env_le * w_env[:, None], 0.0)
        hit = lane_live & its.valid

        # emitted radiance
        em_id = si["emitter"]
        cos_l = m.dot(si["wi_world"], ng)
        le = scene.emitters.radiance[torch.clamp_min(em_id, 0)]
        le = torch.where(((em_id >= 0) & (cos_l > 0.0))[:, None], le, 0.0)
        pdf_em = emitterlib.pdf_direct_area(scene, o, d, its.t, its.prim, cos_l)
        w_bsdf = torch.where(s["prev_delta"], 1.0,
                             mis_weight(cfg.mis_mode, s["prev_pdf"], pdf_em))
        if cfg.hide_emitters:
            w_bsdf = torch.where(t == 0, 0.0, w_bsdf)
        L_path = L_path + torch.where(hit[:, None], beta * le * w_bsdf[:, None], 0.0)

        can_continue = t < (cfg.max_depth - 1)
        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"], u_blend=bu(7), aux=si)

        # NEE
        u_nee = torch.stack([bu(0), bu(1), bu(2)], -1)
        ds = emitterlib.sample_direct(scene, p, u_nee)
        wo_local = m.to_local(ns, ds.d)
        f_nee, pdf_b_nee = bsdflib.eval_pdf(sp, wi_local, wo_local, families)
        nee_ok = hit & can_continue & (ds.pdf > 0.0) & (torch.amax(f_nee, -1) > 0.0)
        w_nee = torch.where(ds.is_delta, 1.0,
                            mis_weight(cfg.mis_mode, ds.pdf, pdf_b_nee))
        contrib = beta * f_nee * ds.radiance * m.safe_div(w_nee, ds.pdf)[:, None]
        if not fuse:
            blocked = trace.shadow_blocked(scene, p, ds.d, ds.dist, cfg.occupancy_shadows)
            L_path = L_path + torch.where((nee_ok & ~blocked)[:, None], contrib, 0.0)

        # BSDF sample + continuation decision
        wo, weight, pdf, is_delta = bsdflib.sample(
            sp, wi_local, bu(3), torch.stack([bu(4), bu(5)], -1), families)
        d_new = m.to_world(ns, wo)
        eta_r = torch.where(
            (sp.type == _ir.BSDF_DIELECTRIC)
            & (m.cos_theta(wi_local) * m.cos_theta(wo) < 0),
            torch.where(m.cos_theta(wi_local) > 0, sp.eta[..., 0],
                        1.0 / sp.eta[..., 0]),
            1.0)
        eta_scale = s["eta_scale"] * eta_r
        beta_new = beta * weight
        alive = hit & can_continue & (pdf > 0.0) & (torch.amax(beta_new, -1) > 0.0)
        q = torch.clamp_max(torch.amax(beta_new, -1) * eta_scale * eta_scale, 0.95)
        q = torch.clamp_min(q, 0.05)
        do_rr = t >= (cfg.rr_depth - 1)
        survive = torch.where(do_rr, bu(6) < q, True)
        beta_new = beta_new / torch.where(do_rr, q, 1.0)[:, None]
        alive = alive & survive

        # --- regeneration ---------------------------------------------------
        died = lane_live & ~alive
        new_done = s["done"] + died
        L_accum = L_accum_in + torch.where(died[:, None], L_path, 0.0)
        new_sample = sample + died
        o_cam, d_cam = camera_ray_at(s["pix"], new_sample)
        regen = died & (new_done < spp_lane)

        off = torch.where(m.dot(d_new, ng) > 0, RAY_EPS, -RAY_EPS)[:, None]
        o_next = torch.where(regen[:, None], o_cam,
                             torch.where(alive[:, None], p + ng * off, o))
        d_next = torch.where(regen[:, None], d_cam,
                             torch.where(alive[:, None], d_new, d))
        out = dict(
            pix=s["pix"],
            o=o_next, d=d_next,
            sample=torch.where(died, new_sample, sample),
            done=new_done,
            bounce=torch.where(alive, t + 1, 0),
            L_path=torch.where(alive[:, None], L_path, 0.0),
            L_accum=L_accum,
            beta=torch.where(alive[:, None], beta_new, 1.0),
            prev_pdf=torch.where(alive, pdf, 1.0),
            prev_delta=torch.where(alive, is_delta, True),
            eta_scale=torch.where(alive, eta_scale, 1.0),
        )
        if fuse:
            out.update(
                pend=nee_ok,
                pend_o=p,
                pend_d=ds.d,
                pend_dist=torch.where(nee_ok, ds.dist, 0.0),
                pend_contrib=torch.where(nee_ok[:, None], contrib, 0.0),
                # a dying path's pending NEE lands in the banked accumulator
                pend_accum=died,
            )
        return out

    # one device->host read per step (the busy flag, or in a ladder stage
    # the busy count) decides whether to go on
    if compact:
        widths = []
        wdt = n // 2
        while wdt >= max(1024, n // 16):
            widths.append(max(-(-wdt // 1024) * 1024, 1024))
            wdt //= 2
        film = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
        for nxt in widths:
            # run the stage while the busy lanes outnumber the next width
            while int((busy := busy_of(state)).sum()) > nxt:
                state = step(state)
            film.index_add_(0, state["pix"], state["L_accum"])
            # stable: busy lanes first, in lane order; all of them fit
            idx = torch.argsort((~busy).to(torch.uint8), stable=True)[:nxt]
            state = {k: v[idx] for k, v in state.items()}
            state["L_accum"] = torch.zeros_like(state["L_accum"])
        while bool(busy_of(state).any()):
            state = step(state)
        img = film.index_add_(0, state["pix"], state["L_accum"])
    else:
        while bool(busy_of(state).any()):
            state = step(state)
        img = state["L_accum"].reshape(lanes_per_pixel, npix, 3).sum(0)
    img = torch.nan_to_num(img / cfg.spp, nan=0.0, posinf=0.0, neginf=0.0)
    return img.reshape(h, w, 3)
