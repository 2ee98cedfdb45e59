"""Stochastic progressive photon mapping and the fork's adaptive (CPPM)
radius strategies (port of integrators/sppm.py).

The analog of src/integrators/sppm/sppm.cpp and the fork's
SPPMFramework<GatherPoint> family (src/integrators/cppm/cppm_framework.h:35,
strategy variants cppm0-3.cpp). Per pass:

  1. camera pass: one sample a pixel traced to the first non-delta
     surface (delta chains followed through), giving gather points (pos,
     normal, beta, direct light: emission on delta-prefixed paths + NEE);
  2. photon pass: a wavefront of particles from the emitters; every
     non-delta bounce deposits a photon (pos, power, incident direction);
  3. gather: the photons of the second bounce on (the first hits are
     direct light, which the NEE above counts) go into a spatial hash
     (ops/hashgrid.py, for the kd-tree of photonmap.h:36); each gather
     point sums f(wi, wo) x power within its radius;
  4. progressive update of the per-pixel statistics: R'^2 = R^2 (N + a M)
     / (N + M), tau rescaled alike (Hachisuka & Jensen 2009): the
     "CPPM-prime" strategy; "constant" and "linear" are the fork's others
     (cppm1.cpp:93, cppm2.cpp:103).

A pass is a plain function of the pass index and the progressive state.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import math as m
from ..core.rng import uniform
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..models import sensor as sensorlib
from ..models.emitter import sample_emitter_ray
from ..ops import hashgrid, trace
from .common import RenderConfig

RAY_EPS = 1e-3

# the fork's radius strategies (cppm_framework.h + cppm0-3.cpp)
RADIUS_SPPM = 0       # "CPPM-prime": classic SPPM alpha-shrink
RADIUS_CONSTANT = 1   # "CPPM-constant": fixed radius (biased, low variance)
RADIUS_LINEAR = 2     # "CPPM-linear": r^2 ~ 1/pass


class SPPMState(NamedTuple):
    r2: torch.Tensor      # (Q,) current gather radius^2 per pixel
    n: torch.Tensor       # (Q,) accumulated photon count statistic
    tau: torch.Tensor     # (Q,3) accumulated unnormalised flux
    direct: torch.Tensor  # (Q,3) accumulated direct + specular-path radiance
    passes: torch.Tensor  # () float32, the number of completed passes


def state_from_jax(state, device="cuda") -> SPPMState:
    """A JAX package SPPMState (of numpy or JAX arrays) on `device`."""
    import numpy as np

    return SPPMState(*(torch.as_tensor(np.array(x, np.float32), device=device) for x in state))


def initial_state(npix: int, initial_radius: float, device) -> SPPMState:
    return SPPMState(
        r2=torch.full((npix,), initial_radius ** 2, dtype=torch.float32, device=device),
        n=torch.zeros((npix,), device=device), tau=torch.zeros((npix, 3), device=device),
        direct=torch.zeros((npix, 3), device=device),
        passes=torch.zeros((), device=device))


def scene_extent(scene) -> float:
    """The largest side of the vertices' bounding box."""
    v = scene.vertices
    return float(torch.max(torch.amax(v, 0) - torch.amin(v, 0)))


def _camera_pass(scene, cam, cfg, pass_idx: int, specular_depth: int = 4):
    """One sample a pixel traced to the first non-delta surface. Returns the
    gather points as a dict (pos, ns, wi, mat, uv, valid, beta) and the
    direct radiance collected on the way (emission on delta-prefixed
    paths + NEE at the gather point: the non-photon part of the
    estimator), under "direct"."""
    w, h = cam.width, cam.height
    npix = w * h
    dev = scene.device
    pid = torch.arange(npix, dtype=torch.int64, device=dev)

    def u(k):
        return uniform(cfg.seed, pid, pass_idx, k)

    px = (pid % w).to(torch.float32) + u(0)
    py = (pid // w).to(torch.float32) + u(1)
    o, d, _ = sensorlib.sample_rays(cam, px, py, torch.stack([u(2), u(3)], -1))

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((npix,) + shape, dtype=dtype, device=dev)

    beta = torch.ones((npix, 3), device=dev)
    L_direct = zeros(3)
    active = torch.ones((npix,), dtype=torch.bool, device=dev)
    prev_delta = torch.ones((npix,), dtype=torch.bool, device=dev)
    gp_pos, gp_ns, gp_wi, gp_uv = zeros(3), zeros(3), zeros(3), zeros(2)
    gp_mat = zeros(dtype=torch.int32)
    gp_valid = zeros(dtype=torch.bool)

    families = scene.bsdf_families
    delta_only = tuple(f for f in families if f in bsdflib.DELTA_FAMILIES)

    for t in range(specular_depth):
        its = trace.closest_hit(scene, o, d)
        si = trace.surface_interaction(scene, o, d, its)
        ns, ng, p = si["ns"], si["ng"], si["p"]
        # emitted radiance (only on delta-prefixed paths: MIS-free)
        em_id = si["emitter"]
        cos_l = m.dot(si["wi_world"], ng)
        le = scene.emitters.radiance[torch.clamp_min(em_id, 0)]
        vis = active & its.valid & (em_id >= 0) & (cos_l > 0.0) & prev_delta
        L_direct = L_direct + torch.where(vis[:, None], beta * le, 0.0)
        env = emitterlib.env_radiance(scene, d)
        L_direct = L_direct + torch.where((active & ~its.valid & prev_delta)[:, None],
                                          beta * env, 0.0)
        active = active & its.valid

        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"])
        is_delta_mat = torch.zeros((npix,), dtype=torch.bool, device=dev)
        for fam in delta_only:
            is_delta_mat = is_delta_mat | (sp.type == fam)

        # a non-delta surface: the gather point
        new_gp = active & ~is_delta_mat & ~gp_valid
        gp_pos = torch.where(new_gp[:, None], p, gp_pos)
        gp_ns = torch.where(new_gp[:, None], ns, gp_ns)
        gp_wi = torch.where(new_gp[:, None], si["wi_world"], gp_wi)
        gp_mat = torch.where(new_gp, si["mat"].to(torch.int32), gp_mat)
        gp_uv = torch.where(new_gp[:, None], si["uv"], gp_uv)
        gp_valid = gp_valid | new_gp

        # NEE at the new gather points (the photons carry indirect light
        # only: sppm.cpp makes the same split)
        u_nee = torch.stack([u(8 + 8 * t), u(9 + 8 * t), u(10 + 8 * t)], -1)
        ds = emitterlib.sample_direct(scene, p, u_nee)
        wi_local = m.to_local(ns, si["wi_world"])
        wo_local = m.to_local(ns, ds.d)
        f_nee, _ = bsdflib.eval_pdf(sp, wi_local, wo_local, families)
        # shadow ray from the raw point, t in (eps, dist (1 - eps))
        blocked = trace.any_hit(scene, p, ds.d, ds.dist)
        ok = new_gp & (ds.pdf > 0) & ~blocked
        L_direct = L_direct + torch.where(
            ok[:, None], beta * f_nee * ds.radiance / torch.clamp_min(ds.pdf, 1e-20)[:, None],
            0.0)

        # follow delta chains (mirror, glass) toward a non-delta surface
        cont = active & is_delta_mat & ~gp_valid
        wo, wgt, pdf, _ = bsdflib.sample(
            sp, wi_local, u(4 + 8 * t), torch.stack([u(5 + 8 * t), u(6 + 8 * t)], -1),
            families)
        d_new = m.to_world(ns, wo)
        o_new = p + ng * torch.where(m.dot(d_new, ng) > 0, RAY_EPS, -RAY_EPS)[:, None]
        beta = torch.where(cont[:, None], beta * wgt, beta)
        o = torch.where(cont[:, None], o_new, o)
        d = torch.where(cont[:, None], d_new, d)
        active = cont & (pdf > 0)

    return {"pos": gp_pos, "ns": gp_ns, "wi": gp_wi, "mat": gp_mat, "uv": gp_uv,
            "valid": gp_valid, "beta": beta, "direct": L_direct}


def _photon_pass(scene, cfg, pass_idx: int, n_photons: int, max_depth: int,
                 with_tags: bool = False):
    """A wavefront of photons; returns the flat deposits (pos, incident
    direction, power, valid), max_depth x n_photons rows
    (GatherPhotonProcess, gatherproc.h:35). With with_tags, also each
    deposit's depth and whether its last bounce sampled a delta lobe, so
    the photon mapper can split caustic and indirect maps (gatherproc.h
    ECausticPhotons / ESurfacePhotons)."""
    dev = scene.device
    seed = (cfg.seed ^ 0x9E3779B9) & 0xFFFFFFFF
    pid = torch.arange(n_photons, dtype=torch.int64, device=dev)

    def u(k):
        return uniform(seed, pid, pass_idx, k)

    ers = sample_emitter_ray(scene, u(0), torch.stack([u(1), u(2)], -1),
                             torch.stack([u(3), u(4)], -1))
    o, d, beta = ers.o, ers.d, ers.beta
    active = torch.ones((n_photons,), dtype=torch.bool, device=dev)
    families = scene.bsdf_families
    prev_delta = torch.zeros((n_photons,), dtype=torch.bool, device=dev)

    ph_pos, ph_dir, ph_pow, ph_valid, ph_depth, ph_prevdelta = [], [], [], [], [], []
    for t in range(max_depth):
        its = trace.closest_hit(scene, o, d)
        si = trace.surface_interaction(scene, o, d, its)
        active = active & its.valid
        ns, ng, p = si["ns"], si["ng"], si["p"]
        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"])
        non_delta = torch.zeros((n_photons,), dtype=torch.bool, device=dev)
        for fam in families:
            if fam not in bsdflib.DELTA_FAMILIES:
                non_delta = non_delta | (sp.type == fam)
        # deposit (a photon stores its direction toward the surface)
        ph_pos.append(p)
        ph_dir.append(-d)
        ph_pow.append(beta)
        ph_valid.append(active & non_delta)
        if with_tags:
            ph_depth.append(torch.full((n_photons,), t, dtype=torch.int32, device=dev))
            ph_prevdelta.append(prev_delta)

        wi_l = m.to_local(ns, si["wi_world"])
        wo, wgt, pdf, smp_delta = bsdflib.sample(
            sp, wi_l, u(5 + 4 * t), torch.stack([u(6 + 4 * t), u(7 + 4 * t)], -1), families)
        d_new = m.to_world(ns, wo)
        if with_tags:
            # the next deposit's "arrived by a specular bounce": the lobe
            # actually sampled (a composite BSDF can pick a delta one)
            prev_delta = torch.where(active, smp_delta, prev_delta)
        beta_new = beta * wgt
        alive = active & (pdf > 0) & (torch.amax(beta_new, -1) > 0)
        if t >= 2:      # Russian roulette
            q = torch.clamp(torch.amax(wgt, -1), 0.05, 0.95).detach()
            alive = alive & (u(8 + 4 * t) < q)
            beta_new = beta_new / q[:, None]
        beta = beta_new
        active = alive
        o = p + ng * torch.where(m.dot(d_new, ng) > 0, RAY_EPS, -RAY_EPS)[:, None]
        d = d_new

    base = (torch.cat(ph_pos), torch.cat(ph_dir), torch.cat(ph_pow), torch.cat(ph_valid))
    if with_tags:
        return base + (torch.cat(ph_depth), torch.cat(ph_prevdelta))
    return base


def broadcast_shade_point(sp):
    """sp's per-query fields with a window axis: (Q,) -> (Q, 1), (Q, k) ->
    (Q, 1, k), against (Q, window) candidates."""
    return bsdflib.map_tensors(lambda x: x[:, None] if x.ndim == 1 else x[:, None, :], sp)


def photon_flux(gp, sp_b, families, pdir, ppow, pidx, keep):
    """Each gather point's sum over the candidates `pidx` (Q, window) where
    `keep`: f(wi_cam, wi_photon) x power, with eval's cosine divided out
    (the density estimate is in area measure, cppmphotonmap.cpp:124's raw
    estimate). (Q, 3)."""
    wo_local = m.to_local(gp["ns"][:, None, :], pdir[pidx])
    wi_local = m.to_local(gp["ns"][:, None, :], gp["wi"][:, None, :])
    f, _ = bsdflib.eval_pdf(sp_b, wi_local, wo_local, families)
    # photons from behind the surface fail eval's cos > 0 checks
    cos_o = torch.clamp_min(m.cos_theta(wo_local), 1e-6)
    contrib = f / cos_o[..., None] * ppow[pidx]
    return torch.where(keep[..., None], contrib, 0.0).sum(1)


def one_pass(scene, cam, cfg, state: SPPMState, pass_idx: int, photons_per_pass: int,
             initial_radius: float, alpha: float, strategy: int, window: int,
             direct_photons: bool = False):
    """One camera pass, photon pass, gather and progressive update. Returns
    (the new state, the query's truncated count)."""
    npix = cam.width * cam.height
    dev = scene.device
    families = scene.bsdf_families
    gp = _camera_pass(scene, cam, cfg, pass_idx)
    pos, pdir, ppow, pvalid = _photon_pass(scene, cfg, pass_idx, photons_per_pass,
                                           cfg.max_depth)
    if not direct_photons:
        # the first photons_per_pass deposits are the first hits, direct
        # light that the camera pass's NEE already counts (ROADMAP C37)
        pvalid = pvalid & (torch.arange(pvalid.shape[0], device=dev) >= photons_per_pass)
    r = torch.sqrt(state.r2)
    cell = torch.clamp_min(torch.max(r), initial_radius * 0.25)
    grid = hashgrid.build(pos, pvalid, cell)
    sp_b = broadcast_shade_point(bsdflib.gather_shade_point(scene, gp["mat"], gp["uv"]))

    def reduce_fn(carry, pidx, mask):
        flux, count = carry
        keep = mask & pvalid[pidx]
        return (flux + photon_flux(gp, sp_b, families, pdir, ppow, pidx, keep),
                count + keep.sum(1))

    (flux, mcount), truncated = hashgrid.query_sum(
        grid, pos, gp["pos"], r, reduce_fn,
        (torch.zeros((npix, 3), device=dev), torch.zeros((npix,), dtype=torch.int64,
                                                          device=dev)),
        window=window)
    flux = torch.where(gp["valid"][:, None], flux * gp["beta"], 0.0)
    mcount_f = mcount.to(torch.float32)

    if strategy == RADIUS_CONSTANT:
        new_r2 = state.r2
        new_n = state.n + mcount_f
        new_tau = state.tau + flux
    elif strategy == RADIUS_LINEAR:
        shrink = (state.passes + 1.0) / (state.passes + 2.0)
        new_r2 = state.r2 * shrink
        new_n = state.n + mcount_f
        new_tau = (state.tau + flux) * shrink
    else:   # SPPM
        has = mcount_f > 0
        ratio = (state.n + alpha * mcount_f) / torch.clamp_min(state.n + mcount_f, 1.0)
        new_r2 = torch.where(has, state.r2 * ratio, state.r2)
        new_tau = torch.where(has[:, None], (state.tau + flux) * ratio[:, None], state.tau)
        new_n = state.n + alpha * mcount_f
    return (SPPMState(new_r2, new_n, new_tau, state.direct + gp["direct"], state.passes + 1.0),
            truncated)


def render(scene, cam, cfg: RenderConfig, n_passes: int = 8,
           photons_per_pass: int = 1 << 17, initial_radius: float | None = None,
           alpha: float = 0.7, strategy: int = RADIUS_SPPM, window: int = 64,
           direct_photons: bool = False):
    """Progressive photon mapping -> ((H, W, 3), {"truncated": [per pass],
    "r2": (Q,)}). The film is direct / passes + tau / (pi r^2 N_emitted).

    The photons gathered are those of the second bounce on: the camera
    pass's NEE counts the direct light. direct_photons=True gathers the
    first hits too, as the JAX package does, which counts the direct light
    twice (ROADMAP C37: the Cornell box at 256x256 renders ~24% above
    path.li's mean); it is kept for parity with the JAX package."""
    w, h = cam.width, cam.height
    npix = w * h
    if initial_radius is None:
        # scene-extent heuristic (sppm.cpp initialRadius auto mode)
        initial_radius = scene_extent(scene) * 5.0 / max(w, h)
    state = initial_state(npix, initial_radius, scene.device)
    truncs = []
    for i in range(n_passes):
        state, truncated = one_pass(scene, cam, cfg, state, i, photons_per_pass,
                                    initial_radius, alpha, strategy, window, direct_photons)
        truncs.append(int(truncated))

    total_photons = n_passes * photons_per_pass
    indirect = state.tau / (math.pi * state.r2[:, None] * total_photons)
    img = state.direct / n_passes + indirect
    return img.reshape(h, w, 3), {"truncated": truncs, "r2": state.r2}
