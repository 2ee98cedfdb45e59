"""Volumetric photon mapping with a stepped beam radiance estimate (port of
integrators/bre.py).

The analog of src/integrators/photonmapper/bre.cpp: the reference builds a
BVH over volume photons and intersects the camera beam with per-photon
spheres; here the beam integral is a jittered fixed-step quadrature along
the ray, each step querying a hash grid of the volume photons with a 3D
kernel:

  photon pass: light paths scatter through the scene's medium (distance
  sampling + the phase function), a photon deposited at every medium
  event;
  camera pass: L = sum_k Tr(0, t_k) sigma_s(x_k) L_i(x_k, w) dt,
  L_i = (1 / (4/3 pi r^3)) sum_p W_p phase(w_p -> w).

Homogeneous and grid media both work (the density modulates deposition and
transmittance through models/medium.py's samplers).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import math as m
from ..core.rng import uniform
from ..models import emitter as emitterlib
from ..models import medium as medlib
from ..models import phase as phaselib
from ..models import sensor as sensorlib
from ..ops import hashgrid, trace
from ..utils import graphs
from .common import RenderConfig

MAX_VOL_BOUNCES = 4


def _is_grid(med) -> bool:
    return med.kind in (medlib.MEDIUM_GRID, medlib.MEDIUM_HGRID)


def trace_volume_photons(scene, cfg: RenderConfig, n_paths: int, seed: int):
    """Light paths through scene.medium; returns (pos (P,3), dir (P,3),
    power (P,3), valid (P,)) with P = n_paths x MAX_VOL_BOUNCES."""
    med = scene.medium
    lanes = torch.arange(n_paths, dtype=torch.int64, device=scene.device)

    def u(dim):
        return uniform(seed, lanes, 1, dim)

    ers = emitterlib.sample_emitter_ray(scene, u(0), torch.stack([u(1), u(2)], -1),
                                        torch.stack([u(3), u(4)], -1))
    o, d, beta = ers.o, ers.d, ers.beta

    ppos, pdir, ppow, pval = [], [], [], []
    active = torch.amax(beta, -1) > 0
    for b in range(MAX_VOL_BOUNCES):
        its = trace.closest_hit(scene, o, d)
        t_surf = torch.where(its.valid, its.t, 1e30)
        if _is_grid(med):
            t_m, is_med, w_med, _ = medlib.sample_distance_grid(
                med, lambda j, b=b: u(100 + b * 200 + j), o, d, t_surf)
        else:
            t_m, is_med, w_med, _ = medlib.sample_distance(med, u(10 + 8 * b), u(11 + 8 * b),
                                                           t_surf)
        t_m = torch.clamp_max(t_m, 3e7)
        event = active & is_med
        x = o + d * t_m[:, None]
        beta_evt = beta * w_med
        ppos.append(x)
        pdir.append(d)
        ppow.append(torch.where(event[:, None], beta_evt, 0.0))
        pval.append(event)
        # continue by phase sampling
        u2 = torch.stack([u(12 + 8 * b), u(13 + 8 * b)], -1)
        ph_ax = medlib.phase_axis(med, x)
        wo, pdf_ph = phaselib.sample(med.phase, med.g, -d, u2, med.phase_params, ph_ax)
        w_ph = phaselib.sample_weight(med.phase, med.g, -d, wo, pdf_ph, med.phase_params, ph_ax)
        o = x
        d = torch.where(event[:, None], wo, d)
        beta = torch.where(event[:, None], beta_evt * w_ph[:, None], 0.0)
        active = event
    return torch.cat(ppos), torch.cat(pdir), torch.cat(ppow), torch.cat(pval)


class _Beams(NamedTuple):
    """What every beam step reads: the volume photons and their hash grid,
    the camera rays, their step length and query radius, the kernel's
    normalisation, and the directly visible emitters' term."""
    pos: torch.Tensor
    pdir: torch.Tensor
    ppow: torch.Tensor
    grid: hashgrid.HashGrid
    o: torch.Tensor
    d: torch.Tensor
    imp: torch.Tensor
    dt: torch.Tensor
    radius_q: torch.Tensor
    kernel: object           # a 0-dim tensor, or a float where the radius is given
    emitted: torch.Tensor


def _prologue(scene, cam, cfg: RenderConfig, n_paths: int, steps: int,
              radius: float | None) -> _Beams:
    """The photon pass, the hash grid and the camera rays: the work before
    the beam steps (render_jit's prologue graph)."""
    med = scene.medium
    w, h = cam.width, cam.height
    npix = w * h
    dev = scene.device

    v = scene.vertices
    ext = torch.amax(v, 0) - torch.amin(v, 0)
    diag = torch.sqrt(torch.sum(ext * ext))
    r = radius if radius is not None else 0.02 * diag

    pos, pdir, ppow, pval = trace_volume_photons(scene, cfg, n_paths, cfg.seed + 3)
    # a given radius enters the grid as a tensor made on the device (a
    # captured prologue may not copy it from the host)
    cell = r if radius is None else torch.full((), r, dtype=torch.float32, device=dev)
    grid = hashgrid.build(pos, pval, cell)
    kernel = 1.0 / (4.0 / 3.0 * math.pi * r ** 3)

    lanes = torch.arange(npix, dtype=torch.int64, device=dev)
    px = (lanes % w).to(torch.float32) + _upix(cfg, lanes, 0)
    py = (lanes // w).to(torch.float32) + _upix(cfg, lanes, 1)
    o, d, imp = sensorlib.sample_rays(cam, px, py, _upix(cfg, lanes, 2)[:, None].repeat(1, 2))
    its = trace.closest_hit(scene, o, d)
    t_far = torch.where(its.valid, its.t, 0.3 * diag * 3.0)
    # a tensor of its own (not a view of r): the prologue graph writes it
    radius_q = torch.full((npix,), r, device=dev) if radius is not None \
        else r.expand(npix).contiguous()

    # directly visible emitters through the medium
    si = trace.surface_interaction(scene, o, d, its)
    em_id = si["emitter"]
    cos_l = m.dot(si["wi_world"], si["ng"])
    le = scene.emitters.radiance[torch.clamp_min(em_id, 0)]
    vis = its.valid & (em_id >= 0) & (cos_l > 0)
    tr_s = torch.exp(-med.sigma_t[None, :] * torch.clamp_max(t_far, 1e30)[:, None])
    emitted = torch.where(vis[:, None], tr_s * le, 0.0)
    return _Beams(pos, pdir, ppow, grid, o, d, imp, t_far / steps, radius_q, kernel, emitted)


def _upix(cfg: RenderConfig, lanes, dim):
    return uniform(cfg.seed, lanes, 0, dim)


def _beam_step(scene, cfg: RenderConfig, beams: _Beams, k, n_paths: int, window: int):
    """Step k's share of the beam integral, (npix, 3); k a Python int or a
    0-dim float32 tensor on the device (render_jit's step graph)."""
    med = scene.medium
    npix = beams.o.shape[0]
    dev = beams.o.device
    lanes = torch.arange(npix, dtype=torch.int64, device=dev)
    o, d, dt, pdir, ppow = beams.o, beams.d, beams.dt, beams.pdir, beams.ppow
    sigma_s = med.sigma_t * med.albedo

    def in_scatter(x):
        """(Q, window) candidates -> the phase-weighted photon power at x."""
        def reduce_fn(carry, pidx, mask):
            shape = pdir[pidx].shape
            ph_val, _ = phaselib.eval_pdf(
                med.phase, med.g, -pdir[pidx].reshape(-1, 3),
                d[:, None, :].expand(shape).reshape(-1, 3), med.phase_params,
                medlib.phase_axis(med, x[:, None, :].expand(shape).reshape(-1, 3)))
            contrib = ppow[pidx] * ph_val.reshape(mask.shape)[..., None]
            return (carry[0] + torch.sum(torch.where(mask[..., None], contrib, 0.0), dim=1),)
        return reduce_fn

    tk = (k + _upix(cfg, lanes, 3)) * dt
    x = o + d * tk[:, None]
    (li,), _ = hashgrid.query_sum(beams.grid, beams.pos, x, beams.radius_q, in_scatter(x),
                                  (torch.zeros((npix, 3), device=dev),), window=window)
    li = li * beams.kernel / n_paths
    if _is_grid(med):
        dens = medlib.density_at(med, x)
        # transmittance to tk: a jittered quadrature for grids
        tr = medlib.transmittance_grid(med, o, d, tk, _upix(cfg, lanes, 4), steps=16)
    else:
        dens = torch.ones((npix,), device=dev)
        tr = torch.exp(-med.sigma_t[None, :] * tk[:, None])
    return tr * sigma_s[None, :] * dens[:, None] * li * dt[:, None]


def _image(cam, beams: _Beams, L) -> torch.Tensor:
    L = L + beams.emitted
    return (L * beams.imp[:, None]).reshape(cam.height, cam.width, 3)


def render(scene, cam, cfg: RenderConfig, n_paths: int = 1 << 16, steps: int = 32,
           radius: float | None = None, window: int = 64) -> torch.Tensor:
    """Beam-gathered volumetric render -> (H, W, 3). Surfaces contribute
    their directly visible emission only (the reference pairs bre with the
    photon mapper's surface estimate; pair it with `direct` here)."""
    assert scene.medium is not None, "bre needs a participating medium"
    beams = _prologue(scene, cam, cfg, n_paths, steps, radius)
    L = torch.zeros((cam.width * cam.height, 3), device=scene.device)
    for k in range(steps):
        L = L + _beam_step(scene, cfg, beams, k, n_paths, window)
    return _image(cam, beams, L)


class _BeamGraph:
    """render_jit's cache entry: static copies of the scene and camera, the
    prologue's outputs (written in place by its graph), the step index on
    the device, the beam sum, and the pieces: the prologue and one step."""

    def __init__(self, scene, cam, cfg: RenderConfig, n_paths, steps, radius, window):
        dev = scene.device
        self.statics = graphs.Statics(scene, cam)
        s_scene, s_cam = self.statics.trees
        self.k = torch.zeros((), dtype=torch.float32, device=dev)
        self.L = torch.zeros((cam.width * cam.height, 3), device=dev)
        self.beams = None

        def prologue():
            return _prologue(s_scene, s_cam, cfg, n_paths, steps, radius)

        def step():
            self.L.add_(_beam_step(s_scene, cfg, self.beams, self.k, n_paths, window))

        self.prologue = prologue
        self.prologue_graph = None
        self.step = graphs.Piece(step)

    def render(self, scene, cam, steps: int) -> torch.Tensor:
        self.statics.load(scene, cam)
        if self.beams is None:
            # the first call's prologue runs eagerly and its outputs become
            # the tensors that the prologue's graph writes into
            with torch.no_grad():
                self.beams = self.prologue()
            self.prologue_graph = graphs.capture(
                lambda: graphs.copy_leaves(self.beams, self.prologue()))
        else:
            self.prologue_graph.replay()
        self.L.zero_()
        for k in range(steps):
            self.k.fill_(k)
            self.step.run()
        return _image(cam, self.beams, self.L)


_GRAPHS = graphs.Cache()


def render_jit(scene, cam, cfg: RenderConfig, n_paths: int = 1 << 16, steps: int = 32,
               radius: float | None = None, window: int = 64) -> torch.Tensor:
    """`render`, compiled and cached as the JAX package's render_jit is
    (utils/graphs.py). On the card the first call of a key (cfg, n_paths,
    steps, radius, window, the scene's and camera's static_key) runs the
    prologue (the volume photons, `hashgrid.build`'s sort, the camera rays
    and the emitters' term) eagerly and captures it as a graph that writes
    its outputs into the eager run's tensors; it renders the first beam
    step eagerly and captures the step (the hash-grid query's fixed window
    keeps every shape static), with k in a device tensor. Every later step
    replays the step graph; every later call of the key replays the
    prologue graph, then the steps. On the CPU this is `render`. A failed
    capture raises; a leaf that requires grad raises
    NotImplementedError."""
    assert scene.medium is not None, "bre needs a participating medium"
    graphs.refuse_grad("bre.render_jit", scene, cam)
    if scene.device.type != "cuda":
        return render(scene, cam, cfg, n_paths, steps, radius, window)
    key = (cfg, n_paths, steps, radius, window, graphs.static_key(scene, cam))
    with _GRAPHS.lock, torch.cuda.device(scene.device):
        entry = _GRAPHS.get(key, lambda: _BeamGraph(scene, cam, cfg, n_paths, steps, radius,
                                                     window))
        return entry.render(scene, cam, steps)
