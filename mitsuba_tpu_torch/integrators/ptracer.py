"""Adjoint particle tracer: random walks from the emitters, splatted to the
sensor (port of integrators/ptracer.py; the reference's
src/integrators/ptracer, particleproc.h:128).

Emitter-sampled light paths carry power; every vertex connects to the
pinhole with a visibility ray and splats f G W_e onto the film, one
`index_add_` on the flattened film per splat. Camera importance of the
pinhole: W(omega) = 1 / (A_film cos^3), A_film the film's area at unit
distance; vertex x adds beta f_cos(x -> eye) / d^2 W (npix / N) to its
pixel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import math as m
from ..core.rng import uniform
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..models import sensor as sensorlib
from ..models.emitter import sample_emitter_ray
from ..ops import trace
from ..utils import graphs
from .bdpt import splat_to_film
from .common import RenderConfig

RAY_EPS = 1e-3
DIMS_PER_BOUNCE = 8
# particles traced at once
CHUNK = 1 << 19


def _chunking(cam, cfg: RenderConfig, n_particles: int | None):
    """(particles, chunk): spp x npix particles unless given, in chunks of
    at most CHUNK (a divisor of the count)."""
    if n_particles is None:
        n_particles = cam.width * cam.height * cfg.spp
    chunk = min(n_particles, CHUNK)
    while n_particles % chunk:
        chunk -= 1
    return n_particles, chunk


def _trace_chunk(scene, cam, cfg: RenderConfig, pid, film):
    """Trace the particles `pid` ((n,) int64 ids) and splat them onto film
    ((H W, 3)): one chunk of the loop, the work render_jit captures."""
    families = scene.bsdf_families
    eye = cam.to_world[:3, 3]
    fwd = cam.to_world[:3, 2]
    film_area = sensorlib.film_area(cam)
    dev = pid.device
    chunk = pid.shape[0]

    def splat(p, beta_f):
        """beta_f (= beta f_cos) through the pinhole onto the film."""
        px, py, valid, _ = sensorlib.world_to_raster(cam, p)
        to_eye = eye[None, :] - p
        d2 = torch.clamp_min(m.dot(to_eye, to_eye), 1e-12)
        dir_e = to_eye / torch.sqrt(d2)[:, None]
        cos_cam = torch.clamp_min(m.dot(-dir_e, fwd[None, :]), 1e-6)
        blocked = trace.any_hit(scene, p + dir_e * RAY_EPS, dir_e, torch.sqrt(d2))
        weight = m.safe_div(1.0, d2 * film_area * cos_cam ** 3)
        ok = valid & ~blocked
        splat_to_film(film, cam, px, py, torch.where(ok[:, None], beta_f * weight[:, None], 0.0))

    def u(dim, sample=0):
        return uniform(cfg.seed, pid, sample, dim)

    ers = sample_emitter_ray(scene, u(0), torch.stack([u(1), u(2)], -1),
                             torch.stack([u(3), u(4)], -1))
    o, d, beta = ers.o, ers.d, ers.beta
    # the emission vertex (area lights only: a delta position is invisible
    # to the camera, an infinite light has no surface): the camera sees Le
    # directly, so the area-measure throughput is beta_pos = beta / pi and
    # the connection's "f_cos" is cos_x
    cos_x = torch.clamp_min(m.dot(m.normalize(eye[None, :] - o), ers.ng), 0.0)
    splat(o, torch.where(ers.is_area[:, None], (beta / math.pi) * cos_x[:, None], 0.0))

    active = torch.ones((chunk,), dtype=torch.bool, device=dev)
    for t in range(cfg.max_depth - 1):
        its = trace.closest_hit(scene, o, d)
        si = trace.surface_interaction(scene, o, d, its)
        active = active & its.valid
        ns, ngs, p = si["ns"], si["ng"], si["p"]
        wi_local = m.to_local(ns, si["wi_world"])
        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"])

        # connect to the camera: f_cos toward the eye
        to_eye = eye[None, :] - p
        dir_e = to_eye / m.length(to_eye, keepdims=True)
        f_cos, _ = bsdflib.eval_pdf(sp, wi_local, m.to_local(ns, dir_e), families)
        off = torch.where(m.dot(dir_e, ngs) > 0, RAY_EPS, -RAY_EPS)
        splat(p + ngs * off[:, None], torch.where(active[:, None], beta * f_cos, 0.0))

        # continue the walk (importance transport: sample()'s weight
        # f cos / pdf is symmetric for these reciprocal BSDFs)
        dim0 = 8 + t * DIMS_PER_BOUNCE
        wo, weight, pdf, _ = bsdflib.sample(
            sp, wi_local, u(dim0, 1), torch.stack([u(dim0 + 1, 1), u(dim0 + 2, 1)], -1),
            families)
        d_new = m.to_world(ns, wo)
        beta_new = beta * weight
        alive = active & (pdf > 0.0) & (torch.amax(beta_new, -1) > 0.0)
        if t >= cfg.rr_depth - 1:       # Russian roulette
            q = torch.clamp(torch.amax(beta_new, -1), 0.05, 0.95).detach()
            beta_new = beta_new / q[:, None]
            alive = alive & (u(dim0 + 3, 1) < q)
        o_new = p + ngs * torch.where(m.dot(d_new, ngs) > 0, RAY_EPS, -RAY_EPS)[:, None]
        o = torch.where(alive[:, None], o_new, o)
        d = torch.where(alive[:, None], d_new, d)
        beta = torch.where(alive[:, None], beta_new, 0.0)
        active = alive


def _finish(scene, cam, cfg: RenderConfig, film, n_particles: int) -> torch.Tensor:
    """The image from the film's splats of n_particles, plus the directly
    visible environment: an infinite light has no surface, so no particle
    splats it; it is the s=0 term, one jittered camera pass per pixel and
    slot (area emitters stay with the emission splat)."""
    dev = scene.device
    w, h = cam.width, cam.height
    npix = w * h
    img = film.reshape(h, w, 3) * float(np.float32(npix) / np.float32(n_particles))
    if scene.envmap is not None or scene.has_env:
        bg_spp = int(min(max(cfg.spp, 1), 8))
        pid = torch.arange(npix, dtype=torch.int64, device=dev).repeat(bg_spp)
        slot = torch.repeat_interleave(torch.arange(bg_spp, dtype=torch.int64, device=dev), npix)
        jx = uniform(cfg.seed, pid, slot + 2, 0)
        jy = uniform(cfg.seed, pid, slot + 2, 1)
        px = (pid % w).to(torch.float32) + jx
        py = (pid // w).to(torch.float32) + jy
        o_c, d_c, _ = sensorlib.sample_rays(
            cam, px, py, torch.zeros((npix * bg_spp, 2), dtype=torch.float32, device=dev))
        its = trace.closest_hit(scene, o_c, d_c)
        le = torch.where(~its.valid[:, None], emitterlib.env_radiance(scene, d_c), 0.0)
        img = img + le.reshape(bg_spp, npix, 3).mean(0).reshape(h, w, 3)
    return img


def render(scene, cam, cfg: RenderConfig, n_particles: int | None = None) -> torch.Tensor:
    """The light-traced image, (H, W, 3): spp x npix particles unless
    n_particles is given, in chunks of at most CHUNK (a divisor of the
    count)."""
    dev = scene.device
    n_particles, chunk = _chunking(cam, cfg, n_particles)
    film = torch.zeros((cam.height * cam.width, 3), dtype=torch.float32, device=dev)
    for ci in range(n_particles // chunk):
        _trace_chunk(scene, cam, cfg,
                     torch.arange(chunk, dtype=torch.int64, device=dev) + ci * chunk, film)
    return _finish(scene, cam, cfg, film, n_particles)


class _ParticleGraph:
    """render_jit's cache entry: static copies of the scene and camera, the
    chunk's first particle id on the device, the film, and the piece that
    traces one chunk into it."""

    def __init__(self, scene, cam, cfg: RenderConfig, n_particles: int, chunk: int):
        dev = scene.device
        self.statics = graphs.Statics(scene, cam)
        s_scene, s_cam = self.statics.trees
        self.base = torch.zeros((), dtype=torch.int64, device=dev)
        lanes = torch.arange(chunk, dtype=torch.int64, device=dev)
        self.film = torch.zeros((cam.height * cam.width, 3), dtype=torch.float32, device=dev)
        self.piece = graphs.Piece(
            lambda: _trace_chunk(s_scene, s_cam, cfg, lanes + self.base, self.film))

    def render(self, scene, cam, cfg: RenderConfig, n_particles: int, chunk: int):
        self.statics.load(scene, cam)
        self.film.zero_()
        for ci in range(n_particles // chunk):
            self.base.fill_(ci * chunk)
            self.piece.run()
        return _finish(scene, cam, cfg, self.film, n_particles)


_GRAPHS = graphs.Cache()


def render_jit(scene, cam, cfg: RenderConfig, n_particles: int | None = None) -> torch.Tensor:
    """`render`, compiled and cached as the JAX package's render_jit is
    (utils/graphs.py). On the card the first call of a key (cfg, the
    particle count, the scene's and camera's static_key) traces its first
    chunk eagerly and captures the chunk (emission, walk, every splat into
    a static film); every later chunk and call of the key replays it with
    the chunk's first particle id written into a device tensor. The
    environment's camera pass runs eagerly once per call. On the CPU this
    is `render`. A failed capture raises; a leaf that requires grad raises
    NotImplementedError."""
    graphs.refuse_grad("ptracer.render_jit", scene, cam)
    if scene.device.type != "cuda":
        return render(scene, cam, cfg, n_particles)
    n_particles, chunk = _chunking(cam, cfg, n_particles)
    key = (cfg, n_particles, graphs.static_key(scene, cam))
    with _GRAPHS.lock, torch.cuda.device(scene.device):
        entry = _GRAPHS.get(key, lambda: _ParticleGraph(scene, cam, cfg, n_particles, chunk))
        return entry.render(scene, cam, cfg, n_particles, chunk)
