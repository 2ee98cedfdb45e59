"""Bidirectional path tracing with per-pixel light subpaths, light paths
from every emitter kind, Veach MIS over every (s,t) strategy, and the t=1
light image (port of integrators/bdpt.py; the reference's
src/integrators/bdpt, bdpt_proc.cpp:163,283,347-352).

Both subpaths are dense per-depth lists of (N, ...) tensors from one
unrolled walk each; every (s,t) pair is a static loop iteration, and its
connection one shadow query. MIS uses bdptmis.py's streaming quantities.

`li` is the per-ray integrator without the light image (the camera-splat
strategies are left out of the MIS sums, so the weights still sum to 1
over the strategies used). `render` adds the light image: the t=1
strategies splat through the pinhole, one `index_add_` on the flattened
film per splat, and every weight counts them.
"""
from __future__ import annotations

import math

import torch

from ..core import math as m
from ..core.rng import SampleStream
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..models import sensor as sensorlib
from ..models.emitter import EV_DIR, connect_emitter_vertex, sample_emitter_ray, scene_bsphere
from ..ops import trace
from ..ops.gather import gather_rows
from ..utils import graphs
from . import bdptmis, common
from .common import RenderConfig

RAY_EPS = 1e-3
INV_PI = 1.0 / math.pi
_WALK_KEYS = ("p", "ns", "ng", "wi", "beta", "valid", "delta", "mat", "uv", "em", "prim",
              "dvcm", "dvc", "st_pre", "d_in", "escaped")


def _mis_exp(cfg) -> float:
    # cfg.mis_mode: 0 power, 1 balance; 2 (uniform) takes the balance
    # exponent here: the fork's uniform mode lives in lvcbpt
    return 2.0 if cfg.mis_mode == 0 else 1.0


def _walk(scene, families, stream, dim0, o, d, beta0, st0, b, depth, first_inf=None):
    """Unrolled random walk keeping each depth's vertex and its MIS state
    on arrival (after on_hit, before scattering)."""
    n = o.shape[0]
    v = {k: [] for k in _WALK_KEYS}
    beta = beta0
    active = torch.ones((n,), dtype=torch.bool, device=o.device)
    st = st0
    prev_p = o
    for i in range(depth):
        its = trace.closest_hit(scene, o, d)
        si = trace.surface_interaction(scene, o, d, its)
        v["st_pre"].append(st)          # the state before the hit (env escapes)
        v["d_in"].append(d)
        v["escaped"].append(active & ~its.valid)
        active_new = active & its.valid
        ns, ng, p = si["ns"], si["ng"], si["p"]
        dvec = p - prev_p
        dist2 = torch.clamp_min(m.dot(dvec, dvec), 1e-12)
        st_here = bdptmis.on_hit(st, dist2, m.dot(d, ng), b,
                                 skip_dist2=first_inf if i == 0 else None)
        for key, x in (("p", p), ("ns", ns), ("ng", ng), ("wi", si["wi_world"]),
                       ("beta", beta), ("valid", active_new), ("mat", si["mat"]),
                       ("uv", si["uv"]), ("em", si["emitter"]), ("prim", its.prim),
                       ("dvcm", st_here.dvcm), ("dvc", st_here.dvc)):
            v[key].append(x)
        active = active_new

        def u(k):
            return stream.at_dim(dim0 + 8 * i + k)

        spt = bsdflib.gather_shade_point(scene, si["mat"], si["uv"], u_blend=u(7))
        wi_local = m.to_local(ns, si["wi_world"])
        wo, wgt, pdf, is_delta = bsdflib.sample(spt, wi_local, u(3),
                                                torch.stack([u(4), u(5)], -1), families)
        v["delta"].append(is_delta)
        d_new = m.to_world(ns, wo)
        _, pdf_rev_sa = bsdflib.eval_pdf(spt, wo, wi_local, families)
        st = bdptmis.scatter(st_here, pdf, pdf_rev_sa, m.cos_theta(wo), is_delta, b)

        beta = beta * wgt
        active = active & (pdf > 0) & (torch.amax(beta, -1) > 0)
        prev_p = p
        o = p + ng * torch.where(m.dot(d_new, ng) > 0, RAY_EPS, -RAY_EPS)[:, None]
        d = d_new
    return v


def _cam_quantities(cam, d):
    """(the pinhole's solid-angle pdf of each camera ray, the film's area
    at unit distance)."""
    cos_cam = torch.clamp_min(m.dot(d, cam.to_world[:3, 2][None, :]), 1e-6)
    film_area = sensorlib.film_area(cam)
    return m.safe_div(1.0, film_area * cos_cam ** 3), film_area


def splat_to_film(film, cam, px, py, contrib):
    """Add contrib at the raster positions (px, py), clipped to the film,
    onto `film`, a flattened (H W, 3) image: one index_add_ (atomics on
    the card, so the order of the sums varies from run to run there)."""
    xi = torch.clamp(px.to(torch.int32), 0, cam.width - 1)
    yi = torch.clamp(py.to(torch.int32), 0, cam.height - 1)
    film.index_add_(0, (yi * cam.width + xi).to(torch.int64), contrib)


def _li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig, light_image: bool,
        film=None):
    """The shared body: L (N,3); with light_image, the t=1 splats are added
    onto `film` (flattened, (H W, 3))."""
    b = _mis_exp(cfg)
    n = o.shape[0]
    dev = o.device
    families = scene.bsdf_families
    max_edges = cfg.max_depth
    T = max_edges
    S = max(max_edges - 1, 0)
    nlp = cam.width * cam.height       # light subpaths per sample slot
    occ = cfg.occupancy_shadows

    em = scene.emitters
    _, e1a, e2a = scene.tri_vertices()
    area_all = 0.5 * m.length(m.cross(e1a, e2a))
    pg_area, _, _ = emitterlib._group_probs(scene)
    _, r_bs = scene_bsphere(scene)
    disk_pdf = 1.0 / (math.pi * r_bs * r_bs)
    eye_pos = cam.to_world[:3, 3]
    fwd = cam.to_world[:3, 2]

    # --- eye subpath ----------------------------------------------------
    pdf_cam_sa, film_area = _cam_quantities(cam, d)
    st_cam0 = bdptmis.camera_start(nlp, pdf_cam_sa, b, light_image)
    ones3 = torch.ones((n, 3), dtype=torch.float32, device=dev)
    eye = _walk(scene, families, stream, 4, o, d, ones3, st_cam0, b, T)

    # --- light subpath --------------------------------------------------
    base = 4 + 8 * T
    u_sel = stream.at_dim(base)
    u_pos = torch.stack([stream.at_dim(base + 1), stream.at_dim(base + 2)], -1)
    u_dir = torch.stack([stream.at_dim(base + 3), stream.at_dim(base + 4)], -1)
    ers = sample_emitter_ray(scene, u_sel, u_pos, u_dir)
    st_l0 = bdptmis.light_start(ers, b)
    inf_light = ers.is_env | (ers.kind == EV_DIR)
    light = _walk(scene, families, stream, base + 5, ers.o, ers.d, ers.beta, st_l0, b, S,
                  first_inf=inf_light)

    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    def splat(p, contrib, active):
        """contrib (all but the camera's importance) through the pinhole
        onto the film."""
        px, py, valid, _ = sensorlib.world_to_raster(cam, p)
        to_eye = eye_pos[None, :] - p
        d2 = torch.clamp_min(m.dot(to_eye, to_eye), 1e-12)
        dir_e = to_eye * torch.rsqrt(d2)[:, None]
        cos_cam = torch.clamp_min(m.dot(-dir_e, fwd[None, :]), 1e-6)
        # from the raw point: any_hit clips to (SHADOW_EPS, t (1 - SHADOW_EPS))
        blocked = trace.shadow_blocked(scene, p, dir_e, torch.sqrt(d2), occ)
        w_e = m.safe_div(1.0, d2 * film_area * cos_cam ** 3)
        ok = valid & ~blocked & active
        c = torch.nan_to_num(torch.where(ok[:, None], contrib * w_e[:, None], 0.0),
                             nan=0.0, posinf=0.0, neginf=0.0)
        splat_to_film(film, cam, px, py, c)

    def state(walk, i):
        return bdptmis.MisState(walk["dvcm"][i], walk["dvc"][i])

    def shade(walk, i, wo_world):
        """(f, pdf toward wo, pdf back toward the predecessor) at vertex i."""
        sp = bsdflib.gather_shade_point(scene, walk["mat"][i], walk["uv"][i])
        ns = walk["ns"][i]
        wi = m.to_local(ns, walk["wi"][i])
        wo = m.to_local(ns, wo_world)
        f, pdf = bsdflib.eval_pdf(sp, wi, wo, families)
        _, pdf_rev = bsdflib.eval_pdf(sp, wo, wi, families)
        return f, pdf, pdf_rev

    # ================= s = 0: the eye path hits an emitter ==============
    for t in range(1, T + 1):
        i = t - 1
        em_id = eye["em"][i]
        cos_l = m.dot(eye["wi"][i], eye["ng"][i])
        hit = eye["valid"][i] & (em_id >= 0) & (cos_l > 0.0)
        le = gather_rows(em.radiance, torch.clamp_min(em_id, 0))
        prim = torch.clamp_min(eye["prim"][i], 0)
        direct_a = m.safe_div(gather_rows(em.select_pdf_full, prim) * pg_area,
                              gather_rows(area_all, prim))
        emission = direct_a * torch.clamp_min(cos_l, 0.0) * INV_PI
        w = bdptmis.weight_hit_area(state(eye, i), direct_a, emission, b)
        L = L + torch.where(hit[:, None], eye["beta"][i] * le * w[:, None], 0.0)

        # escaped rays see the environment (the pre-hit state: solid angle)
        if scene.has_env:
            d_i = eye["d_in"][i]
            le_env = emitterlib.env_radiance(scene, d_i)
            if cfg.hide_emitters and t == 1:
                le_env = torch.zeros_like(le_env)
            if i == 0:
                # camera -> env, one edge: the only strategy
                w_env = torch.ones((n,), dtype=torch.float32, device=dev)
            else:
                w_env = bdptmis.weight_hit_env(eye["st_pre"][i],
                                               emitterlib.pdf_direct_env(scene, d_i),
                                               disk_pdf, b)
            L = L + torch.where(eye["escaped"][i][:, None],
                                eye["beta"][i] * le_env * w_env[:, None], 0.0)

    # ================= s = 1: eye vertices to z0 ========================
    for t in range(1, T + 1):
        if 1 + t > max_edges:
            continue
        i = t - 1
        yp, yng = eye["p"][i], eye["ng"][i]
        cdir, dist, g, _ = connect_emitter_vertex(scene, yp, ers.kind, ers.pos, ers.ng,
                                                  ers.aux_dir, ers.cutoff)
        f_y, pdf_y_sa, pdf_y_rev = shade(eye, i, cdir)
        w = bdptmis.weight_connect_z0(state(eye, i), ers.kind, ers.pos, ers.ng, ers.aux_dir,
                                      ers.cutoff, ers.pdf_pos, disk_pdf, yp, yng, pdf_y_sa,
                                      pdf_y_rev, b)
        contrib = eye["beta"][i] * f_y * g[:, None] * ers.beta_pos
        ok = eye["valid"][i] & (torch.amax(contrib, -1) > 0.0)
        blocked = trace.shadow_blocked(scene, yp, cdir, dist, occ)
        L = L + torch.where((ok & ~blocked)[:, None], contrib * w[:, None], 0.0)

    # ============ inner connections: s >= 2, t >= 1 ====================
    for s in range(2, S + 2):
        k = s - 2                      # the junction's index in light[]
        for t in range(1, T + 1):
            if s + t > max_edges:
                continue
            i = t - 1
            zp, zng = light["p"][k], light["ng"][k]
            yp, yng = eye["p"][i], eye["ng"][i]
            to_z = zp - yp
            d2 = torch.clamp_min(m.dot(to_z, to_z), 1e-12)
            dist = torch.sqrt(d2)
            cdir = to_z * torch.rsqrt(d2)[:, None]
            f_y, pdf_y_sa, pdf_y_rev = shade(eye, i, cdir)
            f_z, pdf_z_sa, pdf_z_rev = shade(light, k, -cdir)
            w = bdptmis.weight_connect_inner(state(eye, i), state(light, k), pdf_y_sa,
                                             pdf_y_rev, pdf_z_sa, pdf_z_rev,
                                             m.dot(cdir, yng), m.dot(-cdir, zng), d2, b)
            contrib = eye["beta"][i] * f_y * f_z * light["beta"][k] / d2[:, None]
            ok = eye["valid"][i] & light["valid"][k] & (torch.amax(contrib, -1) > 0.0)
            blocked = trace.shadow_blocked(scene, yp, cdir, dist, occ)
            L = L + torch.where((ok & ~blocked)[:, None], contrib * w[:, None], 0.0)

    # ================= t = 1: the light image ===========================
    if light_image:
        # (s=1, t=1): the emitter vertex itself; area lights only (a delta
        # position is invisible, an infinite light has no surface)
        to_eye0 = eye_pos[None, :] - ers.pos
        d2_0 = torch.clamp_min(m.dot(to_eye0, to_eye0), 1e-12)
        dir_e0 = to_eye0 * torch.rsqrt(d2_0)[:, None]
        cos_x = torch.clamp_min(m.dot(dir_e0, ers.ng), 0.0)
        cos_cam0 = torch.clamp_min(m.dot(-dir_e0, fwd[None, :]), 1e-6)
        pdf_cam_a0 = m.safe_div(cos_x, d2_0 * film_area * cos_cam0 ** 3)
        w0 = bdptmis.weight_splat_z0(ers.pdf_pos, pdf_cam_a0, nlp, ers.is_area, b)
        splat(ers.pos, torch.where(ers.is_area[:, None], ers.beta_pos * (cos_x * w0)[:, None],
                                   0.0),
              torch.ones((n,), dtype=torch.bool, device=dev))

        # (s>=2, t=1): every light surface vertex
        for k in range(S):
            if k + 2 > max_edges:
                continue
            zp = light["p"][k]
            to_eye = eye_pos[None, :] - zp
            d2 = torch.clamp_min(m.dot(to_eye, to_eye), 1e-12)
            dir_e = to_eye * torch.rsqrt(d2)[:, None]
            f_z, _, pdf_z_rev = shade(light, k, dir_e)
            cos_cam = torch.clamp_min(m.dot(-dir_e, fwd[None, :]), 1e-6)
            cos_v = torch.abs(m.dot(dir_e, light["ng"][k]))
            pdf_cam_a = m.safe_div(cos_v, d2 * film_area * cos_cam ** 3)
            w = bdptmis.weight_splat(state(light, k), pdf_cam_a, nlp, pdf_z_rev, b)
            splat(zp, light["beta"][k] * f_z * w[:, None], light["valid"][k])

    return L


def li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> torch.Tensor:
    """Per-ray BDPT without the light image (the weights sum to 1 over the
    hit and connection strategies)."""
    return _li(scene, cam, o, d, stream, cfg, light_image=False)


def _chunk_image(scene, cam, cfg: RenderConfig, layout, base, chunk: int):
    """One spp chunk of the light image: (the eye strategies' per-pixel sum
    (H, W, 3), the t=1 splats' film (H, W, 3)) of the samples base + slot
    (common.chunk_layout; `base` a 0-dim int64 tensor on the device): the
    work render_jit captures."""
    w, h = cam.width, cam.height
    pixel_ids, sample_slot, px_base, py_base = layout
    stream = SampleStream(cfg.seed, pixel_ids, sample_slot + base, 0,
                          kind=cfg.sampler, spp=cfg.spp)
    jx = stream.next_1d()
    jy = stream.next_1d()
    u_lens = stream.next_2d()
    o, d, imp = sensorlib.sample_rays(cam, px_base + jx, py_base + jy, u_lens)
    film = torch.zeros((h * w, 3), dtype=torch.float32, device=o.device)
    L = _li(scene, cam, o, d, stream, cfg, light_image=True, film=film)
    L = torch.nan_to_num(L * imp[:, None], nan=0.0, posinf=0.0, neginf=0.0)
    return torch.sum(L.reshape(h, w, chunk, 3), dim=2), film.reshape(h, w, 3)


def _layout(scene, cam, cfg: RenderConfig):
    chunk = cfg.resolve_chunk(cam.width, cam.height)
    pixel_ids = torch.arange(cam.width * cam.height, dtype=torch.int64, device=scene.device)
    return chunk, common.chunk_layout(pixel_ids, chunk, cam.width)


def render(scene, cam, cfg: RenderConfig) -> torch.Tensor:
    """Full BDPT with the light image (bdpt_proc.cpp:347-352): the eye
    strategies accumulate per pixel, the t=1 strategies splat; both are
    divided by spp (w h light paths per sample slot). Box filter; the
    chunks are common.render's."""
    chunk, layout = _layout(scene, cam, cfg)
    img = torch.zeros((cam.height, cam.width, 3), dtype=torch.float32, device=scene.device)
    for ci in range(cfg.spp // chunk):
        eye, film = _chunk_image(scene, cam, cfg, layout,
                                 common._base(ci * chunk, scene.device), chunk)
        img = img + eye
        img = img + film
    return img / float(cfg.spp)


class _ChunkImageGraph:
    """render_jit's cache entry: static copies of the scene and camera, the
    chunk's sample base on the device, the image, and the piece that adds
    one chunk's eye sums and splats into it."""

    def __init__(self, scene, cam, cfg: RenderConfig):
        self.chunk, layout = _layout(scene, cam, cfg)
        self.statics = graphs.Statics(scene, cam)
        s_scene, s_cam = self.statics.trees
        self.base = common._base(0, scene.device)
        self.img = torch.zeros((cam.height, cam.width, 3), dtype=torch.float32,
                               device=scene.device)

        def add_chunk():
            eye, film = _chunk_image(s_scene, s_cam, cfg, layout, self.base, self.chunk)
            self.img.add_(eye)
            self.img.add_(film)

        self.piece = graphs.Piece(add_chunk)

    def render(self, scene, cam, cfg: RenderConfig) -> torch.Tensor:
        self.statics.load(scene, cam)
        self.img.zero_()
        for ci in range(cfg.spp // self.chunk):
            self.base.fill_(ci * self.chunk)
            self.piece.run()
        return self.img / float(cfg.spp)


_GRAPHS = graphs.Cache()


def render_jit(scene, cam, cfg: RenderConfig) -> torch.Tensor:
    """`render` (the light image), compiled and cached as the JAX package's
    render_jit is (utils/graphs.py): on the card the first call of a key
    (cfg, the scene's and camera's static_key) renders its first spp chunk
    eagerly and captures the chunk (the eye strategies' sums and the light
    image's `index_add_` splats into a static image); every later chunk and
    call of the key replays it with the chunk's sample base written into a
    device tensor. On the CPU this is `render`. A failed capture raises; a
    leaf that requires grad raises NotImplementedError."""
    graphs.refuse_grad("bdpt.render_jit", scene, cam)
    if scene.device.type != "cuda":
        return render(scene, cam, cfg)
    key = (cfg, graphs.static_key(scene, cam))
    with _GRAPHS.lock, torch.cuda.device(scene.device):
        entry = _GRAPHS.get(key, lambda: _ChunkImageGraph(scene, cam, cfg))
        return entry.render(scene, cam, cfg)
