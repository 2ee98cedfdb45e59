"""Light-vertex-cache bidirectional path tracing, LVC-BPT (port of
integrators/lvcbpt.py; the fork's flagship integrator,
src/integrators/myBDPT/LVCBPT.cpp:30-55).

A light pass traces n_paths light subpaths and keeps every vertex, the
emitter vertex included, in one flat cache; the eye pass connects each
eye vertex to M cache rows picked uniformly (connectSubpaths,
LVCBPT.cpp:704-744), reweighted by V / (M n_paths). The strategies are
BDPT's without the light image (eye hit s=0, z0 s=1, inner s>=2), so
the weights are bdptmis.py's; cfg.mis_mode picks the fork's MIS mode
(LVCBPT.cpp:88-96): 0 power, 1 balance, 2 uniform (1/k over the k
strategies of a k-edge path, numStrategy at LVCBPT.cpp:553; like the
fork it ignores delta lobes).

`li` builds its cache on every call with n_paths = max(N // 4, 1024), N
the batch's rays, so the image depends on common.render's spp chunk, as
in the JAX package. The cache's rows are fetched by one gather of a
packed float table per connection.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core.rng import SampleStream
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..models.emitter import EV_DIR, connect_emitter_vertex, sample_emitter_ray, scene_bsphere
from ..ops import trace
from . import bdptmis
from .bdpt import _cam_quantities, _mis_exp, _walk
from .common import RenderConfig

INV_PI = 1.0 / math.pi
# the light pass's seed offset
LIGHT_SEED = 0x51CBA7


class LightCache(NamedTuple):
    """Flat cache of light vertices (m_LVC, LVCBPT.cpp:120): rows 0..n-1
    hold the emitter vertices z0, each following block of n rows one depth
    of surface vertices."""

    pos: torch.Tensor        # (V,3)
    ns: torch.Tensor         # (V,3)
    ng: torch.Tensor         # (V,3)
    wi: torch.Tensor         # (V,3) toward the previous vertex (z0: the ray direction)
    beta: torch.Tensor       # (V,3) throughput (z0 rows: beta_pos)
    mat: torch.Tensor        # (V,) int32 material (-1: an emitter vertex)
    uv: torch.Tensor         # (V,2)
    depth: torch.Tensor      # (V,) int32 edges from the emitter (z0: 0)
    valid: torch.Tensor      # (V,) bool
    delta: torch.Tensor      # (V,) bool: the vertex's BSDF sample was a delta lobe
    dvcm: torch.Tensor       # (V,) MIS state on arrival (bdptmis)
    dvc: torch.Tensor        # (V,)
    # z0 rows' emitter data (where mat == -1)
    ekind: torch.Tensor      # (V,) int32 EV_*
    eaux: torch.Tensor       # (V,3) spot axis / infinite light's ray direction
    ecut: torch.Tensor       # (V,2) spot (cos cutoff, cos beam)
    epdf_pos: torch.Tensor   # (V,) z0's pdf in its own measure


def build_light_cache(scene, cfg: RenderConfig, n_paths: int, b: float) -> LightCache:
    """The light pass: one walk over n_paths lanes (traceLightSubpath,
    LVCBPT.cpp:322), its vertices kept."""
    dev = scene.device
    pid = torch.arange(n_paths, dtype=torch.int64, device=dev)
    zeros_i = torch.zeros((n_paths,), dtype=torch.int64, device=dev)
    stream = SampleStream(cfg.seed ^ LIGHT_SEED, pid, zeros_i, 0, kind=0, spp=cfg.spp)
    u_sel = stream.at_dim(0)
    u_pos = torch.stack([stream.at_dim(1), stream.at_dim(2)], -1)
    u_dir = torch.stack([stream.at_dim(3), stream.at_dim(4)], -1)
    ers = sample_emitter_ray(scene, u_sel, u_pos, u_dir)
    st0 = bdptmis.light_start(ers, b)
    S = max(cfg.max_depth - 1, 0)
    lw = _walk(scene, scene.bsdf_families, stream, 5, ers.o, ers.d, ers.beta, st0, b, S,
               first_inf=ers.is_env | (ers.kind == EV_DIR))

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    n = n_paths
    neg1 = full((n,), -1, torch.int32)
    rows = dict(pos=[ers.pos], ns=[ers.ng], ng=[ers.ng], wi=[ers.d], beta=[ers.beta_pos],
                mat=[neg1], uv=[full((n, 2), 0.0)], depth=[full((n,), 0, torch.int32)],
                valid=[full((n,), True, torch.bool)], delta=[full((n,), False, torch.bool)],
                dvcm=[full((n,), 0.0)], dvc=[full((n,), 0.0)], ekind=[ers.kind],
                eaux=[ers.aux_dir], ecut=[ers.cutoff], epdf_pos=[ers.pdf_pos])
    for k in range(S):
        for key in ("ns", "ng", "wi", "beta", "uv", "valid", "delta", "dvcm", "dvc"):
            rows[key].append(lw[key][k])
        rows["pos"].append(lw["p"][k])
        rows["mat"].append(lw["mat"][k].to(torch.int32))
        rows["depth"].append(full((n,), k + 1, torch.int32))
        rows["ekind"].append(neg1)
        rows["eaux"].append(full((n, 3), 0.0))
        rows["ecut"].append(full((n, 2), 0.0))
        rows["epdf_pos"].append(full((n,), 0.0))
    return LightCache(**{k: torch.cat(v) for k, v in rows.items()})


# the packed row: (field, width); integer and boolean fields are exact as float32
_PACKED = (("pos", 3), ("ns", 3), ("ng", 3), ("wi", 3), ("beta", 3), ("uv", 2), ("eaux", 3),
           ("ecut", 2), ("dvcm", 1), ("dvc", 1), ("epdf_pos", 1), ("mat", 1), ("depth", 1),
           ("valid", 1), ("ekind", 1))


def _packed(cache: LightCache) -> torch.Tensor:
    cols = []
    for name, width in _PACKED:
        x = getattr(cache, name).to(torch.float32)
        cols.append(x.reshape(x.shape[0], width))
    return torch.cat(cols, 1)


def _rows(table: torch.Tensor, vidx: torch.Tensor) -> dict:
    """The cache rows vidx, unpacked: one gather."""
    g = table[vidx]
    out, c = {}, 0
    for name, width in _PACKED:
        out[name] = g[:, c:c + width] if width > 1 else g[:, c]
        c += width
    for name in ("mat", "depth", "ekind"):
        out[name] = out[name].to(torch.int32)
    out["valid"] = out["valid"] > 0.5
    return out


def li(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig,
       n_connect: int = 4) -> torch.Tensor:
    """The eye pass over a batch of rays; the cache is built from cfg.seed
    on each call and shared by every ray of the batch."""
    b = _mis_exp(cfg)
    uniform_mode = cfg.mis_mode == 2
    n = o.shape[0]
    dev = o.device
    M = n_connect
    families = scene.bsdf_families
    T = cfg.max_depth
    occ = cfg.occupancy_shadows
    n_paths = max(n // 4, 1024)
    cache = build_light_cache(scene, cfg, n_paths, b)
    V = cache.pos.shape[0]
    table = _packed(cache)
    # float32, as the JAX package divides
    cache_scale = float(np.float32(V) / np.float32(M * n_paths))

    em = scene.emitters
    _, e1a, e2a = scene.tri_vertices()
    area_all = 0.5 * m.length(m.cross(e1a, e2a))
    pg_area, _, _ = emitterlib._group_probs(scene)
    _, r_bs = scene_bsphere(scene)
    disk_pdf = 1.0 / (math.pi * r_bs * r_bs)

    pdf_cam_sa, _ = _cam_quantities(cam, d)
    st0 = bdptmis.camera_start(1, pdf_cam_sa, b, light_image=False)
    ones3 = torch.ones((n, 3), dtype=torch.float32, device=dev)
    eye = _walk(scene, families, stream, 4, o, d, ones3, st0, b, T)
    base = 4 + 8 * T                     # the connections' pick dims

    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    def full(value):
        return torch.full((n,), value, dtype=torch.float32, device=dev)

    # ---------------- eye hits (s = 0) ---------------------------------
    for t in range(1, T + 1):
        i = t - 1
        em_id = eye["em"][i]
        cos_l = m.dot(eye["wi"][i], eye["ng"][i])
        hit = eye["valid"][i] & (em_id >= 0) & (cos_l > 0.0)
        le = em.radiance[torch.clamp_min(em_id, 0)]
        if uniform_mode:
            w = full(1.0 if t == 1 else 1.0 / t)
        else:
            prim = torch.clamp_min(eye["prim"][i], 0)
            direct_a = m.safe_div(em.select_pdf_full[prim] * pg_area, area_all[prim])
            emission = direct_a * torch.clamp_min(cos_l, 0.0) * INV_PI
            st_i = bdptmis.MisState(eye["dvcm"][i], eye["dvc"][i])
            w = bdptmis.weight_hit_area(st_i, direct_a, emission, b)
        L = L + torch.where(hit[:, None], eye["beta"][i] * le * w[:, None], 0.0)

        if scene.has_env:
            d_i = eye["d_in"][i]
            le_env = emitterlib.env_radiance(scene, d_i)
            if cfg.hide_emitters and t == 1:
                le_env = torch.zeros_like(le_env)
            if i == 0:
                w_env = full(1.0)
            elif uniform_mode:
                w_env = full(1.0 / t)
            else:
                w_env = bdptmis.weight_hit_env(eye["st_pre"][i],
                                               emitterlib.pdf_direct_env(scene, d_i),
                                               disk_pdf, b)
            L = L + torch.where(eye["escaped"][i][:, None],
                                eye["beta"][i] * le_env * w_env[:, None], 0.0)

    # ---------------- cache connections --------------------------------
    for t in range(1, T + 1):
        i = t - 1
        yp, yns, yng = eye["p"][i], eye["ns"][i], eye["ng"][i]
        sp_y = bsdflib.gather_shade_point(scene, eye["mat"][i], eye["uv"][i])
        wi_y = m.to_local(yns, eye["wi"][i])
        st_y = bdptmis.MisState(eye["dvcm"][i], eye["dvc"][i])
        for j in range(M):
            uj = stream.at_dim(base + i * M + j)
            vidx = torch.clamp_max((uj * V).to(torch.int32), V - 1)
            r = _rows(table, vidx)
            lp, lns, lng = r["pos"], r["ns"], r["ng"]
            is_emit = r["mat"] < 0

            cdir_e, dist_e, g_e, _ = connect_emitter_vertex(scene, yp, r["ekind"], lp, lns,
                                                            r["eaux"], r["ecut"])
            to_l = lp - yp
            d2 = torch.clamp_min(m.dot(to_l, to_l), 1e-12)
            cdir = torch.where(is_emit[:, None], cdir_e, to_l * torch.rsqrt(d2)[:, None])
            dist = torch.where(is_emit, dist_e, torch.sqrt(d2))

            wo_y = m.to_local(yns, cdir)
            f_y, pdf_y_sa = bsdflib.eval_pdf(sp_y, wi_y, wo_y, families)
            _, pdf_y_rev = bsdflib.eval_pdf(sp_y, wo_y, wi_y, families)

            sp_z = bsdflib.gather_shade_point(scene, torch.clamp_min(r["mat"], 0), r["uv"])
            wi_z = m.to_local(lns, r["wi"])
            wo_z = m.to_local(lns, -cdir)
            f_z, pdf_z_sa = bsdflib.eval_pdf(sp_z, wi_z, wo_z, families)
            _, pdf_z_rev = bsdflib.eval_pdf(sp_z, wo_z, wi_z, families)

            if uniform_mode:
                w = 1.0 / (t + r["depth"] + 1).to(torch.float32)
            else:
                w_z0 = bdptmis.weight_connect_z0(st_y, r["ekind"], lp, lns, r["eaux"],
                                                 r["ecut"], r["epdf_pos"], disk_pdf, yp, yng,
                                                 pdf_y_sa, pdf_y_rev, b)
                st_z = bdptmis.MisState(r["dvcm"], r["dvc"])
                w_in = bdptmis.weight_connect_inner(st_y, st_z, pdf_y_sa, pdf_y_rev, pdf_z_sa,
                                                    pdf_z_rev, m.dot(cdir, yng),
                                                    m.dot(-cdir, lng), d2, b)
                w = torch.where(is_emit, w_z0, w_in)

            light_term = torch.where(is_emit[:, None], g_e[:, None] * ones3, f_z / d2[:, None])
            contrib = eye["beta"][i] * f_y * light_term * r["beta"] * cache_scale * w[:, None]
            ok = (eye["valid"][i] & r["valid"] & (t + r["depth"] + 1 <= T)
                  & (torch.amax(contrib, -1) > 0.0))
            blocked = trace.shadow_blocked(scene, yp, cdir, dist, occ)
            contrib = torch.nan_to_num(contrib, nan=0.0, posinf=0.0, neginf=0.0)
            L = L + torch.where((ok & ~blocked)[:, None], contrib, 0.0)
    return L
