"""Virtual point lights, the preview renderer (port of integrators/vpl.py;
the reference's src/librender/vpl.cpp:76 and src/integrators/vpl).

The VPLs are the LVC-BPT light cache (lvcbpt.build_light_cache, with
max(N // 16, 256) light paths for a batch of N rays); each camera ray's
first hit connects to M of them, picked uniformly, with the geometry
term's distance clamped (the classic VPL bias against fireflies,
vpl.cpp m_clamping).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as m
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..ops import trace
from .common import RenderConfig
from .lvcbpt import _packed, _rows, build_light_cache

CLAMP_DIST2 = 0.05   # the geometry term's clamp on d^2
N_VPL = 8            # connections per ray


def li(scene, cam, o, d, stream, cfg: RenderConfig) -> torch.Tensor:
    n = o.shape[0]
    families = scene.bsdf_families
    n_paths = max(n // 16, 256)
    M = N_VPL
    cache = build_light_cache(scene, cfg, n_paths, 1.0)
    V = cache.pos.shape[0]
    table = _packed(cache)
    # float32, as the JAX package divides
    scale = float(np.float32(V) / np.float32(M * n_paths))

    its = trace.closest_hit(scene, o, d)
    si = trace.surface_interaction(scene, o, d, its)
    ns, ng, p = si["ns"], si["ng"], si["p"]
    wi_local = m.to_local(ns, si["wi_world"])
    active = its.valid

    # visible emitters and the environment
    em_id = si["emitter"]
    cos_l = m.dot(si["wi_world"], ng)
    le = scene.emitters.radiance[torch.clamp_min(em_id, 0)]
    L = torch.where((active & (em_id >= 0) & (cos_l > 0))[:, None], le, 0.0)
    L = L + torch.where(active[:, None], 0.0, emitterlib.env_radiance(scene, d))

    sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"])
    for j in range(M):
        vidx = torch.clamp_max((stream.at_dim(4 + j) * V).to(torch.int32), V - 1)
        r = _rows(table, vidx)
        lns = r["ns"]
        to_l = r["pos"] - p
        d2 = torch.clamp_min(m.dot(to_l, to_l), CLAMP_DIST2)   # the clamped G
        dist = m.length(to_l)
        cdir = to_l / torch.clamp_min(dist, 1e-9)[:, None]
        f_e, _ = bsdflib.eval_pdf(sp, wi_local, m.to_local(ns, cdir), families)
        is_emit = r["mat"] < 0
        cos_le = torch.clamp_min(m.dot(lns, -cdir), 0.0)
        sp_l = bsdflib.gather_shade_point(scene, torch.clamp_min(r["mat"], 0), r["uv"])
        f_l, _ = bsdflib.eval_pdf(sp_l, m.to_local(lns, r["wi"]), m.to_local(lns, -cdir),
                                  families)
        light_term = torch.where(is_emit[:, None], cos_le[:, None].expand(-1, 3), f_l)
        contrib = f_e * light_term * r["beta"] * (scale / d2)[:, None]
        ok = active & r["valid"] & (torch.amax(contrib, -1) > 0)
        blocked = trace.any_hit(scene, p, cdir, dist)
        L = L + torch.where((ok & ~blocked)[:, None], contrib, 0.0)
    return L
