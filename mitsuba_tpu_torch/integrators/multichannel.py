"""Multichannel rendering: radiance and AOVs in one pass (port of
integrators/multichannel.py; the reference's misc/multichannel.cpp).

Every requested channel is evaluated on the same camera rays; the AOVs
reuse the primary intersection. The rays are batched by spp chunk
(RenderConfig.resolve_chunk); each sample keeps the JAX package's
(pixel, sample) indices, so the radiance channel draws the numbers
common.render draws.
"""
from __future__ import annotations

import torch

from ..core.rng import SampleStream
from ..models import bsdf as bsdflib
from ..models import sensor as sensorlib
from ..ops import trace
from . import path
from .common import RenderConfig


def render(scene, cam, cfg: RenderConfig,
           channels=("radiance", "depth", "normal", "albedo")) -> dict:
    """{channel: (H, W, 3) float32 image} for radiance, depth, normal,
    position and albedo."""
    dev = scene.device
    w, h = cam.width, cam.height
    spp = cfg.spp
    chunk = cfg.resolve_chunk(w, h)
    pids = torch.repeat_interleave(torch.arange(w * h, dtype=torch.int64, device=dev), chunk)
    slot = torch.arange(chunk, dtype=torch.int64, device=dev).repeat(w * h)
    sums = {}
    for c0 in range(0, spp, chunk):
        stream = SampleStream(cfg.seed, pids, slot + c0, 0, kind=cfg.sampler, spp=spp)
        jx = stream.next_1d()
        jy = stream.next_1d()
        u_lens = stream.next_2d()
        px = (pids % w).to(torch.float32) + jx
        py = (pids // w).to(torch.float32) + jy
        o, d, imp = sensorlib.sample_rays(cam, px, py, u_lens)

        outs = {}
        its = trace.closest_hit(scene, o, d)
        si = trace.surface_interaction(scene, o, d, its)
        if "radiance" in channels:
            outs["radiance"] = torch.nan_to_num(path.li(scene, cam, o, d, stream, cfg)
                                                * imp[:, None])
        if "depth" in channels:
            outs["depth"] = torch.where(its.valid, its.t, 0.0)[:, None].expand(-1, 3)
        if "normal" in channels:
            outs["normal"] = torch.where(its.valid[:, None], si["ns"], 0.0)
        if "position" in channels:
            outs["position"] = torch.where(its.valid[:, None], si["p"], 0.0)
        if "albedo" in channels:
            sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"], aux=si)
            outs["albedo"] = torch.where(its.valid[:, None], sp.reflectance, 0.0)
        for k, v in outs.items():
            part = v.reshape(h, w, chunk, 3).sum(2)
            sums[k] = part if k not in sums else sums[k] + part
    return {k: v / spp for k, v in sums.items()}
