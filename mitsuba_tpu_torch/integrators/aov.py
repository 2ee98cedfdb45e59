"""AOV integrators: depth, position and normal fields, albedo, ambient
occlusion and motion vectors (port of integrators/aov.py; the reference's
src/integrators/misc/{ao,field,depth,motion}.cpp).
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core import warp
from ..core.rng import SampleStream, uniform
from ..models import bsdf as bsdflib
from ..models import sensor as sensorlib
from ..ops import trace
from .common import RenderConfig

SENSOR_DIMS = 4
RAY_EPS = 1e-3


def _primary(scene, o, d):
    its = trace.closest_hit(scene, o, d)
    return its, trace.surface_interaction(scene, o, d, its)


def li_depth(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> torch.Tensor:
    """The ray's distance to its first hit (misc/depth.cpp), 0 on a miss."""
    its = trace.closest_hit(scene, o, d)
    return torch.where(its.valid, its.t, 0.0)[:, None].expand(-1, 3)


def li_normal(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> torch.Tensor:
    """The shading normal field (misc/field.cpp 'shNormal')."""
    its, si = _primary(scene, o, d)
    return torch.where(its.valid[:, None], si["ns"], 0.0)


def li_position(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> torch.Tensor:
    its, si = _primary(scene, o, d)
    return torch.where(its.valid[:, None], si["p"], 0.0)


def li_albedo(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> torch.Tensor:
    its, si = _primary(scene, o, d)
    sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"], aux=si)
    return torch.where(its.valid[:, None], sp.reflectance, 0.0)


def li_ao(scene, cam, o, d, stream: SampleStream, cfg: RenderConfig) -> torch.Tensor:
    """Ambient occlusion (misc/ao.cpp): one cosine-weighted probe per
    sample, of length cfg.ao_length (1e6 where it is not positive)."""
    its, si = _primary(scene, o, d)
    ns, ng, p = si["ns"], si["ng"], si["p"]
    u2 = torch.stack([uniform(stream.seed, stream.pixel, stream.sample, SENSOR_DIMS),
                      uniform(stream.seed, stream.pixel, stream.sample, SENSOR_DIMS + 1)], -1)
    wo = m.to_world(ns, warp.square_to_cosine_hemisphere(u2))
    length = cfg.ao_length if cfg.ao_length > 0 else 1e6
    o2 = p + ng * torch.where(m.dot(wo, ng) > 0, RAY_EPS, -RAY_EPS)[:, None]
    blocked = trace.any_hit(scene, o2, wo, torch.full_like(p[:, 0], length))
    vis = torch.where(its.valid & ~blocked, 1.0, 0.0)
    return vis[:, None].expand(-1, 3)


def li_motion(scene, cam, o, d, stream, cfg):
    """Screen-space motion vectors (misc/motion.cpp): the primary hit
    projected at shutter open and close, (dx, dy, 0) in pixels; camera
    motion only."""
    its, si = _primary(scene, o, d)
    p = si["p"]
    px0, py0, v0, _ = sensorlib.world_to_raster(cam.replace(to_world_end=None), p)
    if cam.to_world_end is not None:
        cam1 = cam.replace(to_world=cam.to_world_end, to_world_end=None)
        px1, py1, v1, _ = sensorlib.world_to_raster(cam1, p)
    else:
        px1, py1, v1 = px0, py0, v0
    ok = its.valid & v0 & v1
    dx = torch.where(ok, px1 - px0, 0.0)
    dy = torch.where(ok, py1 - py0, 0.0)
    return torch.stack([dx, dy, torch.zeros_like(dx)], -1)
