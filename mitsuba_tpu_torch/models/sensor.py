"""Sensors: batched primary-ray generation (port of models/sensor.py).

Only the perspective pinhole camera is ported; the other sensor kinds and
two-keyframe motion blur raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import math as m

SENSOR_PERSPECTIVE = 0


@dataclasses.dataclass
class Camera:
    """Pinhole camera. `to_world` maps camera space (looking down +z) to
    world space."""

    to_world: torch.Tensor     # (4,4)
    fov_x: torch.Tensor        # scalar, degrees
    aperture: torch.Tensor     # scalar lens radius
    focus_dist: torch.Tensor   # scalar
    kc: torch.Tensor = None    # (2,) radial distortion
    to_world_end: torch.Tensor = None
    width: int = 256
    height: int = 256
    kind: int = SENSOR_PERSPECTIVE
    near: float = 1e-2

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def look_at(origin, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world matrix (Transform::lookAt)."""
    origin = np.asarray(origin, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = target - origin
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up / np.linalg.norm(up), fwd)
    right = right / np.linalg.norm(right)
    new_up = np.cross(fwd, right)
    mat = np.eye(4, dtype=np.float32)
    mat[:3, 0] = right
    mat[:3, 1] = new_up
    mat[:3, 2] = fwd
    mat[:3, 3] = origin
    return mat


def make_camera(origin, target, up=(0, 1, 0), fov_x=39.0, width=256, height=256,
                kind=SENSOR_PERSPECTIVE, aperture=0.0, focus_dist=1.0,
                kc=(0.0, 0.0), device="cpu") -> Camera:
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(
        to_world=f32(look_at(origin, target, up)),
        fov_x=f32(fov_x),
        aperture=f32(aperture),
        focus_dist=f32(focus_dist),
        kc=f32(kc),
        width=int(width),
        height=int(height),
        kind=int(kind),
    )


def camera_from_jax(jcam, device="cpu") -> Camera:
    """Carry a JAX package Camera across (leaves through `np.asarray`)."""
    if getattr(jcam, "to_world_end", None) is not None:
        raise NotImplementedError("camera motion blur is not ported")

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return Camera(
        to_world=f32(jcam.to_world),
        fov_x=f32(jcam.fov_x),
        aperture=f32(jcam.aperture),
        focus_dist=f32(jcam.focus_dist),
        kc=None if jcam.kc is None else f32(jcam.kc),
        width=int(jcam.width),
        height=int(jcam.height),
        kind=int(jcam.kind),
        near=float(jcam.near),
    )


def sample_rays(cam: Camera, px: torch.Tensor, py: torch.Tensor,
                u_lens: torch.Tensor):
    """World-space rays through continuous pixel positions.

    px, py: (N,) in [0, W) x [0, H); u_lens: (N,2), unused by the pinhole.
    Returns (o, d, importance), with importance 1.
    """
    if cam.kind != SENSOR_PERSPECTIVE:
        raise NotImplementedError(f"sensor kind {cam.kind} is not ported")
    if cam.to_world_end is not None:
        raise NotImplementedError("camera motion blur is not ported")
    n = px.shape[0]
    dev = px.device
    w = float(cam.width)
    h = float(cam.height)
    # NDC in [-1, 1], y flipped so pixel (0,0) is top-left
    sx = 2.0 * px / w - 1.0
    sy = 1.0 - 2.0 * py / h
    tan_half = torch.tan(0.5 * (cam.fov_x * (math.pi / 180.0)))
    aspect = np.float32(h) / np.float32(w)

    imp = torch.ones((n,), dtype=torch.float32, device=dev)
    d_cam = torch.stack([sx * tan_half, sy * tan_half * aspect,
                         torch.ones_like(sx)], dim=-1)
    d_cam = m.normalize(d_cam)
    o_cam = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    rot = cam.to_world[:3, :3]
    o = _rotate(o_cam, rot) + cam.to_world[:3, 3]
    d = m.normalize(_rotate(d_cam, rot))
    return o, d, imp


def _rotate(v: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Camera-to-world rotation of (N,3) vectors: the render path's only
    matmul (float32; the package turns TF32 off)."""
    return v @ rot.T
