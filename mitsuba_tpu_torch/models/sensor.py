"""Sensors: batched primary-ray generation (port of models/sensor.py).

Every sensor kind of the JAX package: perspective, thin lens, orthographic,
spherical (lat-long), telecentric, perspective with radial distortion, and
the radiance, fluence and irradiance meters, each with two-keyframe motion
blur (`to_world_end`). Besides ray generation: the projection of world
points to raster coordinates and the one-pixel ray differentials of the
projective kinds (the camera-silhouette boundary pass and EWA read them).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import math as m
from ..core import warp

SENSOR_PERSPECTIVE = 0
SENSOR_THINLENS = 1
SENSOR_ORTHOGRAPHIC = 2
SENSOR_SPHERICAL = 3
SENSOR_TELECENTRIC = 4
SENSOR_RDIST = 5
SENSOR_RADIANCEMETER = 6
SENSOR_FLUENCEMETER = 7
SENSOR_IRRADIANCEMETER = 8

SENSOR_NAMES = {v: k[7:].lower() for k, v in list(globals().items())
                if k.startswith("SENSOR_")}
# the pinhole geometry: their ray differentials are the pinhole's
_PROJECTIVE = (SENSOR_PERSPECTIVE, SENSOR_THINLENS, SENSOR_RDIST)


@dataclasses.dataclass
class Camera:
    """A sensor of any kind. `to_world` maps camera space (looking down +z)
    to world space; `to_world_end`, where set, is the shutter-close pose of
    two-keyframe motion blur. Orthographic and telecentric sensors read
    `fov_x` as the film's half-width in world units."""

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
                kc=(0.0, 0.0), device="cuda") -> Camera:
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


def camera_from_jax(jcam, device="cuda") -> Camera:
    """Carry a JAX package Camera across (leaves through `np.asarray`),
    its motion-blur pose included."""
    def f32(x):
        return None if x is None else torch.as_tensor(np.array(x, np.float32), device=device)

    return Camera(
        to_world=f32(jcam.to_world),
        fov_x=f32(jcam.fov_x),
        aperture=f32(jcam.aperture),
        focus_dist=f32(jcam.focus_dist),
        kc=f32(jcam.kc),
        to_world_end=f32(getattr(jcam, "to_world_end", None)),
        width=int(jcam.width),
        height=int(jcam.height),
        kind=int(jcam.kind),
        near=float(jcam.near),
    )


def sample_rays(cam: Camera, px: torch.Tensor, py: torch.Tensor,
                u_lens: torch.Tensor):
    """World-space rays through continuous pixel positions.

    px, py: (N,) in [0, W) x [0, H); u_lens: (N,2) aperture samples (the
    lens disk, the meters' directions; motion blur reads u_lens[..., 0] as
    the shutter time). Returns (o, d, importance): importance is 4 pi for
    the fluence meter, pi for the irradiance meter and 1 otherwise.
    """
    n = px.shape[0]
    dev = px.device
    w = float(cam.width)
    h = float(cam.height)
    # NDC in [-1, 1], y flipped so pixel (0,0) is top-left
    sx = 2.0 * px / w - 1.0
    sy = 1.0 - 2.0 * py / h
    tan_half, aspect = _tan_half_aspect(cam)

    def zeros3():
        return torch.zeros((n, 3), dtype=torch.float32, device=dev)

    def plus_z():
        return torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3)

    def on_lens():
        lens = warp.square_to_uniform_disk_concentric(u_lens) * cam.aperture
        return torch.cat([lens, torch.zeros((n, 1), dtype=torch.float32, device=dev)], -1)

    imp = torch.ones((n,), dtype=torch.float32, device=dev)
    kind = cam.kind
    if kind in _PROJECTIVE:
        if kind == SENSOR_RDIST:
            # the stored image is distorted by r' = r (1 + kc0 r^2 + kc1 r^4):
            # four Newton steps find the undistorted film point
            r_d = torch.sqrt(sx * sx + (sy * aspect) ** 2) + 1e-12
            r_u = r_d
            for _ in range(4):
                r2 = r_u * r_u
                r4 = r2 * r2
                f = r_u * (1.0 + cam.kc[0] * r2 + cam.kc[1] * r4) - r_d
                fp = 1.0 + 3.0 * cam.kc[0] * r2 + 5.0 * cam.kc[1] * r4
                r_u = r_u - f / torch.clamp_min(fp, 1e-6)
            scale = r_u / r_d
            sx = sx * scale
            sy = sy * scale
        d_cam = torch.stack([sx * tan_half, sy * tan_half * aspect,
                             torch.ones_like(sx)], dim=-1)
        o_cam = zeros3()
        if kind == SENSOR_THINLENS:
            # sample the lens disk, refocus at the focus plane
            focus_p = d_cam * (cam.focus_dist / d_cam[..., 2:3])
            o_cam = on_lens()
            d_cam = focus_p - o_cam
        d_cam = m.normalize(d_cam)
    elif kind == SENSOR_TELECENTRIC:
        # orthographic chief rays through a per-pixel aperture disk,
        # refocused at the focus plane
        extent = cam.fov_x
        film_p = torch.stack([sx * extent, sy * extent * aspect, torch.zeros_like(sx)], -1)
        o_cam = film_p + on_lens()
        focus_p = film_p + plus_z() * cam.focus_dist
        d_cam = m.normalize(focus_p - o_cam)
    elif kind == SENSOR_RADIANCEMETER:
        # one ray along the sensor axis
        o_cam, d_cam = zeros3(), plus_z()
    elif kind == SENSOR_FLUENCEMETER:
        # L over the full sphere: uniform sphere directions, importance 4 pi
        o_cam, d_cam = zeros3(), warp.square_to_uniform_sphere(u_lens)
        imp = torch.full((n,), 4.0 * math.pi, dtype=torch.float32, device=dev)
    elif kind == SENSOR_IRRADIANCEMETER:
        # L cos(theta) over the +z hemisphere: cosine sampling, importance pi
        o_cam, d_cam = zeros3(), warp.square_to_cosine_hemisphere(u_lens)
        imp = torch.full((n,), math.pi, dtype=torch.float32, device=dev)
    elif kind == SENSOR_ORTHOGRAPHIC:
        # parallel rays along +z; fov_x is the film's half-width
        extent = cam.fov_x
        o_cam = torch.stack([sx * extent, sy * extent * aspect, torch.zeros_like(sx)], -1)
        d_cam = plus_z()
    elif kind == SENSOR_SPHERICAL:
        # lat-long panorama
        phi = (px / w) * 2.0 * math.pi - math.pi
        theta = (py / h) * math.pi
        st = torch.sin(theta)
        d_cam = torch.stack([st * torch.sin(phi), torch.cos(theta), st * torch.cos(phi)], -1)
        o_cam = zeros3()
    else:
        raise ValueError(f"unknown sensor kind {kind}")

    if cam.to_world_end is not None:
        # motion blur: the pose at shutter time u_lens[..., 0] (the JAX
        # package's choice: a thin lens correlates lens and time), lerped
        # and re-orthonormalised by Gram-Schmidt
        tt = u_lens[..., 0][:, None, None]
        m01 = cam.to_world[None, :3, :4] * (1.0 - tt) + cam.to_world_end[None, :3, :4] * tt
        r0 = m.normalize(m01[:, :, 0])
        r1 = m.normalize(m01[:, :, 1] - r0 * m.dot(m01[:, :, 1], r0, keepdims=True))
        r2 = m.cross(r0, r1)
        rot_t = torch.stack([r0, r1, r2], -1).transpose(1, 2)
        o = (o_cam[:, None, :] @ rot_t).squeeze(1) + m01[:, :, 3]
        d = m.normalize((d_cam[:, None, :] @ rot_t).squeeze(1))
        return o, d, imp
    rot = cam.to_world[:3, :3]
    o = _rotate(o_cam, rot) + cam.to_world[:3, 3]
    d = m.normalize(_rotate(d_cam, rot))
    return o, d, imp


def _tan_half_aspect(cam: Camera):
    tan_half = torch.tan(0.5 * (cam.fov_x * (math.pi / 180.0)))
    return tan_half, np.float32(cam.height) / np.float32(cam.width)


def film_area(cam: Camera) -> torch.Tensor:
    """The pinhole film's area at unit distance (the 1/A_film of the
    camera's importance W_e)."""
    tan_half, aspect = _tan_half_aspect(cam)
    return 4.0 * tan_half * tan_half * aspect


def world_to_raster(cam: Camera, p: torch.Tensor):
    """Project world points (N,3) to continuous pixel coordinates (JAX
    sensor.py:198), by the pinhole model whatever the kind, as there.
    Returns (px, py, valid, importance): valid where the point lies in front
    of the near plane and inside the film; importance is the W_e factor
    1 / (A_film cos^4) of particle tracing."""
    rot = cam.to_world[:3, :3]
    trans = cam.to_world[:3, 3]
    p_cam = (p - trans) @ rot    # rot is orthonormal: its inverse is rot.T
    z = p_cam[..., 2]
    valid = z > cam.near
    zs = torch.where(valid, z, 1.0)
    tan_half, aspect = _tan_half_aspect(cam)
    sx = p_cam[..., 0] / (zs * tan_half)
    sy = p_cam[..., 1] / (zs * tan_half * aspect)
    px = (sx + 1.0) * 0.5 * cam.width
    py = (1.0 - sy) * 0.5 * cam.height
    valid = valid & (px >= 0) & (px < cam.width) & (py >= 0) & (py < cam.height)
    cos_t = m.normalize(p_cam)[..., 2]
    imp = m.safe_div(torch.ones_like(cos_t),
                     film_area(cam) * torch.clamp_min(cos_t, 1e-6) ** 4)
    return px, py, valid, imp


def ray_differentials(cam: Camera, d: torch.Tensor):
    """Changes (dd_dx, dd_dy) of unit world ray directions d (N,3) for
    one-pixel raster steps, in closed form from the pinhole model (JAX
    sensor.py:223). The thin lens and the distorted perspective take the
    pinhole's; every other kind gives zeros (no footprint)."""
    if cam.kind not in _PROJECTIVE:
        z = torch.zeros_like(d)
        return z, z
    tan_half, aspect = _tan_half_aspect(cam)
    rot = cam.to_world[:3, :3]
    d_cam = d @ rot                       # R^T d (columns orthonormal)
    v = d_cam / torch.clamp_min(d_cam[..., 2:3], 1e-8)
    zero = torch.zeros_like(tan_half)
    dv_dx = torch.stack([2.0 * 1.0 / np.float32(cam.width) * tan_half, zero, zero])
    dv_dy = torch.stack([zero, -2.0 * 1.0 / np.float32(cam.height) * aspect * tan_half,
                         zero])

    def dnorm(vv, dvv):
        # d(normalize(v)) = (I - n n^T) dv / |v|
        inv_len = torch.rsqrt(torch.clamp_min(m.dot(vv, vv), 1e-12))
        nrm = vv * inv_len[:, None]
        dvv = dvv.expand(vv.shape)
        return (dvv - nrm * m.dot(nrm, dvv)[:, None]) * inv_len[:, None]

    return dnorm(v, dv_dx) @ rot.T, dnorm(v, dv_dy) @ rot.T


def _rotate(v: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Camera-to-world rotation of (N,3) vectors: the render path's only
    matmul (float32; the package turns TF32 off)."""
    return v @ rot.T
