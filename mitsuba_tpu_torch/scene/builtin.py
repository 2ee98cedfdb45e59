"""Built-in test scenes (port of scene/builtin.py): the Cornell box and the
sphere-shadow mesh fixture. The geometry is built in numpy exactly as the
JAX package builds it, then copied to `device`."""
from __future__ import annotations

import numpy as np

from . import ir
from ..models import sensor as sensorlib


def cornell_box(width=256, height=256, light_scale=1.0, area_light=True,
                device="cpu"):
    """The classic Cornell box and its usual view. Returns (scene, camera).
    area_light=False omits the ceiling light."""
    verts: list = []
    tris: list = []
    mats: list = []
    tri_mat: list = []
    tri_rad: dict = {}

    def add_quad(p0, p1, p2, p3, mat_id, radiance=None):
        base = len(verts)
        verts.extend([p0, p1, p2, p3])
        t0 = [base, base + 1, base + 2]
        t1 = [base, base + 2, base + 3]
        for t in (t0, t1):
            if radiance is not None:
                tri_rad[len(tris)] = radiance
            tris.append(t)
            tri_mat.append(mat_id)

    white = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.725, 0.71, 0.68]}
    red = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.63, 0.065, 0.05]}
    green = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.14, 0.45, 0.091]}
    light_mat = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}
    mats.extend([white, red, green, light_mat])
    W, R, G, LM = 0, 1, 2, 3

    add_quad([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0], W)   # floor
    add_quad([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1], W)   # ceiling
    add_quad([0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1], W)   # back wall
    add_quad([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1], R)   # left wall
    add_quad([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0], G)   # right wall

    # short block (right, front) and tall block (left, back)
    _add_box(add_quad, W, center=(0.66, 0.0, 0.32), size=(0.30, 0.30, 0.30), angle=-0.30)
    _add_box(add_quad, W, center=(0.32, 0.0, 0.66), size=(0.30, 0.60, 0.30), angle=0.29)

    if area_light:
        # area light just below the ceiling (normal -y)
        le = (np.asarray([17.0, 12.0, 4.0]) * light_scale).tolist()
        add_quad([0.37, 0.9988, 0.33], [0.63, 0.9988, 0.33],
                 [0.63, 0.9988, 0.67], [0.37, 0.9988, 0.67], LM, radiance=le)

    scene = ir.build_scene(
        np.asarray(verts, np.float32),
        np.asarray(tris, np.int32),
        np.asarray(tri_mat, np.int32),
        mats,
        tri_radiance=tri_rad,
        device=device,
    )
    cam = sensorlib.make_camera(
        origin=[0.5, 0.5, -1.4],
        target=[0.5, 0.5, 0.0],
        fov_x=39.3077,
        width=width,
        height=height,
        device=device,
    )
    return scene, cam


def _add_box(add_quad, mat, center, size, angle):
    """Box rotated about y, sitting on the floor, outward normals."""
    cx, cy, cz = center
    sx, sy, sz = size
    c, s = np.cos(angle), np.sin(angle)

    def rot(p):
        x, y, z = p
        x -= cx
        z -= cz
        return [cx + c * x + s * z, y, cz - s * x + c * z]

    x0, x1 = cx - sx / 2, cx + sx / 2
    y0, y1 = cy, cy + sy
    z0, z1 = cz - sz / 2, cz + sz / 2
    # 5 faces (bottom skipped)
    add_quad(*[rot(p) for p in ([x0, y1, z0], [x0, y1, z1], [x1, y1, z1], [x1, y1, z0])], mat)  # top +y
    add_quad(*[rot(p) for p in ([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0])], mat)  # -x
    add_quad(*[rot(p) for p in ([x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1])], mat)  # +x
    add_quad(*[rot(p) for p in ([x0, y0, z0], [x0, y1, z0], [x1, y1, z0], [x1, y0, z0])], mat)  # -z front
    add_quad(*[rot(p) for p in ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1])], mat)  # +z back


def sphere_shadow(nu=72, nv=72, radius=0.25, width=20, height=20,
                  attach_bvh=False, device="cpu"):
    """Mesh-scale shadow fixture: a UV-sphere blocker (2*nu*nv triangles)
    between an area light and a floor, seen from under the sphere. Returns
    (scene, cam, sphere_vertex_rows). Only the brute-force form is ported:
    attach_bvh=True raises until the big-mesh intersector lands."""
    if attach_bvh:
        raise NotImplementedError("sphere_shadow: BVH/cluster tables are not ported")
    us = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vs = np.linspace(0, np.pi, nv + 1)
    c = (0.0, 1.0, 0.0)
    V = []
    for v in vs:
        for u in us:
            V.append([c[0] + radius * np.sin(v) * np.cos(u),
                      c[1] + radius * np.cos(v),
                      c[2] + radius * np.sin(v) * np.sin(u)])
    T = []
    for i in range(nv):
        for j in range(nu):
            a = i * nu + j
            b = i * nu + (j + 1) % nu
            cc = (i + 1) * nu + j
            d = (i + 1) * nu + (j + 1) % nu
            T += [[a, b, cc], [b, d, cc]]
    V = np.asarray(V, np.float32)
    T = np.asarray(T, np.int32)
    base = len(V)
    verts = np.concatenate([V, np.asarray(
        [[-3, 0, -3], [-3, 0, 3], [3, 0, 3], [3, 0, -3],
         [-0.25, 2.6, -0.25], [0.25, 2.6, -0.25],
         [0.25, 2.6, 0.25], [-0.25, 2.6, 0.25]], np.float32)])
    tris = np.concatenate([T, np.asarray(
        [[base, base + 1, base + 2], [base, base + 2, base + 3],
         [base + 4, base + 5, base + 6], [base + 4, base + 6, base + 7]],
        np.int32)])
    tri_mat = np.concatenate([
        np.ones(len(T), np.int32),          # sphere: dark
        np.zeros(2, np.int32),              # floor: white
        np.full(2, 2, np.int32)])           # light holder
    white = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.8, 0.8, 0.8]}
    dark = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.2, 0.2, 0.2]}
    lm = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}
    scene = ir.build_scene(
        verts, tris, tri_mat, [white, dark, lm],
        tri_radiance={len(tris) - 2: [40.0] * 3,
                      len(tris) - 1: [40.0] * 3},
        device=device)
    cam = sensorlib.make_camera(
        origin=[0.0, 0.55, 0.0], target=[0.0, 0.0, 0.0], up=[0, 0, 1],
        fov_x=80.0, width=width, height=height, device=device)
    return scene, cam, (0, base)
