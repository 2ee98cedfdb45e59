"""Built-in test scenes (port of scene/builtin.py): the Cornell box, lit by
its area light or by a point, spot or environment light, the
mirror-caustic box, the Veach MIS sweep, the sphere-shadow mesh fixture and
the big-mesh displaced sphere of the JAX package's bench. The geometry is
built in numpy exactly as the JAX package builds it, then copied to
`device` (the card unless the caller names another)."""
from __future__ import annotations

import numpy as np
import torch

from . import bvh as bvhlib
from . import ir
from ..models import sensor as sensorlib


def cornell_box(width=256, height=256, light_scale=1.0, area_light=True,
                device="cuda"):
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


def cornell_box_lit(light="point", width=16, height=16, device="cuda"):
    """The Cornell geometry without its area light, lit by a point light
    (light="point"), a downward spot light ("spot") or a constant
    environment through the open front ("env"). Returns (scene, camera)."""
    scene, cam = cornell_box(width=width, height=height, area_light=False, device=device)
    if light == "env":
        return scene.replace(has_env=True, env_radiance=torch.tensor(
            [1.0, 0.9, 0.7], device=scene.device)), cam
    if light == "point":
        recs = [{"kind": ir.DELTA_POINT, "position": [0.5, 0.8, 0.5],
                 "intensity": [2.0, 1.8, 1.5]}]
    elif light == "spot":
        recs = [{"kind": ir.DELTA_SPOT, "position": [0.5, 0.95, 0.5],
                 "direction": [0.0, -1.0, 0.0], "intensity": [4.0, 3.6, 3.0],
                 "cutoff_deg": 40.0, "beam_deg": 30.0}]
    else:
        raise ValueError(light)
    return scene.replace(delta_emitters=ir.build_delta_emitters(recs, device=device)), cam


def _quad_adder(verts, tris, tri_mat, tri_rad):
    """add_quad(p0, p1, p2, p3, mat_id, radiance=None): two triangles,
    counter-clockwise = front face, appended to the lists."""
    def add_quad(p0, p1, p2, p3, mat_id, radiance=None):
        base = len(verts)
        verts.extend([p0, p1, p2, p3])
        for t in ([base, base + 1, base + 2], [base, base + 2, base + 3]):
            if radiance is not None:
                tri_rad[len(tris)] = radiance
            tris.append(t)
            tri_mat.append(mat_id)
    return add_quad


def caustic_box(width=16, height=16, rough=False, device="cuda"):
    """The mirror-caustic fixture: the Cornell box with its right wall a
    conductor mirror (a GGX rough one with rough=True) and a small bright
    light on the left wall aimed at it. Returns (scene, camera)."""
    verts, tris, mats, tri_mat, tri_rad = [], [], [], [], {}
    add_quad = _quad_adder(verts, tris, tri_mat, tri_rad)
    white = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.725, 0.71, 0.68]}
    if rough:
        mirror = {"type": ir.BSDF_ROUGH_CONDUCTOR, "eta": [0.2, 0.92, 1.1],
                  "k": [3.9, 2.45, 2.14], "specular": [1.0, 1.0, 1.0], "alpha": 0.08}
    else:
        mirror = {"type": ir.BSDF_CONDUCTOR, "eta": [0.2, 0.92, 1.1],
                  "k": [3.9, 2.45, 2.14], "specular": [1.0, 1.0, 1.0]}
    dark = {"type": ir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}
    mats.extend([white, mirror, dark])
    W, M, LM = 0, 1, 2
    add_quad([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0], W)      # floor
    add_quad([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1], W)      # ceiling
    add_quad([0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1], W)      # back
    add_quad([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1], W)      # left
    add_quad([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0], M)      # right: the mirror
    # small bright light high on the left wall, facing the mirror (+x)
    add_quad([0.001, 0.6, 0.45], [0.001, 0.7, 0.45],
             [0.001, 0.7, 0.55], [0.001, 0.6, 0.55], LM, radiance=[80.0, 70.0, 50.0])
    scene = ir.build_scene(np.asarray(verts, np.float32), np.asarray(tris, np.int32),
                           np.asarray(tri_mat, np.int32), mats, tri_radiance=tri_rad,
                           device=device)
    cam = sensorlib.make_camera(origin=[0.5, 0.5, -1.4], target=[0.5, 0.5, 0.0],
                                fov_x=39.3077, width=width, height=height, device=device)
    return scene, cam


def veach_mis(width=256, height=192, device="cuda"):
    """The Veach MIS sweep: four GGX rough-conductor plates of roughness
    0.005-0.1 under four area lights of equal power and sizes 0.033-0.9.
    Returns (scene, camera)."""
    verts, tris, mats, tri_mat, tri_rad = [], [], [], [], {}
    add_quad = _quad_adder(verts, tris, tri_mat, tri_rad)
    mats.append({"type": ir.BSDF_DIFFUSE, "reflectance": [0.4, 0.4, 0.4]})
    add_quad([-6, -2, -6], [-6, -2, 14], [6, -2, 14], [6, -2, -6], 0)   # floor
    add_quad([-6, -2, 6], [-6, 8, 6], [6, 8, 6], [6, -2, 6], 0)         # back wall
    for a, pz, py in zip([0.005, 0.02, 0.05, 0.1], [2.0, 2.6, 3.2, 3.8],
                         [0.0, 0.55, 1.1, 1.65]):
        mid = len(mats)
        mats.append({"type": ir.BSDF_ROUGH_CONDUCTOR, "specular": [1.0, 1.0, 1.0],
                     "eta": [0.2, 0.92, 1.1], "k": [3.9, 2.45, 2.14], "alpha": [a, a],
                     "extra": [0.0, 0.0, 0.0, ir.MICROFACET_GGX]})
        # plates tilted toward the camera and the lights
        w, depth = 2.4, 0.35
        add_quad([-w, py, pz], [-w, py + 0.25, pz + depth], [w, py + 0.25, pz + depth],
                 [w, py, pz], mid)
    # equal power, so radiance ~ 1 / area
    lm = len(mats)
    mats.append({"type": ir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]})
    for x, sz in zip([-1.8, -0.6, 0.6, 1.8], [0.033, 0.1, 0.3, 0.9]):
        rad = 30.0 / (sz * sz * np.pi * 4)
        add_quad([x - sz / 2, 4.0, 4.0], [x + sz / 2, 4.0, 4.0],
                 [x + sz / 2, 4.0 - sz, 4.0 - 0.01], [x - sz / 2, 4.0 - sz, 4.0 - 0.01],
                 lm, radiance=[rad, rad, rad])
    scene = ir.build_scene(np.asarray(verts, np.float32), np.asarray(tris, np.int32),
                           np.asarray(tri_mat, np.int32), mats, tri_radiance=tri_rad,
                           device=device)
    cam = sensorlib.make_camera(origin=[0.0, 2.0, -6.5], target=[0.0, 1.0, 2.0], fov_x=50.0,
                                width=width, height=height, device=device)
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
                  attach_bvh=False, device="cuda"):
    """Mesh-scale shadow fixture: a UV-sphere blocker (2*nu*nv triangles)
    between an area light and a floor, seen from under the sphere. Returns
    (scene, cam, sphere_vertex_rows). attach_bvh=True attaches the
    stackless BVH (the JAX package also builds its cluster tables there)."""
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
    if attach_bvh:
        scene = bvhlib.attach(scene)
    cam = sensorlib.make_camera(
        origin=[0.0, 0.55, 0.0], target=[0.0, 0.0, 0.0], up=[0, 0, 1],
        fov_x=80.0, width=width, height=height, device=device)
    return scene, cam, (0, base)


# the big-mesh fixture's view (bench.py:_bigmesh_scene)
DISPLACED_SPHERE_CAMERA = dict(origin=[0.0, 0.8, 3.6], target=[0, 0, 0], fov_x=45.0)


def displaced_sphere_mesh(nu=235, nv=150):
    """Geometry and materials of the displaced-sphere fixture as numpy:
    (vertices, indices, tri_material, materials, tri_radiance), the
    arguments of `ir.build_scene`. nu x (nv-1) x 2 sphere triangles
    (70,030 at the defaults) over a floor, under a 12.0 area light."""
    uu = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vv = np.linspace(1e-3, np.pi - 1e-3, nv)
    U, V = np.meshgrid(uu, vv, indexing="ij")
    r = 1.0 + 0.15 * np.sin(5 * U) * np.sin(4 * V)
    verts = np.stack([np.sin(V) * np.cos(U) * r, np.sin(V) * np.sin(U) * r,
                      np.cos(V) * r], -1).reshape(-1, 3).astype(np.float32)
    i = np.arange(nu)[:, None]
    j = np.arange(nv - 1)[None, :]
    a, b = i * nv + j, ((i + 1) % nu) * nv + j
    # per (i, j): [a, b, a+1] then [b, b+1, a+1], i-major as the bench's loop
    tris = np.stack([np.stack([a, b, a + 1], -1), np.stack([b, b + 1, a + 1], -1)],
                    2).reshape(-1, 3)
    base = len(verts)
    quads = np.asarray([
        # floor y=-1.3
        [-4, -1.3, -4], [-4, -1.3, 4], [4, -1.3, 4], [4, -1.3, -4],
        # light y=+2.2 (normal -y)
        [-0.8, 2.2, -0.8], [0.8, 2.2, -0.8], [0.8, 2.2, 0.8], [-0.8, 2.2, 0.8],
    ], np.float32)
    verts = np.concatenate([verts, quads])
    extra = [[base, base + 1, base + 2], [base, base + 2, base + 3],
             [base + 4, base + 5, base + 6], [base + 4, base + 6, base + 7]]
    tris = np.concatenate([tris, np.asarray(extra)]).astype(np.int32)
    T = len(tris)
    tri_rad = {T - 2: [12.0, 12.0, 12.0], T - 1: [12.0, 12.0, 12.0]}
    mats = [{"type": ir.BSDF_DIFFUSE, "reflectance": [0.6, 0.55, 0.5]}]
    return verts, tris, np.zeros((T,), np.int32), mats, tri_rad


def displaced_sphere(nu=235, nv=150, width=128, height=128, device="cuda"):
    """The JAX package's big-mesh render fixture (bench.py:_bigmesh_scene):
    a displaced sphere of 70,034 triangles at the defaults, with the BVH
    attached. Returns (scene, camera)."""
    verts, tris, tri_mat, mats, tri_rad = displaced_sphere_mesh(nu, nv)
    scene = bvhlib.attach(ir.build_scene(verts, tris, tri_mat, mats,
                                         tri_radiance=tri_rad, device=device))
    cam = sensorlib.make_camera(width=width, height=height, device=device,
                                **DISPLACED_SPHERE_CAMERA)
    return scene, cam
