"""The Cornell box as numpy arrays: a frozen copy of the geometry of
`mitsuba_tpu_torch/scene/builtin.py:cornell_box` (and `_add_box`), so that a
later change to the program cannot move the benchmark's inputs.

`geometry()` returns (vertices (V,3) float32, indices (T,3) int32,
tri_material (T,) int32, reflectances [(r, g, b)], tri_radiance {tri: (r,
g, b)}), the same arrays the builtin passes to `ir.build_scene`; `VIEW` is
its camera."""
from __future__ import annotations

import numpy as np

VIEW = {"origin": [0.5, 0.5, -1.4], "target": [0.5, 0.5, 0.0], "up": [0.0, 1.0, 0.0],
        "fov_x": 39.3077}


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
    add_quad(*[rot(p) for p in ([x0, y1, z0], [x0, y1, z1], [x1, y1, z1], [x1, y1, z0])], mat)
    add_quad(*[rot(p) for p in ([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0])], mat)
    add_quad(*[rot(p) for p in ([x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1])], mat)
    add_quad(*[rot(p) for p in ([x0, y0, z0], [x0, y1, z0], [x1, y1, z0], [x1, y0, z0])], mat)
    add_quad(*[rot(p) for p in ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1])], mat)


def geometry(light_scale: float = 1.0):
    verts, tris, tri_mat, tri_rad = [], [], [], {}

    def add_quad(p0, p1, p2, p3, mat_id, radiance=None):
        base = len(verts)
        verts.extend([p0, p1, p2, p3])
        for t in ([base, base + 1, base + 2], [base, base + 2, base + 3]):
            if radiance is not None:
                tri_rad[len(tris)] = radiance
            tris.append(t)
            tri_mat.append(mat_id)

    reflectances = [(0.725, 0.71, 0.68), (0.63, 0.065, 0.05), (0.14, 0.45, 0.091),
                    (0.0, 0.0, 0.0)]
    W, R, G, LM = 0, 1, 2, 3
    add_quad([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0], W)   # floor
    add_quad([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1], W)   # ceiling
    add_quad([0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1], W)   # back wall
    add_quad([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1], R)   # left wall
    add_quad([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0], G)   # right wall
    # short block (right, front) and tall block (left, back)
    _add_box(add_quad, W, center=(0.66, 0.0, 0.32), size=(0.30, 0.30, 0.30), angle=-0.30)
    _add_box(add_quad, W, center=(0.32, 0.0, 0.66), size=(0.30, 0.60, 0.30), angle=0.29)
    # area light just below the ceiling (normal -y)
    le = tuple(float(x) for x in np.asarray([17.0, 12.0, 4.0]) * light_scale)
    add_quad([0.37, 0.9988, 0.33], [0.63, 0.9988, 0.33],
             [0.63, 0.9988, 0.67], [0.37, 0.9988, 0.67], LM, radiance=le)
    return (np.asarray(verts, np.float32), np.asarray(tris, np.int32),
            np.asarray(tri_mat, np.int32), reflectances, tri_rad)
