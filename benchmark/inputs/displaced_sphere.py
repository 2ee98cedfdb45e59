"""The big-mesh fixture as numpy arrays: a frozen copy of
`mitsuba_tpu_torch/scene/builtin.py:displaced_sphere_mesh` and its view
`DISPLACED_SPHERE_CAMERA` (bench.py's `_bigmesh_scene`), so that a later
change to the program cannot move the benchmark's inputs. One change:
the sphere's triangles are wound outward.

A sphere of radius 1 displaced by 0.15 sin(5u) sin(4v), nu x (nv - 1) x 2
triangles (70,030 at the defaults), over a floor, under a 12.0 area light:
70,034 triangles in all. `geometry()` returns the arrays of
`cornell.geometry()`."""
from __future__ import annotations

import numpy as np

VIEW = {"origin": [0.0, 0.8, 3.6], "target": [0.0, 0.0, 0.0], "up": [0.0, 1.0, 0.0],
        "fov_x": 45.0}


def geometry(nu: int = 235, nv: int = 150):
    uu = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vv = np.linspace(1e-3, np.pi - 1e-3, nv)
    U, V = np.meshgrid(uu, vv, indexing="ij")
    r = 1.0 + 0.15 * np.sin(5 * U) * np.sin(4 * V)
    verts = np.stack([np.sin(V) * np.cos(U) * r, np.sin(V) * np.sin(U) * r,
                      np.cos(V) * r], -1).reshape(-1, 3).astype(np.float32)
    i = np.arange(nu)[:, None]
    j = np.arange(nv - 1)[None, :]
    a, b = i * nv + j, ((i + 1) % nu) * nv + j
    # per (i, j): [a, a+1, b] then [b, a+1, b+1], i-major. bench.py winds
    # them [a, b, a+1], [b, b+1, a+1], inward (dP/du x dP/dv = -sin v P):
    # under the one-sided diffuse BSDF every path ends at its first hit on
    # the sphere. Wound outward (the config's `winding`), the mesh is lit.
    tris = np.stack([np.stack([a, a + 1, b], -1), np.stack([b, a + 1, b + 1], -1)],
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
    tri_rad = {T - 2: (12.0, 12.0, 12.0), T - 1: (12.0, 12.0, 12.0)}
    return verts, tris, np.zeros((T,), np.int32), [(0.6, 0.55, 0.5)], tri_rad
