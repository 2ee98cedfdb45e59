"""Trace dispatch: one entry point per query (port of ops/trace.py).

Every scene up to BRUTE_MAX_TRIS triangles takes the brute-force search
(ops/brute_kernel.py: the CUDA kernel on the GPU, its plain twin on the
CPU). Larger meshes take the big-mesh intersector in the JAX package
(ops/binned_intersect.py); it is not ported yet, so they raise.
"""
from __future__ import annotations

from . import intersect as _isect

# the JAX package's PALLAS_BRUTE_MAX_TRIS: above it the O(N*T) brute-force
# search gives way to the big-mesh intersector
BRUTE_MAX_TRIS = 4096


def _check_brute(scene):
    if scene.num_triangles > BRUTE_MAX_TRIS:
        raise NotImplementedError(
            f"{scene.num_triangles} triangles: meshes above {BRUTE_MAX_TRIS} "
            "take the big-mesh intersector, which is not ported yet")


def closest_hit(scene, o, d, tmax=None) -> _isect.Intersection:
    _check_brute(scene)
    return _isect.intersect_brute(scene, o, d, tmax)


def any_hit(scene, o, d, tmax):
    _check_brute(scene)
    return _isect.occluded_brute(scene, o, d, tmax)


def shadow_blocked(scene, o, d, tmax):
    """Shadow query (exact; the occupancy-map approximation is not ported)."""
    return any_hit(scene, o, d, tmax)


def closest_and_any(scene, o_c, d_c, tmax_c, o_s, d_s, tmax_s):
    """Closest hit (o_c, d_c) plus shadow any-hit (o_s, d_s), in the
    decomposed form: the fused single dispatch exists only on the big-mesh
    path."""
    return closest_hit(scene, o_c, d_c, tmax_c), shadow_blocked(scene, o_s, d_s, tmax_s)


surface_interaction = _isect.surface_interaction
Intersection = _isect.Intersection
