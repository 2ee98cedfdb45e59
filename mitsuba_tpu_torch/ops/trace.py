"""Trace dispatch: one entry point per query (port of ops/trace.py).

The policy mirrors the JAX package's, with the card in the TPU's place:

  * a scene with a BVH attached walks it (ops/bvh_kernel.py: the CUDA
    walk on the card, its plain twin on the CPU), unless brute force is
    preferred: on the card up to BRUTE_MAX_TRIS triangles;
  * every other scene takes the brute-force search (ops/brute_kernel.py),
    at any size.

`closest_and_any` is one fused launch on the card's BVH path (`fuses`,
which also sets the wavefront's default `fuse`) and decomposes into the
two standard queries everywhere else.

Every query detaches its inputs (`intersect.search_inputs`), as the JAX
package stops the gradient of its searches: the results carry no autograd
history, and gradients reach the hit through `surface_interaction`.
"""
from __future__ import annotations

from . import bvh_kernel
from . import intersect as _isect

# the JAX package's PALLAS_BRUTE_MAX_TRIS: on the card, up to this many
# triangles the brute-force kernel is taken even where a BVH is attached
# (the TPU's crossover, not yet re-measured on the H100)
BRUTE_MAX_TRIS = 4096


def _prefer_brute(scene) -> bool:
    return scene.device.type == "cuda" and scene.num_triangles <= BRUTE_MAX_TRIS


def _walks_bvh(scene) -> bool:
    return scene.bvh is not None and not _prefer_brute(scene)


def fuses(scene) -> bool:
    """True where `closest_and_any` is one launch: the card's BVH path."""
    return _walks_bvh(scene) and scene.device.type == "cuda"


def closest_hit(scene, o, d, tmax=None) -> _isect.Intersection:
    if _walks_bvh(scene):
        return bvh_kernel.closest_hit(scene, scene.bvh, o, d, tmax)
    return _isect.intersect_brute(scene, o, d, tmax)


def any_hit(scene, o, d, tmax):
    if _walks_bvh(scene):
        return bvh_kernel.any_hit(scene, scene.bvh, o, d, tmax)
    return _isect.occluded_brute(scene, o, d, tmax)


def shadow_blocked(scene, o, d, tmax):
    """Shadow query (exact; the occupancy-map approximation is not ported)."""
    return any_hit(scene, o, d, tmax)


def closest_and_any(scene, o_c, d_c, tmax_c, o_s, d_s, tmax_s):
    """Closest hit (o_c, d_c) plus shadow any-hit (o_s, d_s): one launch on
    the card's BVH path, the two standard calls everywhere else."""
    if fuses(scene):
        return bvh_kernel.closest_and_any(scene, scene.bvh, o_c, d_c, tmax_c,
                                          o_s, d_s, tmax_s)
    return closest_hit(scene, o_c, d_c, tmax_c), shadow_blocked(scene, o_s, d_s, tmax_s)


surface_interaction = _isect.surface_interaction
Intersection = _isect.Intersection
