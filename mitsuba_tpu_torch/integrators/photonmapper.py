"""Classic two-map photon mapper (Jensen; port of integrators/photonmapper.py).

The analog of src/integrators/photonmapper/photonmapper.cpp: one photon
pass builds two maps split by path class (gatherproc.h ECausticPhotons /
ESurfacePhotons):

  * caustic map: deposits whose previous bounce was a delta lobe (L S+ D
    paths), looked up at the camera's gather point with a tight radius;
  * indirect map: deposits after an earlier non-delta bounce (L D .+ D
    paths), the multi-bounce diffuse transport.

Direct illumination and the first specular chain come from SPPM's camera
pass (emission + NEE). The kd-tree and its kNN lookups become the hash
grid of ops/hashgrid.py with a fixed scene-scaled radius (`radius_scale`).
Biased like the original; SPPM is the consistent progressive
alternative.
"""
from __future__ import annotations

import math

import torch

from ..models import bsdf as bsdflib
from ..ops import hashgrid
from .common import RenderConfig
from .sppm import (_camera_pass, _photon_pass, broadcast_shade_point, photon_flux,
                   scene_extent)


def render(scene, cam, cfg: RenderConfig, n_photons: int = 1 << 18,
           n_passes: int = 4, radius_scale: float = 1.0, window: int = 64) -> torch.Tensor:
    """-> (H, W, 3): n_passes camera samples a pixel averaged, both photon
    maps shot anew each pass (photonCount's analog)."""
    w, h = cam.width, cam.height
    npix = w * h
    dev = scene.device
    r_global = scene_extent(scene) * 5.0 / max(w, h) * radius_scale
    r_caustic = r_global * 0.5
    families = scene.bsdf_families

    def one_pass(pass_idx):
        gp = _camera_pass(scene, cam, cfg, pass_idx)
        pos, pdir, ppow, pvalid, pdepth, pprev = _photon_pass(
            scene, cfg, pass_idx, n_photons, cfg.max_depth, with_tags=True)
        # the map split (photonmapper.cpp shoots caustic + surface maps)
        caustic = pvalid & pprev & (pdepth >= 1)
        indirect = pvalid & ~pprev & (pdepth >= 1)
        sp_b = broadcast_shade_point(bsdflib.gather_shade_point(scene, gp["mat"], gp["uv"]))

        def estimate(valid_mask, radius):
            grid = hashgrid.build(pos, valid_mask, radius)

            def reduce_fn(carry, pidx, mask):
                keep = mask & valid_mask[pidx]
                return (carry[0] + photon_flux(gp, sp_b, families, pdir, ppow, pidx, keep),)

            (flux,), _ = hashgrid.query_sum(
                grid, pos, gp["pos"], torch.full((npix,), radius, device=dev), reduce_fn,
                (torch.zeros((npix, 3), device=dev),), window=window)
            return flux / (math.pi * radius * radius * n_photons)

        li = estimate(indirect, r_global) + estimate(caustic, r_caustic)
        li = torch.where(gp["valid"][:, None], li * gp["beta"], 0.0)
        return gp["direct"] + li

    img = torch.zeros((npix, 3), device=dev)
    for i in range(n_passes):
        img = img + one_pass(i)
    return (img / n_passes).reshape(h, w, 3)
