"""Energy redistribution path tracing, Cline et al. 2005 (port of
integrators/erpt.py).

The analog of src/integrators/erpt (erpt_proc.cpp): plain path tracing
generates seed paths, and each seed's energy is redistributed over the
image by a short Metropolis chain in primary sample space that deposits a
fixed quantum per mutation. The chains run in lockstep as in pssmlt.py,
whose vector stream and Kelemen small steps they share; acceptance
deposits equal energy (the redistribution idea) rather than
luminance-weighted splats.

The uniforms come from a torch.Generator seeded with cfg.seed ^ 0xE897
(the JAX package's key), or from `uniforms` (pssmlt.py's hook: "boot",
"pick", then per step "small_mag", "small_sign", "accept").
"""
from __future__ import annotations

import torch

from .common import RenderConfig
from .pssmlt import (DIMS_PER_BOUNCE, SENSOR_DIMS, _accept, _eval, _small_step, _splat_both,
                     generator_draws, seed_chains)


def render(scene, cam, cfg: RenderConfig, n_chains: int = 1 << 15,
           chain_length: int = 64, n_bootstrap: int = 1 << 17,
           uniforms=None) -> torch.Tensor:
    """ERPT render -> (H, W, 3).

    Seeds are drawn by plain path tracing (uniform primary vectors); a seed
    picked in proportion to its luminance spawns a chain that deposits
    L_avg / chain_length-sized quanta along `chain_length` small mutations
    (erpt.cpp's numChains/mutation logic, pooled over the whole
    wavefront)."""
    w, h = cam.width, cam.height
    dev = scene.device
    ndims = SENSOR_DIMS + cfg.max_depth * DIMS_PER_BOUNCE
    draw = uniforms or generator_draws(cfg.seed ^ 0xE897, dev)

    u_boot = draw("boot", (n_bootstrap, ndims))
    _, lum_boot, _ = _eval(scene, cam, cfg, u_boot)
    # the mean image-plane luminance: the energy quantum's baseline
    # (erpt.cpp computes the same)
    b = torch.mean(lum_boot)
    # selection in proportion to L makes the chains' packets equal-sized
    u_cur = u_boot[seed_chains(lum_boot, draw("pick", (n_chains,)))]
    state = (u_cur, *_eval(scene, cam, cfg, u_cur))

    deposit = b / chain_length  # the luminance quantum per mutation
    img = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
    for _ in range(chain_length):
        u_prop = _small_step(state[0], draw("small_mag", (n_chains, ndims)),
                             draw("small_sign", (n_chains, ndims)))
        prop = (u_prop, *_eval(scene, cam, cfg, u_prop))
        a = torch.clamp(prop[2] / torch.clamp_min(state[2], 1e-12), 0.0, 1.0)
        # the quantum split between the two states, coloured by each
        # state's spectrum (Cline's equal-deposition rule)
        _splat_both(img, a, deposit, state[1:], prop[1:])
        state = _accept(draw("accept", (n_chains,)) < a, prop, state)
    img = img / n_chains * (w * h)
    return img.reshape(h, w, 3)
