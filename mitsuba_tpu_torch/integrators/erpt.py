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

from ..utils import graphs
from .common import RenderConfig
from .pssmlt import (ChainGraph, _accept, _eval, _small_step, _splat_both, bootstrap,
                     generator_draws)


def _start(scene, cam, cfg: RenderConfig, draw, n_chains: int, chain_length: int,
           n_bootstrap: int):
    """Seeds drawn by plain path tracing (uniform primary vectors): a seed
    picked in proportion to its luminance spawns a chain. Returns (state,
    the luminance quantum a mutation deposits)."""
    # b, the mean image-plane luminance, is the energy quantum's baseline
    # (erpt.cpp computes the same); selection in proportion to L makes the
    # chains' packets equal-sized
    state, b = bootstrap(scene, cam, cfg, draw, n_chains, n_bootstrap)
    return state, b / chain_length


def _mutate(scene, cam, cfg: RenderConfig, draw, state, img, deposit):
    """One small mutation of every chain: the quantum split between the two
    states, coloured by each state's spectrum (Cline's equal-deposition
    rule), then the accept draw. Returns the new state (the work
    render_jit captures)."""
    n_chains, ndims = state[0].shape
    u_prop = _small_step(state[0], draw("small_mag", (n_chains, ndims)),
                         draw("small_sign", (n_chains, ndims)))
    prop = (u_prop, *_eval(scene, cam, cfg, u_prop))
    a = torch.clamp(prop[2] / torch.clamp_min(state[2], 1e-12), 0.0, 1.0)
    _splat_both(img, a, deposit, state[1:], prop[1:])
    return _accept(draw("accept", (n_chains,)) < a, prop, state)


def _normalize(img, cam, n_chains: int) -> torch.Tensor:
    w, h = cam.width, cam.height
    return (img / n_chains * (w * h)).reshape(h, w, 3)


def render(scene, cam, cfg: RenderConfig, n_chains: int = 1 << 15,
           chain_length: int = 64, n_bootstrap: int = 1 << 17,
           uniforms=None) -> torch.Tensor:
    """ERPT render -> (H, W, 3).

    Seeds are drawn by plain path tracing (uniform primary vectors); a seed
    picked in proportion to its luminance spawns a chain that deposits
    L_avg / chain_length-sized quanta along `chain_length` small mutations
    (erpt.cpp's numChains/mutation logic, pooled over the whole
    wavefront)."""
    draw = uniforms or generator_draws(cfg.seed ^ 0xE897, scene.device)
    state, deposit = _start(scene, cam, cfg, draw, n_chains, chain_length, n_bootstrap)
    img = torch.zeros((cam.width * cam.height, 3), dtype=torch.float32, device=scene.device)
    for _ in range(chain_length):
        state = _mutate(scene, cam, cfg, draw, state, img, deposit)
    return _normalize(img, cam, n_chains)


_GRAPHS = graphs.Cache()


def render_jit(scene, cam, cfg: RenderConfig, n_chains: int = 1 << 15,
               chain_length: int = 64, n_bootstrap: int = 1 << 17,
               uniforms=None) -> torch.Tensor:
    """`render`, compiled and cached as the JAX package's render_jit is
    (pssmlt.ChainGraph over utils/graphs.py): on the card the seeding runs
    eagerly once a call, the first call of a key (cfg and the counts, the
    scene's and camera's static_key) runs its first mutation eagerly and
    captures one mutation, which every later mutation and call replays
    with the generator registered: the chains draw and step as `render`'s
    do for the same seed (pssmlt.render_jit's note on the splats' order).
    On the CPU this is `render`. `uniforms` raises ValueError on the
    card; a leaf that requires grad raises NotImplementedError; a failed
    capture raises."""
    graphs.refuse_grad("erpt.render_jit", scene, cam)
    if scene.device.type != "cuda":
        return render(scene, cam, cfg, n_chains, chain_length, n_bootstrap, uniforms)
    graphs.refuse_hook("erpt.render_jit", uniforms=uniforms)
    key = (cfg, n_chains, chain_length, n_bootstrap, graphs.static_key(scene, cam))

    def mutate(s, c, draw, state, img, deposit):
        return _mutate(s, c, cfg, draw, state, img, deposit)

    def start(s, c, draw):
        return _start(s, c, cfg, draw, n_chains, chain_length, n_bootstrap)

    with _GRAPHS.lock, torch.cuda.device(scene.device):
        entry = _GRAPHS.get(key, lambda: ChainGraph(scene, cam, cfg, n_chains, mutate))
        img = entry.run(scene, cam, cfg.seed ^ 0xE897, start, chain_length)
        return _normalize(img, cam, n_chains)
