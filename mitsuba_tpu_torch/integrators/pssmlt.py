"""Primary-sample-space Metropolis light transport, Kelemen style (port of
integrators/pssmlt.py).

The analog of src/integrators/pssmlt (the two-stage bootstrap at
pssmlt.cpp:331-335, Kelemen small/large mutations in pssmlt_sampler.cpp,
seed work units in pssmlt_proc.cpp:91): tens of thousands of short chains
run in lockstep, every chain one lane, a mutation step one batched
`path.li` over all chains and one `index_add_` of both states' splats.
Seeding resamples bootstrap paths in proportion to their luminance
(two-stage PSSMLT), which removes start-up bias in expectation.

The primary sample vector u in [0,1)^D replaces the reference's lazy
PSSMLTSampler: dims 0-3 drive the sensor sample and each bounce reads
path.py's 8-dim window, so the target function is path.li through a
vector-backed sample stream.

The uniforms: the JAX package draws them with jax.random threefry; the
port draws them from a torch.Generator seeded with cfg.seed, so its chains
take other steps for the same seed (ROADMAP C15's convention). `uniforms`
replaces the generator: a function (name, shape) -> float32 tensor on the
scene's device, called in the order the JAX render splits its keys
("boot", "pick", then per step "large", "fresh", "small_mag",
"small_sign", "accept"); the parity tests pass JAX's draws through it.
"""
from __future__ import annotations

import math

import torch

from ..core import math as m
from ..models import sensor as sensorlib
from ..utils import graphs
from . import path as pathlib
from .common import RenderConfig

SENSOR_DIMS = 4
DIMS_PER_BOUNCE = 8
LUM = (0.2126, 0.7152, 0.0722)


class VectorStream:
    """SampleStream look-alike backed by an explicit (N, D) vector: the
    reference's ReplayableSampler/PSSMLTSampler analog."""

    __slots__ = ("u", "dim")

    def __init__(self, u):
        self.u = u
        self.dim = 0

    def at_dim(self, dim):
        return self.u[:, dim]

    def next_1d(self):
        v = self.u[:, self.dim]
        self.dim += 1
        return v

    def next_2d(self):
        v = self.u[:, self.dim:self.dim + 2]
        self.dim += 2
        return v


def generator_draws(seed: int, device):
    """The default `uniforms`: torch.rand from one Generator seeded with
    `seed`, in call order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return lambda name, shape: torch.rand(shape, generator=gen, device=device)


def _eval(scene, cam, cfg, u):
    """Target evaluation: primary vectors (N, D) -> (color (N, 3),
    luminance (N,), flat pixel index (N,))."""
    w, h = cam.width, cam.height
    px = u[:, 0] * w
    py = u[:, 1] * h
    o, d, imp = sensorlib.sample_rays(cam, px, py, u[:, 2:4])
    color = pathlib.li(scene, cam, o, d, VectorStream(u), cfg) * imp[:, None]
    color = torch.nan_to_num(color, nan=0.0, posinf=0.0, neginf=0.0)
    lum = color @ m.const(LUM, color.device)
    xi = torch.clamp(px.to(torch.int64), 0, w - 1)
    yi = torch.clamp(py.to(torch.int64), 0, h - 1)
    return color, lum, yi * w + xi


def _small_step(u, r1, r2):
    """Kelemen mutation (pssmlt_sampler.cpp mutate): an exponential-scale
    perturbation of every dim, wrapped to [0, 1)."""
    s1, s2 = 1.0 / 1024.0, 1.0 / 64.0
    mag = s2 * torch.exp(-math.log(s2 / s1) * r1)
    delta = torch.where(r2 < 0.5, mag, -mag)
    return torch.remainder(u + delta, 1.0)


def seed_chains(lum_boot, u_pick):
    """Bootstrap indices drawn in proportion to luminance: u_pick (C,) in
    [0, 1) scaled to the luminance total, searched (left) in the running
    sum. torch's cumsum rounds otherwise than XLA's, so a pick within a
    rounding of a bin edge may select the neighbouring path (ROADMAP C39).
    The sum and the search run on the host, in order, whatever the
    device: the card's scan of a bootstrap this long rounds otherwise from
    run to run, which seeded other chains for the same seed (C48)."""
    cdf = torch.cumsum(lum_boot.cpu(), 0)
    idx = torch.searchsorted(cdf, u_pick.cpu() * cdf[-1])
    return torch.clamp(idx, 0, lum_boot.shape[0] - 1).to(lum_boot.device)


def _splat_both(img, a, weight, cur, prop):
    """Expected-value splatting (Kelemen): the current state with weight
    (1 - a) * weight / L_cur and the proposal with a * weight / L_prop,
    each only where its luminance is positive; one index_add_."""
    (c_cur, l_cur, p_cur), (c_prop, l_prop, p_prop) = cur, prop
    w_cur = (1.0 - a) * weight / torch.clamp_min(l_cur, 1e-12)
    w_prop = a * weight / torch.clamp_min(l_prop, 1e-12)
    w_cur = torch.where(l_cur > 0, w_cur, 0.0)
    w_prop = torch.where(l_prop > 0, w_prop, 0.0)
    img.index_add_(0, torch.cat([p_cur, p_prop]),
                   torch.cat([c_cur * w_cur[:, None], c_prop * w_prop[:, None]]))


def _accept(accept, prop, state):
    """The chains' states after the accept draw: the proposal where
    accepted, else the current one."""
    return tuple(torch.where(accept[:, None] if x.ndim == 2 else accept, p, x)
                 for p, x in zip(prop, state))


def bootstrap(scene, cam, cfg: RenderConfig, draw, n_chains: int, n_bootstrap: int):
    """Stage 1: the bootstrap paths, b (their mean luminance) and the
    chains' seeds resampled in proportion to luminance. Returns (state,
    b), state = (u, colour, luminance, pixel) of every chain."""
    ndims = SENSOR_DIMS + cfg.max_depth * DIMS_PER_BOUNCE
    u_boot = draw("boot", (n_bootstrap, ndims))
    _, lum_boot, _ = _eval(scene, cam, cfg, u_boot)
    b = torch.mean(lum_boot)
    u_cur = u_boot[seed_chains(lum_boot, draw("pick", (n_chains,)))]
    return (u_cur, *_eval(scene, cam, cfg, u_cur)), b


def _mutate(scene, cam, cfg: RenderConfig, draw, state, img, b, p_large: float):
    """One lockstep Kelemen mutation of every chain: the proposal, both
    states' splats into img, the accept draw. Returns the new state (the
    work render_jit captures)."""
    n_chains, ndims = state[0].shape
    large = draw("large", (n_chains,)) < p_large
    u_fresh = draw("fresh", (n_chains, ndims))
    u_small = _small_step(state[0], draw("small_mag", (n_chains, ndims)),
                          draw("small_sign", (n_chains, ndims)))
    u_prop = torch.where(large[:, None], u_fresh, u_small)
    prop = (u_prop, *_eval(scene, cam, cfg, u_prop))
    l_cur, l_prop = state[2], prop[2]
    a = torch.clamp(l_prop / torch.clamp_min(l_cur, 1e-12), 0.0, 1.0)
    a = torch.where(l_cur <= 0.0, torch.where(l_prop > 0, 1.0, 0.0), a)
    _splat_both(img, a, b, state[1:], prop[1:])
    return _accept(draw("accept", (n_chains,)) < a, prop, state)


def render(scene, cam, cfg: RenderConfig, n_chains: int = 1 << 15,
           n_mutations: int = 256, p_large: float = 0.3,
           n_bootstrap: int = 1 << 17, uniforms=None) -> torch.Tensor:
    """PSSMLT render -> (H, W, 3). Total path evaluations: n_bootstrap +
    n_chains * (n_mutations + 1)."""
    w, h = cam.width, cam.height
    draw = uniforms or generator_draws(cfg.seed, scene.device)
    state, b = bootstrap(scene, cam, cfg, draw, n_chains, n_bootstrap)
    img = torch.zeros((w * h, 3), dtype=torch.float32, device=scene.device)
    for _ in range(n_mutations):
        state = _mutate(scene, cam, cfg, draw, state, img, b, p_large)
    return _normalize(img, cam, n_chains * n_mutations)


def _normalize(img, cam, n_splats: int) -> torch.Tensor:
    """Each mutation deposits expected weight b/L per chain; the image
    estimator normalizes by the samples-per-pixel equivalent."""
    w, h = cam.width, cam.height
    return (img / n_splats * (w * h)).reshape(h, w, 3)


class ChainGraph:
    """A cache entry of pssmlt's and erpt's render_jit: static copies of the
    scene and camera, a generator, the chains' state, the splat weight and
    the image, and the piece that runs one mutation (`mutate(scene, cam,
    draw, state, img, weight)` -> the new state) and writes the new state
    into the static one. The generator is registered with the graph, so a
    replay draws the uniforms the eager mutation would."""

    def __init__(self, scene, cam, cfg: RenderConfig, n_chains: int, mutate):
        dev = scene.device
        ndims = SENSOR_DIMS + cfg.max_depth * DIMS_PER_BOUNCE
        self.statics = graphs.Statics(scene, cam)
        s_scene, s_cam = self.statics.trees
        self.gen = torch.Generator(device=dev)
        self.draw = lambda name, shape: torch.rand(shape, generator=self.gen, device=dev)
        self.state = (torch.zeros((n_chains, ndims), device=dev),
                      torch.zeros((n_chains, 3), device=dev),
                      torch.zeros((n_chains,), device=dev),
                      torch.zeros((n_chains,), dtype=torch.int64, device=dev))
        self.weight = torch.zeros((), device=dev)
        self.img = torch.zeros((cam.width * cam.height, 3), device=dev)

        def step():
            new = mutate(s_scene, s_cam, self.draw, self.state, self.img, self.weight)
            for dst, src in zip(self.state, new, strict=True):
                dst.copy_(src)

        self.piece = graphs.Piece(step, generators=(self.gen,))

    def run(self, scene, cam, seed: int, start, n_mutations: int) -> torch.Tensor:
        """The image's splat sums of n_mutations steps from the state and
        weight `start(scene, cam, draw)` gives (run eagerly, from the
        generator seeded with `seed`), in the entry's own tensor."""
        self.statics.load(scene, cam)
        self.gen.manual_seed(int(seed))
        with torch.no_grad():
            state, weight = start(*self.statics.trees, self.draw)
        graphs.copy_leaves(self.state, state)
        self.weight.copy_(weight)
        self.img.zero_()
        for _ in range(n_mutations):
            self.piece.run()
        return self.img


_GRAPHS = graphs.Cache()


def render_jit(scene, cam, cfg: RenderConfig, n_chains: int = 1 << 15,
               n_mutations: int = 256, p_large: float = 0.3,
               n_bootstrap: int = 1 << 17, uniforms=None) -> torch.Tensor:
    """`render`, compiled and cached as the JAX package's render_jit is
    (utils/graphs.py). On the card the bootstrap, the luminance CDF and the
    seeding run eagerly once a call; the first call of a key (cfg and the
    counts, the scene's and camera's static_key) runs its first mutation
    eagerly and captures one mutation (the draws from the entry's
    generator, registered with the graph, the proposal's path.li, the
    splat, the accept) into a graph that every later mutation and call
    replays: the chains draw and step as `render`'s do for the same seed,
    and the image equals `render`'s but for the order in which the card's
    `index_add_` sums the splats (bit for bit under torch's deterministic
    algorithms, which order it). On the CPU this is `render`. `uniforms` (a host-made hook)
    raises ValueError on the card; a leaf that requires grad raises
    NotImplementedError; a failed capture raises."""
    graphs.refuse_grad("pssmlt.render_jit", scene, cam)
    if scene.device.type != "cuda":
        return render(scene, cam, cfg, n_chains, n_mutations, p_large, n_bootstrap, uniforms)
    graphs.refuse_hook("pssmlt.render_jit", uniforms=uniforms)
    key = (cfg, n_chains, n_mutations, p_large, n_bootstrap, graphs.static_key(scene, cam))

    def mutate(s, c, draw, state, img, b):
        return _mutate(s, c, cfg, draw, state, img, b, p_large)

    def start(s, c, draw):
        return bootstrap(s, c, cfg, draw, n_chains, n_bootstrap)

    with _GRAPHS.lock, torch.cuda.device(scene.device):
        entry = _GRAPHS.get(key, lambda: ChainGraph(scene, cam, cfg, n_chains, mutate))
        img = entry.run(scene, cam, cfg.seed, start, n_mutations)
        return _normalize(img, cam, n_chains * n_mutations)
