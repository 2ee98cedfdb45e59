"""Render orchestration: sample generation, spp chunking and the film
(port of integrators/common.py).

The film is rendered as ray batches of all pixels x spp_chunk samples in
pixel-major order, exactly as the JAX package orders them, so every sample
gets the same (pixel, sample) indices and the same random numbers. The box
filter sums each pixel's own samples; every other reconstruction filter
splats each chunk into its neighbourhood (film/film.py) and the image is
developed at the end.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.rng import SampleStream
from ..film import film as filmlib
from ..utils import graphs


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings: the JAX package's RenderConfig fields that
    the ported integrators and the scene loader set, with the same
    defaults. `cauchy_b` (a dispersive dielectric's `cauchyB`, read by the
    spectral integrator, ROADMAP A12) is carried so that a loaded or
    converted config keeps it; no integrator of the port reads it."""

    spp: int = 16
    max_depth: int = 8          # path edges (Mitsuba's maxDepth)
    rr_depth: int = 5           # Russian roulette from this depth on
    seed: int = 0
    filter: int = filmlib.FILTER_BOX
    spp_chunk: int = 0          # 0 = auto
    strict_normals: bool = False
    sampler: int = 0            # samplers/qmc.py SAMPLER_* family
    mis_mode: int = 0           # 0=power, 1=balance, 2=uniform
    # shadow rays through the occupancy map (ops/occupancy.py; the fork's
    # myPath2_OM / LVCBPT_OM variants): approximate, where the scene has one
    occupancy_shadows: bool = False
    ao_length: float = -1.0     # the ao integrator's ray length (<0: unbounded)
    hide_emitters: bool = False
    film_tiled: bool = False    # tiledhdrfilm: row bands streamed to disk
    cauchy_b: float = 0.0       # dispersive dielectrics' Cauchy B (um^2)

    def resolve_chunk(self, width: int, height: int) -> int:
        if self.spp_chunk > 0:
            return min(self.spp_chunk, self.spp)
        target_rays = 1 << 19   # ~512k rays per batch
        c = max(1, target_rays // max(width * height, 1))
        while self.spp % c:
            c -= 1
        return min(c, self.spp)


# An integrator Li is: (scene, cam, o, d, stream, cfg) -> (N,3) radiance.
LiFn = Callable


def config_from_jax(jcfg) -> RenderConfig:
    """Carry a JAX package RenderConfig across: every field the port has is
    copied; a field it lacks raises unless it holds the JAX default."""
    ours = {f.name for f in dataclasses.fields(RenderConfig)}
    kw = {}
    for f in dataclasses.fields(jcfg):
        value = getattr(jcfg, f.name)
        if f.name in ours:
            kw[f.name] = value
        elif value != f.default:
            raise NotImplementedError(
                f"config_from_jax: RenderConfig.{f.name}={value!r} is not ported")
    return RenderConfig(**kw)


def chunk_layout(pixel_ids, chunk: int, width: int):
    """The lanes of one chunk, pixel-major: (pixel id, sample slot, x, y of
    the pixel's corner) of every pixel id x chunk slot."""
    pids = torch.repeat_interleave(pixel_ids, chunk)
    slot = torch.arange(chunk, dtype=torch.int64,
                        device=pixel_ids.device).repeat(pixel_ids.shape[0])
    return pids, slot, (pids % width).to(torch.float32), (pids // width).to(torch.float32)


def chunk_radiance(scene, cam, li_fn: LiFn, cfg: RenderConfig, layout, base: torch.Tensor):
    """(px, py, radiance) of one chunk: the samples base + slot of each lane
    of `layout` (chunk_layout). `base` is a 0-dim int64 tensor on the
    scene's device, so a captured chunk takes its samples from a tensor
    that each replay rewrites."""
    from ..models import sensor as sensorlib

    pids, slot, px_base, py_base = layout
    stream = SampleStream(cfg.seed, pids, slot + base, 0, kind=cfg.sampler, spp=cfg.spp)
    # pixel jitter + lens sample: sampler dims 0-3
    jx = stream.next_1d()
    jy = stream.next_1d()
    u_lens = stream.next_2d()
    px, py = px_base + jx, py_base + jy
    o, d, imp = sensorlib.sample_rays(cam, px, py, u_lens)
    radiance = li_fn(scene, cam, o, d, stream, cfg) * imp[:, None]
    return px, py, torch.nan_to_num(radiance, nan=0.0, posinf=0.0, neginf=0.0)


def chunk_sum(scene, cam, li_fn: LiFn, cfg: RenderConfig, layout, base: torch.Tensor,
              chunk: int):
    """One chunk's share of the film: with the box filter a 1-tuple, each
    pixel's sum of its `chunk` samples (Np, 3); else the (H, W, 3) image
    and (H, W) weight splats (film/film.py). The work render_jit captures;
    radiance_sum and film_sum add the chunks up in the same order."""
    px, py, radiance = chunk_radiance(scene, cam, li_fn, cfg, layout, base)
    if cfg.filter == filmlib.FILTER_BOX:
        return (torch.sum(radiance.reshape(-1, chunk, 3), dim=1),)
    return filmlib.splat(cam.width, cam.height, px, py, radiance, cfg.filter)


def _base(sample_base: int, device) -> torch.Tensor:
    return torch.full((), sample_base, dtype=torch.int64, device=device)


def _film_zeros(box: bool, n_pixels: int, cam, device) -> list:
    """chunk_sum's accumulators: the box film's (Np, 3) sums, or the
    full-frame image and weight films."""
    if box:
        return [torch.zeros((n_pixels, 3), dtype=torch.float32, device=device)]
    return [torch.zeros((cam.height, cam.width, 3), dtype=torch.float32, device=device),
            torch.zeros((cam.height, cam.width), dtype=torch.float32, device=device)]


def _accumulate(scene, cam, li_fn, cfg, pixel_ids, sample_base, n_samples, chunk, acc):
    layout = chunk_layout(pixel_ids, chunk, cam.width)
    for ci in range(n_samples // chunk):
        sums = chunk_sum(scene, cam, li_fn, cfg, layout,
                         _base(sample_base + ci * chunk, pixel_ids.device), chunk)
        acc = [a + x for a, x in zip(acc, sums)]
    return acc


def radiance_sum(scene, cam, li_fn: LiFn, cfg: RenderConfig, pixel_ids, sample_base: int,
                 n_samples: int, chunk: int) -> torch.Tensor:
    """Sum of the per-sample radiance of each pixel id -> (Np, 3), the box
    film's sums.

    pixel_ids: (Np,) int64 flattened pixel indices (y * W + x) on the
    scene's device. sample_base: the first sample index (a progressive
    pass or a sample-parallel shard takes the samples [sample_base,
    sample_base + n_samples) of one global set)."""
    acc = _film_zeros(True, pixel_ids.shape[0], cam, pixel_ids.device)
    return _accumulate(scene, cam, li_fn, cfg, pixel_ids, sample_base, n_samples, chunk,
                       acc)[0]


def film_sum(scene, cam, li_fn: LiFn, cfg: RenderConfig, pixel_ids, sample_base: int,
             n_samples: int, chunk: int):
    """The filtered-splat variant of radiance_sum: the full-frame (H, W, 3)
    image and (H, W) weight films of these pixels' samples (splats spill
    past the pixels' own, film/film.py); filmlib.develop divides them."""
    acc = _film_zeros(False, pixel_ids.shape[0], cam, pixel_ids.device)
    return tuple(_accumulate(scene, cam, li_fn, cfg, pixel_ids, sample_base, n_samples,
                             chunk, acc))


def _finish(acc, cfg: RenderConfig, rows: int, width: int, n_samples: int) -> torch.Tensor:
    if cfg.filter == filmlib.FILTER_BOX:
        return acc[0].reshape(rows, width, 3) / max(float(n_samples), 1e-8)
    return filmlib.develop(*acc)


def render(scene, cam, li_fn: LiFn, cfg: RenderConfig, sample_offset: int = 0,
           y0: int = 0, rows: int | None = None) -> torch.Tensor:
    """Full-frame render -> (H, W, 3) float32 on the scene's device.

    sample_offset shifts every pixel's sample indices: a progressive or
    checkpointed render takes samples [offset, offset + spp) of one global
    sample set in each pass. y0 and rows select the row band [y0, y0 + rows)
    -> (rows, W, 3), with the full frame's pixel ids (film/tiled.py); the
    band resolves its own spp chunk, and only the box filter renders one."""
    w, h = cam.width, cam.height
    rows = h - y0 if rows is None else rows
    box = cfg.filter == filmlib.FILTER_BOX
    if not box and (y0, rows) != (0, h):
        raise ValueError("a row band renders with the box filter only")
    chunk = cfg.resolve_chunk(w, rows)
    n_samples = cfg.spp // chunk * chunk
    pixel_ids = torch.arange(w * y0, w * (y0 + rows), dtype=torch.int64, device=scene.device)
    if box:
        acc = (radiance_sum(scene, cam, li_fn, cfg, pixel_ids, sample_offset, n_samples, chunk),)
    else:
        acc = film_sum(scene, cam, li_fn, cfg, pixel_ids, sample_offset, n_samples, chunk)
    return _finish(acc, cfg, rows, w, n_samples)


class ChunkGraph:
    """A cache entry of render_jit and the sharded render_jit: private
    copies of a scene's and a camera's tensors, the chunk's sample base,
    the accumulators of these pixel ids' film and the piece of work that
    adds one chunk into them (run eagerly first, then captured and
    replayed: utils/graphs.Piece). `pixel_ids` (on the scene's device)
    default to the full frame; `chunk` to cfg's for the full frame."""

    def __init__(self, scene, cam, li_fn: LiFn, cfg: RenderConfig, pixel_ids=None,
                 chunk: int | None = None):
        w, h = cam.width, cam.height
        dev = scene.device
        if pixel_ids is None:
            pixel_ids = torch.arange(w * h, dtype=torch.int64, device=dev)
        self.chunk = cfg.resolve_chunk(w, h) if chunk is None else chunk
        self.statics = graphs.Statics(scene, cam)
        s_scene, s_cam = self.statics.trees
        layout = chunk_layout(pixel_ids, self.chunk, w)
        self.base = _base(0, dev)
        self.acc = _film_zeros(cfg.filter == filmlib.FILTER_BOX, pixel_ids.shape[0], cam, dev)

        def add_chunk():
            sums = chunk_sum(s_scene, s_cam, li_fn, cfg, layout, self.base, self.chunk)
            for a, x in zip(self.acc, sums):
                a.add_(x)

        self.piece = graphs.Piece(add_chunk)

    def sums(self, scene, cam, sample_base: int, n_samples: int) -> list:
        """The accumulators after the chunks of the samples [sample_base,
        sample_base + n_samples): radiance_sum's or film_sum's values, in
        the entry's own tensors (the next call overwrites them)."""
        self.statics.load(scene, cam)
        for a in self.acc:
            a.zero_()
        for ci in range(n_samples // self.chunk):
            self.base.fill_(sample_base + ci * self.chunk)
            self.piece.run()
        return self.acc


_CHUNK_GRAPHS = graphs.Cache()


def render_jit(scene, cam, li_fn: LiFn, cfg: RenderConfig,
               sample_offset: int = 0) -> torch.Tensor:
    """`render`, compiled and cached as the JAX package's render_jit is.

    On a CUDA device the first call for a key, (li_fn, cfg) and the
    scene's and camera's structure, static fields and tensor shapes
    (utils/graphs.static_key), renders its first chunk eagerly and
    captures the chunk (sampling, li_fn, the film's sums) into a CUDA
    graph; every later chunk, pass and call of that key replays it, with
    the chunk's sample base written into a device tensor first, so a
    progressive render's passes share one capture. The scene's and
    camera's tensors are copied into the graph's own before each call: a
    scene of the same key renders itself. On the CPU this is `render`. A
    failed capture raises; a leaf that requires grad raises
    NotImplementedError (gradients go through `render` or
    `boundary.render_grad`)."""
    graphs.refuse_grad("common.render_jit", scene, cam)
    if scene.device.type != "cuda":
        return render(scene, cam, li_fn, cfg, sample_offset)
    key = (li_fn, cfg, graphs.static_key(scene, cam))
    with _CHUNK_GRAPHS.lock, torch.cuda.device(scene.device):
        entry = _CHUNK_GRAPHS.get(key, lambda: ChunkGraph(scene, cam, li_fn, cfg))
        n_samples = cfg.spp // entry.chunk * entry.chunk
        acc = entry.sums(scene, cam, int(sample_offset), n_samples)
        return _finish(acc, cfg, cam.height, cam.width, n_samples)


def power_heuristic(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Power heuristic (beta=2) MIS weight for strategy a, in ratio form so
    an infinite pdf_a gives weight 1 rather than inf/inf."""
    r = pdf_b / torch.clamp_min(pdf_a, 1e-30)
    return torch.where(pdf_a > 0.0, 1.0 / (1.0 + r * r), 0.0)


def balance_heuristic(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    r = pdf_b / torch.clamp_min(pdf_a, 1e-30)
    return torch.where(pdf_a > 0.0, 1.0 / (1.0 + r), 0.0)


def uniform_heuristic(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """1/2 wherever both strategies can produce the sample, else 1."""
    return torch.where(pdf_a > 0.0, torch.where(pdf_b > 0.0, 0.5, 1.0), 0.0)


def mis_weight(mode: int, pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Dispatch on the static cfg.mis_mode."""
    if mode == 1:
        return balance_heuristic(pdf_a, pdf_b)
    if mode == 2:
        return uniform_heuristic(pdf_a, pdf_b)
    return power_heuristic(pdf_a, pdf_b)
