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


def _chunk_radiance(scene, cam, li_fn: LiFn, cfg: RenderConfig, pixel_ids,
                    sample_base: int, n_samples: int, chunk: int):
    """For each chunk of `chunk` samples a pixel: (px, py, radiance) of every
    pixel id x chunk slot, pixel-major, for the samples [sample_base,
    sample_base + n_samples) of each pixel."""
    from ..models import sensor as sensorlib

    w = cam.width
    pids = torch.repeat_interleave(pixel_ids, chunk)                 # pixel-major
    slot = torch.arange(chunk, dtype=torch.int64,
                        device=pixel_ids.device).repeat(pixel_ids.shape[0])
    px_base = (pids % w).to(torch.float32)
    py_base = (pids // w).to(torch.float32)
    for ci in range(n_samples // chunk):
        sample_ids = slot + (sample_base + ci * chunk)
        stream = SampleStream(cfg.seed, pids, sample_ids, 0, kind=cfg.sampler, spp=cfg.spp)
        # pixel jitter + lens sample: sampler dims 0-3
        jx = stream.next_1d()
        jy = stream.next_1d()
        u_lens = stream.next_2d()
        px, py = px_base + jx, py_base + jy
        o, d, imp = sensorlib.sample_rays(cam, px, py, u_lens)
        radiance = li_fn(scene, cam, o, d, stream, cfg) * imp[:, None]
        yield px, py, torch.nan_to_num(radiance, nan=0.0, posinf=0.0, neginf=0.0)


def radiance_sum(scene, cam, li_fn: LiFn, cfg: RenderConfig, pixel_ids, sample_base: int,
                 n_samples: int, chunk: int) -> torch.Tensor:
    """Sum of the per-sample radiance of each pixel id -> (Np, 3), the box
    film's sums.

    pixel_ids: (Np,) int64 flattened pixel indices (y * W + x) on the
    scene's device. sample_base: the first sample index (a progressive
    pass or a sample-parallel shard takes the samples [sample_base,
    sample_base + n_samples) of one global set)."""
    npx = pixel_ids.shape[0]
    acc = torch.zeros((npx, 3), dtype=torch.float32, device=pixel_ids.device)
    for _, _, radiance in _chunk_radiance(scene, cam, li_fn, cfg, pixel_ids, sample_base,
                                          n_samples, chunk):
        acc = acc + torch.sum(radiance.reshape(npx, chunk, 3), dim=1)
    return acc


def film_sum(scene, cam, li_fn: LiFn, cfg: RenderConfig, pixel_ids, sample_base: int,
             n_samples: int, chunk: int):
    """The filtered-splat variant of radiance_sum: the full-frame (H, W, 3)
    image and (H, W) weight films of these pixels' samples (splats spill
    past the pixels' own, film/film.py); filmlib.develop divides them."""
    w, h = cam.width, cam.height
    dev = pixel_ids.device
    img = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    wgt = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for px, py, radiance in _chunk_radiance(scene, cam, li_fn, cfg, pixel_ids, sample_base,
                                            n_samples, chunk):
        ci_img, ci_wgt = filmlib.splat(w, h, px, py, radiance, cfg.filter)
        img = img + ci_img
        wgt = wgt + ci_wgt
    return img, wgt


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
        acc = radiance_sum(scene, cam, li_fn, cfg, pixel_ids, sample_offset, n_samples, chunk)
        return acc.reshape(rows, w, 3) / max(float(n_samples), 1e-8)
    img, wgt = film_sum(scene, cam, li_fn, cfg, pixel_ids, sample_offset, n_samples, chunk)
    return filmlib.develop(img, wgt)


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
