"""Render orchestration: sample generation, spp chunking and the box-filter
film (port of integrators/common.py).

The film is rendered as ray batches of all pixels x spp_chunk samples in
pixel-major order, exactly as the JAX package orders them, so every sample
gets the same (pixel, sample) indices and the same random numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.rng import SampleStream

FILTER_BOX = 0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings: the JAX package's RenderConfig fields that
    the ported integrators read, with the same defaults."""

    spp: int = 16
    max_depth: int = 8          # path edges (Mitsuba's maxDepth)
    rr_depth: int = 5           # Russian roulette from this depth on
    seed: int = 0
    filter: int = FILTER_BOX
    spp_chunk: int = 0          # 0 = auto
    strict_normals: bool = False
    sampler: int = 0            # only 0, the independent sampler, is ported
    mis_mode: int = 0           # 0=power, 1=balance, 2=uniform
    hide_emitters: bool = False

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


def render(scene, cam, li_fn: LiFn, cfg: RenderConfig) -> torch.Tensor:
    """Full-frame render -> (H, W, 3) float32 on the scene's device."""
    from ..models import sensor as sensorlib

    if cfg.filter != FILTER_BOX:
        raise NotImplementedError(f"film filter {cfg.filter}: only the box "
                                  "filter is ported")
    dev = scene.device
    w, h = cam.width, cam.height
    chunk = cfg.resolve_chunk(w, h)
    nchunks = cfg.spp // chunk

    pixel_ids = torch.arange(w * h, dtype=torch.int64, device=dev)
    pixel_ids = torch.repeat_interleave(pixel_ids, chunk)        # pixel-major
    sample_slot = torch.arange(chunk, dtype=torch.int64, device=dev).repeat(w * h)
    px_base = (pixel_ids % w).to(torch.float32)
    py_base = (pixel_ids // w).to(torch.float32)

    img = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    for ci in range(nchunks):
        sample_ids = sample_slot + ci * chunk
        stream = SampleStream(cfg.seed, pixel_ids, sample_ids, 0,
                              kind=cfg.sampler, spp=cfg.spp)
        # pixel jitter + lens sample: sampler dims 0-3
        jx = stream.next_1d()
        jy = stream.next_1d()
        u_lens = stream.next_2d()
        o, d, imp = sensorlib.sample_rays(cam, px_base + jx, py_base + jy, u_lens)
        radiance = li_fn(scene, cam, o, d, stream, cfg) * imp[:, None]
        radiance = torch.nan_to_num(radiance, nan=0.0, posinf=0.0, neginf=0.0)
        img = img + torch.sum(radiance.reshape(h, w, chunk, 3), dim=2)
    return img / max(float(nchunks * chunk), 1e-8)


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
