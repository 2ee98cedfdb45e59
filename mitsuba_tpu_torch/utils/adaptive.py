"""Adaptive sampling driver: t-test-guided supersampling (port of
utils/adaptive.py).

The analog of src/integrators/misc/adaptive.cpp: the reference
supersamples 32x32 blocks whose sample mean fails a t-test against the
configured relative error. Here every refinement pass picks the K pixels
with the widest relative confidence interval (K fixed, so the shapes stay
fixed) and renders `batch_spp` more samples for those pixels, on the same
pure (pixel, sample index) streams, so refinement composes with the base
pass without bias.
"""
from __future__ import annotations

import torch

from ..core.rng import SampleStream
from ..integrators.common import RenderConfig

LUM = (0.2126, 0.7152, 0.0722)


def _accumulate(scene, cam, li_fn, cfg, pixel_ids, sample_base, n_samples):
    """Render n_samples for each pixel of pixel_ids (K,), from the sample
    indices sample_base (K,) on; returns (sum_rgb (K,3), sum_lum_sq (K,))."""
    from ..models import sensor as sensorlib

    k = pixel_ids.shape[0]
    w = cam.width
    pids = torch.repeat_interleave(pixel_ids, n_samples)
    slot = torch.arange(n_samples, dtype=torch.int64, device=pixel_ids.device).repeat(k)
    sample_ids = slot + torch.repeat_interleave(sample_base, n_samples)
    stream = SampleStream(cfg.seed, pids, sample_ids, 0, kind=cfg.sampler, spp=cfg.spp)
    jx = stream.next_1d()
    jy = stream.next_1d()
    u_lens = stream.next_2d()
    px = (pids % w).to(torch.float32) + jx
    py = (pids // w).to(torch.float32) + jy
    o, d, imp = sensorlib.sample_rays(cam, px, py, u_lens)
    radiance = li_fn(scene, cam, o, d, stream, cfg) * imp[:, None]
    radiance = torch.nan_to_num(radiance, nan=0.0, posinf=0.0, neginf=0.0)
    r = radiance.reshape(k, n_samples, 3)
    lum = r @ torch.tensor(LUM, dtype=torch.float32, device=r.device)
    return r.sum(1), (lum * lum).sum(1)


def top_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest scores, ties to the lower index as
    jax.lax.top_k breaks them (torch.topk promises no order): the first k
    of a stable descending sort."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def render_adaptive(scene, cam, li_fn, cfg: RenderConfig, base_spp: int = 16,
                    batch_spp: int = 16, max_spp: int = 256, max_error: float = 0.05,
                    refine_frac: float = 0.25):
    """Adaptive render -> (image (H, W, 3), spp map (H, W)), on the scene's
    device. A pixel whose 95% confidence interval of the mean luminance
    exceeds max_error x the mean keeps receiving batches until max_spp
    (adaptive.cpp's maxError / pValue logic)."""
    w, h = cam.width, cam.height
    npix = w * h
    dev = scene.device
    k = max(int(npix * refine_frac), 1)
    lum = torch.tensor(LUM, dtype=torch.float32, device=dev)

    sum_rgb, sum_l2 = _accumulate(scene, cam, li_fn, cfg,
                                  torch.arange(npix, dtype=torch.int64, device=dev),
                                  torch.zeros((npix,), dtype=torch.int64, device=dev), base_spp)
    n = torch.full((npix,), base_spp, dtype=torch.float32, device=dev)

    for _ in range(max((max_spp - base_spp) // batch_spp, 0)):
        mean_l = (sum_rgb @ lum) / n
        var = torch.clamp_min(sum_l2 / n - mean_l * mean_l, 0.0)
        ci = 1.96 * torch.sqrt(var / n)
        score = ci / torch.clamp_min(mean_l, 1e-4)
        score = torch.where(n >= max_spp, -1.0, score)
        if float(torch.max(score)) <= max_error:
            break
        idx = top_k(score, k)
        add_rgb, add_l2 = _accumulate(scene, cam, li_fn, cfg, idx, n[idx].to(torch.int64),
                                      batch_spp)
        sum_rgb.index_add_(0, idx, add_rgb)
        sum_l2.index_add_(0, idx, add_l2)
        n.index_add_(0, idx, torch.full((k,), float(batch_spp), device=dev))

    return (sum_rgb / n[:, None]).reshape(h, w, 3), n.reshape(h, w)
