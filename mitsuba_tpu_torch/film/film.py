"""Film accumulation: reconstruction-filtered splatting into the image (port
of film/film.py).

The six separable filters of the JAX package, evaluated exactly. `splat`
scatters each sample into its S x S pixel neighbourhood and `develop`
divides by the accumulated filter weight. The box filter over pixel-ordered
samples needs no scatter: `accumulate_box_ordered` (and common.render's box
path) reduce by reshape.

`splat` builds every tap at once: the 1D weights per axis (S, N), their
outer product (S*S, N), and one `index_add_` each into the flattened image
and weight. On the GPU `index_add_` is an atomic add; `img[iy, ix] += v`
or `index_put_(accumulate=True)` would sort by index instead and serialise
the many samples that land on one pixel. The taps are laid out tap-major,
the order of the JAX package's loop over (dy, dx), so the CPU adds in the
JAX scatter's order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# filter kinds (the rfilter plugins)
FILTER_BOX = 0
FILTER_TENT = 1
FILTER_GAUSSIAN = 2
FILTER_MITCHELL = 3
FILTER_CATMULLROM = 4
FILTER_LANCZOS = 5

FILTER_NAMES = {v: k[7:].lower() for k, v in list(globals().items())
                if k.startswith("FILTER_")}

_FILTER_RADIUS = {
    FILTER_BOX: 0.5,
    FILTER_TENT: 1.0,
    FILTER_GAUSSIAN: 2.0,
    FILTER_MITCHELL: 2.0,
    FILTER_CATMULLROM: 2.0,
    FILTER_LANCZOS: 3.0,
}


def filter_eval(kind: int, x: torch.Tensor) -> torch.Tensor:
    """1D filter value at offset x (pixels)."""
    ax = torch.abs(x)
    if kind == FILTER_BOX:
        return (ax <= 0.5).to(torch.float32)
    if kind == FILTER_TENT:
        return torch.clamp_min(1.0 - ax, 0.0)
    if kind == FILTER_GAUSSIAN:
        # stddev 0.5, radius 2, offset so that it reaches 0 at the radius
        alpha = 2.0
        r = _FILTER_RADIUS[FILTER_GAUSSIAN]
        floor = float(np.float32(math.exp(-alpha * r * r)))
        return torch.clamp_min(torch.exp(-alpha * ax * ax) - floor, 0.0)
    if kind in (FILTER_MITCHELL, FILTER_CATMULLROM):
        if kind == FILTER_MITCHELL:
            b = c = 1.0 / 3.0
        else:
            b, c = 0.0, 0.5
        x2 = ax * ax
        x3 = x2 * ax
        inner = ((12.0 - 9.0 * b - 6.0 * c) * x3 + (-18.0 + 12.0 * b + 6.0 * c) * x2
                 + (6.0 - 2.0 * b)) / 6.0
        outer = ((-b - 6.0 * c) * x3 + (6.0 * b + 30.0 * c) * x2
                 + (-12.0 * b - 48.0 * c) * ax + (8.0 * b + 24.0 * c)) / 6.0
        return torch.where(ax < 1.0, inner, torch.where(ax < 2.0, outer, 0.0))
    if kind == FILTER_LANCZOS:
        tau = 3.0
        px = math.pi * ax
        near0 = ax < 1e-6
        sinc = torch.where(near0, 1.0, torch.sin(px) / torch.clamp_min(px, 1e-9))
        wind = torch.where(near0, 1.0, torch.sin(px / tau) / torch.clamp_min(px / tau, 1e-9))
        return torch.where(ax < tau, sinc * wind, 0.0)
    raise ValueError(f"unknown filter {kind}")


def support(kind: int) -> int:
    """The odd width S of a filter's pixel footprint."""
    return int(np.ceil(_FILTER_RADIUS[kind] - 0.5)) * 2 + 1


def splat(width: int, height: int, px: torch.Tensor, py: torch.Tensor,
          value: torch.Tensor, kind: int = FILTER_BOX):
    """Filtered splats of N samples at continuous pixel coordinates px, py
    (N,) with value (N,3). Returns (image (H,W,3), weight (H,W))."""
    dev = px.device
    s = support(kind)
    off = torch.arange(-(s // 2), s // 2 + 1, device=dev)[:, None]     # (S,1)
    ix = torch.floor(px).to(torch.int64)[None, :] + off                 # (S,N)
    iy = torch.floor(py).to(torch.int64)[None, :] + off
    wx = filter_eval(kind, (ix.to(torch.float32) + 0.5) - px)
    wy = filter_eval(kind, (iy.to(torch.float32) + 0.5) - py)
    in_x = (ix >= 0) & (ix < width)
    in_y = (iy >= 0) & (iy < height)
    # tap (dy, dx) of sample i at [dy * S + dx, i]
    w = torch.where(in_y[:, None] & in_x[None, :], wx[None, :, :] * wy[:, None, :], 0.0)
    pix = (iy.clamp(0, height - 1) * width)[:, None] + ix.clamp(0, width - 1)[None, :]
    w = w.reshape(-1)
    pix = pix.reshape(-1)
    img = torch.zeros((height * width, 3), dtype=value.dtype, device=dev)
    wgt = torch.zeros((height * width,), dtype=value.dtype, device=dev)
    img.index_add_(0, pix, (value[None, :, :] * w.view(s * s, -1, 1)).reshape(-1, 3))
    wgt.index_add_(0, pix, w.to(value.dtype))
    return img.view(height, width, 3), wgt.view(height, width)


def develop(img: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """Normalise accumulated splats by their filter weight."""
    return img / torch.clamp_min(wgt, 1e-8)[..., None]


def accumulate_box_ordered(width: int, height: int, spp: int, value: torch.Tensor):
    """Box filter over pixel-major samples, spp each: a reshape and mean."""
    return torch.mean(value.reshape(height, width, spp, 3), dim=2)
