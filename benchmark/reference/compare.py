"""The numbers that decide whether a set of rendered images is correct,
against the plain reference's independent images of the same scene.

The program's images P_k (k = 1..K, each of the configuration's spp, each
from its own range of sample indices) and the reference's R_q (q = 1..Q,
the same spp, independent samples) are compared through R, the mean of
the R_q, and v_R, the variance of one reference image per pixel (across
the R_q). The program's images need not be independent of each other: a
low-discrepancy sampler's consecutive sample ranges are not.

- bias_chi2: the mean over blocks of `block` x `block` pixels (per
  channel) of (p_b - r_b)^2 / (v_p,b / K + v_r,b / Q), with p_b, v_p,b the
  block's mean and variance over the program's images and r_b, v_r,b the
  reference's. A bias grows it without bound; a sound render keeps it
  near 1, and above 1 by as much as its images' errors are alike (a
  low-discrepancy sampler's are), which v_p,b does not see.
- worst_image_error: the largest over k of mean_pixels (P_k - R)^2 over
  mean_pixels v_R, less 1/Q (R's own noise): an image's squared error in
  units of one reference image's variance at the same spp. About 1 for
  independent samples, lower for a low-discrepancy sampler; taking fewer
  samples than stated raises it (about twice for half), a wrong image
  raises it without bound.

A block where neither side varies has to agree exactly; one that does not
makes bias_chi2 infinite. One program image (K = 1) has no
variance of its own: v_p,b is taken as 0.
"""
from __future__ import annotations

import numpy as np


def _blocks(imgs, block):
    n, h, w, c = imgs.shape
    hb, wb = h // block, w // block
    x = imgs[:, :hb * block, :wb * block]
    return x.reshape(n, hb, block, wb, block, c).mean((2, 4))


def numbers(program, reference, block):
    """program (K, H, W, 3), reference (Q, H, W, 3) -> {name: value}."""
    program = program.astype(np.float64)
    reference = reference.astype(np.float64)
    k, q = program.shape[0], reference.shape[0]
    if k < 1 or q < 2:
        raise ValueError(f"compare: {k} program and {q} reference images, 1 and 2 at least")
    pb, rb = _blocks(program, block), _blocks(reference, block)
    pm = pb.mean(0)
    pv = pb.var(0, ddof=1) if k > 1 else np.zeros_like(pm)
    rm, rv = rb.mean(0), rb.var(0, ddof=1)
    varies = (pv > 0) | (rv > 0)
    if np.any(~varies & (pm != rm)) or not varies.any():
        bias = float("inf")
    else:
        bias = float(np.mean((pm - rm)[varies] ** 2 / (pv / k + rv / q)[varies]))
    r_mean = reference.mean(0)
    r_var = reference.var(0, ddof=1).mean()
    if r_var > 0:
        worst = max(float(np.mean((p - r_mean) ** 2) / r_var) for p in program) - 1.0 / q
    else:
        worst = float("inf")
    return {"bias_chi2": bias, "worst_image_error": worst}


def judge(values, limits):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number that is not finite fails."""
    checks = {name: {"value": values[name], "limit": limits[name]} for name in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return bool(ok), checks
