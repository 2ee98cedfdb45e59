"""Chi-square goodness-of-fit harness for sample()/pdf() consistency (port
of utils/chi2.py).

The analog of the reference's ChiSquare test harness
(include/mitsuba/core/chisquare.h:40-110, used by
src/tests/test_chisquare.cpp): a warp's `sample` maps uniforms to
directions; its `pdf` must integrate to the observed histogram. Directions
are binned on a (theta, phi) grid, expected counts come from an adaptive
Simpson integration of the pdf over each cell, and a chi-square statistic
over pooled low-count cells is tested at a given significance.

The uniforms are JAX's `jax.random.uniform(PRNGKey(seed), (n, 2))`, drawn
by the numpy threefry copy (core/rng.py), so the same sample function gives
the JAX package's histogram, statistic and p-value. sample_fn and pdf_fn
run on `device`; the binning and the statistic run in numpy on the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.rng import threefry_key, threefry_uniform


def _chi2_sf(x: float, k: int) -> float:
    """Survival function of the chi-square distribution by the
    Wilson-Hilferty normal approximation (good for k >= 3; the cells are
    pooled, so the degrees of freedom are many)."""
    if k <= 0:
        return 1.0
    z = ((x / k) ** (1.0 / 3.0) - (1.0 - 2.0 / (9.0 * k))) / math.sqrt(2.0 / (9.0 * k))
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def spherical_chi2(
    sample_fn,
    pdf_fn,
    n_samples: int = 1 << 20,
    theta_bins: int = 24,
    phi_bins: int = 48,
    sub: int = 8,
    significance: float = 0.0025,
    seed: int = 0,
    sample_weights=None,
    rel_tol: float = 0.02,
    polar_axis: str = "z",
    device="cuda",
):
    """Chi-square test of `sample_fn` against `pdf_fn`.

    sample_fn(u2 (N,2) on device) -> (N,3) unit directions.
    pdf_fn(v (M,3) float32 on device) -> (M,) solid-angle density.
    sample_weights: optional (N,) weights (0 = a rejected sample; the pdf
    then integrates the accepted measure only).

    Returns (passed, p_value, stats)."""
    u = torch.from_numpy(threefry_uniform(threefry_key(seed), (n_samples, 2))).to(device)
    v = _to_numpy(sample_fn(u))
    w = np.ones(n_samples) if sample_weights is None else _to_numpy(sample_weights)

    # `polar_axis` aligns the integration grid's pole with the pdf's natural
    # axis (e.g. "y" for lat-long envmaps): the sin(theta) measure factor
    # only regularizes 1/sin singularities around the grid's pole.
    perm = {"y": [0, 2, 1], "x": [2, 1, 0]}.get(polar_axis, [0, 1, 2])
    v = v[:, perm]

    # observed counts on a theta-uniform grid (chisquare.h: res x 2 res)
    ct = np.clip(v[:, 2], -1.0, 1.0)
    theta = np.arccos(ct)
    phi = np.arctan2(v[:, 1], v[:, 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    ti = np.minimum((theta / np.pi * theta_bins).astype(np.int64), theta_bins - 1)
    pi_ = np.minimum((phi / (2 * np.pi) * phi_bins).astype(np.int64), phi_bins - 1)
    obs = np.zeros((theta_bins, phi_bins))
    np.add.at(obs, (ti, pi_), w)

    def eval_pdf_np(dirs_flat: np.ndarray) -> np.ndarray:
        """pdf_fn on the device at float32 directions given in the grid's
        frame (mapped back through `perm`, which is its own inverse)."""
        dirs = torch.from_numpy(np.ascontiguousarray(dirs_flat[:, perm])).to(device)
        return _to_numpy(pdf_fn(dirs))

    def cells_integral(rows, cols, s):
        """Simpson integral of pdf(omega) sin(theta) dtheta dphi over the
        (row, col) cells with s intervals per axis."""
        npts = s + 1
        w1d = np.ones(npts)
        w1d[1:-1:2] = 4.0
        w1d[2:-1:2] = 2.0
        # endpoints inset by a sliver, so a pdf with a discontinuity on a
        # cell boundary evaluates on the right side (O(1e-4/s) bias)
        frac = np.clip(np.arange(npts) / s, 1e-4 / s, 1.0 - 1e-4 / s)
        th = np.pi * (rows[:, None] + frac[None, :]) / theta_bins   # (C,P)
        # theta kept from the exact poles: below ~5e-4, float32 directions
        # round cos(theta) to 1 and pdfs that rebuild sin(theta) blow up
        th = np.clip(th, 5e-4, np.pi - 5e-4)
        ph = 2 * np.pi * (cols[:, None] + frac[None, :]) / phi_bins
        TH = th[:, :, None]
        PH = ph[:, None, :]
        ST = np.sin(TH)
        CT = np.cos(TH)
        dirs = np.stack(
            np.broadcast_arrays(ST * np.cos(PH), ST * np.sin(PH),
                                np.broadcast_to(CT, (len(rows), npts, npts))),
            axis=-1,
        )
        vals = eval_pdf_np(
            dirs.reshape(-1, 3).astype(np.float32)
        ).reshape(len(rows), npts, npts).astype(np.float64)
        vals = vals * ST  # solid-angle measure; kills 1/sin pole spikes
        h_th = (np.pi / theta_bins) / s
        h_ph = (2 * np.pi / phi_bins) / s
        return np.einsum("cab,a,b->c", vals, w1d, w1d) * (h_th / 3.0) * (h_ph / 3.0)

    # expected counts: each cell refined until successive resolutions agree
    # to 0.1% (chisquare.h:81 / quad.h:132's adaptive quadrature)
    rows, cols = np.meshgrid(np.arange(theta_bins), np.arange(phi_bins), indexing="ij")
    rows = rows.ravel()
    cols = cols.ravel()
    s = max(sub, 4) // 2 * 2
    coarse = cells_integral(rows, cols, s)
    exp = coarse.copy()
    active = np.arange(len(rows))
    prev = coarse
    while s <= 512 and len(active):
        s *= 2
        refined = cells_integral(rows[active], cols[active], s)
        exp[active] = refined
        diff = np.abs(refined - prev[active])
        keep = diff > np.maximum(1e-3 * np.abs(refined), 1e-9)
        prev = exp
        active = active[keep]
    fine = exp.reshape(theta_bins, phi_bins)
    # scaled by the total sample count: with rejection the pdf already
    # integrates to the acceptance fraction
    exp = fine * float(n_samples)

    # pool cells with an expected count below 5 (chisquare.cpp)
    obs_f = obs.ravel()
    exp_f = exp.ravel()
    order = np.argsort(exp_f)
    obs_f, exp_f = obs_f[order], exp_f[order]
    pooled_obs, pooled_exp = [], []
    acc_o = acc_e = 0.0
    for o, e in zip(obs_f, exp_f):
        acc_o += o
        acc_e += e
        if acc_e >= 5.0:
            pooled_obs.append(acc_o)
            pooled_exp.append(acc_e)
            acc_o = acc_e = 0.0
    if acc_e > 0 and pooled_exp:
        pooled_obs[-1] += acc_o
        pooled_exp[-1] += acc_e
    pooled_obs = np.asarray(pooled_obs)
    pooled_exp = np.asarray(pooled_exp)

    # variance: the Poisson count variance plus a systematic integration
    # budget (rel_tol * expected)^2, which sharp lobes need
    var = np.maximum(pooled_exp, 1e-9) + (rel_tol * pooled_exp) ** 2
    chi2 = float(np.sum((pooled_obs - pooled_exp) ** 2 / var))
    dof = max(len(pooled_exp) - 1, 1)
    p = _chi2_sf(chi2, dof)
    return p >= significance, p, {
        "chi2": chi2,
        "dof": dof,
        "pdf_mass": float(fine.sum()),
        "accept_frac": float(np.sum(w) / n_samples),
    }
