"""Special-function math tier: real spherical harmonics, Catmull-Rom
splines, Brent-style root refinement, Gauss quadrature (port of
core/special.py).

The analog of the reference's small-math headers:
  * include/mitsuba/core/sh.h + libcore/shvector.cpp: the real SH basis,
    a closed-form recurrence unrolled for a static order;
  * include/mitsuba/core/spline.h: Catmull-Rom 1D interpolation,
    integration and sampling by inversion on uniform grids;
  * include/mitsuba/core/brent.h: bracketed root refinement, a
    bisection/secant hybrid with a fixed trip count;
  * include/mitsuba/core/quad.h: Gauss-Legendre and Gauss-Lobatto nodes
    and weights, built with numpy and used as float32 tensors.

Everything is batched over leading axes. The fixed-trip loops (brent's
48 steps, spline_sample's bisection) are Python loops that never stop
early, as the JAX package's fori_loops.
"""
from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Real spherical harmonics (sh.h / shvector.cpp)
# ---------------------------------------------------------------------------


def sh_count(order: int) -> int:
    """Number of real SH basis functions for bands 0..order-1."""
    return order * order


def sh_eval(d: torch.Tensor, order: int) -> torch.Tensor:
    """The real SH basis at unit directions d (..., 3) -> (..., order**2),
    flattened as idx = l*(l+1)+m (SHVector::eval). The associated-Legendre
    recurrence is unrolled for the static order; sin(theta)^m is folded
    into the azimuthal terms, tracked as sin^m cos(m phi) and sin^m sin(m
    phi) by a Chebyshev recurrence on x and y."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = []
    cm = sm = None
    for m_ in range(order):
        if m_ == 0:
            cm, sm = torch.ones_like(x), torch.zeros_like(x)
        else:
            cm, sm = cm * x - sm * y, sm * x + cm * y
        # P_m^m / sin^m = (-1)^m (2m-1)!!
        dfact = 1.0
        for i_ in range(1, m_ + 1):
            dfact *= -(2 * i_ - 1)
        p_prev = torch.full_like(z, dfact)       # P_m^m / sin^m
        p_curr = z * (2 * m_ + 1) * p_prev       # P_{m+1}^m / sin^m
        for l_ in range(m_, order):
            if l_ == m_:
                p_lm = p_prev
            elif l_ == m_ + 1:
                p_lm = p_curr
            else:
                p_next = ((2 * l_ - 1) * z * p_curr - (l_ + m_ - 1) * p_prev) / (l_ - m_)
                p_prev, p_curr = p_curr, p_next
                p_lm = p_next
            k = np.sqrt((2 * l_ + 1) / (4 * np.pi) * _fact_ratio(l_ - m_, l_ + m_))
            if m_ == 0:
                out.append((l_ * (l_ + 1), float(k) * p_lm))
            else:
                s2 = float(np.sqrt(2.0) * k)
                out.append((l_ * (l_ + 1) + m_, s2 * p_lm * cm))
                out.append((l_ * (l_ + 1) - m_, s2 * p_lm * sm))
    res = [None] * (order * order)
    for idx, val in out:
        res[idx] = val
    return torch.stack(res, dim=-1)


def _fact_ratio(a: int, b: int) -> float:
    """a! / b! for b >= a, computed stably."""
    r = 1.0
    for i in range(a + 1, b + 1):
        r /= i
    return r


def sh_project(fn, order: int, n_theta: int = 64, n_phi: int = 128, device="cuda"):
    """Project fn(d (M,3)) -> (M,) onto SH coefficients by quadrature
    (SHVector::project): Gauss-Legendre in cos(theta), trapezoid in phi.
    Returns (order**2,) coefficients on `device`."""
    xg, wg = np.polynomial.legendre.leggauss(n_theta)
    cos_t = torch.as_tensor(xg.astype(np.float32), device=device)
    phi = torch.arange(n_phi, device=device, dtype=torch.float32) * (2.0 * np.pi / n_phi)
    ct, ph = torch.meshgrid(cos_t, phi, indexing="ij")
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    d = torch.stack([st * torch.cos(ph), st * torch.sin(ph), ct], dim=-1)
    vals = fn(d.reshape(-1, 3)).reshape(n_theta, n_phi)
    basis = sh_eval(d.reshape(-1, 3), order).reshape(n_theta, n_phi, -1)
    w = torch.as_tensor(wg.astype(np.float32), device=device) * (2.0 * np.pi / n_phi)
    return torch.einsum("tp,tpk,t->k", vals, basis, w)


# ---------------------------------------------------------------------------
# Catmull-Rom cubic splines on uniform grids (spline.h)
# ---------------------------------------------------------------------------


def _cell(values: torch.Tensor, t: torch.Tensor):
    """(i, f, v1, v2, d1, d2): the cell of t in [0, 1], its fraction, the
    cell's end values and the Catmull-Rom derivatives (one-sided at the
    boundary cells, like spline.h)."""
    n = values.shape[0]
    x = torch.clamp(t, 0.0, 1.0) * (n - 1)
    i = torch.clamp(x.to(torch.int64), 0, n - 2)
    f = x - i.to(x.dtype)
    v0 = values[torch.clamp_min(i - 1, 0)]
    v1 = values[i]
    v2 = values[i + 1]
    v3 = values[torch.clamp_max(i + 2, n - 1)]
    d1 = torch.where(i > 0, 0.5 * (v2 - v0), v2 - v1)
    d2 = torch.where(i < n - 2, 0.5 * (v3 - v1), v2 - v1)
    return i, f, v1, v2, d1, d2


def spline_eval(values: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Catmull-Rom interpolation of a uniform grid at t in [0, 1]
    (spline.h evalCubicInterp1D). values: (N,), t: (...,)."""
    _, f, v1, v2, d1, d2 = _cell(values, t)
    f2, f3 = f * f, f * f * f
    return ((2 * f3 - 3 * f2 + 1) * v1 + (-2 * f3 + 3 * f2) * v2 +
            (f3 - 2 * f2 + f) * d1 + (f3 - f2) * d2)


def spline_integrate(values: torch.Tensor) -> torch.Tensor:
    """Cumulative integral of the Catmull-Rom interpolant over a uniform
    grid on [0, 1] at the N grid points, cum[0] = 0 (spline.h
    integrateCubicInterp1D)."""
    n = values.shape[0]
    i = torch.arange(n - 1, device=values.device)
    v0 = values[torch.clamp_min(i - 1, 0)]
    v1 = values[:-1]
    v2 = values[1:]
    v3 = values[torch.clamp_max(i + 2, n - 1)]
    d1 = torch.where(i > 0, 0.5 * (v2 - v0), v2 - v1)
    d2 = torch.where(i < n - 2, 0.5 * (v3 - v1), v2 - v1)
    # integral of the Hermite basis over one cell of width h = 1/(n-1)
    cell = (0.5 * (v1 + v2) + (d1 - d2) / 12.0) / (n - 1)
    return torch.cat([torch.zeros((1,), dtype=values.dtype, device=values.device),
                      torch.cumsum(cell, 0)])


def spline_sample(values: torch.Tensor, u: torch.Tensor, n_iter: int = 16):
    """Sample t ~ the normalized Catmull-Rom density over [0, 1] by CDF
    inversion, n_iter bisection steps (spline.h sampleCubicInterp1D).
    Returns (t, pdf(t))."""
    cum = spline_integrate(values)
    total = torch.clamp_min(cum[-1], 1e-30)
    target = u * total
    lo = torch.zeros_like(u)
    hi = torch.ones_like(u)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        below = _cum_at(values, cum, mid) < target
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    t = 0.5 * (lo + hi)
    return t, spline_eval(values, t) / total


def _cum_at(values: torch.Tensor, cum: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """CDF of the interpolant at arbitrary t (exact per-cell quartic)."""
    n = values.shape[0]
    i, f, v1, v2, d1, d2 = _cell(values, t)
    f2 = f * f
    f3, f4 = f2 * f, f2 * f2
    h = 1.0 / (n - 1)
    part = (v1 * (0.5 * f4 - f3 + f) + v2 * (-0.5 * f4 + f3) +
            d1 * (0.25 * f4 - (2.0 / 3.0) * f3 + 0.5 * f2) +
            d2 * (0.25 * f4 - f3 / 3.0)) * h
    return cum[i] + part


# ---------------------------------------------------------------------------
# Brent-style bracketed root refinement (brent.h)
# ---------------------------------------------------------------------------


def brent(fn, lo: torch.Tensor, hi: torch.Tensor, n_iter: int = 48) -> torch.Tensor:
    """Find fn(x) = 0 on [lo, hi] (fn(lo), fn(hi) of opposite sign).

    Each of the n_iter steps tries the secant point and bisects when it
    leaves the bracket: Brent's safeguard without the inverse-quadratic
    branch (brent.h BrentSolver::solve), batched, never stopping early."""
    a, b = lo, hi
    fa, fb = fn(lo), fn(hi)
    for _ in range(n_iter):
        sec = b - fb * (b - a) / torch.where(torch.abs(fb - fa) > 1e-30, fb - fa, 1e-30)
        mid = 0.5 * (a + b)
        inside = (sec > torch.minimum(a, b)) & (sec < torch.maximum(a, b))
        x = torch.where(inside, sec, mid)
        fx = fn(x)
        left = fa * fx <= 0.0
        a, fa, b, fb = (torch.where(left, a, x), torch.where(left, fa, fx),
                        torch.where(left, x, b), torch.where(left, fx, fb))
    return torch.where(torch.abs(fa) < torch.abs(fb), a, b)


# ---------------------------------------------------------------------------
# Gauss quadrature (quad.h)
# ---------------------------------------------------------------------------


def gauss_legendre(n: int, device="cuda"):
    """Nodes and weights on [-1, 1] (quad.h gaussLegendre), float32: the
    numpy float64 values rounded as the JAX package's jnp.asarray rounds
    them with x64 off."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (torch.as_tensor(x.astype(np.float32), device=device),
            torch.as_tensor(w.astype(np.float32), device=device))


def gauss_lobatto(n: int, device="cuda"):
    """Gauss-Lobatto nodes and weights on [-1, 1] (quad.h gaussLobatto):
    the endpoints and the roots of P'_{n-1}; float32 as gauss_legendre."""
    if n < 2:
        raise ValueError("gauss_lobatto needs n >= 2")
    leg = np.polynomial.legendre.Legendre.basis(n - 1)
    xi = leg.deriv().roots()
    x = np.concatenate([[-1.0], np.sort(xi.real), [1.0]])
    pn = leg(x)
    w = 2.0 / (n * (n - 1) * pn * pn)
    return (torch.as_tensor(x.astype(np.float32), device=device),
            torch.as_tensor(w.astype(np.float32), device=device))


def integrate(fn, a: float, b: float, n: int = 64, rule: str = "legendre",
              device="cuda") -> torch.Tensor:
    """Fixed-order quadrature of fn over [a, b]: one weighted sum."""
    x, w = gauss_legendre(n, device) if rule == "legendre" else gauss_lobatto(n, device)
    xm = 0.5 * (a + b) + 0.5 * (b - a) * x
    return 0.5 * (b - a) * torch.sum(w * fn(xm))
