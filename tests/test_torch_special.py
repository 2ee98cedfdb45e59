"""The port's special functions (mitsuba_tpu_torch/core/special.py) against
the JAX package's (mitsuba_tpu/core/special.py) on the same seeded inputs,
each at 1e-6 on 4,096 inputs (SH_PROJECT_TOL for the quadrature's sums),
then the JAX package's own tests of the module (tests/test_special.py) on
the port: SH orthonormality and closed forms, projection, the splines,
Brent's root and the Gauss rules."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import special as jspecial
from mitsuba_tpu_torch.core import special

torch.set_num_threads(1)

N = 4096
TOL = 1e-6
# sh_project sums 64 x 128 products per coefficient: its order of
# summation (one einsum in each package) moves the last bits
SH_PROJECT_TOL = 1e-5
CPU = "cpu"


def _dirs(n, seed):
    d = np.random.RandomState(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(mine, ref, tol=TOL):
    mine, ref = np.asarray(mine), np.asarray(ref)
    assert mine.shape == ref.shape and mine.dtype == ref.dtype, (mine.shape, ref.shape)
    np.testing.assert_allclose(mine, ref, rtol=tol, atol=tol)


VALUES = np.asarray([0.5, 2.0, 1.0, 3.0, 0.75, 1.5, 4.0, 0.2], np.float32)


@pytest.mark.parametrize("order", [1, 3, 5])
def test_sh_eval_matches_jax(order):
    d = _dirs(N, order)
    _close(special.sh_eval(_t(d), order), jspecial.sh_eval(jnp.asarray(d), order))
    assert special.sh_count(order) == jspecial.sh_count(order) == order * order


def test_sh_project_matches_jax():
    def fn(lib):
        return lambda d: 1.0 + d[:, 2] + 0.5 * d[:, 0] * d[:, 1] + lib.exp(-d[:, 0])

    mine = special.sh_project(fn(torch), 4, device=CPU)
    _close(mine, jspecial.sh_project(fn(jnp), 4), SH_PROJECT_TOL)


def test_splines_match_jax():
    t = np.random.RandomState(1).uniform(-0.05, 1.05, N).astype(np.float32)
    u = np.random.RandomState(2).uniform(0, 1, N).astype(np.float32)
    v, jv = _t(VALUES), jnp.asarray(VALUES)
    _close(special.spline_eval(v, _t(t)), jspecial.spline_eval(jv, jnp.asarray(t)))
    cum, jcum = special.spline_integrate(v), jspecial.spline_integrate(jv)
    _close(cum, jcum)
    _close(special._cum_at(v, cum, _t(t)), jspecial._cum_at(jv, jcum, jnp.asarray(t)))
    for mine, ref in zip(special.spline_sample(v, _t(u)),
                         jspecial.spline_sample(jv, jnp.asarray(u))):
        _close(mine, ref)


def test_brent_matches_jax():
    rs = np.random.RandomState(3)
    c = rs.uniform(1.0, 8.0, N).astype(np.float32)
    lo = np.zeros(N, np.float32)
    hi = np.full(N, 3.0, np.float32)

    def f(c):
        return lambda x: x * x * x - c

    mine = special.brent(f(_t(c)), _t(lo), _t(hi))
    _close(mine, jspecial.brent(f(jnp.asarray(c)), jnp.asarray(lo), jnp.asarray(hi)))


@pytest.mark.parametrize("n", [2, 3, 8, 17])
def test_gauss_rules_match_jax(n):
    """Nodes and weights bit for bit (both float32 roundings of numpy's
    float64), and integrate at 1e-6."""
    for rule, mine, ref in (("legendre", special.gauss_legendre(n, CPU), jspecial.gauss_legendre(n)),
                            ("lobatto", special.gauss_lobatto(n, CPU), jspecial.gauss_lobatto(n))):
        for a, b in zip(mine, ref):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        got = special.integrate(torch.cos, 0.0, 1.3, n=n, rule=rule, device=CPU)
        _close(got, jspecial.integrate(jnp.cos, 0.0, 1.3, n=n, rule=rule))
    with pytest.raises(ValueError):
        special.gauss_lobatto(1, CPU)


# --------------------------------------------------------------------------
# tests/test_special.py on the port
# --------------------------------------------------------------------------


def _fibonacci_sphere(n):
    i = np.arange(n) + 0.5
    z = 1.0 - 2.0 * i / n
    phi = np.pi * (1 + 5 ** 0.5) * i
    st = np.sqrt(1 - z * z)
    return np.stack([st * np.cos(phi), st * np.sin(phi), z], axis=-1).astype(np.float32)


def test_sh_orthonormality():
    order = 4
    n_t, n_p = 64, 128
    xg, wg = np.polynomial.legendre.leggauss(n_t)
    phi = np.arange(n_p) * (2 * np.pi / n_p)
    ct, ph = np.meshgrid(xg, phi, indexing="ij")
    st = np.sqrt(np.maximum(1 - ct * ct, 0))
    d = np.stack([st * np.cos(ph), st * np.sin(ph), ct], -1).reshape(-1, 3)
    basis = special.sh_eval(_t(d.astype(np.float32)), order).numpy()
    w = (wg[:, None] * np.ones((1, n_p)) * (2 * np.pi / n_p)).reshape(-1)
    gram = np.einsum("nk,nl,n->kl", basis, basis, w)
    assert np.allclose(gram, np.eye(order * order), atol=2e-5), gram


def test_sh_known_values():
    d = _fibonacci_sphere(32)
    b = special.sh_eval(_t(d), 2).numpy()
    assert np.allclose(b[:, 0], 0.5 / np.sqrt(np.pi), atol=1e-6)
    c = np.sqrt(3 / (4 * np.pi))
    assert np.allclose(b[:, 2], c * d[:, 2], atol=1e-5)


def test_sh_project_reconstruct():
    def fn(d):
        return 1.0 + d[:, 2] + 0.5 * d[:, 0] * d[:, 1]

    coeff = special.sh_project(fn, order=3, device=CPU).numpy()
    d = _fibonacci_sphere(64)
    recon = special.sh_eval(_t(d), 3).numpy() @ coeff
    assert np.allclose(recon, fn(d), atol=1e-4)


def test_spline_interpolates_and_is_exact_on_cubics():
    vals = torch.tensor([0.0, 1.0, 4.0, 9.0, 16.0])
    out = special.spline_eval(vals, torch.linspace(0, 1, 5)).numpy()
    assert np.allclose(out, vals.numpy(), atol=1e-6)
    lin = torch.linspace(2.0, 7.0, 9)
    t = torch.linspace(0, 1, 33)
    assert np.allclose(special.spline_eval(lin, t).numpy(), 2.0 + 5.0 * t.numpy(), atol=1e-6)


def test_spline_integral_matches_quadrature():
    vals = torch.tensor([1.0, 3.0, 2.0, 5.0, 4.0, 1.5])
    cum = special.spline_integrate(vals).numpy()
    t = torch.linspace(0, 1, 4001)
    y = special.spline_eval(vals, t).numpy()
    assert abs(cum[-1] - np.trapezoid(y, t.numpy())) < 1e-4
    assert cum[0] == 0 and np.all(np.diff(cum) > 0)


def test_spline_sample_inverts_cdf():
    vals = torch.tensor([0.5, 2.0, 1.0, 3.0, 0.75])
    u = torch.linspace(0.02, 0.98, 25)
    t, pdf = special.spline_sample(vals, u)
    cum = special.spline_integrate(vals)
    back = (special._cum_at(vals, cum, t) / float(cum[-1])).numpy()
    assert np.allclose(back, u.numpy(), atol=1e-4)
    assert np.all(pdf.numpy() > 0)


def test_brent_root():
    x = special.brent(lambda x: x * x * x - 2.0 * x - 5.0, torch.full((4,), 1.0),
                      torch.full((4,), 3.0)).numpy()
    assert np.allclose(x, 2.0945514815, atol=1e-6)


def test_gauss_quadrature():
    val = float(special.integrate(lambda x: x ** 6, -1.0, 1.0, n=8, device=CPU))
    assert abs(val - 2.0 / 7.0) < 1e-6
    x, w = special.gauss_lobatto(6, CPU)
    assert float(x[0]) == -1.0 and float(x[-1]) == 1.0
    assert abs(float(torch.sum(w)) - 2.0) < 1e-6
    val = float(special.integrate(torch.cos, 0.0, np.pi / 2, n=16, rule="lobatto", device=CPU))
    assert abs(val - 1.0) < 1e-6
