"""The port's warps (mitsuba_tpu_torch/core/warp.py) against the JAX
package's (mitsuba_tpu/core/warp.py): every warp and pdf on the same 4,096
seeded uniforms at 1e-6 (the vMF warp up to kappa = 100, in the JAX order
of operations; a direction's x and y at 1e-6 plus four last bits of z
carried through sqrt(1 - z^2), ROADMAP C44), then tests/test_warp.py's
chi-square cases on the port's warps through the port's spherical_chi2
(utils/chi2.py), on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import warp as jwarp
from mitsuba_tpu_torch.core import rng, warp
from mitsuba_tpu_torch.utils.chi2 import spherical_chi2

torch.set_num_threads(1)

N = 4096
TOL = 1e-6
ULPS = 4
CHI2_N = 1 << 18   # tests/test_warp.py's N


def _u(seed, n=N):
    u = np.random.RandomState(seed).uniform(0, 1, (n, 2)).astype(np.float32)
    u[:4] = [[0.0, 0.0], [1e-7, 0.5], [0.5, 0.5], [0.9999999, 0.25]]
    return u


def _dirs(seed, n=N):
    d = np.random.RandomState(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _close(mine, ref):
    """At TOL, but x and y of a unit direction: they come from sqrt(1 -
    z^2), which turns a last bit of z (a log or exp near 1, which XLA and
    torch round apart) into an error of ulp(z) z / sin(theta) in x and y,
    up to sqrt(2 ulp) ~ 5e-4 at the pole. There z is held at TOL and x, y
    at TOL plus ULPS last bits of z so propagated."""
    mine, ref = mine.numpy(), np.asarray(ref)
    assert mine.shape == ref.shape and mine.dtype == ref.dtype
    if mine.ndim == 2 and mine.shape[1] == 3:
        np.testing.assert_allclose(mine[:, 2], ref[:, 2], rtol=TOL, atol=TOL)
        eps = ULPS * float(np.finfo(np.float32).eps)
        sin = np.sqrt(np.maximum(1.0 - ref[:, 2].astype(np.float64) ** 2, eps))
        err = np.abs(mine[:, :2] - ref[:, :2]).max(-1)
        assert np.all(err <= TOL + eps / sin), (err - eps / sin).max()
        return
    np.testing.assert_allclose(mine, ref, rtol=TOL, atol=TOL)


# name: (sample args, pdf name or None, pdf args)
WARPS = {
    "uniform_hemisphere": ((), None, ()),
    "uniform_disk": ((), None, ()),
    "std_normal": ((), None, ()),
    "tent": ((), None, ()),
    "beckmann": ((0.3,), "beckmann_pdf", (0.3,)),
    "ggx": ((0.2,), "ggx_pdf", (0.2,)),
    "von_mises_fisher": ((8.0,), "von_mises_fisher_pdf", (8.0,)),
    "phong_lobe": ((12.0,), "phong_lobe_pdf", (12.0,)),
}


@pytest.mark.parametrize("name", sorted(WARPS))
def test_warp_and_pdf_match_jax(name):
    args, pdf, pdf_args = WARPS[name]
    u = _u(sorted(WARPS).index(name))
    mine = getattr(warp, f"square_to_{name}")(torch.as_tensor(u), *args)
    _close(mine, getattr(jwarp, f"square_to_{name}")(jnp.asarray(u), *args))
    if pdf is not None:
        v = np.concatenate([mine.numpy(), _dirs(7)])
        _close(getattr(warp, f"square_to_{pdf}")(torch.as_tensor(v), *pdf_args),
               getattr(jwarp, f"square_to_{pdf}")(jnp.asarray(v), *pdf_args))
    assert warp.square_to_uniform_hemisphere_pdf() == jwarp.square_to_uniform_hemisphere_pdf()


@pytest.mark.parametrize("kappa", [0.5, 8.0, 30.0, 100.0])
def test_von_mises_fisher_up_to_kappa_100(kappa):
    """w = 1 + log(max(u0 + (1 - u0) e^{-2 kappa}, 1e-30)) / kappa in the
    JAX order of operations: the port agrees at 1e-6 up to kappa = 100."""
    u = _u(11)
    _close(warp.square_to_von_mises_fisher(torch.as_tensor(u), kappa),
           jwarp.square_to_von_mises_fisher(jnp.asarray(u), kappa))
    v = _dirs(12)
    _close(warp.square_to_von_mises_fisher_pdf(torch.as_tensor(v), kappa),
           jwarp.square_to_von_mises_fisher_pdf(jnp.asarray(v), kappa))


# --------------------------------------------------------------------------
# tests/test_warp.py on the port
# --------------------------------------------------------------------------


def run(sample_fn, pdf_fn, **kw):
    passed, p, stats = spherical_chi2(sample_fn, pdf_fn, n_samples=CHI2_N, device="cpu", **kw)
    assert passed, f"chi2 failed: p={p:.5f} stats={stats}"
    assert abs(stats["pdf_mass"] - stats["accept_frac"]) < 2e-2, stats


def test_uniform_sphere():
    run(warp.square_to_uniform_sphere,
        lambda v: torch.full(v.shape[:-1], warp.square_to_uniform_sphere_pdf()))


def test_uniform_hemisphere():
    run(warp.square_to_uniform_hemisphere,
        lambda v: torch.where(v[..., 2] >= 0, warp.square_to_uniform_hemisphere_pdf(), 0.0))


def test_cosine_hemisphere():
    run(warp.square_to_cosine_hemisphere, warp.square_to_cosine_hemisphere_pdf)


def test_uniform_cone():
    cc = float(np.cos(np.pi / 4))
    run(lambda u: warp.square_to_uniform_cone(u, cc),
        lambda v: torch.where(v[..., 2] > cc, warp.square_to_uniform_cone_pdf(cc), 0.0))


@pytest.mark.parametrize("alpha", [0.1, 0.4])
def test_beckmann(alpha):
    run(lambda u: warp.square_to_beckmann(u, alpha),
        lambda v: warp.square_to_beckmann_pdf(v, alpha))


@pytest.mark.parametrize("alpha", [0.1, 0.4])
def test_ggx(alpha):
    run(lambda u: warp.square_to_ggx(u, alpha), lambda v: warp.square_to_ggx_pdf(v, alpha))


def test_vmf():
    kappa = 8.0
    run(lambda u: warp.square_to_von_mises_fisher(u, kappa),
        lambda v: warp.square_to_von_mises_fisher_pdf(v, kappa))


def test_phong_lobe():
    n = 12.0
    run(lambda u: warp.square_to_phong_lobe(u, n), lambda v: warp.square_to_phong_lobe_pdf(v, n))


def test_disk_concentric_uniform():
    u = torch.from_numpy(rng.threefry_uniform(rng.threefry_key(1), (1 << 16, 2)))
    d = warp.square_to_uniform_disk_concentric(u).numpy()
    r2 = (d ** 2).sum(-1)
    assert np.all(r2 <= 1.0 + 1e-6)
    assert abs(r2.mean() - 0.5) < 5e-3


def test_uniform_triangle():
    u = torch.from_numpy(rng.threefry_uniform(rng.threefry_key(2), (1 << 16, 2)))
    b = warp.square_to_uniform_triangle(u).numpy()
    assert np.all(b >= 0) and np.all(b.sum(-1) <= 1.0 + 1e-6)
    assert np.allclose(b.mean(0), [1 / 3, 1 / 3], atol=5e-3)
