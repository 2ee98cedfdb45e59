"""The port's chi-square harness (mitsuba_tpu_torch/utils/chi2.py) against
the JAX package's (mitsuba_tpu/utils/chi2.py): its uniforms are JAX's
jax.random.uniform draws bit for bit (the numpy threefry copy, in JAX's
partitionable mode, which the installed JAX runs in); on the same sample
function the histograms are equal, so the statistic, the degrees of
freedom and the p-value equal JAX's (the statistic and p-value to
STAT_RTOL, from the last bits of the two packages' pdf evaluations); with
each package's own warps both pass alike."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import warp as jwarp
from mitsuba_tpu.utils import chi2 as jchi2
from mitsuba_tpu_torch.core import rng, warp
from mitsuba_tpu_torch.utils import chi2

torch.set_num_threads(1)

N = 1 << 16
# the pdfs' last bits (XLA's exp and pow against torch's) move each
# expected count by ~1e-7 relative; the statistic and p-value moved by
# at most 1.2e-7 relative (measured on these cases)
STAT_RTOL = 1e-6

CASES = {
    "vmf": (lambda m: lambda u: m.square_to_von_mises_fisher(u, 8.0),
            lambda m: lambda v: m.square_to_von_mises_fisher_pdf(v, 8.0), {}),
    "ggx": (lambda m: lambda u: m.square_to_ggx(u, 0.2),
            lambda m: lambda v: m.square_to_ggx_pdf(v, 0.2), {}),
    "phong_y_axis": (lambda m: lambda u: m.square_to_phong_lobe(u, 12.0)[..., [0, 2, 1]],
                     lambda m: lambda v: m.square_to_phong_lobe_pdf(v[..., [0, 2, 1]], 12.0),
                     {"polar_axis": "y"}),
    "cosine_rejected": (lambda m: m.square_to_cosine_hemisphere,
                        lambda m: lambda v: 0.5 * m.square_to_cosine_hemisphere_pdf(v),
                        {"sample_weights": np.tile([1.0, 0.0], N // 2)}),
}


def test_threefry_uniforms_are_jax_bit_for_bit():
    assert jax.config.jax_threefry_partitionable
    for seed, shape in ((0, (N, 2)), (3, (1000, 2)), (12345, (7, 3))):
        np.testing.assert_array_equal(
            rng.threefry_uniform(rng.threefry_key(seed), shape),
            np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape)))


def test_chi2_sf_matches_jax():
    for x, k in ((10.0, 5), (500.0, 480), (2000.0, 1100), (0.0, 3), (3.0, 0)):
        assert chi2._chi2_sf(x, k) == jchi2._chi2_sf(x, k)


def _jax_samples(case):
    """The JAX warp as a sample function both harnesses can call: numpy
    directions from the uniforms (a torch tensor or a JAX array)."""
    sample = CASES[case][0](jwarp)
    return lambda u: np.asarray(sample(jnp.asarray(np.asarray(u))))


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_samples_same_statistic(case):
    _, pdf, kw = CASES[case]
    got = chi2.spherical_chi2(_jax_samples(case), pdf(warp), n_samples=N, seed=3,
                              device="cpu", **kw)
    ref = jchi2.spherical_chi2(_jax_samples(case), pdf(jwarp), n_samples=N, seed=3, **kw)
    assert got[0] == ref[0] and got[0]
    assert got[2]["dof"] == ref[2]["dof"]
    assert got[2]["accept_frac"] == ref[2]["accept_frac"]
    np.testing.assert_allclose(got[1], ref[1], rtol=STAT_RTOL)
    for k in ("chi2", "pdf_mass"):
        np.testing.assert_allclose(got[2][k], ref[2][k], rtol=STAT_RTOL)


@pytest.mark.parametrize("case", ["vmf", "ggx"])
def test_own_warps_pass_alike(case):
    """Each package's warp through its own harness: both pass, with the
    same degrees of freedom."""
    sample, pdf, kw = CASES[case]
    got = chi2.spherical_chi2(sample(warp), pdf(warp), n_samples=N, seed=5, device="cpu", **kw)
    ref = jchi2.spherical_chi2(sample(jwarp), pdf(jwarp), n_samples=N, seed=5, **kw)
    assert got[0] and ref[0]
    assert got[2]["dof"] == ref[2]["dof"]


def test_wrong_pdf_fails():
    """A pdf that is not the warp's own fails (the harness can fail)."""
    passed, p, _ = chi2.spherical_chi2(
        lambda u: warp.square_to_von_mises_fisher(u, 8.0),
        lambda v: warp.square_to_von_mises_fisher_pdf(v, 6.0), n_samples=N, device="cpu")
    assert not passed and p < 1e-6
