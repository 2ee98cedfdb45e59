"""The port's dipole subsurface model (mitsuba_tpu_torch/models/subsurface.py)
against the JAX package's (mitsuba_tpu/models/subsurface.py) on the JAX
tests' own fixtures (tests/test_subsurface.py): the blue-noise and
stratified points bit for bit (the same numpy RandomState darts), and
rd_profile, _refracted_connection, compute_irradiance,
sss_exitant_radiance (whose gather the port chunks over the queries) and
single_scatter_radiance in both modes within TOL; then the JAX package's
seven tests of the module on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators import common as jcommon
from mitsuba_tpu.models import subsurface as jsss
from mitsuba_tpu.scene import builtin as jbuiltin
from mitsuba_tpu_torch.integrators import common
from mitsuba_tpu_torch.models import subsurface as sss
from mitsuba_tpu_torch.scene import builtin, ir

torch.set_num_threads(1)

TOL = 1e-5
CPU = "cpu"


def params(lib, albedo=0.8, sigma_t=10.0):
    mod = jsss if lib is jnp else sss
    return mod.DipoleParams(sigma_s=lib.asarray([albedo * sigma_t] * 3, dtype=lib.float32),
                            sigma_a=lib.asarray([(1 - albedo) * sigma_t] * 3, dtype=lib.float32),
                            g=0.0, eta=1.3)


def _close(mine, ref, tol=TOL):
    mine, ref = mine.numpy(), np.asarray(ref)
    assert mine.shape == ref.shape and mine.dtype == ref.dtype
    np.testing.assert_allclose(mine, ref, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def cornell():
    """tests/test_subsurface.py's cache fixture: the short block's
    triangles, 256 darts, the irradiance at 4 samples (seed 1), and the
    gather at sigma_t = 30 at the first 32 points; in both packages."""
    jscene, _ = jbuiltin.cornell_box()
    scene = ir.from_jax(jscene, device=CPU)
    mask = np.zeros(jscene.num_triangles, bool)
    mask[10:20] = True
    jpts = jsss.sample_surface_points(jscene, mask, 256)
    jE = jsss.compute_irradiance(jscene, jpts[0], jpts[1], jcommon.RenderConfig(seed=1),
                                 n_samples=4)
    q, qn = jpts[0][:32], jpts[1][:32]
    jlo = jsss.sss_exitant_radiance(params(jnp, sigma_t=30.0), jpts[0], jE, jpts[2], q, qn, qn)
    return scene, mask, jpts, np.asarray(jE), np.asarray(jlo)


@pytest.fixture(scope="module")
def single_scatter():
    """tests/test_subsurface.py's single-scatter fixture (an 8x8 Cornell
    box, 64 queries 0.02 above the floor looking up, sigma_a 0.05, 8
    samples) through the JAX package in both modes."""
    jscene, _ = jbuiltin.cornell_box(width=8, height=8)
    q, qn = _queries()
    p = jsss.DipoleParams(sigma_s=jnp.asarray([1.0] * 3), sigma_a=jnp.asarray([0.05] * 3),
                          g=0.0, eta=1.3)
    cfg = jcommon.RenderConfig(spp=8, max_depth=2, seed=0)
    ref = {exact: np.asarray(jsss.single_scatter_radiance(
        p, jscene, jnp.asarray(q), jnp.asarray(qn), jnp.asarray(qn), cfg, n_samples=8,
        exact_nee=exact)) for exact in (True, False)}
    return ir.from_jax(jscene, device=CPU), ref


def _queries(n=64):
    q = np.tile(np.asarray([[0.0, 0.02, 0.0]], np.float32), (n, 1))
    qn = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (n, 1))
    return q, qn


@pytest.mark.parametrize("blue_noise", [True, False])
def test_surface_points_bit_equal(cornell, blue_noise):
    scene, mask, _, _, _ = cornell
    jscene, _ = jbuiltin.cornell_box()
    for seed, n in ((0, 256), (3, 200)):
        mine = sss.sample_surface_points(scene, mask, n, seed=seed, blue_noise=blue_noise)
        ref = jsss.sample_surface_points(jscene, mask, n, seed=seed, blue_noise=blue_noise)
        for a, b in zip(mine[:2], ref[:2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert mine[2] == ref[2]


@pytest.mark.parametrize("albedo,sigma_t", [(0.8, 10.0), (0.2, 10.0), (0.9, 30.0)])
def test_rd_profile_matches_jax(albedo, sigma_t):
    r = np.linspace(1e-3, 2.0, 512).astype(np.float32)
    _close(sss.rd_profile(params(torch, albedo, sigma_t), torch.as_tensor(r)),
           jsss.rd_profile(params(jnp, albedo, sigma_t), jnp.asarray(r)))


def test_refracted_connection_matches_jax():
    h = np.asarray([0.05, 0.2, 0.01, 0.3], np.float32)
    H = np.asarray([1.0, 0.5, 2.0, 0.1], np.float32)
    for d_xy in (np.asarray([0.7, 0.3, 1.5, 0.9], np.float32), np.zeros(4, np.float32)):
        for eta in (1.0, 1.3, 1.5, 2.4):
            mine = sss._refracted_connection(eta, *(torch.as_tensor(a) for a in (h, H, d_xy)))
            ref = jsss._refracted_connection(eta, *(jnp.asarray(a) for a in (h, H, d_xy)))
            for a, b in zip(mine, ref):
                _close(a, b)


def test_irradiance_and_gather_match_jax(cornell):
    scene, mask, jpts, jE, jlo = cornell
    pts, nrm = (torch.tensor(np.asarray(a)) for a in jpts[:2])
    area = jpts[2]
    E = sss.compute_irradiance(scene, pts, nrm, common.RenderConfig(seed=1), n_samples=4)
    _close(E, jE)
    lo = sss.sss_exitant_radiance(params(torch, sigma_t=30.0), pts, E, area, pts[:32], nrm[:32],
                                  nrm[:32])
    _close(lo, jlo)


def test_gather_chunks_like_one(cornell, monkeypatch):
    """The chunked gather equals one dense gather bit for bit: each query's
    sum over the cache points is formed whole in either."""
    _, _, jpts, jE, _ = cornell
    pts, nrm = (torch.tensor(np.asarray(a)) for a in jpts[:2])
    args = (params(torch, sigma_t=30.0), pts, torch.tensor(jE), jpts[2], pts, nrm, nrm)
    whole = sss.sss_exitant_radiance(*args)
    monkeypatch.setattr(sss, "GATHER_PAIRS", 3 * pts.shape[0])
    np.testing.assert_array_equal(sss.sss_exitant_radiance(*args).numpy(), whole.numpy())


@pytest.mark.parametrize("exact", [True, False])
def test_single_scatter_matches_jax(single_scatter, exact):
    scene, ref = single_scatter
    q, qn = (torch.as_tensor(a) for a in _queries())
    p = sss.DipoleParams(sigma_s=torch.tensor([1.0] * 3), sigma_a=torch.tensor([0.05] * 3),
                         g=0.0, eta=1.3)
    got = sss.single_scatter_radiance(p, scene, q, qn, qn,
                                      common.RenderConfig(spp=8, max_depth=2, seed=0),
                                      n_samples=8, exact_nee=exact)
    _close(got, ref[exact])
    assert float(got.mean()) > 0


# --------------------------------------------------------------------------
# tests/test_subsurface.py on the port
# --------------------------------------------------------------------------


def test_rd_profile_properties():
    r = torch.linspace(1e-3, 2.0, 512)
    rd = sss.rd_profile(params(torch), r).numpy()
    assert np.isfinite(rd).all() and (rd >= 0).all()
    assert np.all(np.diff(rd[:, 0]) <= 1e-6)
    dr = float(r[1] - r[0])
    total = 2 * np.pi * (rd * r.numpy()[:, None] * dr).sum(0)
    assert np.all(total < 1.0) and np.all(total > 0.1), total


def test_higher_albedo_brighter():
    r = torch.linspace(1e-3, 1.0, 256)
    dr = float(r[1] - r[0])

    def total(albedo):
        rd = sss.rd_profile(params(torch, albedo), r).numpy()
        return (2 * np.pi * rd * r.numpy()[:, None] * dr).sum()

    assert total(0.9) > total(0.5) > total(0.2)


def test_cache_and_gather(cornell):
    scene, mask = cornell[:2]
    pts, nrm, area = sss.sample_surface_points(scene, mask, 256)
    assert pts.shape[1] == 3 and pts.shape[0] > 128 and area > 0
    E = sss.compute_irradiance(scene, pts, nrm, common.RenderConfig(seed=1), n_samples=4)
    assert torch.isfinite(E).all() and float(E.max()) > 0
    lo = sss.sss_exitant_radiance(params(torch, sigma_t=30.0), pts, E, area, pts[:32],
                                  nrm[:32], nrm[:32]).numpy()
    assert np.isfinite(lo).all() and (lo >= 0).all() and lo.max() > 0


def test_single_scatter_positive_and_attenuates():
    scene, _ = builtin.cornell_box(width=8, height=8, device=CPU)
    cfg = common.RenderConfig(spp=8, max_depth=2, seed=0)
    q, qn = (torch.as_tensor(a) for a in _queries())

    def run(sig_a):
        p = sss.DipoleParams(sigma_s=torch.tensor([1.0] * 3), sigma_a=torch.tensor([sig_a] * 3),
                             g=0.0, eta=1.3)
        out = sss.single_scatter_radiance(p, scene, q, qn, qn, cfg, n_samples=8).numpy()
        assert np.isfinite(out).all()
        return out.mean()

    bright, dark = run(0.05), run(5.0)
    assert bright > 0 and dark < 0.7 * bright, (dark, bright)


def test_blue_noise_placement(cornell):
    scene = cornell[0]
    mask = np.zeros(scene.num_triangles, bool)
    mask[0:2] = True
    n_req = 200
    pts, nrm, area = sss.sample_surface_points(scene, mask, n_req, seed=3)
    pts = pts.numpy()
    assert len(pts) > 0.6 * n_req
    total_area = float(area) * len(pts)
    r = 0.7 * np.sqrt(total_area / (2.0 * np.sqrt(3.0) * n_req))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1) + np.eye(len(pts)) * 1e9
    assert d2.min() >= r * r * (1 - 1e-5), (np.sqrt(d2.min()), r)
    pts2, _, _ = sss.sample_surface_points(scene, mask, n_req, seed=3, blue_noise=False)
    assert pts2.shape == (n_req, 3)


def test_refracted_connection_satisfies_snell():
    h = torch.tensor([0.05, 0.2, 0.01, 0.3])
    H = torch.tensor([1.0, 0.5, 2.0, 0.1])
    d_xy = torch.tensor([0.7, 0.3, 1.5, 0.9])
    for eta in (1.3, 1.5, 2.4):
        r, _ = sss._refracted_connection(eta, h, H, d_xy)
        sin_i = r / torch.sqrt(r * r + h * h)
        q = d_xy - r
        sin_o = q / torch.sqrt(q * q + H * H)
        assert np.allclose((eta * sin_i).numpy(), sin_o.numpy(), atol=2e-5), eta
        assert float(torch.max(eta * sin_i)) <= 1.0 + 1e-5
    r1, _ = sss._refracted_connection(1.0, h, H, d_xy)
    assert np.allclose(r1.numpy(), (d_xy * h / (h + H)).numpy(), atol=2e-5)
    r0, _ = sss._refracted_connection(1.5, h, H, torch.zeros_like(d_xy))
    assert np.allclose(r0.numpy(), 0.0, atol=1e-6)


def slab(device=CPU):
    """tests/test_subsurface.py's flat-slab fixture: a 2x2 floor under a
    0.6x0.6 area light at height 1, in the port."""
    verts = np.asarray([[-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1],
                        [-0.3, 1.0, -0.3], [0.3, 1.0, -0.3],
                        [0.3, 1.0, 0.3], [-0.3, 1.0, 0.3]], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    return ir.build_scene(verts, tris, np.zeros(4, np.int32), [{"type": ir.BSDF_DIFFUSE}],
                          tri_radiance={2: [10.0, 10.0, 10.0], 3: [10.0, 10.0, 10.0]},
                          device=device)


def slab_ratio(scene, n_samples=32):
    """exact / classical mean on the slab fixture (64 queries on a line
    across the floor, 32 samples, seed 3), and both images."""
    p = sss.DipoleParams(sigma_s=torch.tensor([2.0] * 3), sigma_a=torch.tensor([0.2] * 3),
                         eta=1.4, g=0.0)
    n = 64
    qp = torch.stack([torch.linspace(-0.4, 0.4, n), torch.zeros(n), torch.zeros(n)], -1)
    qp, ns = qp.to(scene.device), torch.tensor([[0.0, 1.0, 0.0]], device=scene.device).repeat(n, 1)
    cfg = common.RenderConfig(spp=1, seed=3)
    le, lc = (sss.single_scatter_radiance(p, scene, qp, ns, ns, cfg, n_samples=n_samples,
                                          exact_nee=exact) for exact in (True, False))
    return float(le.mean()) / float(lc.mean()), le, lc


def test_single_scatter_exact_vs_classical():
    ratio, le, lc = slab_ratio(slab())
    assert torch.isfinite(le).all() and float(le.min()) >= 0
    assert float(le.mean()) > 0 and float(lc.mean()) > 0
    assert 0.3 < ratio < 3.0, ratio
