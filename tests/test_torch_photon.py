"""Parity of the port's photon-mapping family with the JAX package on the
CPU: the hash grid (_cell_hash, build, query_sum), SPPM's camera and photon
passes, sppm.render in its three radius strategies, the two-map photon
mapper, the beam radiance estimate over a homogeneous and a grid medium,
and the irradiance cache (its build, the interpolation from the JAX
package's cache, the render).

The same seeded inputs go through both packages at tiny sizes (films of
8-16 px, 2^12-2^13 photons, 1-2 passes); each JAX function is jitted once
per case.

Bars:
- exact: the cell hashes for coordinates in [-2^20, 2^20), build's order
  and sorted hash, query_sum's counts (against JAX and brute force, the
  sums at rtol 1e-5, as tests/test_sppm.py:12), truncated counts, the
  gather points' materials and validity, the deposits' validity and tags;
- 1e-5 (atol + rtol): the gather points and direct radiance, the photon
  deposits on their valid lanes, with at most DEPOSIT_MAX_OFF of the
  ~16,000 valid deposits beyond it (ROADMAP C36: the emitter rays' cosine
  lift turns a last-bit sin/cos difference into ~1e-6 at depth 0, and each
  bounce amplifies it, up to 3.6e-5 at depth 2 here);
- 1e-4 (the goldens' bar): the renders, each with at most its stated count
  of pixels beyond it. SPPM: at most SPPM_MAX_OFF = 2 pixels of 256, in
  each of three holdings: sppm.render with direct_photons=True (the JAX
  package's gather) against jsppm.render; one_pass from state_from_jax of
  the JAX render's state after its first pass against its second; and the
  port's default gather, which skips the first-hit photons (ROADMAP C37),
  against jsppm.render over photon passes with those deposits made
  invalid. Measured: 2, 2 and 0 pixels for the SPPM, constant and linear
  strategies, the same in the render and in the one pass from the JAX
  state (so both come from the second pass's gather: n differs there, by
  one photon's diffuse contribution, the same rgb in both pixels); 0 for
  the default gather. JAX's own sppm.render run eagerly (jax.disable_jit)
  agrees with the port within 1.2e-7 at every pixel, so the two pixels
  come from XLA's fusion of the jitted pass moving a deposit or a gather
  point by its last bits across a gather radius or a cell boundary, not
  from the port.

About 91 s on one worker (most of it XLA compiling the JAX references).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators import (bre as jbre, common as jcom, irrcache as jirr,
                                     photonmapper as jpm, sppm as jsppm)
from mitsuba_tpu.models import medium as jmed
from mitsuba_tpu.ops import hashgrid as jhg
from mitsuba_tpu.scene import builtin as jb
from mitsuba_tpu_torch.integrators import bre, common, irrcache, photonmapper, sppm
from mitsuba_tpu_torch.models import sensor
from mitsuba_tpu_torch.ops import hashgrid
from mitsuba_tpu_torch.scene import ir

torch.set_num_threads(1)

TOL = 1e-5
RENDER_TOL = 1e-4
DEPOSIT_MAX_OFF = 16
SPPM_MAX_OFF = 2
GRADIENT_MAX_OFF = 1
J = jnp.asarray


def T(a):
    return torch.as_tensor(np.array(a))


def _off(a, b, tol):
    """Rows of a (JAX) and b (port) beyond atol = rtol = tol."""
    a = np.asarray(a).astype(np.float32)
    b = b.cpu().numpy().astype(np.float32) if isinstance(b, torch.Tensor) else b
    assert a.shape == b.shape
    return int((np.abs(a - b) > tol + tol * np.abs(a)).reshape(a.shape[0], -1).any(-1).sum())


def _image_off(a, b, tol=RENDER_TOL):
    """Pixels of two (H, W, 3) images beyond the bar."""
    a = np.asarray(a)
    return _off(a.reshape(-1, 3), b.reshape(-1, 3), tol)


def _both(jscene, jcam):
    return (jscene, jcam, ir.from_jax(jscene, device="cpu"),
            sensor.camera_from_jax(jcam, device="cpu"))


@pytest.fixture(scope="module")
def scenes():
    """{fixture: (JAX scene, JAX camera, port scene, port camera)}: the
    Cornell box at 8x8 and 16x16, caustic_box (a mirror: delta chains and
    caustic deposits) at 8x8."""
    return {"cornell": _both(*jb.cornell_box(width=8, height=8)),
            "cornell16": _both(*jb.cornell_box(width=16, height=16)),
            "caustic": _both(*jb.caustic_box(width=8, height=8))}


def _cfg(**kw):
    jcfg = jcom.RenderConfig(**{"spp": 4, "max_depth": 3, "seed": 0, **kw})
    return jcfg, common.config_from_jax(jcfg)


# ---------------------------------------------------------------------------
# the hash grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table_size", [1 << 18, 1000003])
def test_cell_hash_matches_jax(table_size):
    """uint32 arithmetic in int64: bit-equal for coordinates in [-2^20,
    2^20), the extremes and the negative ones (two's complement) included."""
    rs = np.random.RandomState(table_size % 97)
    c = rs.randint(-(1 << 20), 1 << 20, (3, 20000)).astype(np.int32)
    c[:, :6] = [[-(1 << 20), (1 << 20) - 1, -1, 0, 1, -2]] * 3
    want = np.asarray(jhg._cell_hash(*map(J, c), table_size))
    got = hashgrid._cell_hash(*map(T, c), table_size)
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("cell", [0.05, 0.3])
def test_build_matches_jax(cell):
    """order and sorted_hash equal: the sort is stable, so the points of a
    cell (many share one at 0.3, and repeated points tie) keep their order;
    invalid points sort to the end."""
    rs = np.random.RandomState(1)
    pos = rs.uniform(-1, 1, (3000, 3)).astype(np.float32)
    pos[2000:2400] = pos[:400]                       # exact ties
    valid = rs.uniform(size=3000) > 0.2
    jg = jhg.build(J(pos), J(valid), cell)
    g = hashgrid.build(T(pos), T(valid), cell)
    assert np.array_equal(np.asarray(jg.order), g.order.numpy())
    assert np.array_equal(np.asarray(jg.sorted_hash), g.sorted_hash.numpy())
    assert float(g.cell_size) == float(jg.cell_size) and g.table_size == jg.table_size


@pytest.mark.parametrize("window", [256, 2])
def test_query_sum_matches_jax_and_brute_force(window):
    """tests/test_sppm.py:12's protocol: counts exact against JAX and, with
    a window that holds every cell (256), against brute force; sums at rtol
    1e-5; with window 2 the truncated count and the windowed counts equal
    JAX's."""
    rs = np.random.RandomState(0)
    p, q = 2000, 128
    pos = rs.uniform(-1, 1, (p, 3)).astype(np.float32)
    valid = rs.rand(p) > 0.1
    queries = rs.uniform(-1, 1, (q, 3)).astype(np.float32)
    weights = rs.uniform(0, 1, (p,)).astype(np.float32)
    radius = np.full((q,), 0.15, np.float32)

    jg = jhg.build(J(pos), J(valid), 0.15)
    jw = J(weights)
    (js, jc), jt = jhg.query_sum(
        jg, J(pos), J(queries), J(radius),
        lambda c, i, mk: (c[0] + jnp.where(mk, jw[i], 0.0).sum(1), c[1] + mk.sum(1)),
        (jnp.zeros(q), jnp.zeros(q, jnp.int32)), window=window)
    g = hashgrid.build(T(pos), T(valid), 0.15)
    tw = T(weights)
    (s, c), t = hashgrid.query_sum(
        g, T(pos), T(queries), T(radius),
        lambda c, i, mk: (c[0] + torch.where(mk, tw[i], 0.0).sum(1), c[1] + mk.sum(1)),
        (torch.zeros(q), torch.zeros(q, dtype=torch.int64)), window=window)
    assert int(t) == int(jt)
    assert np.array_equal(np.asarray(jc), c.numpy())
    assert np.allclose(np.asarray(js), s.numpy(), rtol=1e-5)
    if window == 256:
        assert int(t) == 0
        d = queries[:, None, :] - pos[None, :, :]
        inside = ((d ** 2).sum(-1) <= 0.15 ** 2) & valid[None, :]
        assert np.array_equal(c.numpy(), inside.sum(1))
        assert np.allclose(s.numpy(), (inside * weights[None, :]).sum(1), rtol=1e-5)
    else:
        assert int(t) > 0


# ---------------------------------------------------------------------------
# SPPM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", ["cornell16", "caustic"])
def test_camera_pass_matches_jax(scenes, fixture):
    """The gather points and direct radiance of pass 1 at 1e-5; materials
    and validity exact. caustic_box follows its mirror's delta chains."""
    jscene, jcam, scene, cam = scenes[fixture]
    jcfg, cfg = _cfg()
    want = jax.jit(lambda s: jsppm._camera_pass(s, jcam, jcfg, J(1)))(jscene)
    got = sppm._camera_pass(scene, cam, cfg, 1)
    assert np.asarray(want["valid"]).sum() > 0
    for k in ("mat", "valid"):
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
    for k in ("pos", "ns", "wi", "uv", "beta", "direct"):
        assert _off(want[k], got[k], TOL) == 0, k


@pytest.mark.parametrize("fixture", ["cornell", "caustic"])
def test_photon_pass_matches_jax(scenes, fixture):
    """2^13 photons, depth 3, with tags: validity, depth and the delta tag
    exact; position, direction and power at 1e-5 on the valid deposits,
    at most DEPOSIT_MAX_OFF beyond (C36)."""
    jscene, _, scene, _ = scenes[fixture]
    jcfg, cfg = _cfg()
    n = 1 << 13
    want = jax.jit(lambda s: jsppm._photon_pass(s, jcfg, J(1), n, 3, with_tags=True))(jscene)
    got = sppm._photon_pass(scene, cfg, 1, n, 3, with_tags=True)
    valid = np.asarray(want[3])
    assert valid.sum() > n
    for k in (3, 4, 5):
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
    for k in (0, 1, 2):
        assert _off(np.asarray(want[k])[valid], got[k].numpy()[valid], TOL) <= DEPOSIT_MAX_OFF
    if fixture == "caustic":
        tags = got[5].numpy() & valid & (got[4].numpy() >= 1)
        assert tags.sum() > 50      # caustic deposits exist


class _KeepPassStates:
    """Stands in for the `jax` module inside the JAX package's sppm: its
    jit wraps render's per-pass body so that each pass's SPPMState is kept
    (that render returns only the image, the truncated counts and r2)."""

    def __init__(self):
        self.states = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        jitted = jax.jit(fn)

        def call(*args):
            out = jitted(*args)
            self.states.append(out[0])
            return out
        return call


@pytest.mark.parametrize("strategy", [sppm.RADIUS_SPPM, sppm.RADIUS_CONSTANT,
                                      sppm.RADIUS_LINEAR])
def test_sppm_render_matches_jax(scenes, strategy, monkeypatch):
    """Cornell 16x16, 2 passes x 2^13 photons, depth 3, radius 0.05 (no
    window truncation), the JAX package's gather (direct_photons=True;
    ROADMAP C37): the port's render against jsppm.render at 1e-4, at most
    SPPM_MAX_OFF pixels beyond (see the module's notes); the truncated
    counts equal, r2 alike. Then one_pass from state_from_jax of the JAX
    render's state after its first pass gives the JAX state after its
    second: n and r2 at 1e-5, tau and direct at 1e-4, at most SPPM_MAX_OFF
    pixels beyond, the pass count equal."""
    jscene, jcam, scene, cam = scenes["cornell16"]
    jcfg, cfg = _cfg()
    kw = dict(photons_per_pass=1 << 13, initial_radius=0.05, strategy=strategy)
    keep = _KeepPassStates()
    monkeypatch.setattr(jsppm, "jax", keep)
    jimg, jst = jsppm.render(jscene, jcam, jcfg, n_passes=2, **kw)
    monkeypatch.undo()
    img, st = sppm.render(scene, cam, cfg, n_passes=2, direct_photons=True, **kw)
    assert st["truncated"] == jst["truncated"] == [0, 0]
    assert _image_off(jimg, img) <= SPPM_MAX_OFF
    assert _off(jst["r2"], st["r2"], TOL) <= SPPM_MAX_OFF
    npix = cam.width * cam.height
    if strategy == sppm.RADIUS_CONSTANT:
        assert torch.equal(st["r2"], torch.full((npix,), 0.05 ** 2))
    if strategy == sppm.RADIUS_LINEAR:
        assert torch.allclose(st["r2"], torch.full((npix,), 0.05 ** 2 / 3), rtol=1e-6)

    after_first, want = keep.states
    got, truncated = sppm.one_pass(scene, cam, cfg, sppm.state_from_jax(after_first, "cpu"), 1,
                                   kw["photons_per_pass"], 0.05, 0.7, strategy, 64,
                                   direct_photons=True)
    assert int(truncated) == 0
    assert float(got.passes) == float(want.passes) == 2.0
    for k in ("r2", "n"):
        assert _off(getattr(want, k), getattr(got, k), TOL) <= SPPM_MAX_OFF, k
    for k in ("tau", "direct"):
        assert _off(getattr(want, k), getattr(got, k), RENDER_TOL) <= SPPM_MAX_OFF, k


def test_sppm_default_gather_matches_jax_without_first_hits(scenes, monkeypatch):
    """By default the port's gather skips the first hits (direct light,
    which the camera pass's NEE counts; C37). Its render equals the JAX
    package's sppm.render with the first n deposits of each photon pass
    made invalid (its _photon_pass wrapped) at 1e-4, at most SPPM_MAX_OFF
    pixels beyond, and lies below the JAX package's own gather."""
    jscene, jcam, scene, cam = scenes["cornell16"]
    jcfg, cfg = _cfg()
    kw = dict(n_passes=2, photons_per_pass=1 << 12, initial_radius=0.05)
    jboth, _ = jsppm.render(jscene, jcam, jcfg, **kw)
    photon_pass = jsppm._photon_pass

    def no_first_hits(scene_, cfg_, pass_idx, n, depth, with_tags=False):
        out = photon_pass(scene_, cfg_, pass_idx, n, depth, with_tags)
        return out[:3] + (out[3].at[:n].set(False),) + out[4:]

    monkeypatch.setattr(jsppm, "_photon_pass", no_first_hits)
    jimg, jst = jsppm.render(jscene, jcam, jcfg, **kw)
    img, st = sppm.render(scene, cam, cfg, **kw)
    assert st["truncated"] == jst["truncated"] == [0, 0]
    assert _image_off(jimg, img) <= SPPM_MAX_OFF
    assert float(np.asarray(jboth).mean()) > float(img.mean())


@pytest.mark.parametrize("fixture", ["cornell", "caustic"])
def test_photonmapper_matches_jax(scenes, fixture):
    """One pass of 2^12 photons, both maps, at 1e-4. radius_scale 0.1 (a
    radius of 0.07 at 8x8): the default radius of an 8x8 film, 0.69, would
    put every photon of the box in a few cells and truncate each window."""
    jscene, jcam, scene, cam = scenes[fixture]
    jcfg, cfg = _cfg()
    kw = dict(n_photons=1 << 12, n_passes=1, radius_scale=0.1)
    want = jpm.render(jscene, jcam, jcfg, **kw)
    got = photonmapper.render(scene, cam, cfg, **kw)
    assert got.shape == (8, 8, 3) and float(got.mean()) > 0
    assert _image_off(want, got) == 0


# ---------------------------------------------------------------------------
# bre
# ---------------------------------------------------------------------------

def _fog(kind):
    if kind == "homogeneous":
        return jmed.make_homogeneous([0.6] * 3, [0.05] * 3, g=0.0)
    z, y, x = np.meshgrid(*[np.linspace(0, 1, 8)] * 3, indexing="ij")
    density = np.exp(-8 * ((x - 0.5) ** 2 + (y - 0.4) ** 2 + (z - 0.5) ** 2))
    return jmed.make_grid(density.astype(np.float32), 1.5, 0.9, g=0.3)


@pytest.mark.parametrize("kind", ["homogeneous", "grid"])
def test_bre_matches_jax(scenes, kind):
    """The volume photons (trace_volume_photons) exact in validity and at
    1e-5 on the valid ones, then bre.render (2^10 paths, 4 steps) at 1e-4,
    in the homogeneous fog of tests/test_bre.py and an 8^3 density grid."""
    jscene0, jcam, _, cam = scenes["cornell"]
    jscene = jscene0.replace(medium=_fog(kind))
    scene = ir.from_jax(jscene, device="cpu")
    jcfg, cfg = _cfg()
    want = jax.jit(lambda s: jbre.trace_volume_photons(s, jcfg, 1 << 10, 7))(jscene)
    got = bre.trace_volume_photons(scene, cfg, 1 << 10, 7)
    valid = np.asarray(want[3])
    assert valid.sum() > 100 and np.array_equal(valid, got[3].numpy())
    for k in (0, 1, 2):
        assert _off(np.asarray(want[k])[valid], got[k].numpy()[valid], TOL) == 0, k
    jimg = jbre.render_jit(jscene, jcam, jcfg, n_paths=1 << 10, steps=4)
    img = bre.render_jit(scene, cam, cfg, n_paths=1 << 10, steps=4)
    assert float(img.mean()) > 0
    assert _image_off(jimg, img) == 0


# ---------------------------------------------------------------------------
# irrcache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def caches(scenes):
    """The JAX package's cache and the port's, of the Cornell box (256
    points, 8 hemisphere rays, seed 77)."""
    jscene, _, scene, _ = scenes["cornell"]
    jcfg, cfg = _cfg()
    jc = jirr.build_cache(jscene, jcfg, n_points=256, n_hemi=8, seed=77)
    return jc, irrcache.build_cache(scene, cfg, n_points=256, n_hemi=8, seed=77)


def test_irrcache_build_matches_jax(scenes, caches):
    """Each cache point's triangle (from the cumulative areas: XLA's cumsum
    and torch.cumsum may add in other orders) picked alike: 0 of 256
    differ, and the two cdfs agree to 1 ulp; the points, normals, E, R and
    the rotational gradients at 1e-5, the translational ones too but for at
    most GRADIENT_MAX_OFF of 256 records; the grids equal."""
    jscene, _, scene, _ = scenes["cornell"]
    jc, c = caches
    v, i = np.asarray(jscene.vertices), np.asarray(jscene.indices)
    p0 = J(v[i[:, 0]])
    areas = 0.5 * jnp.linalg.norm(jnp.cross(J(v[i[:, 1]]) - p0, J(v[i[:, 2]]) - p0), axis=-1)
    jcdf = np.asarray(jnp.cumsum(areas) / jnp.cumsum(areas)[-1])
    cdf = irrcache.triangle_cdf(scene).numpy()
    assert np.abs(jcdf - cdf).max() <= np.spacing(np.float32(1))
    from mitsuba_tpu_torch.core.rng import uniform
    u0 = uniform(77, torch.arange(256), 0, 0).numpy()
    tri_j, tri_t = np.searchsorted(jcdf, u0), np.searchsorted(cdf, u0)
    assert int((tri_j != tri_t).sum()) == 0
    for k in (0, 1, 2, 3, 6):
        assert _off(jc[k], c[k], TOL) == 0, k
    # the translational gradient sums terms of ~1/r of either sign: one
    # record's small component (0.0463 beside components ~5) is 1.6e-5 off
    assert _off(jc[7], c[7], TOL) <= GRADIENT_MAX_OFF
    assert np.array_equal(np.asarray(jc[4].order), c[4].order.numpy())
    assert np.array_equal(np.asarray(jc[4].sorted_hash), c[4].sorted_hash.numpy())
    assert c[5] == pytest.approx(jc[5], rel=1e-7)


def test_irrcache_interpolate_and_render_match_jax(scenes, caches):
    """interpolate from cache_from_jax of the JAX package's cache, at 300
    surface points, at 1e-5; the render of li_factory over the same cache,
    and irrcache.render (the port's own build of the fixture's cache), at
    1e-4."""
    jscene, jcam, scene, cam = scenes["cornell"]
    jcfg, cfg = _cfg()
    jc, _ = caches
    carried = irrcache.cache_from_jax(jc, device="cpu")
    rs = np.random.RandomState(5)
    p = np.asarray(jc[0])[rs.randint(0, 256, 300)] + rs.normal(0, 0.02, (300, 3))
    n = np.asarray(jc[1])[rs.randint(0, 256, 300)]
    p, n = p.astype(np.float32), n.astype(np.float32)
    want = jax.jit(lambda q, m: jirr.interpolate(jc, q, m))(J(p), J(n))
    assert _off(want, irrcache.interpolate(carried, T(p), T(n)), TOL) == 0
    jimg = jcom.render_jit(jscene, jcam, jirr.li_factory(jc), jcfg)
    assert _image_off(jimg, common.render(scene, cam, irrcache.li_factory(carried), cfg)) == 0
    assert _image_off(jimg, irrcache.render(scene, cam, cfg, n_points=256, n_hemi=8)) == 0
