"""Parity of the port's primary-sample Metropolis integrators
(mitsuba_tpu_torch/integrators/pssmlt.py and erpt.py) with the JAX package
on the CPU.

- `_small_step` on the same uniforms: within 1e-6 (a wrap across 0 or 1
  would move a dim by 1; none does at these inputs).
- `_eval` on the same 1,024 primary vectors (the Cornell box at 8x8,
  depth 3): colour and luminance at 1e-5 (atol + rtol; ROADMAP C38's bar
  for path radiance: a path of three bounces carries C10's 1e-6 per
  bounce, measured 1.8e-5 relative, 6.5e-6 absolute, on 5 of 3,072
  values), the pixel index exact.
- `pssmlt.render` and `erpt.render` with the JAX package's threefry
  uniforms passed through `uniforms=`, against `render_jit` at 8x8, 256
  chains, 8 steps, 1,024 bootstrap paths, depth 3: the goldens' 1e-4 on
  every pixel but those a divergent chain moves. A chain diverges where its
  luminance-CDF pick lands within a rounding of a bin edge, since torch's
  cumsum rounds otherwise than XLA's (ROADMAP C39): the test counts the
  seeds that differ (at most MAX_SEED_FLIPS of 256) and the pixels beyond
  1e-4 (at most MAX_PIXELS_OFF of 64). Measured: 0 seeds and 0 pixels for
  both integrators.
- The JAX tests' brightness bars on the port's own generator, at their
  sizes (tests/test_pssmlt.py, tests/test_more_integrators.py:25): the
  16x16 Cornell box, depth 4, 4,096 chains, the mean within 8% (pssmlt, and
  the blurred images correlated above 0.95) and 10% (erpt) of path.li's at
  128 spp.

Each JAX render is jitted once; `_eval`'s jit is shared by the bootstrap
checks of both integrators (the same shapes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators import common as jcom, erpt as jerpt, pssmlt as jpssmlt
from mitsuba_tpu.scene import builtin as jb
from mitsuba_tpu_torch.integrators import common, erpt, path, pssmlt
from mitsuba_tpu_torch.models import sensor
from mitsuba_tpu_torch.scene import builtin, ir

torch.set_num_threads(1)

EVAL_TOL = 1e-5
RENDER_TOL = 1e-4
MAX_SEED_FLIPS = 2
MAX_PIXELS_OFF = 4
WIDTH, DEPTH = 8, 3
N_BOOT, N_CHAINS, N_STEPS = 1024, 256, 8
NDIMS = jpssmlt.SENSOR_DIMS + DEPTH * jpssmlt.DIMS_PER_BOUNCE
CFG = dict(spp=1, max_depth=DEPTH, seed=1)


@pytest.fixture(scope="module")
def box():
    jscene, jcam = jb.cornell_box(width=WIDTH, height=WIDTH)
    return jscene, jcam, ir.from_jax(jscene, "cpu"), sensor.camera_from_jax(jcam, "cpu")


@pytest.fixture(scope="module")
def jeval(box):
    """The JAX package's _eval, jitted once: u (N_BOOT, NDIMS) -> (color,
    lum, pixel)."""
    jscene, jcam = box[:2]
    cfg = jcom.RenderConfig(**CFG)
    fn = jax.jit(lambda s, c, u: jpssmlt._eval(s, c, cfg, u))
    return lambda u: [np.asarray(a) for a in fn(jscene, jcam, jnp.asarray(u))]


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_draws(seed, step_names):
    """The JAX renders' uniforms, in the order they split their keys
    (pssmlt.py:73-90, erpt.py:38-59), served to the port's `uniforms=`
    hook by name. Returns (draw, the raw arrays by name)."""
    shapes = {"boot": (N_BOOT, NDIMS), "pick": (N_CHAINS,), "large": (N_CHAINS,),
              "fresh": (N_CHAINS, NDIMS), "small_mag": (N_CHAINS, NDIMS),
              "small_sign": (N_CHAINS, NDIMS), "accept": (N_CHAINS,)}
    kb, kr, km = jax.random.split(jax.random.PRNGKey(seed), 3)
    draws = {"boot": [jax.random.uniform(kb, shapes["boot"])],
             "pick": [jax.random.uniform(kr, shapes["pick"])]}
    for k in jax.random.split(km, N_STEPS):
        for name, kk in zip(step_names, jax.random.split(k, len(step_names))):
            draws.setdefault(name, []).append(jax.random.uniform(kk, shapes[name]))
    served = {name: iter(v) for name, v in draws.items()}

    def draw(name, shape):
        a = _t(next(served[name]))
        assert tuple(a.shape) == tuple(shape), (name, a.shape, shape)
        return a

    return draw, draws


def test_small_step_matches_jax():
    rs = np.random.RandomState(0)
    u, r1, r2 = (rs.uniform(size=(4096, NDIMS)).astype(np.float32) for _ in range(3))
    want = np.asarray(jpssmlt._small_step(jnp.asarray(u), jnp.asarray(r1), jnp.asarray(r2)))
    got = pssmlt._small_step(_t(u), _t(r1), _t(r2)).numpy()
    assert got.dtype == np.float32 and ((got >= 0) & (got < 1)).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_eval_matches_jax(box, jeval):
    rs = np.random.RandomState(1)
    u = rs.uniform(size=(N_BOOT, NDIMS)).astype(np.float32)
    jcolor, jlum, jpix = jeval(u)
    color, lum, pix = pssmlt._eval(box[2], box[3], common.RenderConfig(**CFG), _t(u))
    assert (lum.numpy() > 0).sum() > N_BOOT // 4      # the box is lit
    np.testing.assert_allclose(color.numpy(), jcolor, rtol=EVAL_TOL, atol=EVAL_TOL)
    np.testing.assert_allclose(lum.numpy(), jlum, rtol=EVAL_TOL, atol=EVAL_TOL)
    np.testing.assert_array_equal(pix.numpy(), jpix)


PARITY = {
    "pssmlt": (jpssmlt, ("large", "fresh", "small_mag", "small_sign", "accept"), 1,
               dict(n_mutations=N_STEPS)),
    "erpt": (jerpt, ("small_mag", "small_sign", "accept"), 1 ^ 0xE897,
             dict(chain_length=N_STEPS)),
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_render_matches_jax_with_its_uniforms(box, jeval, name):
    jmod, step_names, seed, kw = PARITY[name]
    port = {"pssmlt": pssmlt, "erpt": erpt}[name]
    jscene, jcam, scene, cam = box
    want = np.asarray(jmod.render_jit(jscene, jcam, jcom.RenderConfig(**CFG), n_chains=N_CHAINS,
                                      n_bootstrap=N_BOOT, **kw))
    draw, raw = jax_draws(seed, step_names)
    got = port.render(scene, cam, common.RenderConfig(**CFG), n_chains=N_CHAINS,
                      n_bootstrap=N_BOOT, uniforms=draw, **kw).numpy()
    # the seeds each package's CDF picks from the same bootstrap draws
    jlum = jeval(np.asarray(raw["boot"][0]))[1]
    cdf = jnp.cumsum(jnp.asarray(jlum))
    jseeds = np.asarray(jnp.clip(jnp.searchsorted(cdf, raw["pick"][0] * cdf[-1]), 0, N_BOOT - 1))
    _, lum, _ = pssmlt._eval(scene, cam, common.RenderConfig(**CFG), _t(raw["boot"][0]))
    seeds = pssmlt.seed_chains(lum, _t(raw["pick"][0])).numpy()
    seed_flips = int((seeds != jseeds).sum())
    off = int((~np.isclose(got, want, rtol=RENDER_TOL, atol=RENDER_TOL)).any(-1).sum())
    assert np.isfinite(got).all() and got.min() >= 0 and got.mean() > 0.05
    assert seed_flips <= MAX_SEED_FLIPS, seed_flips
    assert off <= MAX_PIXELS_OFF, (off, float(np.abs(got - want).max()))
    if seed_flips == 0:
        np.testing.assert_allclose(got, want, rtol=RENDER_TOL, atol=RENDER_TOL)


@pytest.fixture(scope="module")
def box16():
    scene, cam = builtin.cornell_box(16, 16, device="cpu")
    ref = common.render(scene, cam, path.li,
                        common.RenderConfig(spp=128, max_depth=4, seed=0)).numpy()
    return scene, cam, ref


def _blur(a, k=3):
    from numpy.lib.stride_tricks import sliding_window_view
    pad = np.pad(a.mean(-1), k // 2, mode="edge")
    return sliding_window_view(pad, (k, k)).mean((-1, -2))


def test_pssmlt_brightness(box16):
    """tests/test_pssmlt.py's protocol on the port's generator."""
    scene, cam, ref = box16
    img = pssmlt.render(scene, cam, common.RenderConfig(spp=1, max_depth=4, seed=1),
                        n_chains=1 << 12, n_mutations=128, n_bootstrap=1 << 14).numpy()
    assert np.isfinite(img).all() and img.min() >= 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 0.08, (img.mean(), ref.mean())
    corr = np.corrcoef(_blur(ref).ravel(), _blur(img).ravel())[0, 1]
    assert corr > 0.95, corr


def test_erpt_brightness(box16):
    """tests/test_more_integrators.py::test_erpt_brightness on the port's
    generator."""
    scene, cam, ref = box16
    img = erpt.render(scene, cam, common.RenderConfig(spp=1, max_depth=4, seed=2),
                      n_chains=1 << 12, chain_length=64, n_bootstrap=1 << 14).numpy()
    assert np.isfinite(img).all() and img.min() >= 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 0.1, (img.mean(), ref.mean())
