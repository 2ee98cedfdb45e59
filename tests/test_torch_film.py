"""The port's film (mitsuba_tpu_torch/film) and common.render's front end
against the JAX package: the six reconstruction filters, splat and
develop on numpy-seeded samples, a Cornell render with the LD sampler, the
Gaussian filter and a thin lens against the JAX render, sample_offset, and
the tiled film against the port's full frame."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mitsuba_tpu.film import film as jfilm
from mitsuba_tpu.integrators import common as jcommon, path as jpath
from mitsuba_tpu.io import image as jimage
from mitsuba_tpu.models import sensor as jS
from mitsuba_tpu.scene import builtin as jb
from mitsuba_tpu_torch.film import film as tfilm, tiled as ttiled
from mitsuba_tpu_torch.integrators import common as tcommon, path as tpath
from mitsuba_tpu_torch.models import sensor as tS
from mitsuba_tpu_torch.samplers import qmc as tq
from mitsuba_tpu_torch.scene import builtin as tb

torch.set_num_threads(1)

FILTERS = sorted(tfilm.FILTER_NAMES)
FILTER_IDS = [tfilm.FILTER_NAMES[k] for k in FILTERS]
FILTER_ATOL = 1e-6
SPLAT_RTOL = 1e-5
# the goldens' bar (tests/test_golden.py:109)
RENDER_ATOL = 1e-4


@pytest.mark.parametrize("kind", FILTERS, ids=FILTER_IDS)
def test_filter_eval(kind):
    x = np.concatenate([np.linspace(-4, 4, 801, dtype=np.float32),
                        np.random.RandomState(kind).uniform(-4, 4, 4096).astype(np.float32)])
    j = np.asarray(jfilm.filter_eval(kind, jnp.asarray(x)))
    t = tfilm.filter_eval(kind, torch.from_numpy(x)).numpy()
    assert t.dtype == np.float32
    np.testing.assert_allclose(t, j, atol=FILTER_ATOL, rtol=0)
    assert tfilm._FILTER_RADIUS == jfilm._FILTER_RADIUS


@pytest.mark.parametrize("kind", FILTERS, ids=FILTER_IDS)
def test_splat_and_develop(kind):
    """Samples over an 8x6 film and a pixel beyond each edge, so taps fall
    outside; image, weight and the developed image."""
    rs = np.random.RandomState(10 + kind)
    n = 2048
    px = rs.uniform(-1, 9, n).astype(np.float32)
    py = rs.uniform(-1, 7, n).astype(np.float32)
    val = rs.uniform(0, 2, (n, 3)).astype(np.float32)
    jimg, jwgt = jfilm.splat(8, 6, jnp.asarray(px), jnp.asarray(py), jnp.asarray(val), kind)
    timg, twgt = tfilm.splat(8, 6, torch.from_numpy(px), torch.from_numpy(py),
                             torch.from_numpy(val), kind)
    assert timg.shape == (6, 8, 3) and twgt.shape == (6, 8)
    for t, j in ((timg, jimg), (twgt, jwgt),
                 (tfilm.develop(timg, twgt), jfilm.develop(jimg, jwgt))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=SPLAT_RTOL, atol=0)


def test_accumulate_box_ordered():
    v = np.random.RandomState(3).uniform(size=(2 * 3 * 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tfilm.accumulate_box_ordered(3, 2, 4, torch.from_numpy(v)).numpy(),
        np.asarray(jfilm.accumulate_box_ordered(3, 2, 4, jnp.asarray(v))), rtol=1e-6)


@pytest.fixture(scope="module")
def thinlens_cornell():
    """The Cornell box at 8x8 through a thin lens (aperture 0.03, focus 1.9)
    in both packages, and the JAX render with the LD sampler and the
    Gaussian filter (jitted once; sample_offset 0 and 4, traced)."""
    jscene, jcam = jb.cornell_box(width=8, height=8)
    jcam = jcam.replace(kind=jS.SENSOR_THINLENS, aperture=jnp.float32(0.03),
                        focus_dist=jnp.float32(1.9))
    scene, _ = tb.cornell_box(width=8, height=8, device="cpu")
    kw = dict(spp=8, max_depth=3, seed=3, filter=tfilm.FILTER_GAUSSIAN, sampler=tq.SAMPLER_LD)
    jcfg = jcommon.RenderConfig(**kw)
    ref, ref_off4 = (np.asarray(jcommon.render_jit(jscene, jcam, jpath.li, jcfg, sample_offset=o))
                     for o in (0, 4))
    return scene, tS.camera_from_jax(jcam, device="cpu"), tcommon.RenderConfig(**kw), ref, \
        ref_off4


def test_render_ld_gaussian_thinlens(thinlens_cornell):
    """The slice as a whole: common.render(path.li) with the LD sampler,
    the Gaussian filter and the thin lens against the JAX render."""
    scene, cam, cfg, ref, _ = thinlens_cornell
    assert cam.kind == tS.SENSOR_THINLENS
    img = tcommon.render(scene, cam, tpath.li, cfg).numpy()
    assert img.shape == ref.shape == (8, 8, 3)
    np.testing.assert_allclose(img, ref, atol=RENDER_ATOL, rtol=RENDER_ATOL)


def test_sample_offset(thinlens_cornell):
    """sample_offset 4 against the JAX render at the same offset; and
    samples [0, 4) and [4, 8) average, under the box filter, to the
    8-sample render of the same sample set."""
    scene, cam, cfg, ref, ref_off4 = thinlens_cornell
    off4 = tcommon.render(scene, cam, tpath.li, cfg, sample_offset=4).numpy()
    np.testing.assert_allclose(off4, ref_off4, atol=RENDER_ATOL, rtol=RENDER_ATOL)
    assert not np.array_equal(ref_off4, ref)
    box = tcommon.RenderConfig(spp=8, max_depth=3, seed=3, sampler=tq.SAMPLER_LD, spp_chunk=4)
    half = tcommon.RenderConfig(spp=4, max_depth=3, seed=3, sampler=tq.SAMPLER_LD)
    full = tcommon.render(scene, cam, tpath.li, box)
    parts = [tcommon.render(scene, cam, tpath.li, half, sample_offset=o) for o in (0, 4)]
    torch.testing.assert_close((parts[0] + parts[1]) / 2, full, atol=1e-6, rtol=1e-6)
    assert not torch.equal(parts[0], parts[1])


def test_tiled_matches_full_frame(tmp_path):
    """render_tiled in 4-row bands into an EXR, read back by the JAX
    package's reader, against the port's full-frame render (each band
    resolves its own chunk, so the sums' order differs); a filter other
    than the box raises, in render_tiled and in a row band of
    common.render."""
    scene, cam = tb.cornell_box(width=8, height=8, device="cpu")
    cfg = tcommon.RenderConfig(spp=8, max_depth=3, seed=3, sampler=tq.SAMPLER_SOBOL)
    full = tcommon.render(scene, cam, tpath.li, cfg).numpy()
    out = tmp_path / "t.exr"
    mean = ttiled.render_tiled(scene, cam, tpath.li, cfg, str(out), tile_rows=4,
                               metadata={"spp": 8.0})
    img = jimage.read_exr(out)
    assert img.shape == full.shape
    np.testing.assert_allclose(img, full, rtol=1e-5, atol=1e-6)
    assert abs(mean - float(full.mean(dtype=np.float64))) < 1e-6
    assert jimage.read_exr_attrs(out)["spp"] == 8.0
    with pytest.raises(ValueError, match="box filter only"):
        ttiled.render_tiled(scene, cam, tpath.li,
                            tcommon.RenderConfig(spp=8, filter=tfilm.FILTER_TENT),
                            str(tmp_path / "f.exr"))
    with pytest.raises(ValueError, match="box filter only"):
        tcommon.render(scene, cam, tpath.li, tcommon.RenderConfig(spp=8, filter=tfilm.FILTER_TENT),
                       y0=4, rows=4)
