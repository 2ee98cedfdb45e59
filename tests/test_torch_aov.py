"""The AOV integrators (integrators/aov.py) and multichannel.render against
the JAX package's on the CPU, each JAX render jitted once, on the Cornell
box at 8x8 x 4 spp, depth 3. Bar: the goldens' rtol = atol = 1e-4, at most
one pixel beyond it (C8's allowance); multichannel's radiance channel
against the port's own common.render(path.li) at 1e-4."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mitsuba_tpu.integrators import aov as jaov, common as jcom, multichannel as jmc
from mitsuba_tpu.models import sensor as jsensor
from mitsuba_tpu.scene import builtin as jb
from mitsuba_tpu_torch.integrators import aov, common, multichannel, path
from mitsuba_tpu_torch.models import sensor
from mitsuba_tpu_torch.scene import ir

torch.set_num_threads(1)

RENDER_TOL = 1e-4
RENDER_MAX_OFF = 1
CFG = dict(spp=4, max_depth=3, seed=0)


@pytest.fixture(scope="module")
def cornell():
    """The Cornell box, its camera moving 0.05 to the side over the
    shutter (motion vectors other than 0)."""
    jscene, jcam = jb.cornell_box(width=8, height=8)
    end = np.array(jcam.to_world)
    end[0, 3] += 0.05
    jcam = jcam.replace(to_world_end=jnp.asarray(end))
    return (jscene, jcam, ir.from_jax(jscene, device="cpu"),
            sensor.camera_from_jax(jcam, device="cpu"))


def _close(img, ref, tol=RENDER_TOL):
    img = img.numpy() if isinstance(img, torch.Tensor) else img
    ref = np.asarray(ref)
    assert img.shape == ref.shape and img.dtype == np.float32
    off = (np.abs(img - ref) > tol + tol * np.abs(ref)).any(-1)
    assert off.sum() <= RENDER_MAX_OFF, (np.argwhere(off), np.abs(img - ref).max())


@pytest.mark.parametrize("name,changes", [
    ("depth", {}), ("normal", {}), ("position", {}), ("albedo", {}), ("ao", {}),
    ("ao", {"ao_length": 0.3}), ("motion", {})])
def test_aov_matches_jax(cornell, name, changes):
    jscene, jcam, scene, cam = cornell
    cfg = {**CFG, **changes}
    fn = f"li_{name}"
    ref = jcom.render_jit(jscene, jcam, getattr(jaov, fn), jcom.RenderConfig(**cfg))
    img = common.render(scene, cam, getattr(aov, fn), common.RenderConfig(**cfg))
    _close(img, ref)
    assert float(img.abs().max()) > 0


def test_motion_vectors_match_jax(cornell):
    """li_motion with the moving camera: the primary hits projected at the
    shutter's open and close poses, the rays from the open pose."""
    jscene, jcam, scene, cam = cornell
    rs = np.random.RandomState(0)
    px, py = (rs.uniform(0, 8, 256).astype(np.float32) for _ in range(2))
    u = np.zeros((256, 2), np.float32)
    jo, jd, _ = jsensor.sample_rays(jcam.replace(to_world_end=None), jnp.asarray(px),
                                    jnp.asarray(py), jnp.asarray(u))
    o, d = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd))
    ref = np.asarray(jaov.li_motion(jscene, jcam, jo, jd, None, None))
    got = aov.li_motion(scene, cam, o, d, None, None).numpy()
    np.testing.assert_allclose(got, ref, rtol=RENDER_TOL, atol=RENDER_TOL)
    assert np.abs(got[:, 0]).max() > 0.1 and (got[:, 2] == 0).all()


def test_multichannel_matches_jax(cornell):
    jscene, jcam, scene, cam = cornell
    jcam, cam = jcam.replace(to_world_end=None), cam.replace(to_world_end=None)
    channels = ("radiance", "depth", "normal", "position", "albedo")
    ref = jmc.render(jscene, jcam, jcom.RenderConfig(**CFG), channels)
    out = multichannel.render(scene, cam, common.RenderConfig(**CFG), channels)
    assert set(out) == set(channels)
    for ch in channels:
        _close(out[ch], ref[ch])
    want = common.render(scene, cam, path.li, common.RenderConfig(**CFG))
    assert torch.allclose(out["radiance"], want, rtol=RENDER_TOL, atol=RENDER_TOL)
    # a smaller spp chunk: the same samples, summed in another order
    small = multichannel.render(scene, cam, common.RenderConfig(**CFG, spp_chunk=1), channels)
    for ch in channels:
        assert torch.allclose(small[ch], out[ch], rtol=1e-6, atol=1e-6), ch
