"""Parity of the port's spectral slice with the JAX package on the CPU: an
envmap's spectral band stack (attach_envmap's `spectral=`, carried by
from_jax), the hero-wavelength tracer spectral.li through common.render
on the gray Cornell box, on tests/test_spectral.py:65's dispersion scene
(cauchy_b 0.08) and under a spectral sky, and the adaptive sampling
driver render_adaptive with its spp map, plus its tie order.

Each JAX render is jitted once, at 8x8 x 4 spp, depth 3-4. Bars: the
goldens' rtol = atol = 1e-4 on every pixel, the spp maps equal, the band
stacks equal. About 35 s on one worker.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators import common as jcom, path as jpath, spectral as jspectral
from mitsuba_tpu.models import sensor as jsensor
from mitsuba_tpu.scene import builtin as jb, envmap as jenv, ir as jir
from mitsuba_tpu.utils import adaptive as jadaptive
from mitsuba_tpu_torch.integrators import common, path, spectral
from mitsuba_tpu_torch.models import sensor
from mitsuba_tpu_torch.scene import envmap, ir
from mitsuba_tpu_torch.utils import adaptive

torch.set_num_threads(1)

RENDER_TOL = 1e-4
BANDS = 11          # the Hosek bands, 320..720 nm


def _image_off(a, b, tol=RENDER_TOL):
    a = np.asarray(a).reshape(-1, 3)
    b = b.cpu().numpy().reshape(-1, 3)
    assert a.shape == b.shape
    return int((np.abs(a - b) > tol + tol * np.abs(a)).any(-1).sum())


def _sky(seed=6, h=8, w=16):
    """An RGB lat-long image and its (H, W, BANDS) band stack."""
    rs = np.random.RandomState(seed)
    img = rs.uniform(0.1, 1.0, (h, w, 3)).astype(np.float32)
    bands = rs.uniform(0.0, 2.0, (h, w, BANDS)).astype(np.float32)
    return img, bands


def _gray_cornell():
    jscene, jcam = jb.cornell_box(width=8, height=8)
    gray = jnp.full_like(jscene.materials.reflectance, 0.6)
    return jscene.replace(materials=jscene.materials.replace(reflectance=gray)), jcam


def _dispersion_scene():
    """tests/test_spectral.py:65's scene at 8x8: a tilted glass pane (eta
    1.8) between the camera and a small white light."""
    verts, tris, tri_mat, tri_rad = [], [], [], {}

    def add_quad(p0, p1, p2, p3, mat_id, radiance=None):
        base = len(verts)
        verts.extend([p0, p1, p2, p3])
        for t in ([base, base + 1, base + 2], [base, base + 2, base + 3]):
            if radiance is not None:
                tri_rad[len(tris)] = radiance
            tris.append(t)
            tri_mat.append(mat_id)

    glass = {"type": jir.BSDF_DIELECTRIC, "eta": [1.8, 1.8, 1.8]}
    dark = {"type": jir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}
    c, st = np.cos(0.6), np.sin(0.6)
    add_quad([-2, -2 * c, 1 - 2 * st], [-2, 2 * c, 1 + 2 * st],
             [2, 2 * c, 1 + 2 * st], [2, -2 * c, 1 - 2 * st], 0)
    add_quad([-0.15, -0.15, 2.5], [-0.15, 0.15, 2.5], [0.15, 0.15, 2.5],
             [0.15, -0.15, 2.5], 1, radiance=[60.0, 60.0, 60.0])
    jscene = jir.build_scene(np.asarray(verts, np.float32), np.asarray(tris, np.int32),
                             np.asarray(tri_mat, np.int32), [glass, dark],
                             tri_radiance=tri_rad)
    jcam = jsensor.make_camera(origin=[0, 0, -1.5], target=[0, 0, 1.0], fov_x=25.0,
                               width=8, height=8)
    return jscene, jcam


def _spectral_sky_scene():
    jscene, jcam = jb.cornell_box(width=8, height=8)
    img, bands = _sky()
    return jenv.attach_envmap(jscene, img, 1.5, spectral=bands), jcam


def test_attach_envmap_spectral_matches_jax():
    """attach_envmap(..., spectral=) on the port's own scene: the band stack
    equals the JAX package's, as from_jax carries it; without it, none."""
    jscene, _ = jb.cornell_box(width=8, height=8)
    img, bands = _sky()
    jem = jenv.attach_envmap(jscene, img, 1.5, spectral=bands).envmap
    scene = ir.from_jax(jscene, device="cpu")
    em = envmap.attach_envmap(scene, img, 1.5, spectral=bands).envmap
    assert np.array_equal(np.asarray(jem.spectral), em.spectral.numpy())
    carried = ir.from_jax(jenv.attach_envmap(jscene, img, 1.5, spectral=bands),
                          device="cpu").envmap
    assert torch.equal(carried.spectral, em.spectral)
    assert envmap.attach_envmap(scene, img, 1.5).envmap.spectral is None
    assert (envmap.SPEC_BANDS_MIN, envmap.SPEC_BANDS_STEP) == (jenv.SPEC_BANDS_MIN,
                                                               jenv.SPEC_BANDS_STEP)


SPECTRAL_SCENES = {
    # name: (JAX scene and camera, config changes)
    "gray_cornell": (_gray_cornell, dict(max_depth=4)),
    "dispersion": (_dispersion_scene, dict(max_depth=4, cauchy_b=0.08, seed=1)),
    "spectral_sky": (_spectral_sky_scene, dict(max_depth=3)),
}


@pytest.mark.parametrize("name", list(SPECTRAL_SCENES))
def test_spectral_li_matches_jax(name):
    """spectral.li through common.render at 8x8 x 4 spp against the JAX
    package's render, every pixel at 1e-4."""
    make, changes = SPECTRAL_SCENES[name]
    jscene, jcam = make()
    jcfg = jcom.RenderConfig(**{"spp": 4, "seed": 0, **changes})
    want = jcom.render_jit(jscene, jcam, jspectral.li, jcfg)
    got = common.render(ir.from_jax(jscene, device="cpu"),
                        sensor.camera_from_jax(jcam, device="cpu"), spectral.li,
                        common.config_from_jax(jcfg))
    assert float(got.mean()) > 1e-4
    assert _image_off(want, got) == 0


def test_render_adaptive_matches_jax():
    """render_adaptive on the Cornell box at 8x8 (base 2, batch 2, max 8,
    max_error 0.02, path.li depth 3): the spp maps equal and adapted, the
    images at 1e-4."""
    jscene, jcam = jb.cornell_box(width=8, height=8)
    jcfg = jcom.RenderConfig(spp=8, max_depth=3, seed=3)
    kw = dict(base_spp=2, batch_spp=2, max_spp=8, max_error=0.02)
    jimg, jmap = jadaptive.render_adaptive(jscene, jcam, jpath.li, jcfg, **kw)
    img, spp_map = adaptive.render_adaptive(
        ir.from_jax(jscene, device="cpu"), sensor.camera_from_jax(jcam, device="cpu"),
        path.li, common.config_from_jax(jcfg), **kw)
    assert np.array_equal(jmap, spp_map.numpy())
    assert spp_map.min() >= 2 and spp_map.max() <= 8 and spp_map.max() > spp_map.min()
    assert _image_off(jimg, img) == 0


def test_adaptive_ties_take_the_lower_index():
    """The refinement's top-k over tied scores (dark pixels tie at 0)
    picks what jax.lax.top_k picks: the lower indices first."""
    score = np.zeros(64, np.float32)
    score[[5, 40, 41]] = [0.3, 0.3, 0.7]
    _, want = jax.lax.top_k(jnp.asarray(score), 16)
    got = adaptive.top_k(torch.as_tensor(score), 16)
    assert np.array_equal(np.asarray(want), got.numpy())
