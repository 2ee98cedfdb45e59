"""Parity of the port's daylight models (mitsuba_tpu_torch/models/hosek.py,
models/sunsky.py) and the sun, sky and sunsky emitters of its loader with
the JAX package on the CPU.

Bars:
- hosek: the RGB and spectral states and radiances equal the JAX
  package's (both are numpy), and meet the JAX tests' ground truth from
  the authors' implementation (tests/test_sunsky.py:172, :214) at its
  rtol 1e-6;
- sunsky.bake of sun, sky and sunsky under both sky models: 1e-6
  relative (measured: equal); bake_spectral: atol + rtol 1e-5 (its
  calibration runs the port's core/spectrum on float32 tensors where the
  JAX package runs its own through XLA: measured 1.2e-7 relative at most,
  2.0e-3 absolute on a solar disk of 16,763);
- sun_direction (the PSA solar position): equal;
- scenes with a sun by time and place, a Preetham sky and an RGB-albedo
  sunsky load equal to `ir.from_jax` of the JAX loads
  (tests/test_torch_xml.py's load_both: C10's bar), and both loaders
  refuse sunDirection beside a time and place;
- the sky scene of tests/test_sunsky.py's spectral test rendered at 8x8 by
  direct.li, path.li and spectral.li against the JAX renders: the goldens'
  1e-4 on every pixel.
"""
import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators import (common as jcom, direct as jdirect, path as jpath,
                                     spectral as jspectral)
from mitsuba_tpu.models import hosek as jhosek, sunsky as jsunsky
from mitsuba_tpu.scene import xml as jxml
from mitsuba_tpu_torch.integrators import common, direct, path, spectral
from mitsuba_tpu_torch.models import hosek, sunsky
from mitsuba_tpu_torch.scene import xml
from tests.test_sunsky import _HOSEK_ORACLE, _HOSEK_SPEC_ORACLE
from tests.test_torch_xml import _scene, _write, load_both

torch.set_num_threads(1)

BAKE_RTOL = 1e-6
SPECTRAL_TOL = 1e-5
RENDER_TOL = 1e-4
SUN = np.asarray([0.3, 0.8, 0.52]) / np.linalg.norm([0.3, 0.8, 0.52])


def test_hosek_states_and_radiances_match_jax():
    rs = np.random.RandomState(0)
    theta = rs.uniform(0, np.pi / 2, 64)
    gamma = rs.uniform(0, np.pi, 64)
    for turb in (1.0, 2.5, 6.3, 10.0):
        for albedo in (0.0, 0.3, np.asarray([0.1, 0.5, 0.9])):
            for elev in (0.0, 0.2, 0.9, 1.5):
                cfg, rad = hosek.cook_state(turb, albedo, elev)
                jcfg, jrad = jhosek.cook_state(turb, albedo, elev)
                assert np.array_equal(cfg, jcfg) and np.array_equal(rad, jrad)
                assert np.array_equal(hosek.radiance(cfg, rad, theta, gamma),
                                      jhosek.radiance(jcfg, jrad, theta, gamma))
            cfgs, rads = hosek.cook_state_spectral(turb, float(np.mean(albedo)), 0.4)
            jcfgs, jrads = jhosek.cook_state_spectral(turb, float(np.mean(albedo)), 0.4)
            assert np.array_equal(cfgs, jcfgs) and np.array_equal(rads, jrads)
            lam = rs.uniform(300, 740, 64)
            assert np.array_equal(hosek.radiance_spectral(cfgs, rads, theta, gamma, lam),
                                  jhosek.radiance_spectral(jcfgs, jrads, theta, gamma, lam))
    d = rs.normal(size=(256, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    assert np.array_equal(hosek.sky_radiance_rgb(d, SUN, 3.0, 0.2),
                          jhosek.sky_radiance_rgb(d, SUN, 3.0, 0.2))
    assert np.array_equal(hosek.sky_radiance_spectral_bands(d, SUN, 3.0, 0.2),
                          jhosek.sky_radiance_spectral_bands(d, SUN, 3.0, 0.2))
    assert np.array_equal(hosek.SPEC_BANDS, jhosek.SPEC_BANDS)
    for turb, elev, th, ga, ref in _HOSEK_ORACLE:
        cfg, rad = hosek.cook_state(turb, 0.3, elev)
        np.testing.assert_allclose(hosek.radiance(cfg, rad, np.asarray(th), np.asarray(ga)),
                                   ref, rtol=1e-6)
    lams = np.asarray([400.0, 541.3, 680.0])
    for turb, elev, th, ga, ref in _HOSEK_SPEC_ORACLE:
        cfgs, rads = hosek.cook_state_spectral(turb, 0.25, elev)
        np.testing.assert_allclose(
            hosek.radiance_spectral(cfgs, rads, np.asarray(th), np.asarray(ga), lams),
            ref, rtol=1e-6)


@pytest.mark.parametrize("model", ["hosek", "preetham"])
@pytest.mark.parametrize("kind", ["sun", "sky", "sunsky"])
def test_bake_matches_jax(kind, model):
    kw = dict(sun_dir=SUN, turbidity=4.0, scale=1.5, resolution=64, sun_radius_scale=2.0,
              sky_model=model, albedo=np.asarray([0.1, 0.3, 0.5]))
    got, want = sunsky.bake(kind, **kw), jsunsky.bake(kind, **kw)
    assert got.dtype == want.dtype == np.float32 and got.shape == (32, 64, 3)
    assert got.max() > 0
    np.testing.assert_allclose(got, want, rtol=BAKE_RTOL, atol=0)


@pytest.mark.parametrize("kind", ["sun", "sky", "sunsky"])
def test_bake_spectral_matches_jax(kind):
    kw = dict(sun_dir=SUN, turbidity=3.0, scale=1.0, resolution=64, albedo=0.2)
    got, want = sunsky.bake_spectral(kind, **kw), jsunsky.bake_spectral(kind, **kw)
    assert got.dtype == want.dtype == np.float32 and got.shape == (32, 64, 11)
    assert got.max() > 0
    np.testing.assert_allclose(got, want, rtol=SPECTRAL_TOL, atol=SPECTRAL_TOL)


@pytest.mark.parametrize("when", [
    {}, dict(hour=0.0), dict(hour=8.0, minute=30.0, second=15.0),
    dict(latitude=-33.87, longitude=151.21, timezone=10.0, month=1, hour=12.0),
    dict(year=2024, month=12, day=21, latitude=48.2, longitude=16.37, timezone=1.0)])
def test_sun_direction_matches_jax(when):
    assert sunsky.sun_coordinates(**when) == jsunsky.sun_coordinates(**when)
    got, want = sunsky.sun_direction(**when), jsunsky.sun_direction(**when)
    assert got.dtype == want.dtype and np.array_equal(got, want)


DAYLIGHT = {
    "sun_by_place": '<emitter type="sun"><float name="latitude" value="48.2"/>'
                    '<float name="longitude" value="16.37"/><float name="timezone" value="2"/>'
                    '<integer name="month" value="6"/><float name="hour" value="10.5"/>'
                    '<integer name="resolution" value="64"/></emitter>',
    "sky_preetham": '<emitter type="sky"><string name="skyModel" value="preetham"/>'
                    '<float name="turbidity" value="5"/><integer name="resolution" value="64"/>'
                    '</emitter>',
    "sunsky_albedo": '<emitter type="sunsky"><vector name="sunDirection" x="0.3" y="0.8" '
                     'z="0.52"/><rgb name="albedo" value="0.1, 0.4, 0.7"/>'
                     '<float name="scale" value="0.5"/><float name="sunRadiusScale" value="3"/>'
                     '<integer name="resolution" value="64"/></emitter>',
}


@pytest.mark.parametrize("name", sorted(DAYLIGHT))
def test_daylight_scenes_load_like_jax(tmp_path, name):
    p = _write(tmp_path, "s.xml", _scene('<shape type="cube"/>' + DAYLIGHT[name]))
    scene = load_both(p)[0]
    assert scene.has_env and scene.envmap.image.shape == (32, 64, 3)
    assert (scene.envmap.spectral is None) == (name == "sky_preetham")


def test_sun_direction_and_place_refused(tmp_path):
    body = DAYLIGHT["sun_by_place"].replace(
        '<float name="hour" value="10.5"/>',
        '<float name="hour" value="10.5"/><vector name="sunDirection" x="0" y="1" z="0"/>')
    p = _write(tmp_path, "bad.xml", _scene('<shape type="cube"/>' + body))
    with pytest.raises(ValueError, match="not both"):
        jxml.load_xml(p)
    with pytest.raises(ValueError, match="not both"):
        xml.load_xml(p, device="cpu")


SKY_SCENE = """\
<scene version="0.6.0">
    <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
    <sensor type="perspective">
        <float name="fov" value="60"/>
        <transform name="toWorld">
            <lookat origin="0, 0.5, 3" target="0, 0.5, 0" up="0, 1, 0"/>
        </transform>
        <sampler type="independent"><integer name="sampleCount" value="4"/></sampler>
        <film type="hdrfilm">
            <integer name="width" value="8"/><integer name="height" value="8"/>
        </film>
    </sensor>
    <emitter type="sunsky">
        <float name="turbidity" value="3"/>
        <vector name="sunDirection" x="0" y="0.7" z="0.7"/>
        <integer name="resolution" value="64"/>
    </emitter>
    <shape type="rectangle">
        <transform name="toWorld"><rotate x="1" angle="-90"/><scale value="4"/></transform>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.5, 0.5, 0.5"/></bsdf>
    </shape>
</scene>
"""

LI = {"direct": (jdirect.li, direct.li), "path": (jpath.li, path.li),
      "spectral": (jspectral.li, spectral.li)}


@pytest.mark.parametrize("integrator", sorted(LI))
def test_sky_renders_match_jax(tmp_path, integrator):
    p = tmp_path / "sky.xml"
    p.write_text(SKY_SCENE)
    jli, li = LI[integrator]
    jscene, jcam, jcfg, _ = jxml.load_xml(p)
    want = np.asarray(jcom.render_jit(jscene, jcam, jli, jcfg))
    scene, cam, cfg, _ = xml.load_xml(p, device="cpu")
    got = common.render(scene, cam, li, cfg).numpy()
    assert np.isfinite(got).all() and got.mean() > 0.1
    np.testing.assert_allclose(got, want, rtol=RENDER_TOL, atol=RENDER_TOL)
