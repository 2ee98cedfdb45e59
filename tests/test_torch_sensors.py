"""The render front end's scene side against the JAX package: every sensor
kind with and without two-keyframe motion blur (sample_rays,
ray_differentials, world_to_raster, camera_from_jax), the meters' closed
forms under a constant environment and motion blur's smear through the
port's renderer, and the vertex-colour and wireframe textures
(build_scene, from_jax, surface_interaction, gather_shade_point)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mitsuba_tpu.models import bsdf as jB, sensor as jS
from mitsuba_tpu.ops import intersect as jI
from mitsuba_tpu.scene import ir as jir
from mitsuba_tpu_torch.integrators import common as tcommon, direct as tdirect, path as tpath
from mitsuba_tpu_torch.models import bsdf as tB, sensor as tS
from mitsuba_tpu_torch.ops import intersect as tI, trace as tT
from mitsuba_tpu_torch.scene import builtin as tb, ir as tir

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# C10's bar: sensor outputs within 1e-6 absolute and 1e-6 relative
ATOL = RTOL = 1e-6
N = 4096
KINDS = sorted(tS.SENSOR_NAMES)


def _jcam(kind, motion):
    """A 24x16 sensor of `kind` at the Cornell pose, with an aperture,
    focus distance and distortion that each kind reads; motion adds a
    shutter-close pose, moved and turned."""
    fov = 0.6 if kind in (jS.SENSOR_ORTHOGRAPHIC, jS.SENSOR_TELECENTRIC) else 39.3
    cam = jS.make_camera([0.5, 0.5, -1.4], [0.5, 0.5, 0.0], fov_x=fov, width=24, height=16,
                         kind=kind, aperture=0.05, focus_dist=1.9, kc=(0.2, -0.05))
    if motion:
        end = np.asarray(jS.look_at([0.62, 0.45, -1.3], [0.45, 0.52, 0.0]))
        cam = cam.replace(to_world_end=jnp.asarray(end))
    return cam


def _rays_in(seed):
    rs = np.random.RandomState(seed)
    px = rs.uniform(0, 24, N).astype(np.float32)
    py = rs.uniform(0, 16, N).astype(np.float32)
    ul = rs.uniform(size=(N, 2)).astype(np.float32)
    return px, py, ul


def _close(t, j, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("motion", [False, True], ids=["static", "motion"])
@pytest.mark.parametrize("kind", KINDS, ids=[tS.SENSOR_NAMES[k] for k in KINDS])
def test_sample_rays(kind, motion):
    jcam = _jcam(kind, motion)
    cam = tS.camera_from_jax(jcam, device="cpu")
    assert cam.kind == kind and (cam.to_world_end is not None) == motion
    px, py, ul = _rays_in(kind)
    jout = jS.sample_rays(jcam, jnp.asarray(px), jnp.asarray(py), jnp.asarray(ul))
    tout = tS.sample_rays(cam, torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(ul))
    for t, j, what in zip(tout, jout, ("o", "d", "importance")):
        assert t.dtype == torch.float32 and t.shape == j.shape
        _close(t, j, what)


def test_ray_differentials_and_world_to_raster():
    """Every kind's differentials (the pinhole's for the thin lens and the
    distorted perspective, zeros elsewhere), and world_to_raster, which
    reads the pinhole model whatever the kind."""
    rs = np.random.RandomState(2)
    d = rs.normal(size=(N, 3)).astype(np.float32) * [0.3, 0.3, 1.0]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    p = rs.uniform([-0.5, -0.5, 0.5], [1.5, 1.5, 2.0], (N, 3)).astype(np.float32)
    for kind in KINDS:
        jcam = _jcam(kind, False)
        cam = tS.camera_from_jax(jcam, device="cpu")
        jdd = jS.ray_differentials(jcam, jnp.asarray(d))
        tdd = tS.ray_differentials(cam, torch.from_numpy(d))
        for t, j in zip(tdd, jdd):
            _close(t, j, f"ray_differentials kind {kind}")
        jw = jS.world_to_raster(jcam, jnp.asarray(p))
        tw = tS.world_to_raster(cam, torch.from_numpy(p))
        for t, j, what in zip(tw, jw, ("px", "py", "valid", "importance")):
            if what == "valid":
                assert np.array_equal(t.numpy(), np.asarray(j)), kind
            else:
                _close(t, j, f"world_to_raster {what} kind {kind}")


def _env_scene(L):
    """tests/test_sensors.py:_env_scene: a constant environment L and one
    tiny black triangle far below."""
    verts = np.asarray([[100, -100, 100], [101, -100, 100], [100, -100, 101]], np.float32)
    return tir.build_scene(verts, np.asarray([[0, 1, 2]], np.int32), np.zeros(1, np.int32),
                           [{"type": tir.BSDF_DIFFUSE}], env_radiance=[L] * 3, device="cpu")


@pytest.mark.parametrize("kind,factor,spp,rtol", [
    (tS.SENSOR_RADIANCEMETER, 1.0, 8, 1e-5),
    (tS.SENSOR_FLUENCEMETER, 4.0 * np.pi, 512, 2e-2),
    (tS.SENSOR_IRRADIANCEMETER, np.pi, 512, 2e-2)], ids=["radiance", "fluence", "irradiance"])
def test_meters_constant_env(kind, factor, spp, rtol):
    """tests/test_sensors.py's closed forms through the port's renderer:
    L, 4 pi L and pi L, at that file's bars."""
    L = 0.8
    cam = tS.make_camera([0, 0, 0], [0, 0, 1], width=1, height=1, kind=kind, device="cpu")
    img = tcommon.render(_env_scene(L), cam, tdirect.li,
                         tcommon.RenderConfig(spp=spp, max_depth=2, seed=0)).numpy()
    np.testing.assert_allclose(img, factor * L, rtol=rtol, atol=1e-5 if rtol < 1e-4 else 0)


def test_motion_blur_smears():
    """tests/test_motion.py:17-28 through the port: a camera translated
    during the shutter keeps the mean within 15% and lowers the mean
    horizontal gradient below 0.9x the static one's."""
    scene, cam = tb.cornell_box(width=24, height=24, device="cpu")
    end = cam.to_world.clone()
    end[0, 3] += 0.3
    cfg = tcommon.RenderConfig(spp=64, max_depth=2, seed=0)
    static = tcommon.render(scene, cam, tpath.li, cfg).numpy()
    blurred = tcommon.render(scene, cam.replace(to_world_end=end), tpath.li, cfg).numpy()
    assert np.isfinite(blurred).all()
    assert abs(blurred.mean() - static.mean()) / static.mean() < 0.15
    gx_s = np.abs(np.diff(static.mean(-1), axis=1)).mean()
    gx_b = np.abs(np.diff(blurred.mean(-1), axis=1)).mean()
    assert gx_b < 0.9 * gx_s, (gx_b, gx_s)


@pytest.fixture(scope="module")
def coloured():
    """chip_smoke's Cornell variant (vertex colours on the back wall, a
    wireframe material on the short block) built by both packages."""
    args = chip_smoke.vertex_color_cornell_args()
    return jir.build_scene(**args), tir.build_scene(**args, device="cpu")


def test_vertex_colors_and_wireframe(coloured):
    """build_scene's and from_jax's fields, then surface_interaction's
    vcolor and wirecolor and gather_shade_point's reflectance on rays at
    the Cornell camera's pixels, against the JAX package."""
    jscene, scene = coloured
    assert scene.has_vtx_colors and scene.has_wireframe
    carried = tir.from_jax(jscene, device="cpu")
    for s in (scene, carried):
        for f in ("vertex_colors", "wire_params"):
            assert np.array_equal(getattr(s, f).numpy(), np.asarray(getattr(jscene, f))), f
        assert (s.has_vtx_colors, s.has_wireframe) == (True, True)
    cam = tb.cornell_box(width=64, height=64, device="cpu")[1]
    rs = np.random.RandomState(5)
    px = torch.from_numpy(rs.uniform(0, 64, N).astype(np.float32))
    py = torch.from_numpy(rs.uniform(0, 64, N).astype(np.float32))
    o, d, _ = tS.sample_rays(cam, px, py, torch.zeros(N, 2))
    its = tT.closest_hit(scene, o, d)
    mats = scene.materials.tex_reflectance[scene.tri_material[its.prim]]
    for tex_id in (tir.TEX_VERTEXCOLOR, tir.TEX_WIREFRAME):
        assert int((its.valid & (mats == tex_id)).sum()) > 100, tex_id
    # first with the barycentrics recomputed from the hit (the brute-force
    # path), then with barycentrics handed in by the search (the BVH path),
    # here the same float32 values in both packages: the wireframe scales
    # the barycentrics by 1 / line width, so their last-bit differences
    # between XLA and torch would reach ~1e-5 (vcolor is held in both)
    p0 = scene.vertices[scene.indices[its.prim, 0]].double()
    e1 = scene.vertices[scene.indices[its.prim, 1]].double() - p0
    e2 = scene.vertices[scene.indices[its.prim, 2]].double() - p0
    pv = torch.linalg.cross(d.double(), e2)
    tv = o.double() - p0
    inv = 1.0 / (e1 * pv).sum(-1)
    b1 = ((tv * pv).sum(-1) * inv).float().clamp(0, 1)
    b2 = ((d.double() * torch.linalg.cross(tv, e1)).sum(-1) * inv).float().clamp(0, 1)
    for keys, hit in ((("vcolor",), its), (("vcolor", "wirecolor"), its._replace(b1=b1, b2=b2))):
        si = tI.surface_interaction(scene, o, d, hit)
        jits = jI.Intersection(*(jnp.asarray(x.numpy()) for x in hit))
        jsi = jI.surface_interaction(jscene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jits)
        for key in keys:
            _close(si[key], jsi[key], key)
    sp = tB.gather_shade_point(scene, si["mat"], si["uv"], aux=si)
    jsp = jB.gather_shade_point(jscene, jsi["mat"], jsi["uv"], aux=jsi)
    _close(sp.reflectance, jsp.reflectance, "reflectance")
