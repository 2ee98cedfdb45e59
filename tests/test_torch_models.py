"""Sensor, emitter and BSDF parity of the port against the JAX package on
the Cornell box, and the scene/camera carried across by from_jax."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mitsuba_tpu.models import bsdf as jB, emitter as jE, sensor as jS
from mitsuba_tpu.scene import builtin as jb
from mitsuba_tpu_torch.models import bsdf as tB, emitter as tE, sensor as tS
from mitsuba_tpu_torch.scene import builtin as tb, ir as tir

torch.set_num_threads(1)

# 1e-6 absolute, and 1e-6 relative for the values above 1 (solid-angle
# pdfs reach ~10, where one float32 ulp is 1e-6): XLA:CPU's float32 sqrt
# is not correctly rounded, torch's is, so lengths differ in the last bit
ATOL = 1e-6
RTOL = 1e-6
N = 4096


@pytest.fixture(scope="module")
def cornell():
    jscene, jcam = jb.cornell_box(width=32, height=32)
    scene, cam = tb.cornell_box(width=32, height=32, device="cpu")
    return jscene, jcam, scene, cam


def _inputs(seed):
    """Shading points on the Cornell walls and blocks, local directions
    over the whole sphere, and uniforms, from a numpy seed."""
    rs = np.random.RandomState(seed)
    p = rs.uniform(0.05, 0.95, (N, 3)).astype(np.float32)
    w = rs.normal(size=(2, N, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    u = rs.uniform(size=(N, 4)).astype(np.float32)
    mat = rs.randint(0, 4, N).astype(np.int32)
    return p, w[0], w[1], u, mat


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def test_from_jax_round_trip(cornell):
    """Every leaf the port carries equals the JAX scene's, static fields
    included, and equals the port's own build of the scene."""
    jscene, jcam, scene, cam = cornell
    carried = tir.from_jax(jscene, device="cpu")
    for obj, jobj in ((carried, jscene), (carried.materials, jscene.materials),
                      (carried.emitters, jscene.emitters)):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                ref = np.asarray(getattr(jobj, f.name))
                assert v.numpy().dtype == ref.dtype, f.name
                assert np.array_equal(v.numpy(), ref), f.name
            elif not dataclasses.is_dataclass(v):
                assert v == getattr(jobj, f.name), f.name
    for f in ("vertices", "indices", "normals", "tri_material", "tri_emitter",
              "tri_opaque", "env_radiance"):
        assert torch.equal(getattr(carried, f), getattr(scene, f)), f
    assert torch.equal(carried.emitters.tri_cdf, scene.emitters.tri_cdf)
    assert (carried.bsdf_families, carried.has_area, carried.num_triangles) == \
        (scene.bsdf_families, scene.has_area, scene.num_triangles)
    carried_cam = tS.camera_from_jax(jcam, device="cpu")
    for f in ("to_world", "fov_x", "aperture", "focus_dist", "kc"):
        assert torch.equal(getattr(carried_cam, f), getattr(cam, f)), f
    assert (carried_cam.width, carried_cam.height) == (cam.width, cam.height)


def test_from_jax_refuses_unported_fields(cornell):
    """A field the port has no counterpart for raises, and so do the TPU
    kernel's cluster tables without the BVH the port walks instead."""
    jscene = cornell[0].replace(cloth=object())
    with pytest.raises(NotImplementedError, match="cloth"):
        tir.from_jax(jscene, device="cpu")
    jscene = cornell[0].replace(clusters=object())
    with pytest.raises(NotImplementedError, match="clusters without a bvh"):
        tir.from_jax(jscene, device="cpu")


def test_sample_rays(cornell):
    _, jcam, _, cam = cornell
    rs = np.random.RandomState(1)
    px = rs.uniform(0, 32, N).astype(np.float32)
    py = rs.uniform(0, 32, N).astype(np.float32)
    ul = rs.uniform(size=(N, 2)).astype(np.float32)
    jo, jd, jimp = jS.sample_rays(jcam, jnp.asarray(px), jnp.asarray(py), jnp.asarray(ul))
    o, d, imp = tS.sample_rays(cam, torch.from_numpy(px), torch.from_numpy(py),
                               torch.from_numpy(ul))
    for a, b, what in ((jo, o, "o"), (jd, d, "d"), (jimp, imp, "imp")):
        _close(a, b, what)
        assert b.dtype == torch.float32


@pytest.mark.parametrize("env", [False, True])
def test_sample_direct_and_pdfs(cornell, env):
    jscene, _, scene, _ = cornell
    if env:
        jscene = jscene.replace(env_radiance=jnp.asarray([0.2, 0.3, 0.4]), has_env=True)
        scene = tir.from_jax(jscene, device="cpu")
    p, _, _, u, _ = _inputs(2)
    jds = jE.sample_direct(jscene, jnp.asarray(p), jnp.asarray(u[:, :3]))
    ds = tE.sample_direct(scene, torch.from_numpy(p), torch.from_numpy(u[:, :3]))
    for f in ("d", "dist", "radiance", "pdf"):
        _close(getattr(jds, f), getattr(ds, f), f)
        assert getattr(ds, f).dtype == torch.float32, f
    for f in ("is_env", "is_delta"):
        assert np.array_equal(np.asarray(getattr(jds, f)), getattr(ds, f).numpy()), f
    # the pdf of the sampled emissive triangle, as BSDF-sampled MIS sees it
    prim = np.asarray(jscene.emitters.tri_index)[np.searchsorted(
        np.asarray(jscene.emitters.tri_cdf), u[:, 0] / (0.5 if env else 1.0))
        .clip(0, 1)].astype(np.int32)
    cos_l = u[:, 3] * 2.0 - 1.0
    args = (p, np.asarray(jds.d), np.asarray(jds.dist), prim, cos_l)
    jpdf = jE.pdf_direct_area(jscene, *(jnp.asarray(a) for a in args))
    pdf = tE.pdf_direct_area(scene, *(torch.from_numpy(np.array(a)) for a in args))
    _close(jpdf, pdf, "pdf_direct_area")
    d = torch.from_numpy(np.array(jds.d))
    _close(jE.pdf_direct_env(jscene, jds.d), tE.pdf_direct_env(scene, d), "pdf_env")
    _close(jE.env_radiance(jscene, jds.d), tE.env_radiance(scene, d), "env")


def test_bsdf_gather_eval_sample(cornell):
    jscene, _, scene, _ = cornell
    _, wi, wo, u, mat = _inputs(3)
    uv = np.zeros((N, 2), np.float32)
    jsp = jB.gather_shade_point(jscene, jnp.asarray(mat), jnp.asarray(uv))
    sp = tB.gather_shade_point(scene, torch.from_numpy(mat), torch.from_numpy(uv))
    for f in ("type", "reflectance", "specular", "eta", "k", "alpha", "extra"):
        assert np.array_equal(np.asarray(getattr(jsp, f)), getattr(sp, f).numpy()), f
    fam = scene.bsdf_families
    jf, jpdf = jB.eval_pdf(jsp, jnp.asarray(wi), jnp.asarray(wo), fam)
    f, pdf = tB.eval_pdf(sp, torch.from_numpy(wi), torch.from_numpy(wo), fam)
    _close(jf, f, "f")
    _close(jpdf, pdf, "pdf")
    assert (f.amax(-1) > 0).any() and (f.amax(-1) == 0).any()
    jout = jB.sample(jsp, jnp.asarray(wi), jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1:3]), fam)
    out = tB.sample(sp, torch.from_numpy(wi), torch.from_numpy(u[:, 0]),
                    torch.from_numpy(u[:, 1:3]), fam)
    for a, b, what in zip(jout[:3], out[:3], ("wo", "weight", "pdf")):
        _close(a, b, what)
    assert np.array_equal(np.asarray(jout[3]), out[3].numpy())


def test_unported_family_raises(cornell):
    """The family that still raises names itself and what it waits for
    (Irawan's cloth); the Hanrahan-Krueger slab gathers."""
    mat = torch.zeros(4, dtype=torch.int32)
    scene = cornell[2].replace(bsdf_families=(tir.BSDF_DIFFUSE, tir.BSDF_HK))
    assert tB.gather_shade_point(scene, mat, torch.zeros(4, 2)).type.shape == (4,)
    for fam, what in ((tir.BSDF_IRAWAN, "irawan.*cloth"),):
        scene = cornell[2].replace(bsdf_families=(tir.BSDF_DIFFUSE, fam))
        with pytest.raises(NotImplementedError, match=what):
            tB.gather_shade_point(scene, mat, torch.zeros(4, 2))


def test_entry_points_default_to_the_card():
    """Every scene and camera builder runs on the card unless the caller
    asks for the CPU (the CPU tests pass device="cpu")."""
    import inspect

    from mitsuba_tpu_torch.models import medium as tmed
    from mitsuba_tpu_torch.scene import bvh as tbvh

    builders = (tir.build_scene, tir.from_jax, tb.cornell_box, tb.sphere_shadow,
                tb.displaced_sphere, tS.make_camera, tS.camera_from_jax,
                tbvh.build_bvh, tb.cornell_box_lit, tir.build_delta_emitters,
                tmed.make_homogeneous, tmed.make_grid, tmed.make_hgrid)
    for fn in builders:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
