"""Parity of the port's textures and environment map with the JAX package:
the texture stack and its mip strip, texel selection (nearest lookups bit
for bit), bilinear, trilinear and EWA lookups, normal and bump maps, the
mip footprint and the ray-differential uv partials of surface_interaction,
the envmap's tables, sampling, pdf and lookup, the emitter's environment
terms, and from_jax on a textured, environment-lit scene. Inputs are drawn
with numpy from a seed (eager JAX on the CPU).

Bars: tables and texel selection bit for bit; looked-up values atol 1e-6
(texels are below 1); directions, pdfs and radiances atol 1e-5 + rtol 1e-5
(ROADMAP C25: atan2 and acos differ in the last bit between XLA:CPU and
torch, which moves a lookup's bilinear weights by an ulp)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mitsuba_tpu.models import emitter as jE, sensor as jS, texture as jtex
from mitsuba_tpu.ops import trace as jtrace
from mitsuba_tpu.scene import builtin as jb, envmap as jenv, ir as jir
from mitsuba_tpu_torch.models import emitter as tE, sensor as tS, texture as ttex
from mitsuba_tpu_torch.ops import trace as ttrace
from mitsuba_tpu_torch.scene import builtin as tb, envmap as tenv, ir as tir

torch.set_num_threads(1)

N = 4096
T, J = torch.as_tensor, jnp.asarray


def _close(a, b, atol=1e-6, rtol=0.0, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all(), what
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=what)


def _textures(rs):
    """Three textures of three sizes: RGB 64x32 (the stack's width), a
    grayscale 16x16 tiled 3x2 with an offset, and a nearest-filtered
    checkerboard."""
    return [{"data": rs.uniform(0, 1, (64, 32, 3)).astype(np.float32)},
            {"data": rs.uniform(0, 1, (16, 16)).astype(np.float32),
             "transform": (3.0, 2.0, 0.25, -0.5)},
            ttex.checkerboard([0.9, 0.1, 0.2], [0.1, 0.8, 0.3])]


def _quad(pkg_ir, textures, lod_scale=None, mats=None, **kw):
    verts = np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0.3, 1], [-1, 0, 1]], np.float32)
    uvs = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    mats = mats or [{"type": jir.BSDF_DIFFUSE, "tex_reflectance": 0}]
    return pkg_ir.build_scene(verts, np.asarray([[0, 2, 1], [0, 3, 2]], np.int32),
                              np.zeros(2, np.int32), mats, uvs=uvs, textures=textures,
                              lod_scale=lod_scale, **kw)


@pytest.fixture(scope="module")
def textured():
    rs = np.random.RandomState(0)
    tex = _textures(rs)
    jscene = _quad(jir, tex, lod_scale=0.01)
    scene = _quad(tir, tex, lod_scale=0.01, device="cpu")
    return jscene, scene


TEX_FIELDS = ("textures", "tex_size", "tex_transform", "tex_nearest", "tex_mips",
              "tri_uv_density")


def test_texture_tables_match_jax(textured):
    """The stack, sizes, transforms, nearest flags, the mip strip's packed
    layout and the uv densities equal the JAX package's array for array,
    built by the port and carried by from_jax."""
    jscene, scene = textured
    carried = tir.from_jax(jscene, device="cpu")
    for f in TEX_FIELDS:
        ref = np.asarray(getattr(jscene, f))
        for s in (scene, carried):
            assert getattr(s, f).numpy().dtype == ref.dtype, f
            assert np.array_equal(getattr(s, f).numpy(), ref), f
    assert scene.tex_mips.shape == (3, 32, 32, 3)
    # without lod_scale neither is built
    plain = _quad(tir, _textures(np.random.RandomState(0)), device="cpu")
    assert plain.tex_mips is None and plain.tri_uv_density is None


def _lookup_inputs(seed):
    rs = np.random.RandomState(seed)
    tid = rs.randint(-1, 3, N).astype(np.int32)
    uv = rs.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    fallback = rs.uniform(size=(N, 3)).astype(np.float32)
    footprint = np.exp(rs.uniform(-9, 0, N)).astype(np.float32)
    # uv partials: isotropic, anisotropic up to 30:1 and beyond the clamp,
    # and a tenth of the lanes without (trilinear)
    major = rs.normal(size=(N, 2)) * np.exp(rs.uniform(-7, -2, (N, 1)))
    minor = np.stack([-major[:, 1], major[:, 0]], -1) / np.exp(rs.uniform(0, 3.4, (N, 1)))
    none = rs.uniform(size=N) < 0.1
    major[none] = 0.0
    minor[none] = 0.0
    return tid, uv, fallback, footprint, major.astype(np.float32), minor.astype(np.float32)


def test_texel_selection_bit_for_bit(textured):
    """Which texel a lookup reads: nearest lookups (every texture flagged
    nearest, so each value is one texel) over uvs far outside [0,1] with
    tiling and negative offsets, floor-mod wrapping included."""
    jscene, scene = textured
    jn = jscene.replace(tex_nearest=jnp.ones_like(jscene.tex_nearest))
    tn = scene.replace(tex_nearest=torch.ones_like(scene.tex_nearest))
    tid, uv, *_ = _lookup_inputs(1)
    tid = np.maximum(tid, 0)
    ref = np.asarray(jtex.sample_bilinear(jn, J(tid), J(uv)))
    got = ttex.sample_bilinear(tn, T(tid), T(uv)).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("mode", ["bilinear", "trilinear", "ewa"])
def test_resolve_matches_jax(textured, mode):
    """texture.resolve: bilinear (no footprint), trilinear (footprint on
    the mip strip) and EWA (uv partials; 8 taps, anisotropy clamped at 8),
    with fallbacks where tex_id < 0."""
    jscene, scene = textured
    tid, uv, fb, fp, dx, dy = _lookup_inputs(2)
    kw, jkw = {}, {}
    if mode != "bilinear":
        kw["footprint"], jkw["footprint"] = T(fp), J(fp)
    if mode == "ewa":
        kw.update(duvdx=T(dx), duvdy=T(dy))
        jkw.update(duvdx=J(dx), duvdy=J(dy))
    ref = jtex.resolve(jscene, J(tid), J(uv), J(fb), **jkw)
    got = ttex.resolve(scene, T(tid), T(uv), T(fb), **kw)
    _close(got, ref, 1e-6, what=mode)
    if mode == "ewa":
        # the EWA lanes differ from the trilinear ones
        tri = ttex.resolve(scene, T(tid), T(uv), T(fb), footprint=T(fp))
        assert ((got - tri).abs().amax(-1) > 1e-3).sum() > N // 4


def test_mip_levels_match_jax(textured):
    """_trilinear_at at every integer and fractional lod, and the strip's
    bilinear at each level, against JAX's."""
    jscene, scene = textured
    tid, uv, *_ = _lookup_inputs(3)
    tid = np.maximum(tid, 0)
    lod = np.random.RandomState(4).uniform(-1, 7, N).astype(np.float32)
    lod[: N // 4] = np.round(lod[: N // 4])
    _close(ttex._trilinear_at(scene, T(tid), T(uv), T(lod)),
           jtex._trilinear_at(jscene, J(tid), J(uv), J(lod)), 1e-6, what="trilinear")
    for level in range(1, 6):
        lv = np.full(N, float(level), np.float32)
        _close(ttex._mip_bilinear(scene, T(tid), T(uv), T(lv)),
               jtex._mip_bilinear(jscene, J(tid), J(uv), J(lv)), 1e-6, what=f"level {level}")


def test_texel_gradient_matches_jax(textured):
    """d(sum of EWA lookups x cotangent)/d(texels) against jax.grad."""
    import jax

    jscene, scene = textured
    tid, uv, fb, fp, dx, dy = _lookup_inputs(5)
    cot = np.random.RandomState(6).normal(size=(N, 3)).astype(np.float32)
    tx = scene.textures.clone().requires_grad_(True)
    (ttex.resolve(scene.replace(textures=tx), T(tid), T(uv), T(fb), footprint=T(fp),
                  duvdx=T(dx), duvdy=T(dy)) * T(cot)).sum().backward()
    g = np.asarray(jax.grad(lambda t: jnp.sum(jtex.resolve(
        jscene.replace(textures=t), J(tid), J(uv), J(fb), footprint=J(fp),
        duvdx=J(dx), duvdy=J(dy)) * cot))(jscene.textures))
    assert np.abs(g).max() > 0.1
    assert np.abs(tx.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def _perturb_scene(pkg_ir, kind, **kw):
    rs = np.random.RandomState(7)
    nm = rs.uniform(0.2, 0.8, (16, 16, 3)).astype(np.float32)
    nm[..., 2] = rs.uniform(0.6, 1.0, (16, 16))
    tex = [{"data": nm}, {"data": rs.uniform(0, 1, (32, 32, 3)).astype(np.float32)}]
    mats = [{"type": jir.BSDF_DIFFUSE, "tex_reflectance": 1, "tex_perturb": 0,
             "perturb_kind": kind}]
    return _quad(pkg_ir, tex, lod_scale=0.004, mats=mats, **kw)


@pytest.mark.parametrize("kind", [1, 2], ids=["normalmap", "bumpmap"])
def test_surface_interaction_matches_jax(kind):
    """surface_interaction on camera rays through a tilted quad with a
    normal or bump map, mips and ray differentials: the perturbed shading
    normal, the texel footprint and the uv partials duvdx/duvdy."""
    jscene = _perturb_scene(jir, kind)
    scene = _perturb_scene(tir, kind, device="cpu")
    assert scene.has_perturb and jscene.has_perturb
    jcam = jS.make_camera([0.3, 1.8, -2.4], [0, 0, 0], fov_x=45, width=32, height=32)
    cam = tS.camera_from_jax(jcam, device="cpu")
    rs = np.random.RandomState(8)
    px = rs.uniform(0, 32, 1024).astype(np.float32)
    py = rs.uniform(0, 32, 1024).astype(np.float32)
    o, d, _ = tS.sample_rays(cam, T(px), T(py), torch.zeros(1024, 2))
    oj, dj = J(o.numpy()), J(d.numpy())
    ddx, ddy = tS.ray_differentials(cam, d)
    jddx, jddy = jS.ray_differentials(jcam, dj)
    its = ttrace.closest_hit(scene, o, d)
    jits = jtrace.closest_hit(jscene, oj, dj)
    assert np.array_equal(its.prim.numpy(), np.asarray(jits.prim)) and its.valid.any()
    si = ttrace.surface_interaction(scene, o, d, its, dd_dx=ddx, dd_dy=ddy)
    jsi = jtrace.surface_interaction(jscene, oj, dj, jits, dd_dx=jddx, dd_dy=jddy)
    hit = its.valid.numpy()
    for k in ("p", "ns", "uv", "footprint", "duvdx", "duvdy"):
        _close(si[k].numpy()[hit], np.asarray(jsi[k])[hit], 1e-5, 1e-5, what=k)
    # the map moved the normal off the geometric one on most lanes
    moved = (si["ns"] - si["ng"]).norm(dim=-1)[its.valid]
    assert (moved > 1e-3).float().mean() > 0.9


# --------------------------------------------------------------------------
# environment map
# --------------------------------------------------------------------------

def _env_image(seed=0, h=16, w=32):
    rs = np.random.RandomState(seed)
    img = rs.uniform(0.05, 1.0, (h, w, 3)).astype(np.float32)
    img[h // 3, w // 4] *= 40.0   # hot spot
    return img


def test_envmap_tables_and_lookups_match_jax():
    """build_envmap's tables equal JAX's; eval_radiance, sample_direction
    (rows, columns and the rescaled u), pdf_direction and dir_to_uv agree."""
    img = _env_image()
    jem = jenv.build_envmap(img, scale=1.5)
    em = tenv.build_envmap(img, scale=1.5, device="cpu")
    for f in ("image", "row_cdf", "cond_cdf", "pdf_map", "scale"):
        assert np.array_equal(getattr(em, f).numpy(), np.asarray(getattr(jem, f))), f
    rs = np.random.RandomState(9)
    u2 = rs.uniform(size=(N, 2)).astype(np.float32)
    # exact CDF values: the search's boundaries
    u2[:64, 0] = np.asarray(jem.row_cdf)[rs.randint(0, 16, 64)]
    u2[64:128, 1] = np.asarray(jem.cond_cdf)[0, rs.randint(0, 32, 64)]
    jd, jpdf, jrad = jenv.sample_direction(jem, J(u2))
    d, pdf, rad = tenv.sample_direction(em, T(u2))
    _close(d, jd, 1e-5, 1e-5, "d")
    _close(pdf, jpdf, 1e-5, 1e-5, "pdf")
    _close(rad, jrad, 1e-5, 1e-5, "radiance")
    dirs = rs.normal(size=(N, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    _close(tenv.pdf_direction(em, T(dirs)), jenv.pdf_direction(jem, J(dirs)), 1e-5, 1e-5)
    _close(tenv.eval_radiance(em, T(dirs)), jenv.eval_radiance(jem, J(dirs)), 1e-5, 1e-5)
    for a, b in zip(tenv.dir_to_uv(T(dirs)), jenv.dir_to_uv(J(dirs))):
        _close(a, b, 1e-6)
    _close(tenv.uv_to_dir(T(u2[:, 0]), T(u2[:, 1])), jenv.uv_to_dir(J(u2[:, 0]), J(u2[:, 1])),
           1e-6)
    rot = jS.look_at([0, 0, 0], [1, 0.3, 0.2])
    assert np.allclose(tenv.rotate_latlong(img, rot), jenv.rotate_latlong(img, rot), atol=1e-5)


def test_envmap_search_matches_searchsorted():
    """The per-lane bisection over each lane's conditional row equals
    searchsorted(side="left") on that row, at and between the CDF values."""
    em = tenv.build_envmap(_env_image(1, 8, 37), device="cpu")
    rs = np.random.RandomState(10)
    row = T(rs.randint(0, 8, N))
    u = rs.uniform(size=N).astype(np.float32)
    u[::3] = em.cond_cdf.numpy()[row.numpy()[::3], rs.randint(0, 37, len(u[::3]))]
    got = tenv._lower_bound(em.cond_cdf, row, T(u))
    ref = [np.searchsorted(em.cond_cdf[r].numpy(), x, side="left") for r, x in zip(row.numpy(), u)]
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_envmap_total_radiance():
    """tests/test_envmap.py:54's protocol on the port: E[L/pdf] over 2^18
    importance samples equals the lat-long map's quadrature, rtol 2e-2."""
    em = tenv.build_envmap(_env_image(3), device="cpu")
    u2 = torch.as_tensor(np.random.RandomState(3).uniform(size=(1 << 18, 2)), dtype=torch.float32)
    _, pdf, rad = tenv.sample_direction(em, u2)
    est = (rad / pdf[:, None]).mean(0).numpy()
    img = em.image.numpy()
    h, w = img.shape[:2]
    theta = (np.arange(h) + 0.5) / h * np.pi
    ref = (img * (np.sin(theta)[:, None, None] * (np.pi / h) * (2 * np.pi / w))).sum((0, 1))
    assert np.allclose(est, ref, rtol=2e-2), (est, ref)


def test_spectral_envmap_matches_jax():
    """eval_radiance_spectral (bilinear over the lat-long band stack, linear
    across the bands) against the JAX package at 1e-5: 4,096 directions,
    the seam's negative columns and the poles included, four wavelengths
    each from below the first band to above the last."""
    rs = np.random.RandomState(8)
    img = _env_image()
    bands = rs.uniform(0.0, 3.0, img.shape[:2] + (11,)).astype(np.float32)
    jem = jenv.attach_envmap(jb.cornell_box(width=8, height=8)[0], img, 1.7,
                             spectral=bands).envmap
    em = tenv.build_envmap(img, 1.7, device="cpu").replace(spectral=torch.as_tensor(bands))
    d = rs.normal(size=(4096, 3)).astype(np.float32)
    d[:4] = [[0, 1, 0], [0, -1, 0], [1e-7, 0.3, -1], [-1e-7, 0.3, -1]]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lam = rs.uniform(300.0, 740.0, (4096, 4)).astype(np.float32)
    want = np.asarray(jenv.eval_radiance_spectral(jem, jnp.asarray(d), jnp.asarray(lam)))
    got = tenv.eval_radiance_spectral(em, torch.as_tensor(d), torch.as_tensor(lam)).numpy()
    assert got.shape == (4096, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def env_lit():
    """The Cornell box lit by an envmap beside its area light, in the JAX
    package and carried by from_jax."""
    jscene = jenv.attach_envmap(jb.cornell_box(width=8, height=8)[0], _env_image(4), 2.0)
    return jscene, tir.from_jax(jscene, device="cpu")


def test_from_jax_textured_env_lit(env_lit):
    """from_jax on a textured scene with mips and an envmap: every tensor
    leaf, the envmap's included, equals the JAX scene's, static fields too;
    attach_envmap on the port's own scene gives the same tables."""
    jscene = jenv.attach_envmap(_quad(jir, _textures(np.random.RandomState(0)), 0.01),
                                _env_image(5))
    carried = tir.from_jax(jscene, device="cpu")
    for obj, jobj in ((carried, jscene), (carried.envmap, jscene.envmap)):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                ref = np.asarray(getattr(jobj, f.name))
                assert v.numpy().dtype == ref.dtype and np.array_equal(v.numpy(), ref), f.name
            elif f.name in ("group_probs", "num_triangles", "bsdf_families", "has_env",
                            "has_area", "has_null", "has_perturb"):
                assert v == getattr(jobj, f.name), f.name
    own = tenv.attach_envmap(_quad(tir, _textures(np.random.RandomState(0)), 0.01,
                                   device="cpu"), _env_image(5))
    assert own.has_env and torch.equal(own.envmap.cond_cdf, carried.envmap.cond_cdf)
    assert not carried.detach().envmap.image.requires_grad


def test_emitter_env_terms_match_jax(env_lit):
    """sample_direct's env branch (envmap importance sampling beside the
    area lights), pdf_direct_env and env_radiance, against JAX's."""
    jscene, scene = env_lit
    rs = np.random.RandomState(11)
    p = rs.uniform(0.05, 0.95, (N, 3)).astype(np.float32)
    u3 = rs.uniform(size=(N, 3)).astype(np.float32)
    jds = jE.sample_direct(jscene, J(p), J(u3))
    ds = tE.sample_direct(scene, T(p), T(u3))
    assert ds.is_env.any() and (~ds.is_env).any()
    assert np.array_equal(ds.is_env.numpy(), np.asarray(jds.is_env))
    for f in ("d", "dist", "radiance", "pdf"):
        _close(getattr(ds, f), getattr(jds, f), 1e-5, 1e-5, f)
    d = T(np.array(jds.d))
    _close(tE.pdf_direct_env(scene, d), jE.pdf_direct_env(jscene, jds.d), 1e-5, 1e-5)
    _close(tE.env_radiance(scene, d), jE.env_radiance(jscene, jds.d), 1e-5, 1e-5)
