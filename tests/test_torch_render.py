"""End-to-end parity of the port's renders: the fixed-depth path tracer
against the JAX package's golden image, the regenerative wavefront against
the JAX wavefront, and the port's own invariants (these mirror
tests/test_wavefront.py)."""
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mitsuba_tpu.integrators import common as jcom, path as jpath, wavefront as jwf
from mitsuba_tpu.scene import builtin as jb
from mitsuba_tpu_torch.core.rng import SampleStream
from mitsuba_tpu_torch.integrators import common, path, wavefront
from mitsuba_tpu_torch.models import sensor
from mitsuba_tpu_torch.scene import builtin, ir

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent

# Golden bar: rtol = atol = 1e-4 (tests/test_golden.py), except at most
# GOLDEN_MAX_FLIPS pixels where one sample of 64 took another path, each
# off by at most GOLDEN_MAX_FLIP. Measured on the CPU: 1 of 1024 pixels,
# (21, 25), max 0.0093. Its camera ray differs from the JAX package's in
# the last bit (XLA:CPU fuses the ray math into FMAs and rounds sqrt
# otherwise) and grazes the short block's top edge: JAX hits the top face,
# the port the front face.
GOLDEN_RTOL = GOLDEN_ATOL = 1e-4
GOLDEN_MAX_FLIPS = 1
GOLDEN_MAX_FLIP = 0.01


def _cornell(w, h, env=None):
    jscene, jcam = jb.cornell_box(width=w, height=h)
    if env is not None:
        jscene = jscene.replace(env_radiance=jnp.asarray(env), has_env=True)
    return jscene, jcam, ir.from_jax(jscene, device="cpu"), builtin.cornell_box(w, h, device="cpu")[1]


def test_path_matches_golden():
    """tools/golden_scenes.py's cornell_path config: 32x32, 64 spp, depth
    8, rr 5, seed 7; the golden was rendered by the JAX package."""
    ref = np.load(ROOT / "tests" / "golden" / "cornell_path.npy")
    scene, cam = builtin.cornell_box(width=32, height=32, device="cpu")
    cfg = common.RenderConfig(spp=64, max_depth=8, rr_depth=5, seed=7)
    img = common.render(scene, cam, path.li, cfg).numpy()
    assert img.shape == ref.shape and img.dtype == np.float32
    diff = np.abs(img - ref)
    off = (diff > GOLDEN_ATOL + GOLDEN_RTOL * np.abs(ref)).any(-1)
    assert off.sum() <= GOLDEN_MAX_FLIPS, np.argwhere(off)
    assert diff.max() < GOLDEN_MAX_FLIP, diff.max()


def test_wavefront_matches_jax_wavefront():
    jscene, jcam, scene, cam = _cornell(16, 16)
    ref = np.asarray(jwf.render_jit(jscene, jcam,
                                    jcom.RenderConfig(spp=16, max_depth=4, seed=0)))
    img = wavefront.render(scene, cam, common.RenderConfig(spp=16, max_depth=4, seed=0))
    assert np.allclose(ref, img.numpy(), atol=1e-5), np.abs(ref - img.numpy()).max()


def test_wavefront_matches_fixed_depth():
    """Same estimator and sample streams: the regenerative renderer equals
    the fixed-depth one."""
    scene, cam = builtin.cornell_box(width=16, height=16, device="cpu")
    cfg = common.RenderConfig(spp=16, max_depth=6, rr_depth=3, seed=4)
    ref = common.render(scene, cam, path.li, cfg)
    img = wavefront.render(scene, cam, cfg)
    assert torch.allclose(ref, img, atol=1e-5), (ref - img).abs().max()


def test_lane_split_invariant():
    scene, cam = builtin.cornell_box(width=8, height=8, device="cpu")
    cfg = common.RenderConfig(spp=8, max_depth=3, seed=2)
    a = wavefront.render(scene, cam, cfg, lanes_per_pixel=1)
    b = wavefront.render(scene, cam, cfg, lanes_per_pixel=4)
    assert torch.allclose(a, b, atol=1e-5)


def test_env_depth1_matches_jax_path():
    jscene, jcam, scene, cam = _cornell(8, 8, env=[0.2, 0.3, 0.4])
    cfg = dict(spp=8, max_depth=1, seed=1)
    ref = np.asarray(jcom.render_jit(jscene, jcam, jpath.li, jcom.RenderConfig(**cfg)))
    img = wavefront.render(scene, cam, common.RenderConfig(**cfg))
    assert np.allclose(ref, img.numpy(), atol=1e-5)
    assert img.mean() > 0.0


def test_useful_ray_count():
    """li_with_stats counts the lanes that traced a closest-hit or a shadow
    ray; on Cornell every primary ray hits, so bounce 0 alone gives n."""
    scene, cam = builtin.cornell_box(width=8, height=8, device="cpu")
    n = 64
    pix = torch.arange(n, dtype=torch.int64)
    stream = SampleStream(0, pix, torch.zeros(n, dtype=torch.int64))
    jx, jy = stream.next_1d(), stream.next_1d()
    u_lens = stream.next_2d()
    o, d, _ = sensor.sample_rays(cam, (pix % 8).float() + jx, (pix // 8).float() + jy, u_lens)
    cfg = common.RenderConfig(spp=1, max_depth=1)
    _, rays = path.li_with_stats(scene, cam, o, d, stream, cfg)
    assert rays.item() == n and rays.dtype == torch.int64
    cfg = common.RenderConfig(spp=1, max_depth=8)
    _, rays = path.li_with_stats(scene, cam, o, d, stream, cfg)
    assert n < rays.item() <= 2 * 8 * n


def test_fused_bigmesh_matches_jax_wavefront():
    """The big-mesh leg at a small size: displaced_sphere(48, 48) (4,516
    triangles, BVH attached) through the fused wavefront, against the JAX
    wavefront with fuse=True from the same numpy geometry. On the CPU both
    walk the BVH (the JAX package's CPU route). atol 1e-5, no pixel
    excepted; measured max diff 2.98e-8, 0 edge-flip pixels."""
    from mitsuba_tpu.models import sensor as jsens
    from mitsuba_tpu.scene import bvh as jbvh, ir as jir
    from mitsuba_tpu_torch.ops import brute_kernel, bvh_kernel

    v, f, tm, mats, rad = builtin.displaced_sphere_mesh(48, 48)
    jscene = jbvh.attach(jir.build_scene(v, f, tm, mats, tri_radiance=rad))
    jcam = jsens.make_camera(width=16, height=16, **builtin.DISPLACED_SPHERE_CAMERA)
    assert jscene.num_triangles == 4516
    cfg = dict(spp=8, max_depth=4, rr_depth=3, seed=0)
    ref = np.asarray(jax.jit(lambda s, c: jwf.render(
        s, c, jcom.RenderConfig(**cfg), lanes_per_pixel=4, fuse=True))(jscene, jcam))
    scene = ir.from_jax(jscene, device="cpu")
    bvh_kernel.reset_counts()
    brute_kernel.reset_counts()
    img = wavefront.render(scene, sensor.camera_from_jax(jcam, device="cpu"),
                           common.RenderConfig(**cfg), lanes_per_pixel=4, fuse=True)
    assert np.abs(img.numpy() - ref).max() <= 1e-5, np.abs(img.numpy() - ref).max()
    assert ref.mean() > 0.005
    assert bvh_kernel.PLAIN_CALLS["closest"] > 0 and bvh_kernel.PLAIN_CALLS["any_hit"] > 0
    assert sum(brute_kernel.PLAIN_CALLS.values()) == 0


def test_compaction_ladder_invariant():
    """The compaction ladder reproduces the plain regenerative render, and
    the fused (deferred-shadow) estimator equals the unfused one: same
    samples, only the film's summation order differs (a port of
    tests/test_wavefront.py's test of the same name)."""
    scene, cam = builtin.cornell_box(width=32, height=32, device="cpu")
    cfg = common.RenderConfig(spp=8, max_depth=4, rr_depth=3, seed=3)
    a = wavefront.render(scene, cam, cfg, lanes_per_pixel=4, compact=False, fuse=True)
    b = wavefront.render(scene, cam, cfg, lanes_per_pixel=4, compact=True, fuse=True)
    c = wavefront.render(scene, cam, cfg, lanes_per_pixel=4)
    assert (a - b).abs().max() < 1e-5
    assert (a - c).abs().max() < 1e-5


def test_compact_raises_where_it_cannot_act():
    """compact needs fuse and >= 4096 lanes; without them it raises rather
    than doing nothing (ROADMAP C5)."""
    scene, cam = builtin.cornell_box(width=32, height=32, device="cpu")
    cfg = common.RenderConfig(spp=4, max_depth=2, seed=0)
    with pytest.raises(ValueError, match="compact"):
        wavefront.render(scene, cam, cfg, lanes_per_pixel=4, compact=True)
    with pytest.raises(ValueError, match="compact"):
        wavefront.render(scene, cam, cfg, lanes_per_pixel=2, compact=True, fuse=True)


def test_bvh_render_matches_brute():
    """sphere_shadow(24, 24) renders the same through the BVH twin as
    through brute force (measured: equal to the last bit)."""
    from mitsuba_tpu_torch.ops import brute_kernel, bvh_kernel

    scene_bvh, cam, _ = builtin.sphere_shadow(24, 24, width=16, height=16,
                                              attach_bvh=True, device="cpu")
    scene, _, _ = builtin.sphere_shadow(24, 24, width=16, height=16, device="cpu")
    cfg = common.RenderConfig(spp=16, max_depth=4, rr_depth=3, seed=1)
    bvh_kernel.reset_counts()
    brute_kernel.reset_counts()
    img = wavefront.render(scene_bvh, cam, cfg)
    assert bvh_kernel.PLAIN_CALLS["closest"] > 0 and brute_kernel.PLAIN_CALLS["closest"] == 0
    ref = wavefront.render(scene, cam, cfg)
    assert torch.allclose(img, ref, atol=1e-5), (img - ref).abs().max()
    assert img.mean() > 0.05


def test_port_imports_no_jax():
    """The port runs where JAX is absent: no module of it imports jax."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|mitsuba_tpu)(?![\w])", re.M)
    files = sorted((ROOT / "mitsuba_tpu_torch").rglob("*.py"))
    assert len(files) > 15
    names = {f.relative_to(ROOT / "mitsuba_tpu_torch").as_posix() for f in files}
    assert {"models/medium.py", "models/phase.py", "integrators/volpath.py",
            "samplers/qmc.py", "samplers/sobol.py", "film/film.py", "film/tiled.py"} <= names
    for f in files + [ROOT / "chip_smoke.py"]:
        assert not pat.search(f.read_text()), f


# --------------------------------------------------------------------------
# materials and lighting: microfacet plates, textures, the environment map
# --------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["veach_mis", "envmap_textured"])
def test_material_golden(name):
    """tools/golden_scenes.py's veach_mis (48x36, 64 spp, depth 3, seed 7:
    four GGX plates) and envmap_textured (24x24, 64 spp, depth 3, seed 7:
    a bilinear-textured quad under an 8x16 envmap) configs through the
    port's path.li, against the JAX package's goldens at rtol = atol =
    1e-4, the golden bar (at most GOLDEN_MAX_FLIPS pixels excepted).
    Measured on the CPU: 0 pixels off, max diff 1.4e-6 and 4.8e-7."""
    ref = np.load(ROOT / "tests" / "golden" / f"{name}.npy")
    if name == "veach_mis":
        scene, cam = builtin.veach_mis(width=48, height=36, device="cpu")
    else:
        cs = _chip_smoke()
        scene, cam = cs.textured_quad("cpu", *cs.golden_textures(), 24, 24)
    cfg = common.RenderConfig(spp=64, max_depth=3, seed=7)
    img = common.render(scene, cam, path.li, cfg).numpy()
    assert img.shape == ref.shape and img.dtype == np.float32 and img.mean() > 0.01
    diff = np.abs(img - ref)
    off = (diff > GOLDEN_ATOL + GOLDEN_RTOL * np.abs(ref)).any(-1)
    assert off.sum() <= GOLDEN_MAX_FLIPS, np.argwhere(off)
    assert diff.max() < GOLDEN_MAX_FLIP, diff.max()


@pytest.mark.parametrize("rough", [False, True], ids=["mirror", "rough_beckmann"])
def test_caustic_box_matches_jax(rough):
    """caustic_box (12x12, 16 spp, depth 4) with a delta conductor mirror or
    a 0.08-rough Beckmann one, against the JAX render of the same config.
    Bar: atol 1e-4 (measured below)."""
    jscene, jcam = jb.caustic_box(width=12, height=12, rough=rough)
    scene, cam = builtin.caustic_box(width=12, height=12, rough=rough, device="cpu")
    cfg = dict(spp=16, max_depth=4, seed=3)
    ref = np.asarray(jcom.render_jit(jscene, jcam, jpath.li, jcom.RenderConfig(**cfg)))
    img = common.render(scene, cam, path.li, common.RenderConfig(**cfg)).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.01
    assert np.abs(img - ref).max() <= 1e-4, np.abs(img - ref).max()


def test_mipped_textures_and_ewa_match_jax_path():
    """A 64x64 texture with mips under an envmap (the envmap_textured
    geometry, lod_scale from the camera): path.li runs EWA on the primary
    hit and the trilinear footprint after it; the port's render equals the
    JAX package's (atol 1e-5), and the port's wavefront equals its path.li
    (the JAX wavefront does not: it filters every hit trilinearly, C26)."""
    from mitsuba_tpu.models import sensor as jsens
    from mitsuba_tpu.scene import envmap as jenv, ir as jir

    cs = _chip_smoke()
    rs = np.random.RandomState(1)
    tex = rs.uniform(0.1, 0.9, (64, 64, 3)).astype(np.float32)
    env = rs.uniform(0.0, 2.0, (16, 32, 3)).astype(np.float32)
    scene, cam = cs.textured_quad("cpu", tex, env, 12, 12, mips=True)
    verts, tris, uvs = cs.TEXTURED_QUAD
    jscene = jenv.attach_envmap(jir.build_scene(
        verts, tris, np.zeros(2, np.int32), [{"type": jir.BSDF_DIFFUSE, "tex_reflectance": 0}],
        uvs=uvs, textures=[{"data": tex}], lod_scale=cs.lod_scale(cam)), env)
    jcam = jsens.make_camera(**cs.TEXTURED_QUAD_CAMERA, width=12, height=12)
    assert scene.tex_mips is not None and torch.equal(
        scene.tri_uv_density, torch.as_tensor(np.array(jscene.tri_uv_density)))
    cfg = dict(spp=8, max_depth=3, seed=2)
    ref = np.asarray(jcom.render_jit(jscene, jcam, jpath.li, jcom.RenderConfig(**cfg)))
    img = common.render(scene, cam, path.li, common.RenderConfig(**cfg))
    assert np.abs(img.numpy() - ref).max() <= 1e-5, np.abs(img.numpy() - ref).max()
    wf = wavefront.render(scene, cam, common.RenderConfig(**cfg))
    assert (wf - img).abs().max() <= 1e-5
    # EWA changed the image: the same render without the uv partials differs
    flat = common.render(scene.replace(tex_mips=None), cam, path.li, common.RenderConfig(**cfg))
    assert (flat - img).abs().max() > 1e-3


def test_veach_wavefront_matches_path():
    """The [veach] check at a CPU size: veach_mis through the wavefront
    equals common.render(path.li) within 1e-5, as tests/test_wavefront.py
    holds the JAX package."""
    scene, cam = builtin.veach_mis(width=32, height=24, device="cpu")
    cfg = common.RenderConfig(spp=8, max_depth=3, seed=5)
    a = wavefront.render(scene, cam, cfg, lanes_per_pixel=2)
    b = common.render(scene, cam, path.li, cfg)
    assert (a - b).abs().max() <= 1e-5 and b.mean() > 0.01
