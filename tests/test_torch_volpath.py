"""Parity of the port's volumetric path tracer and delta lights with the
JAX package: volpath.li over every medium kind and the non-HG phases, the
vacuum limit against path.li, the volpath_homogeneous golden, sample_direct
and the power-weighted group probabilities with point, spot and
directional lights, the lit Cornell boxes through path.li, the sigma_t and
albedo gradients, and the integrators that refuse a medium.

Radiance is compared on the same camera rays and sample streams: the
port's rays go to the JAX function as numpy arrays. The JAX references run
eagerly with `unroll=True`, once per module (module-scoped fixtures): on
the CPU a jit compile of volpath.li costs 6-17 s per medium kind, an eager
run 1-1.5 s once the first has compiled its primitives. Bars (ROADMAP
C10/C23): radiance within 1e-5, gradients within 1e-4 of the largest
entry, the golden at the golden bar of tests/test_torch_render.py."""
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mitsuba_tpu.core.rng import SampleStream as JStream
from mitsuba_tpu.integrators import common as jcom, path as jpath, volpath as jvp
from mitsuba_tpu.models import emitter as jem, medium as jmed, phase as jph
from mitsuba_tpu.scene import builtin as jb, ir as jir
from mitsuba_tpu_torch.core.rng import SampleStream
from mitsuba_tpu_torch.integrators import boundary, common, path, volpath, wavefront
from mitsuba_tpu_torch.models import emitter, medium as tmed, sensor
from mitsuba_tpu_torch.ops import brute_kernel
from mitsuba_tpu_torch.scene import builtin, ir

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-5
GRAD_RTOL = 1e-4
GOLDEN_TOL = 1e-4
GOLDEN_MAX_FLIPS = 1
GOLDEN_MAX_FLIP = 0.01
SEED = 3
CFG = dict(spp=4, max_depth=3, rr_depth=2, seed=SEED)

KKAY = (0.3, 0.8, 0.2, 0.6, 0.4, 12.0)
MIXTURE = (jph.PHASE_HG, 0.7, 0.6, jph.PHASE_RAYLEIGH, 0.3, 0.0)


def _blob(n=12):
    zz, yy, xx = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    return (np.exp(-((xx - 0.4) ** 2 + (yy - 0.5) ** 2 + (zz - 0.5) ** 2) / 0.05)
            * 3.0).astype(np.float32)


def _hgrid():
    rs = np.random.RandomState(5)
    table = np.arange(8, dtype=np.int32).reshape(2, 2, 2)
    table[1, 0, 1] = -1
    return table, rs.uniform(0.0, 2.5, (8, 5, 5, 5)).astype(np.float32)


# name -> (maker, args, kwargs): the same call in both packages' medium module
MEDIA = {
    "homogeneous": ("make_homogeneous", ([0.3, 0.4, 0.5], [0.1, 0.05, 0.2], 0.3), {}),
    "grid": ("make_grid", (_blob(), 3.0, 0.7, 0.2), {}),
    "hgrid": ("make_hgrid", (*_hgrid(), 2.0, 0.6, -0.2), {}),
    "kkay": ("make_homogeneous", ([0.4] * 3, [0.1] * 3), dict(phase=jph.PHASE_KKAY,
                                                             phase_params=KKAY)),
    "mixture": ("make_homogeneous", ([0.4] * 3, [0.1] * 3), dict(phase=jph.PHASE_MIXTURE,
                                                                phase_params=MIXTURE)),
    "microflake": ("make_homogeneous", ([0.4] * 3, [0.1] * 3), dict(
        phase=jph.PHASE_MICROFLAKE,
        phase_params=jph.make_microflake_params(0.3, axis=(0.2, 0.9, 0.1)))),
}


def _medium_pair(name):
    maker, args, kw = MEDIA[name]
    return getattr(jmed, maker)(*args, **kw), getattr(tmed, maker)(*args, **kw, device="cpu")


def _batch(cam, spp, seed):
    """Every pixel x spp camera rays in the renderer's order through the
    port's sensor, with each package's sample stream after the sensor dims."""
    w, h = cam.width, cam.height
    pix = torch.repeat_interleave(torch.arange(w * h), spp)
    smp = torch.arange(spp).repeat(w * h)
    st = SampleStream(seed, pix, smp, 0)
    jx, jy = st.next_1d(), st.next_1d()
    u_lens = st.next_2d()
    o, d, _ = sensor.sample_rays(cam, (pix % w).float() + jx, (pix // w).float() + jy, u_lens)
    port = (o, d, SampleStream(seed, pix, smp, 4))
    jax_ = (jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            JStream(jnp.uint32(seed), jnp.asarray(pix.numpy().astype(np.uint32)),
                    jnp.asarray(smp.numpy().astype(np.uint32)), 4))
    return port, jax_


def _jax_li(li, jscene, jcam, batch, **cfg):
    o, d, st = batch
    return np.asarray(li(jscene, jcam, o, d, st, jcom.RenderConfig(unroll=True, **cfg)))


@pytest.fixture(scope="module")
def cornell():
    jscene, jcam = jb.cornell_box(width=8, height=8)
    scene = ir.from_jax(jscene, device="cpu")
    cam = sensor.camera_from_jax(jcam, device="cpu")
    return jscene, jcam, scene, cam, _batch(cam, CFG["spp"], SEED)


@pytest.fixture(scope="module")
def volpath_refs(cornell):
    """JAX volpath radiance of every MEDIA case on the Cornell batch."""
    jscene, jcam, _, _, (_, jbatch) = cornell
    return {name: _jax_li(jvp.li, jscene.replace(medium=_medium_pair(name)[0]), jcam, jbatch,
                          **CFG)
            for name in MEDIA}


@pytest.mark.parametrize("name", list(MEDIA))
def test_volpath_matches_jax(name, cornell, volpath_refs):
    """volpath.li on Cornell 8x8 x 4 spp rays, depth 3, Russian roulette
    from depth 2: each medium kind (homogeneous, a dense grid blob, a
    block-sparse grid with an empty cell) and the non-HG phases, against
    JAX's radiance within 1e-5, every ray."""
    _, _, scene, cam, (batch, _) = cornell
    o, d, st = batch
    brute_kernel.reset_counts()
    L = volpath.li(scene.replace(medium=_medium_pair(name)[1]), cam, o, d, st,
                   common.RenderConfig(**CFG)).numpy()
    ref = volpath_refs[name]
    assert np.isfinite(L).all() and L.mean() > 0.01
    assert np.abs(L - ref).max() <= ATOL, np.abs(L - ref).max()
    # one closest and two any-hit searches per bounce (surface and medium NEE)
    assert brute_kernel.PLAIN_CALLS["closest"] == CFG["max_depth"]
    assert brute_kernel.PLAIN_CALLS["any_hit"] == 2 * CFG["max_depth"]


def test_volpath_vacuum_limit_is_path_bit_for_bit():
    """A zero-density medium renders path.li's image bit for bit: the
    surface lanes read path.py's sample dims (tests/test_volpath.py:86)."""
    scene, cam = builtin.cornell_box(width=16, height=16, device="cpu")
    cfg = common.RenderConfig(spp=16, max_depth=4, seed=0)
    ref = common.render(scene, cam, path.li, cfg)
    vac = scene.replace(medium=tmed.make_homogeneous([0.0] * 3, [0.0] * 3, device="cpu"))
    img = common.render(vac, cam, volpath.li, cfg)
    assert torch.equal(img, ref)
    # without a medium volpath.li is path.li
    assert torch.equal(common.render(scene, cam, volpath.li, cfg), ref)


def test_volpath_matches_golden():
    """tools/golden_scenes.py's volpath_homogeneous (Cornell 24x24, sigma_s
    0.2, sigma_a 0.05, g 0.3, 64 spp, depth 6, seed 7): its JAX scene
    carried across from_jax and rendered through the port's volpath.li,
    against the golden the JAX package rendered, at the golden bar: rtol =
    atol = 1e-4, at most one pixel beyond it and below 0.01."""
    from tools.golden_scenes import _cases

    ref = np.load(ROOT / "tests" / "golden" / "volpath_homogeneous.npy")
    jscene, jcam, jli, jcfg = _cases()["volpath_homogeneous"]()
    assert jli is jvp.li and jscene.medium is not None
    scene = ir.from_jax(jscene, device="cpu")
    cam = sensor.camera_from_jax(jcam, device="cpu")
    img = common.render(scene, cam, volpath.li, common.RenderConfig(
        spp=jcfg.spp, max_depth=jcfg.max_depth, seed=jcfg.seed)).numpy()
    assert img.shape == ref.shape and img.dtype == np.float32 and img.mean() > 0.01
    diff = np.abs(img - ref)
    off = (diff > GOLDEN_TOL + GOLDEN_TOL * np.abs(ref)).any(-1)
    assert off.sum() <= GOLDEN_MAX_FLIPS, np.argwhere(off)
    assert diff.max() < GOLDEN_MAX_FLIP, diff.max()


DELTA_RECORDS = [
    {"kind": jir.DELTA_POINT, "position": [0.5, 0.8, 0.5], "intensity": [2.0, 1.8, 1.5]},
    {"kind": jir.DELTA_SPOT, "position": [0.5, 0.95, 0.5], "direction": [0.1, -1.0, 0.0],
     "intensity": [4.0, 3.6, 3.0], "cutoff_deg": 40.0, "beam_deg": 30.0},
    {"kind": jir.DELTA_DIRECTIONAL, "direction": [0.3, -1.0, 0.2], "intensity": 0.8},
]


@pytest.mark.parametrize("power", [False, True], ids=["uniform_groups", "power_groups"])
def test_sample_direct_delta_matches_jax(power):
    """sample_direct on the area-lit Cornell box with a point, a spot and a
    directional light and a constant environment, over 4,096 random points
    in the box: every field (n_l included) equal to JAX's within 1e-5 (rtol
    and atol; the inverse-square radiance goes through a sqrt and a
    reciprocal), with the groups split evenly or by compute_group_probs
    (whose probabilities equal JAX's within 1e-6)."""
    jscene, _ = jb.cornell_box(width=4, height=4)
    jscene = jscene.replace(delta_emitters=jir.build_delta_emitters(DELTA_RECORDS),
                            has_env=True, env_radiance=jnp.asarray([0.3, 0.2, 0.1]))
    scene = ir.from_jax(jscene, device="cpu")
    if power:
        jscene = jem.compute_group_probs(jscene)
        scene = emitter.compute_group_probs(scene)
        assert np.allclose(scene.group_probs, jscene.group_probs, atol=1e-6, rtol=1e-6)
        assert min(scene.group_probs) >= 0.05 / 1.1 and abs(sum(scene.group_probs) - 1) < 1e-6
    c, r = emitter.scene_bsphere(scene)
    jc, jr = jem.scene_bsphere(jscene)
    assert np.allclose(c.numpy(), np.asarray(jc)) and np.isclose(float(r), float(jr))
    rs = np.random.RandomState(8)
    p = rs.uniform(0.02, 0.98, (4096, 3)).astype(np.float32)
    u = rs.uniform(size=(4096, 3)).astype(np.float32)
    ref = jem.sample_direct(jscene, jnp.asarray(p), jnp.asarray(u))
    got = emitter.sample_direct(scene, torch.as_tensor(p), torch.as_tensor(u))
    for f in ref._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        if b.dtype == bool:
            assert np.array_equal(a, b), f
        else:
            assert np.allclose(a, b, atol=1e-5, rtol=1e-5), (f, np.abs(a - b).max())
    delta = got.is_delta.numpy()
    assert 0.1 < delta.mean() < 0.9 and got.is_env.any()
    assert (got.radiance.numpy()[delta] > 0).any() and (got.n_l.numpy()[delta] == 0).all()


@pytest.mark.parametrize("light", ["point", "spot", "env"])
def test_cornell_box_lit_path_matches_jax(light):
    """cornell_box_lit through path.li on 8x8 x 4 spp rays, depth 4: the
    port's scene equals the JAX builtin's and its radiance equals JAX's
    within 1e-5."""
    jscene, jcam = jb.cornell_box_lit(light, width=8, height=8)
    scene, cam = builtin.cornell_box_lit(light, width=8, height=8, device="cpu")
    if light != "env":
        for f in ("kind", "position", "direction", "intensity", "cutoff"):
            assert np.array_equal(getattr(scene.delta_emitters, f).numpy(),
                                  np.asarray(getattr(jscene.delta_emitters, f))), f
    assert scene.has_env == jscene.has_env and not scene.has_area
    batch, jbatch = _batch(cam, 4, 1)
    cfg = dict(spp=4, max_depth=4, seed=1)
    ref = _jax_li(jpath.li, jscene, jcam, jbatch, **cfg)
    L = path.li(scene, cam, *batch, common.RenderConfig(**cfg)).numpy()
    assert np.isfinite(L).all() and L.mean() > 1e-3
    assert np.abs(L - ref).max() <= ATOL, np.abs(L - ref).max()


def test_medium_gradients_match_jax(cornell):
    """d(mean radiance)/d(sigma_t) and d/d(albedo) of volpath.li on the
    Cornell batch (homogeneous medium, depth 3, Russian roulette from 2),
    against jax.grad on the same rays, within 1e-4 of the largest entry;
    both finite and non-zero."""
    jscene, jcam, scene, cam, (batch, jbatch) = cornell
    jm, tm = _medium_pair("homogeneous")

    def jloss(sigma_t, albedo):
        s = jscene.replace(medium=jm.replace(sigma_t=sigma_t, albedo=albedo))
        o, d, st = jbatch
        L = jvp.li(s, jcam, o, d, st, jcom.RenderConfig(unroll=True, **CFG))
        return jnp.mean(jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0))

    jg = [np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1))(jm.sigma_t, jm.albedo)]
    leaves = [x.clone().requires_grad_(True) for x in (tm.sigma_t, tm.albedo)]
    L = volpath.li(scene.replace(medium=tm.replace(sigma_t=leaves[0], albedo=leaves[1])),
                   cam, *batch, common.RenderConfig(**CFG))
    torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0).mean().backward()
    for name, x, g in zip(("sigma_t", "albedo"), leaves, jg):
        mine = x.grad.numpy()
        assert np.isfinite(mine).all() and np.abs(g).max() > 1e-4, (name, mine, g)
        assert np.abs(mine - g).max() <= GRAD_RTOL * np.abs(g).max(), (name, mine, g)


def test_integrators_without_media_raise():
    """The wavefront and boundary.render_grad have vacuum transport only: a
    scene with a medium raises, naming volpath (the JAX wavefront renders
    it as vacuum, ROADMAP C28)."""
    scene, cam = builtin.cornell_box(width=8, height=8, device="cpu")
    scene = scene.replace(medium=tmed.make_homogeneous([0.2] * 3, [0.05] * 3, device="cpu"))
    cfg = common.RenderConfig(spp=1, max_depth=2)
    with pytest.raises(NotImplementedError, match="volpath"):
        wavefront.render(scene, cam, cfg)
    with pytest.raises(NotImplementedError, match="volpath"):
        boundary.render_grad(scene, cam, cfg)

