"""The occupancy map (ops/occupancy.py) against the JAX package's on the
CPU: the grid bit for bit, `occluded` bit for bit on 4,096 segments,
from_jax and config_from_jax carrying the map and the flag, the shadow
queries' dispatch, and path.li, direct.li and bdpt.li with
`occupancy_shadows` against the JAX renders (each jitted once) at the
goldens' rtol = atol = 1e-4, at most one pixel beyond it (C8's
allowance)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mitsuba_tpu.integrators import bdpt as jbdpt, common as jcom, direct as jdirect, path as jpath
from mitsuba_tpu.ops import occupancy as jocc
from mitsuba_tpu.scene import builtin as jb
from mitsuba_tpu_torch.integrators import bdpt, common, direct, path, wavefront
from mitsuba_tpu_torch.ops import occupancy, trace
from mitsuba_tpu_torch.scene import builtin, ir
from mitsuba_tpu_torch.models import sensor

torch.set_num_threads(1)

N = 4096
RENDER_TOL = 1e-4
RENDER_MAX_OFF = 1
CFG = dict(spp=4, max_depth=3, seed=0, occupancy_shadows=True)


@pytest.fixture(scope="module")
def cornell():
    jscene, jcam = jb.cornell_box(width=8, height=8)
    jscene = jocc.attach(jscene, res=128)
    return (jscene, jcam, ir.from_jax(jscene, device="cpu"),
            sensor.camera_from_jax(jcam, device="cpu"))


def _segments(seed, lo=-0.2, hi=1.2):
    """N segments between random points in and around the unit box."""
    rs = np.random.RandomState(seed)
    a = rs.uniform(lo, hi, (N, 3)).astype(np.float32)
    b = rs.uniform(lo, hi, (N, 3)).astype(np.float32)
    d = b - a
    dist = np.linalg.norm(d, axis=1).astype(np.float32)
    return a, (d / dist[:, None]).astype(np.float32), dist


def test_grid_bit_for_bit(cornell):
    jscene, _, scene, _ = cornell
    jom = jscene.occupancy
    for om in (scene.occupancy, occupancy.build(np.asarray(jscene.vertices),
                                                np.asarray(jscene.indices), device="cpu"),
               occupancy.attach(builtin.cornell_box(8, 8, device="cpu")[0]).occupancy):
        assert om.grid.dtype == torch.uint8 and om.res == jom.res == 128
        for f in ("grid", "box_min", "inv_extent"):
            assert np.array_equal(getattr(om, f).numpy(), np.asarray(getattr(jom, f))), f
    assert 0 < int(scene.occupancy.grid.sum()) < 128 ** 3 // 4


def test_grid_of_a_mesh_bit_for_bit():
    """A finer mesh (displaced_sphere_mesh(48, 48), some 4,500 triangles)
    at res 64."""
    verts, tris = builtin.displaced_sphere_mesh(48, 48)[:2]
    jom = jocc.build(verts, tris, res=64)
    om = occupancy.build(verts, tris, res=64, device="cpu")
    assert om.res == 64
    for f in ("grid", "box_min", "inv_extent"):
        assert np.array_equal(getattr(om, f).numpy(), np.asarray(getattr(jom, f))), f


@pytest.mark.parametrize("march_lanes", [occupancy.MARCH_LANES, 1000])
def test_occluded_bit_for_bit(cornell, march_lanes, monkeypatch):
    """4,096 segments in and around the box, the lane chunk at its default
    and at 1,000 (five chunks, the last partial)."""
    monkeypatch.setattr(occupancy, "MARCH_LANES", march_lanes)
    jscene, _, scene, _ = cornell
    a, d, dist = _segments(0)
    ref = np.asarray(jocc.occluded(jscene.occupancy, jnp.asarray(a), jnp.asarray(d),
                                   jnp.asarray(dist)))
    got = occupancy.occluded(scene.occupancy, torch.from_numpy(a), torch.from_numpy(d),
                             torch.from_numpy(dist))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), ref)
    assert 0.2 < ref.mean() < 0.95
    assert occupancy.occluded(scene.occupancy, *(torch.zeros((0, 3)),) * 2,
                              torch.zeros((0,))).shape == (0,)


def test_from_jax_and_config_carry_the_map(cornell):
    jscene, _, scene, _ = cornell
    assert isinstance(scene.occupancy, occupancy.OccupancyMap)
    assert scene.detach().occupancy.grid is not None
    assert ir.from_jax(jb.cornell_box(4, 4)[0], device="cpu").occupancy is None
    cfg = common.config_from_jax(jcom.RenderConfig(**CFG))
    assert cfg == common.RenderConfig(**CFG)


def test_shadow_dispatch(cornell):
    """shadow_blocked marches the map only where asked and present;
    closest_and_any then decomposes into the closest hit and the march."""
    _, _, scene, _ = cornell
    a, d, dist = (torch.from_numpy(x) for x in _segments(1, 0.05, 0.95))
    exact = trace.any_hit(scene, a, d, dist)
    marched = occupancy.occluded(scene.occupancy, a, d, dist)
    assert not torch.equal(exact, marched)
    assert torch.equal(trace.shadow_blocked(scene, a, d, dist), exact)
    assert torch.equal(trace.shadow_blocked(scene, a, d, dist, True), marched)
    plain = scene.replace(occupancy=None)
    assert torch.equal(trace.shadow_blocked(plain, a, d, dist, True), exact)
    its, blocked = trace.closest_and_any(scene, a, d, None, a, d, dist, True)
    assert torch.equal(blocked, marched)
    assert torch.equal(its.prim, trace.closest_hit(scene, a, d).prim)
    # the approximation agrees with the exact query on most segments
    # (tests/test_occupancy.py's bar)
    assert (exact == marched).float().mean() > 0.9


RENDERS = {
    "path": (jpath.li, path.li),
    "direct": (jdirect.li, direct.li),
    "bdpt": (jbdpt.li, bdpt.li),
}


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_with_the_map_matches_jax(cornell, name):
    jscene, jcam, scene, cam = cornell
    jli, li = RENDERS[name]
    ref = np.asarray(jcom.render_jit(jscene, jcam, jli, jcom.RenderConfig(**CFG)))
    img = common.render(scene, cam, li, common.RenderConfig(**CFG)).numpy()
    off = (np.abs(img - ref) > RENDER_TOL + RENDER_TOL * np.abs(ref)).any(-1)
    assert off.sum() <= RENDER_MAX_OFF, (np.argwhere(off), np.abs(img - ref).max())
    exact = common.render(scene, cam, li, common.RenderConfig(
        **{**CFG, "occupancy_shadows": False})).numpy()
    assert not np.array_equal(img, exact)
    assert abs(img.mean() - exact.mean()) < 0.15 * exact.mean()


def test_wavefront_with_the_map_equals_path(cornell):
    """The regenerative wavefront reads the flag at both shadow sites: the
    same image as path.li with the map."""
    _, _, scene, cam = cornell
    cfg = common.RenderConfig(**CFG)
    ref = common.render(scene, cam, path.li, cfg)
    for fuse in (False, True):
        img = wavefront.render(scene, cam, cfg, fuse=fuse)
        assert torch.allclose(img, ref, atol=1e-5), (fuse, (img - ref).abs().max())
