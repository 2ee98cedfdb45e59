"""Brute-force intersection parity: the port's plain closest hit and any-hit
against the JAX package's VPU form (bit for bit) and against the Pallas
GEMM kernel in interpret mode (within the key's t quantisation), plus
surface_interaction."""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mitsuba_tpu.ops import intersect as jI
from mitsuba_tpu.scene import builtin as jb, ir as jir
from mitsuba_tpu_torch.ops import brute_kernel, intersect as tI
from mitsuba_tpu_torch.scene import ir as tir

torch.set_num_threads(1)


def random_tri_scene(n_tris, seed, null_frac=0.0):
    """tests/test_bvh.py's random soup; null_frac of the triangles get the
    null BSDF (index-matched interfaces that must not block shadows)."""
    rs = np.random.RandomState(seed)
    base = rs.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = rs.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    e2 = rs.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    verts = np.concatenate([base, base + e1, base + e2], 0)
    tris = np.stack([np.arange(n_tris), np.arange(n_tris) + n_tris,
                     np.arange(n_tris) + 2 * n_tris], -1).astype(np.int32)
    tri_mat = (rs.uniform(size=n_tris) < null_frac).astype(np.int32)
    return jir.build_scene(verts, tris, tri_mat,
                           [{"type": jir.BSDF_DIFFUSE}, {"type": jir.BSDF_NULL}])


def random_rays(n, seed, jscene, lo=-2.0, hi=2.0, center=(0.0, 0.0, 0.0)):
    """Random origins; half the rays aim at a random point of a random
    triangle (so even a 3-triangle scene is hit), half go anywhere."""
    rs = np.random.RandomState(seed)
    o = (rs.uniform(lo, hi, (n, 3)) + np.asarray(center)).astype(np.float32)
    v = np.asarray(jscene.vertices)[np.asarray(jscene.indices)]
    tri = v[rs.randint(0, len(v), n)]
    b = rs.dirichlet((1.0, 1.0, 1.0), n)
    target = np.einsum("nk,nkc->nc", b, tri)
    d = np.where(np.arange(n)[:, None] % 2 == 0, target - o,
                 rs.normal(size=(n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = rs.uniform(0.5, 4.0, (n,)).astype(np.float32)
    return o, d, tmax


def cornell_primary_rays():
    from mitsuba_tpu.models import sensor as jsens

    scene, cam = jb.cornell_box(width=32, height=32)
    rs = np.random.RandomState(5)
    px = rs.uniform(0, 32, 2048).astype(np.float32)
    py = rs.uniform(0, 32, 2048).astype(np.float32)
    o, d, _ = jsens.sample_rays(cam, jnp.asarray(px), jnp.asarray(py),
                                jnp.zeros((2048, 2)))
    tmax = rs.uniform(0.5, 3.0, (2048,)).astype(np.float32)
    return scene, np.array(o), np.array(d), tmax


def _case(name):
    if name == "cornell":
        return cornell_primary_rays()
    if name == "sphere_shadow":
        scene, _, _ = jb.sphere_shadow(nu=24, nv=24, attach_bvh=False)
        return (scene,) + random_rays(1024, 11, scene, -0.5, 0.5, (0.0, 1.0, 0.0))
    n_tris, null_frac = {"rand3": (3, 0.0), "rand500": (500, 0.0),
                         "rand500_null": (500, 0.3)}[name]
    scene = random_tri_scene(n_tris, n_tris, null_frac)
    return (scene,) + random_rays(1024, n_tris, scene)


@pytest.mark.parametrize("name", ["cornell", "rand3", "rand500",
                                  "rand500_null", "sphere_shadow"])
def test_plain_brute_equals_jax_vpu(name):
    """Same operations in the same order: valid, t, prim and blocked are
    equal. JAX runs op by op (disable_jit): under jit XLA:CPU contracts
    a*b+c into FMAs, which the reference VPU form does not intend and the
    port's CUDA kernel is built without."""
    jscene, o, d, tmax = _case(name)
    scene = tir.from_jax(jscene, device="cpu")
    with jax.disable_jit():
        ref = jI.intersect_brute(jscene, jnp.asarray(o), jnp.asarray(d))
        ref_blocked = jI.occluded_brute(jscene, jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(tmax))
    its = tI.intersect_brute(scene, torch.from_numpy(o), torch.from_numpy(d))
    blocked = tI.occluded_brute(scene, torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(tmax))
    assert np.array_equal(np.asarray(ref.valid), its.valid.numpy())
    assert np.array_equal(np.asarray(ref.t), its.t.numpy())
    assert np.array_equal(np.asarray(ref.prim), its.prim.numpy())
    assert np.array_equal(np.asarray(ref_blocked), blocked.numpy())
    # both outcomes occur, so the comparison means something
    assert 0 < its.valid.sum() < len(o) or name == "cornell"
    assert 0 < blocked.sum() < len(o)
    if name == "rand500_null":
        # null triangles are hit by closest rays but block no shadow ray
        assert not np.asarray(jscene.tri_opaque)[its.prim.numpy()[its.valid.numpy()]].all()


def _interp(fn):
    """Run a Pallas kernel in interpret mode, as tests/test_bvh.py does."""
    import jax.experimental.pallas as plmod
    orig = plmod.pallas_call

    def call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    def wrapper(*a, **k):
        with mock.patch.object(plmod, "pallas_call", call):
            return fn(*a, **k)
    return wrapper


def test_plain_brute_matches_pallas_kernel():
    """Against the TPU kernel itself (interpret mode). Its GEMM form rounds
    differently from direct Moller-Trumbore, so: valid equal, t within the
    key quantisation (rtol 3e-5), prim equal or t-tied (tests/test_bvh.py's
    bar), blocked equal."""
    from mitsuba_tpu.ops import pallas_intersect

    jscene = random_tri_scene(600, 600)
    o, d, tmax = random_rays(512, 600, jscene)
    key, base = _interp(pallas_intersect.closest_key)(
        jscene, jnp.asarray(o), jnp.asarray(d), jnp.full((512,), 3.0e38), 128)
    ref = jI._finish_closest(jscene, key, base, 512)
    ref_blocked = _interp(pallas_intersect.any_hit)(
        jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))

    scene = tir.from_jax(jscene, device="cpu")
    its = tI.intersect_brute(scene, torch.from_numpy(o), torch.from_numpy(d))
    blocked = tI.occluded_brute(scene, torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(tmax))
    valid = np.asarray(ref.valid)
    assert np.array_equal(valid, its.valid.numpy())
    assert valid.sum() > 50
    rt, t = np.asarray(ref.t)[valid], its.t.numpy()[valid]
    assert np.allclose(rt, t, rtol=3e-5)
    same = np.asarray(ref.prim)[valid] == its.prim.numpy()[valid]
    assert np.all(same | np.isclose(rt, t, rtol=3e-5))
    assert np.array_equal(np.asarray(ref_blocked), blocked.numpy())


def test_surface_interaction_matches_jax():
    jscene, o, d, _ = cornell_primary_rays()
    scene = tir.from_jax(jscene, device="cpu")
    ref_its = jI.intersect_brute(jscene, jnp.asarray(o), jnp.asarray(d))
    ref = jI.surface_interaction(jscene, jnp.asarray(o), jnp.asarray(d), ref_its)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    si = tI.surface_interaction(scene, to, td, tI.intersect_brute(scene, to, td))
    for k in ("p", "ng", "ns", "uv", "wi_world"):
        np.testing.assert_allclose(si[k].numpy(), np.asarray(ref[k]), atol=1e-6,
                                   err_msg=k)
    for k in ("mat", "emitter"):
        assert np.array_equal(si[k].numpy(), np.asarray(ref[k])), k


def test_closest_and_any_matches_jax():
    """trace.closest_and_any (decomposed form) on two independent ray sets:
    closest hit and blocked equal to the JAX package's dispatcher."""
    from mitsuba_tpu.ops import trace as jT
    from mitsuba_tpu_torch.ops import trace as tT

    jscene, o_c, d_c, _ = _case("rand500_null")
    o_s, d_s, tmax_s = random_rays(1024, 77, jscene)
    with jax.disable_jit():
        ref, ref_blocked = jT.closest_and_any(
            jscene, jnp.asarray(o_c), jnp.asarray(d_c), None,
            jnp.asarray(o_s), jnp.asarray(d_s), jnp.asarray(tmax_s))
    its, blocked = tT.closest_and_any(
        tir.from_jax(jscene, device="cpu"), torch.from_numpy(o_c), torch.from_numpy(d_c), None,
        torch.from_numpy(o_s), torch.from_numpy(d_s), torch.from_numpy(tmax_s))
    for k in ("valid", "t", "prim"):
        assert np.array_equal(np.asarray(getattr(ref, k)), getattr(its, k).numpy()), k
    assert np.array_equal(np.asarray(ref_blocked), blocked.numpy())
    assert 0 < blocked.sum() < len(o_s)


def test_wrapper_routes_by_device():
    """A CPU tensor takes the plain version and counts it; a tensor on any
    other non-CUDA device is refused rather than sent down the plain path."""
    jscene, o, d, tmax = _case("rand3")
    scene = tir.from_jax(jscene, device="cpu")
    tris = tI.tri_soa(scene)
    brute_kernel.reset_counts()
    brute_kernel.closest_key(tris, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(tmax))
    brute_kernel.any_hit(tris, scene.tri_opaque, torch.from_numpy(o),
                         torch.from_numpy(d), torch.from_numpy(tmax))
    assert brute_kernel.PLAIN_CALLS == {"closest": 1, "any_hit": 1}
    assert brute_kernel.KERNEL_LAUNCHES == {"closest": 0, "any_hit": 0}
    meta = [torch.empty(s, device="meta") for s in ((9, 3), (4, 3), (4, 3), (4,))]
    with pytest.raises(ValueError, match="CUDA"):
        brute_kernel.closest_key(*meta)
    assert brute_kernel.KERNEL_LAUNCHES == {"closest": 0, "any_hit": 0}
