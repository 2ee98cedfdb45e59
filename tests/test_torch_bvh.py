"""Big-mesh intersection parity: the port's BVH build against the JAX
package's, its 4-wide table against the binary heap it collapses, its
ordered wide walk (the twin of csrc/bvh_intersect.cu) against the JAX
binary walk and against the TPU kernel it replaces (binned_intersect, in
Pallas interpret mode), and the fused entry against the separate ones."""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mitsuba_tpu.ops import bvh_traverse as jbt, intersect as jI
from mitsuba_tpu.scene import bvh as jbvh, ir as jir
from mitsuba_tpu_torch.ops import bvh_kernel
from mitsuba_tpu_torch.scene import builtin, bvh as tbvh, ir as tir

torch.set_num_threads(1)

# Twin against the jitted JAX walk: XLA:CPU contracts the Moller-Trumbore
# sums into FMAs (ROADMAP C8), so t may differ in its last bits and a ray
# grazing an edge may flip. Bars: valid, prim and blocked equal on >= 99.9%
# of rays, t within the key's quantisation (rtol 3e-5) where both hit.
# Measured on 2,048 rays per scene: 0 valid, prim or blocked flips; on the
# grid 9 t values differ in their last bits, on the sphere none.
WALK_AGREE = 0.999
T_RTOL = 3e-5
# Against the binned TPU kernel: tests/test_bvh.py:163-169's bars.
# Measured on 512 rays: 0 valid, prim or blocked differences, t at most
# 1.38e-5 relative apart (the key's 7 stolen bits).
BINNED_AGREE = 0.998


def jittered_grid():
    """tests/test_bvh.py's synthetic fixture: a 64x64 jittered grid of
    quads, 7,938 triangles."""
    g = 64
    xx, zz = np.meshgrid(np.linspace(-1, 1, g), np.linspace(-1, 1, g))
    yy = np.random.RandomState(0).uniform(-0.05, 0.05, xx.shape)
    v = np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.float32)
    f = []
    for i in range(g - 1):
        for j in range(g - 1):
            a = i * g + j
            f += [[a, a + 1, a + g], [a + 1, a + g + 1, a + g]]
    return v, np.asarray(f, np.int32)


def _scenes(name):
    """(JAX scene with bvh attached, the port's scene carried across)."""
    if name == "grid":
        v, f = jittered_grid()
        js = jir.build_scene(v, f, np.zeros(len(f), np.int32),
                             [{"type": jir.BSDF_DIFFUSE}])
    else:
        v, f, tm, mats, rad = builtin.displaced_sphere_mesh(40, 30)
        js = jir.build_scene(v, f, tm, mats, tri_radiance=rad)
    js = js.replace(bvh=jbvh.build_bvh(np.asarray(js.vertices), np.asarray(js.indices)))
    return js, tir.from_jax(js, device="cpu")


def chords(js, n, seed):
    """tests/test_bvh.py's random chords: from a point on the bounding
    sphere toward a point inside it; shadow limits 0.8 of the radius."""
    v = np.asarray(js.vertices)
    lo, hi = v.min(0), v.max(0)
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo) / 2)
    rs = np.random.RandomState(seed)
    a = rs.normal(size=(n, 3))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b = rs.normal(size=(n, 3))
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    o = center + a * radius
    d = center + b * radius * 0.5 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32),
            np.full((n,), radius * 0.8, np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("name", ["grid", "displaced_sphere"])
def test_build_bvh_equals_jax(name):
    """Array for array, and the kernel's leaf table holds the triangles
    (pads: the far degenerate one) the JAX walk gathers."""
    js, scene = _scenes(name)
    b = tbvh.build_bvh(np.asarray(js.vertices), np.asarray(js.indices), device="cpu")
    for f in ("aabb_min", "aabb_max", "miss_link", "tri_order"):
        ref = np.asarray(getattr(js.bvh, f))
        assert getattr(b, f).numpy().dtype == ref.dtype, f
        assert np.array_equal(getattr(b, f).numpy(), ref), f
    assert (b.n_internal, b.n_leaves) == (js.bvh.n_internal, js.bvh.n_leaves)
    p0, e1, e2, _ = jbt._leaf_tris(js, js.bvh, jnp.arange(js.bvh.n_leaves))
    rows = np.concatenate([np.asarray(x).reshape(-1, 3) for x in (p0, e1, e2)], 1).T
    assert np.array_equal(scene.bvh.leaf_tris.numpy().transpose(1, 0, 2).reshape(9, -1), rows)
    pad = np.asarray(js.bvh.tri_order) < 0
    assert pad.any() and not scene.bvh.leaf_opaque.numpy()[pad].any()
    nodes = scene.bvh.nodes.numpy()
    assert np.array_equal(nodes[:, :3], np.asarray(js.bvh.aabb_min))
    assert np.array_equal(nodes[:, 3:6], np.asarray(js.bvh.aabb_max))
    assert np.array_equal(nodes[:, 6].view(np.int32), np.asarray(js.bvh.miss_link))
    # the attached heap fields are views of the node table: one copy of the tree
    for f in ("aabb_min", "aabb_max", "miss_link"):
        assert (getattr(scene.bvh, f).untyped_storage().data_ptr()
                == scene.bvh.nodes.untyped_storage().data_ptr()), f


@pytest.mark.parametrize("name", ["grid", "displaced_sphere"])
def test_twin_matches_jax_walk(name):
    js, scene = _scenes(name)
    o, d, limit = chords(js, 2048, 1)
    ref = jbt.closest_hit(js, js.bvh, jnp.asarray(o), jnp.asarray(d))
    ref_blocked = np.asarray(jbt.any_hit(js, js.bvh, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(limit)))
    to, td, tl = _t(o, d, limit)
    its = bvh_kernel.closest_hit(scene, scene.bvh, to, td)
    blocked = bvh_kernel.any_hit(scene, scene.bvh, to, td, tl).numpy()
    valid = np.asarray(ref.valid)
    assert (valid == its.valid.numpy()).mean() >= WALK_AGREE
    both = valid & its.valid.numpy()
    assert (np.asarray(ref.prim)[both] == its.prim.numpy()[both]).mean() >= WALK_AGREE
    np.testing.assert_allclose(its.t.numpy()[both], np.asarray(ref.t)[both], rtol=T_RTOL)
    assert (ref_blocked == blocked).mean() >= WALK_AGREE
    # both outcomes occur, so the comparison means something
    assert 0.2 < both.mean() < 1.0 and 0.05 < blocked.mean() < 0.95


def test_twin_op_by_op_equals_jax_walk():
    """Against the JAX walk run op by op (no XLA fusion, so no FMA
    contraction), the twin's results are equal bit for bit: valid, t, prim
    and blocked. The twin visits the 4-wide tree nearest first and the JAX
    walk the binary tree left first; each box and triangle test is the same
    arithmetic, and on these rays no two hits tie in quantised t, so the
    order changes nothing."""
    js, scene = _scenes("displaced_sphere")
    o, d, limit = chords(js, 32, 2)
    with jax.disable_jit():
        ref = jbt.closest_hit(js, js.bvh, jnp.asarray(o), jnp.asarray(d))
        ref_blocked = jbt.any_hit(js, js.bvh, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(limit))
    to, td, tl = _t(o, d, limit)
    its = bvh_kernel.closest_hit(scene, scene.bvh, to, td)
    for k in ("valid", "t", "prim"):
        assert np.array_equal(np.asarray(getattr(ref, k)), getattr(its, k).numpy()), k
    assert np.array_equal(np.asarray(ref_blocked),
                          bvh_kernel.any_hit(scene, scene.bvh, to, td, tl).numpy())


@pytest.mark.parametrize("name", ["grid", "displaced_sphere", "one_leaf", "two_leaves"])
def test_wide_table_collapses_binary_heap(name):
    """Every child box of the wide table is its binary node's box bit for
    bit (the JAX build's arrays): a node's four grandchildren, or the root's
    two children where the binary depth is odd (the grid: 11 levels; the
    sphere: 10). Every leaf is referenced exactly once, every wide node but
    the root exactly once; empty slots carry an inverted box. Trees of one
    and two leaves too."""
    if name in ("grid", "displaced_sphere"):
        js, scene = _scenes(name)
    else:
        n_tris = 1 if name == "one_leaf" else 6
        v = np.random.RandomState(n_tris).uniform(-1, 1, (3 * n_tris, 3)).astype(np.float32)
        f = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
        js = jir.build_scene(v, f, np.zeros(n_tris, np.int32), [{"type": jir.BSDF_DIFFUSE}])
        js = js.replace(bvh=jbvh.build_bvh(v, f))
        scene = tir.from_jax(js, device="cpu")
    b = scene.bvh
    amin = np.asarray(js.bvh.aabb_min).view(np.int32)
    amax = np.asarray(js.bvh.aabb_max).view(np.int32)
    rec = b.wide.numpy().view(np.int32)
    depth = b.n_leaves.bit_length() - 1
    assert b.wide_depth == max(1, (depth + 1) // 2) and not rec[:, 28:].any()
    lo = rec[:, 0:12].reshape(-1, 3, 4).transpose(0, 2, 1)
    hi = rec[:, 12:24].reshape(-1, 3, 4).transpose(0, 2, 1)
    ref = rec[:, 24:28]
    source = {0: 0}        # wide node -> its binary node, found from the root
    leaves = []
    for i in range(rec.shape[0]):
        node = source[i]
        if depth == 0:
            kids = [0]
        elif node == 0 and depth % 2:
            kids = [1, 2]
        else:
            kids = [4 * node + 3 + c for c in range(4)]
        for c in range(4):
            r = int(ref[i, c])
            if c >= len(kids):
                assert r == tbvh.EMPTY
                assert (lo[i, c].view(np.float32) == tbvh.BIG).all()
                assert (hi[i, c].view(np.float32) == -tbvh.BIG).all()
                continue
            if r < 0:
                assert kids[c] - b.n_internal == -1 - r
                leaves.append(-1 - r)
            else:
                assert r not in source and r > i
                source[r] = kids[c]
            assert np.array_equal(lo[i, c], amin[kids[c]])
            assert np.array_equal(hi[i, c], amax[kids[c]])
    assert sorted(leaves) == list(range(b.n_leaves))
    assert sorted(source) == list(range(rec.shape[0]))


@pytest.mark.parametrize("name", ["one_leaf", "two_leaves", "displaced_sphere"])
def test_ordered_twin_matches_brute_force(name):
    """The ordered walk against the JAX brute force (the exact reference
    both share the key with) on small trees and the sphere, and its work
    counts: four box tests per wide fetch, a stack within its bound."""
    from mitsuba_tpu_torch.ops import bvh_traverse as tbt

    if name == "displaced_sphere":
        js, scene = _scenes(name)
    else:
        n_tris = 1 if name == "one_leaf" else 6
        rs = np.random.RandomState(n_tris)
        v = rs.uniform(-1, 1, (3 * n_tris, 3)).astype(np.float32)
        f = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
        js = jir.build_scene(v, f, np.zeros(n_tris, np.int32), [{"type": jir.BSDF_DIFFUSE}])
        js = js.replace(bvh=jbvh.build_bvh(v, f))
        scene = tir.from_jax(js, device="cpu")
    o, d, limit = chords(js, 1024, 6)
    ref = jI.intersect_brute(js, jnp.asarray(o), jnp.asarray(d))
    ref_blocked = np.asarray(jI.occluded_brute(js, jnp.asarray(o), jnp.asarray(d),
                                               jnp.asarray(limit)))
    to, td, tl = _t(o, d, limit)
    its = bvh_kernel.closest_hit(scene, scene.bvh, to, td)
    assert np.array_equal(np.asarray(ref.valid), its.valid.numpy())
    both = its.valid.numpy()
    assert both.any()
    assert (np.asarray(ref.prim)[both] == its.prim.numpy()[both]).mean() >= WALK_AGREE
    np.testing.assert_allclose(its.t.numpy()[both], np.asarray(ref.t)[both], rtol=T_RTOL)
    blocked = bvh_kernel.any_hit(scene, scene.bvh, to, td, tl).numpy()
    assert (ref_blocked == blocked).mean() >= WALK_AGREE
    stats = {}
    tbt.walk(scene.bvh, to, td, torch.full((1024,), 3e38), 1024, stats)
    assert stats["box_tests"] == 4 * stats["visits"] and stats["tri_tests"] > 0
    assert 1 <= stats["max_stack"] <= tbt.stack_depth(scene.bvh)


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


def test_twin_matches_binned_tpu_kernel():
    """Against the TPU kernel it replaces (binned closest_hit, any_hit and
    closest_and_any, interpret mode), on 512 random chords at
    tests/test_bvh.py's bars. The binned t is its exact re-test, the
    twin's the key's quantised t: rtol 1e-4 covers its 2^-16 step."""
    from mitsuba_tpu.ops import binned_intersect as bi

    js, scene = _scenes("grid")
    cl = bi.build_clusters(js)
    o, d, limit = chords(js, 512, 0)
    jo, jd, jl = jnp.asarray(o), jnp.asarray(d), jnp.asarray(limit)
    ref = _interp(bi.closest_hit)(js, cl, jo, jd)
    ref_blocked = np.asarray(_interp(bi.any_hit)(js, cl, jo, jd, jl))
    ref_f, ref_fb = _interp(bi.closest_and_any)(js, cl, jo, jd, jnp.full((512,), 3e37),
                                                jo, jd, jl)
    to, td, tl = _t(o, d, limit)
    its = bvh_kernel.closest_hit(scene, scene.bvh, to, td)
    blocked = bvh_kernel.any_hit(scene, scene.bvh, to, td, tl).numpy()
    for r, rb in ((ref, ref_blocked), (ref_f, np.asarray(ref_fb))):
        va, vb = np.asarray(r.valid), its.valid.numpy()
        assert (va == vb).mean() > BINNED_AGREE
        both = va & vb
        assert both.mean() > 0.3
        np.testing.assert_allclose(its.t.numpy()[both], np.asarray(r.t)[both],
                                   rtol=1e-4, atol=1e-5)
        assert (np.asarray(r.prim)[both] == its.prim.numpy()[both]).mean() > BINNED_AGREE
        assert (rb == blocked).mean() > BINNED_AGREE
    # and against brute force, the contract both kernels share
    brute = jI.intersect_brute(js, jo, jd)
    assert np.array_equal(np.asarray(brute.valid), its.valid.numpy())


def test_fused_equals_separate():
    """closest_and_any equals closest_hit + any_hit exactly, retired rays
    (tmax 0; a quarter of each class) included: they neither hit nor
    block (a port of tests/test_bvh.py:455-498)."""
    js, scene = _scenes("grid")
    o_c, d_c, _ = chords(js, 512, 3)
    v = np.asarray(js.vertices)
    center = (v.min(0) + v.max(0)) / 2
    radius = float(np.linalg.norm(v.max(0) - v.min(0)) / 2)
    b = -d_c
    o_s, d_s = (center + b * radius).astype(np.float32), d_c.copy()
    k = np.arange(512)
    tm_c = np.where(k % 4 == 0, 0.0, 3e37).astype(np.float32)
    tm_s = np.where(k % 4 == 1, 0.0, radius * 0.9).astype(np.float32)
    to_c, td_c, tt_c, to_s, td_s, tt_s = _t(o_c, d_c, tm_c, o_s, d_s, tm_s)
    bvh_kernel.reset_counts()
    its_f, blk_f = bvh_kernel.closest_and_any(scene, scene.bvh, to_c, td_c, tt_c,
                                              to_s, td_s, tt_s)
    its_s = bvh_kernel.closest_hit(scene, scene.bvh, to_c, td_c, tt_c)
    blk_s = bvh_kernel.any_hit(scene, scene.bvh, to_s, td_s, tt_s)
    assert bvh_kernel.PLAIN_CALLS == {"closest": 1, "any_hit": 1, "closest_and_any": 1}
    assert bvh_kernel.KERNEL_LAUNCHES == {"closest": 0, "any_hit": 0, "closest_and_any": 0}
    for f in ("valid", "t", "prim"):
        assert torch.equal(getattr(its_f, f), getattr(its_s, f)), f
    assert torch.equal(blk_f, blk_s)
    assert not blk_f[1::4].any() and not its_f.valid[0::4].any()
    assert its_f.valid.any() and blk_f.any()


def test_wrapper_routes_by_device():
    """A CPU tensor takes the plain walk; a tensor on any other non-CUDA
    device is refused, never sent down the plain path."""
    js, scene = _scenes("displaced_sphere")
    o, d, limit = _t(*chords(js, 16, 4))
    bvh_kernel.reset_counts()
    bvh_kernel.closest_key(scene.bvh, o, d, limit)
    bvh_kernel.blocked(scene.bvh, o, d, limit)
    assert bvh_kernel.PLAIN_CALLS == {"closest": 1, "any_hit": 1, "closest_and_any": 0}
    meta = [torch.empty(s, device="meta") for s in ((4, 3), (4, 3), (4,))]
    with pytest.raises(ValueError, match="CUDA"):
        bvh_kernel.closest_key(scene.bvh, *meta)
    with pytest.raises(ValueError, match="CUDA"):
        bvh_kernel.closest_and_any_key(scene.bvh, *meta, *meta)
    assert sum(bvh_kernel.KERNEL_LAUNCHES.values()) == 0


def test_trace_dispatch():
    """With a BVH on the CPU, trace walks it (at any size, as the JAX
    package's CPU route does); without one it takes brute force, above
    4,096 triangles too; closest_and_any decomposes off the card."""
    from mitsuba_tpu_torch.ops import brute_kernel, trace

    js, scene = _scenes("grid")
    o, d, limit = _t(*chords(js, 64, 5))
    bvh_kernel.reset_counts()
    brute_kernel.reset_counts()
    its = trace.closest_hit(scene, o, d)
    trace.closest_and_any(scene, o, d, None, o, d, limit)
    assert bvh_kernel.PLAIN_CALLS == {"closest": 2, "any_hit": 1, "closest_and_any": 0}
    assert not trace.fuses(scene)
    bare = scene.replace(bvh=None)
    ref = trace.closest_hit(bare, o, d)
    assert brute_kernel.PLAIN_CALLS["closest"] == 1 and bare.num_triangles > 4096
    assert torch.equal(its.valid, ref.valid) and torch.equal(its.prim[its.valid],
                                                             ref.prim[ref.valid])


def test_displaced_sphere_is_the_bench_fixture():
    """builtin.displaced_sphere is bench.py's big-mesh scene: the same
    70,034 triangles in the same order, floor, light, material and
    camera."""
    import bench

    js, jc = bench._bigmesh_scene(128, 128)
    scene, cam = builtin.displaced_sphere(device="cpu")
    assert scene.num_triangles == js.num_triangles == 70_034
    for f in ("vertices", "indices", "normals", "tri_material", "tri_emitter"):
        assert np.array_equal(getattr(scene, f).numpy(), np.asarray(getattr(js, f))), f
    for f in ("radiance", "tri_index", "tri_cdf"):
        assert np.array_equal(getattr(scene.emitters, f).numpy(),
                              np.asarray(getattr(js.emitters, f))), f
    assert np.array_equal(scene.materials.reflectance.numpy(),
                          np.asarray(js.materials.reflectance))
    assert np.array_equal(cam.to_world.numpy(), np.asarray(jc.to_world))
    assert float(cam.fov_x) == float(jc.fov_x) and (cam.width, cam.height) == (128, 128)
