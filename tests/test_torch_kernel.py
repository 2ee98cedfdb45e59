"""The CUDA kernels (brute force, BVH walk) against their plain PyTorch
versions on the card, alone and inside a reverse-mode step, and the kernel
build. Imports no JAX, so the card's tests run
where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernel.py
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from mitsuba_tpu_torch import _build
from mitsuba_tpu_torch.ops import brute_kernel as bk, bvh_kernel as bvk, bvh_traverse, intersect
from mitsuba_tpu_torch.scene import builtin

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rays(n, seed, dev, lo=-0.2, hi=1.2):
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    limit = rs.uniform(0.05, 2.0, n).astype(np.float32)
    return (torch.as_tensor(a, device=dev) for a in (o, d, limit))


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["cornell", "sphere_shadow"])
def test_kernel_equals_plain_on_card(cuda, scene_name):
    """Built with --fmad=false, the kernel rounds as the plain version does:
    (key, chunk_base) and blocked agree bit for bit, and the wrapper counts
    the launches."""
    if scene_name == "cornell":
        scene = builtin.cornell_box(device=cuda)[0]
    else:
        scene = builtin.sphere_shadow(24, 24, device=cuda)[0]
    tris = intersect.tri_soa(scene)
    o, d, limit = _rays(50_000, 0, cuda)
    tmax = torch.full((50_000,), 3.0e38, device=cuda)
    bk.reset_counts()
    key, base = bk.closest_key(tris, o, d, tmax)
    blocked = bk.any_hit(tris, scene.tri_opaque, o, d, limit)
    assert bk.KERNEL_LAUNCHES == {"closest": 1, "any_hit": 1}
    assert bk.PLAIN_CALLS == {"closest": 0, "any_hit": 0}
    pkey, pbase = bk.closest_key_plain(tris, o, d, tmax)
    assert torch.equal(key, pkey) and torch.equal(base, pbase)
    assert torch.equal(blocked, bk.any_hit_plain(tris, scene.tri_opaque, o, d, limit))
    assert 0 < int(blocked.sum()) < 50_000


def _rows(n_tris, seed):
    """(9, T) rows p0 e1 e2 of random triangles in [-1, 1]^3."""
    rs = np.random.RandomState(seed)
    p0 = rs.uniform(-1, 1, (n_tris, 3))
    e = rs.uniform(-0.3, 0.3, (n_tris, 6))
    return np.ascontiguousarray(np.concatenate([p0, e], 1).T, np.float32)


def _rays_at(rows, n, seed, dev):
    """Even rays aimed at a random point of a random triangle, odd ones in
    random directions, from [-1.2, 1.2]^3; limits in [0.05, 2)."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-1.2, 1.2, (n, 3))
    pick = rs.randint(0, rows.shape[1], n)
    b = rs.dirichlet((1.0, 1.0, 1.0), n)
    target = rows[0:3, pick].T + b[:, 1:2] * rows[3:6, pick].T + b[:, 2:3] * rows[6:9, pick].T
    d = np.where(np.arange(n)[:, None] % 2 == 0, target - o, rs.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    limit = rs.uniform(0.05, 2.0, n)
    return (torch.as_tensor(a.astype(np.float32), device=dev) for a in (o, d, limit))


def _brute_equals_plain(rows, opaque, n, seed, dev, lanes):
    tris = torch.as_tensor(rows, device=dev)
    opaque = torch.as_tensor(opaque, device=dev)
    o, d, limit = _rays_at(rows, n, seed, dev)
    tmax = torch.full((n,), 3.0e38, device=dev)
    key, base = bk.closest_key(tris, o, d, tmax, lanes=lanes)
    blocked = bk.any_hit(tris, opaque, o, d, limit, lanes=lanes)
    pkey, pbase = bk.closest_key_plain(tris, o, d, tmax)
    assert torch.equal(key, pkey) and torch.equal(base, pbase)
    assert torch.equal(blocked, bk.any_hit_plain(tris, opaque, o, d, limit))
    return pkey, pbase


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("n_tris", [1, 31, 32, 33, 1156, 4096, 7000])
def test_brute_edges_equal_plain(cuda, n_tris, lanes):
    """Every lane count (and the launcher's choice) at scene sizes around a
    warp and up to one shared-memory tile; 7,000 triangles exceed one tile
    and take the tiled loop. 10,007 rays fill no block and no lane group
    evenly; the opacity mask has holes."""
    rows = _rows(n_tris, n_tris)
    opaque = np.random.RandomState(n_tris).uniform(size=n_tris) < 0.6
    _brute_equals_plain(rows, opaque, 10_007, n_tris, cuda, lanes)
    config = bk.LAST_CONFIG["any_hit"]
    assert (config["tile"] < n_tris) == (n_tris == 7000)
    assert lanes is None or config["lanes"] == lanes


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 1, 8])
def test_brute_ties_across_chunks_take_the_lowest(cuda, lanes):
    """The same 128 triangles in three chunks: every hit ties in key across
    the chunks, and the first chunk (chunk_base 0) must win, as in the
    chunked reduction."""
    one = _rows(128, 11)
    rows = np.concatenate([one, one, one], 1)
    key, base = _brute_equals_plain(rows, np.ones(384, bool), 4_099, 11, cuda, lanes)
    hit = (key & ~127) != intersect.MISS_BITS
    assert bool(hit.any()) and not bool(base[hit].any())


@pytest.mark.cuda
def test_kernel_refuses_bad_input(cuda):
    scene = builtin.cornell_box(device=cuda)[0]
    tris = intersect.tri_soa(scene)
    o, d, limit = _rays(64, 1, cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        bk.closest_key(tris, o.double(), d, limit)
    with pytest.raises(ValueError, match="contiguous float32"):
        bk.closest_key(tris, o.T.contiguous().T, d, limit)
    with pytest.raises(ValueError, match="lanes"):
        bk.closest_key(tris, o, d, limit, lanes=3)


@pytest.mark.cuda
def test_bvh_kernel_equals_plain_on_card(cuda):
    """The BVH walk, built with --fmad=false, equals its plain twin bit for
    bit in all three entries (a quarter of the rays retired, tmax 0), and
    the fused launch equals the two separate ones."""
    scene, _ = builtin.displaced_sphere(96, 64, device=cuda)
    bvh = scene.bvh
    n = 40_000
    o, d, limit = _rays(n, 2, cuda, -2.0, 2.0)
    o2, d2, _ = _rays(n, 3, cuda, -2.0, 2.0)
    tmax = torch.where(torch.arange(n, device=cuda) % 4 == 0, 0.0, 3.0e38)
    bvk.reset_counts()
    key, base = bvk.closest_key(bvh, o, d, tmax)
    blocked = bvk.blocked(bvh, o2, d2, limit)
    fkey, fbase, fblocked = bvk.closest_and_any_key(bvh, o, d, tmax, o2, d2, limit)
    assert bvk.KERNEL_LAUNCHES == {"closest": 1, "any_hit": 1, "closest_and_any": 1}
    assert sum(bvk.PLAIN_CALLS.values()) == 0
    pkey, pbase, _ = bvh_traverse.walk(bvh, o, d, tmax, n)
    pblocked = bvh_traverse.walk(bvh, o2, d2, limit, 0)[2]
    assert torch.equal(key, pkey) and torch.equal(base, pbase)
    assert torch.equal(blocked, pblocked)
    assert torch.equal(fkey, key) and torch.equal(fbase, base)
    assert torch.equal(fblocked, blocked)
    hit = bvh_traverse.decode(bvh, key, base).valid
    assert 0 < int(hit.sum()) < n and not hit[0::4].any()
    assert 0 < int(blocked.sum()) < n


def _grazing(n, seed, dev):
    """Rays that skim the displaced sphere (radius 1 +- 0.15): from 3 units
    back along a tangent at a height of 0.95-1.15 over a random point of
    the unit sphere; a quarter of the closest rays retired (tmax 0) and a
    quarter of the shadow rays (limit 0)."""
    rs = np.random.RandomState(seed)
    u = rs.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    t = np.cross(u, rs.normal(size=(n, 3)))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    o = rs.uniform(0.95, 1.15, (n, 1)) * u - 3.0 * t
    k = np.arange(n)
    tm = np.where(k % 4 == 0, 0.0, 3.0e38)
    limit = np.where(k % 4 == 1, 0.0, 6.0)
    return (torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
            for a in (o, t, tm, o[::-1], t[::-1], limit))


@pytest.mark.cuda
def test_bvh_kernel_grazing_rays_equal_plain(cuda):
    """Grazing rays along the displaced sphere push the walk's stack deep;
    all three entries equal the twin bit for bit, retired lanes included."""
    scene, _ = builtin.displaced_sphere(96, 64, device=cuda)
    bvh = scene.bvh
    n = 20_000
    o, d, tm, o2, d2, limit = _grazing(n, 4, cuda)
    key, base = bvk.closest_key(bvh, o, d, tm)
    blocked = bvk.blocked(bvh, o2, d2, limit)
    fkey, fbase, fblocked = bvk.closest_and_any_key(bvh, o, d, tm, o2, d2, limit)
    stats = {}
    pkey, pbase, _ = bvh_traverse.walk(bvh, o, d, tm, n, stats)
    pblocked = bvh_traverse.walk(bvh, o2, d2, limit, 0, stats)[2]
    assert torch.equal(key, pkey) and torch.equal(base, pbase)
    assert torch.equal(fkey, pkey) and torch.equal(fbase, pbase)
    assert torch.equal(blocked, pblocked) and torch.equal(fblocked, pblocked)
    assert stats["max_stack"] > 2 * bvh.wide_depth
    assert stats["max_stack"] <= bvh_traverse.stack_depth(bvh) <= bvk.KERNEL_STACK


@pytest.mark.cuda
def test_bvh_kernel_refuses_bad_input(cuda):
    scene, _ = builtin.displaced_sphere(24, 16, device=cuda)
    o, d, limit = _rays(64, 1, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bvk.closest_key(scene.bvh, o.double(), d, limit)
    with pytest.raises(ValueError, match="contiguous"):
        bvk.blocked(scene.bvh, o, d.T.contiguous().T, limit)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grads_agree(grads, plain):
    """Equal up to summation order: the splat's index_put accumulation and
    the gathers' backward run on atomics, whose order varies. Bar: 1e-4 of
    each tensor's largest entry."""
    for g, p in zip(grads, plain):
        assert torch.isfinite(g).all() and p.abs().max() > 0
        assert (g - p).abs().max() <= 1e-4 * p.abs().max(), (g - p).abs().max()


@pytest.mark.cuda
def test_grad_through_brute_kernel_equals_plain(cuda):
    """A reverse-mode step through B1 (Cornell, every closest, shadow and
    edge query of render_grad) gives the gradient its plain twin gives."""
    from mitsuba_tpu_torch.integrators import boundary, common

    cs = _chip_smoke()
    scene, cam = builtin.cornell_box(16, 16, device=cuda)
    cfg = common.RenderConfig(spp=2, max_depth=3, seed=1)
    bc = boundary.BoundaryConfig(n_edge=2, n_primary=1024)
    bk.reset_counts()
    grads = cs.render_grads(scene, cam, cfg, bc)
    assert min(bk.KERNEL_LAUNCHES.values()) > 0 and sum(bk.PLAIN_CALLS.values()) == 0
    with cs.plain_patched(bk):
        plain = cs.render_grads(scene, cam, cfg, bc)
    _grads_agree(grads, plain)


@pytest.mark.cuda
def test_grad_through_bvh_kernel_equals_plain(cuda):
    """The same through B2: sphere_shadow(48, 48), 4,612 triangles with the
    BVH attached, above the brute-force limit, so every query walks it."""
    from mitsuba_tpu_torch.integrators import boundary, common

    cs = _chip_smoke()
    scene, cam, _ = builtin.sphere_shadow(48, 48, width=16, height=16, attach_bvh=True,
                                          device=cuda)
    cfg = common.RenderConfig(spp=2, max_depth=2, seed=1)
    bc = boundary.BoundaryConfig(n_edge=2, n_primary=1024)
    bvk.reset_counts()
    bk.reset_counts()
    grads = cs.render_grads(scene, cam, cfg, bc)
    assert bvk.KERNEL_LAUNCHES["closest"] > 0 and bvk.KERNEL_LAUNCHES["any_hit"] > 0
    assert sum(bk.KERNEL_LAUNCHES.values()) == 0 and sum(bvk.PLAIN_CALLS.values()) == 0
    with cs.plain_patched(bvk):
        plain = cs.render_grads(scene, cam, cfg, bc)
    _grads_agree(grads, plain)


@pytest.mark.parametrize("mod", [bk, bvk], ids=["brute", "bvh"])
def test_kept_launches_rerun_through_twins(mod):
    """The smoke run's check of a gradient step's launches against the
    plain twins: every entry keeps its first call at each batch size, the
    rerun in chunks of rays agrees, and a kept result changed in one lane
    is caught. On the CPU the entries take the plain route."""
    from mitsuba_tpu_torch.integrators import boundary, common

    cs = _chip_smoke()
    if mod is bk:
        scene, cam = builtin.cornell_box(8, 8, device="cpu")
    else:
        scene, cam, _ = builtin.sphere_shadow(12, 12, width=8, height=8, attach_bvh=True,
                                              device="cpu")
    cfg = common.RenderConfig(spp=2, max_depth=2, seed=1)
    bc = boundary.BoundaryConfig(n_edge=2, n_primary=256)
    keeping, kept = cs.keeping_launches(mod)
    with keeping:
        cs.render_grads(scene, cam, cfg, bc)
    checked = cs.check_kept(mod, kept, chunk=100)
    assert set(checked) == {"closest_key", "any_hit" if mod is bk else "blocked"}
    assert all(len(v) >= 2 for v in checked.values()), checked   # camera and edge rays
    (entry, n), (_, outs) = max(kept.items(), key=lambda kv: kv[0][1])
    assert n > 100
    outs[0][n // 2] = ~outs[0][n // 2] if outs[0].dtype == torch.bool else outs[0][n // 2] + 1
    with pytest.raises(AssertionError, match=f"{entry} at {n} rays: 1 results differ"):
        cs.check_kept(mod, kept, chunk=100)


def test_build_flags_and_missing_compiler(monkeypatch, tmp_path):
    """The kernels are built for sm_90a without FMA contraction; without a
    CUDA toolkit the build raises rather than falling back."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "--fmad=false" in flags
    assert "fast_math" not in flags
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "/nonexistent/nvcc")
    with pytest.raises(FileNotFoundError):
        _build.build("brute_intersect")
    assert not list(tmp_path.iterdir())
