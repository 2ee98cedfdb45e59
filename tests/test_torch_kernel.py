"""The CUDA kernels (brute force, BVH walk) against their plain PyTorch
versions on the card, and the kernel build. Imports no JAX, so the card's tests run
where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernel.py
"""
import numpy as np
import pytest
import torch

from mitsuba_tpu_torch import _build
from mitsuba_tpu_torch.ops import brute_kernel as bk, bvh_kernel as bvk, bvh_traverse, intersect
from mitsuba_tpu_torch.scene import builtin

torch.set_num_threads(1)


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


@pytest.mark.cuda
def test_kernel_refuses_bad_input(cuda):
    scene = builtin.cornell_box(device=cuda)[0]
    tris = intersect.tri_soa(scene)
    o, d, limit = _rays(64, 1, cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        bk.closest_key(tris, o.double(), d, limit)
    with pytest.raises(ValueError, match="contiguous float32"):
        bk.closest_key(tris, o.T.contiguous().T, d, limit)


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


@pytest.mark.cuda
def test_bvh_kernel_refuses_bad_input(cuda):
    scene, _ = builtin.displaced_sphere(24, 16, device=cuda)
    o, d, limit = _rays(64, 1, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bvk.closest_key(scene.bvh, o.double(), d, limit)
    with pytest.raises(ValueError, match="contiguous"):
        bvk.blocked(scene.bvh, o, d.T.contiguous().T, limit)


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
