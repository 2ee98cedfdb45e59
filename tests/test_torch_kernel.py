"""The brute-force CUDA kernel against its plain PyTorch version on the
card, and the kernel build. Imports no JAX, so the card's tests run
where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernel.py
"""
import numpy as np
import pytest
import torch

from mitsuba_tpu_torch import _build
from mitsuba_tpu_torch.ops import brute_kernel as bk, intersect
from mitsuba_tpu_torch.scene import builtin

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rays(n, seed, dev):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
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
