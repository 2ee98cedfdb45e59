"""The compiled renders' capture and replay on the card: one capture serves
every pass of a progressive render, a second scene of the same shapes
renders its own image through the same graph, a capture that reads the
device back raises, the kernels' launches are counted per replay, the
graphs are shared by threads, and the replayed images equal the eager
ones: bit for bit where no atomics sum them, and where they do (the
Gaussian film's and the compaction ladder's `index_add_`) at ROADMAP
C31's rtol 1e-5 / atol 1e-6. Imports no JAX, so the card's tests run
where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_jit_card.py
"""
import dataclasses

import pytest
import torch

from mitsuba_tpu_torch.film import film
from mitsuba_tpu_torch.integrators import common, path, wavefront
from mitsuba_tpu_torch.ops import brute_kernel, bvh_kernel
from mitsuba_tpu_torch.scene import builtin
from mitsuba_tpu_torch.utils import checkpoint, graphs

ATOMICS_RTOL, ATOMICS_ATOL = 1e-5, 1e-6

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    common._CHUNK_GRAPHS.clear()
    wavefront._WAVEFRONT_GRAPHS.clear()
    graphs.reset_counts()
    return torch.device("cuda", 0)


def _counts():
    return {**{f"brute_{k}": v for k, v in brute_kernel.KERNEL_LAUNCHES.items()},
            **{f"bvh_{k}": v for k, v in bvh_kernel.KERNEL_LAUNCHES.items()}}


def _reset():
    brute_kernel.reset_counts()
    bvh_kernel.reset_counts()


def test_one_capture_serves_four_passes(cuda):
    scene, cam = builtin.cornell_box(64, 64, device=cuda)
    cfg = common.RenderConfig(spp=4, spp_chunk=4, max_depth=4)
    for offset in (0, 4, 8, 12):
        img = common.render_jit(scene, cam, path.li, cfg, sample_offset=offset)
        assert torch.equal(img, common.render(scene, cam, path.li, cfg, sample_offset=offset))
    assert graphs.STATS == {"captures": 1, "replays": 3}
    state = checkpoint.render_progressive(scene, cam, path.li,
                                          dataclasses.replace(cfg, spp=16), 16, pass_spp=4)
    assert state.spp_done == 16 and graphs.STATS == {"captures": 1, "replays": 7}


@pytest.mark.parametrize("film_name", ["box", "gaussian"])
def test_second_scene_same_shapes(cuda, film_name):
    """The graph reads its own copies of the scene's tensors: a brighter
    light in a scene of the same shapes renders through the same capture
    and equals its own eager render."""
    a, cam = builtin.cornell_box(64, 64, device=cuda)
    b, _ = builtin.cornell_box(64, 64, light_scale=2.0, device=cuda)
    filt = film.FILTER_BOX if film_name == "box" else film.FILTER_GAUSSIAN
    cfg = common.RenderConfig(spp=8, spp_chunk=2, max_depth=4, filter=filt)
    img_a = common.render_jit(scene=a, cam=cam, li_fn=path.li, cfg=cfg)
    img_b = common.render_jit(b, cam, path.li, cfg)
    ref_a, ref_b = (common.render(s, cam, path.li, cfg) for s in (a, b))
    tol = dict(atol=0.0, rtol=0.0) if film_name == "box" else \
        dict(atol=ATOMICS_ATOL, rtol=ATOMICS_RTOL)
    torch.testing.assert_close(img_a, ref_a, **tol)
    torch.testing.assert_close(img_b, ref_b, **tol)
    assert img_b.mean() > 1.5 * img_a.mean()
    assert graphs.STATS == {"captures": 1, "replays": 7}


def test_failed_capture_raises(cuda):
    """An li that reads the device back cannot be captured: render_jit
    raises, with no eager render in the graph's place; the next render_jit
    captures and replays as usual."""
    scene, cam = builtin.cornell_box(32, 32, device=cuda)
    cfg = common.RenderConfig(spp=4, spp_chunk=2, max_depth=3)

    def li_reads_back(scene, cam, o, d, stream, cfg):
        out = path.li(scene, cam, o, d, stream, cfg)
        return out * float(out.mean() > -1.0)

    with pytest.raises(RuntimeError, match="capture failed"):
        common.render_jit(scene, cam, li_reads_back, cfg)
    assert graphs.STATS["captures"] == 0
    img = common.render_jit(scene, cam, path.li, cfg)
    assert torch.equal(img, common.render(scene, cam, path.li, cfg))
    assert graphs.STATS["captures"] == 1


def test_launches_counted_per_replay(cuda):
    """B1's launches through a warm graph (every chunk a replay) equal the
    eager render's."""
    scene, cam = builtin.cornell_box(64, 64, device=cuda)
    cfg = common.RenderConfig(spp=8, spp_chunk=2, max_depth=4)
    common.render_jit(scene, cam, path.li, cfg)
    _reset()
    common.render(scene, cam, path.li, cfg)
    eager = _counts()
    _reset()
    graphs.reset_counts()
    common.render_jit(scene, cam, path.li, cfg)
    assert graphs.STATS == {"captures": 0, "replays": 4}
    assert _counts() == eager and eager["brute_closest"] > 0


@pytest.mark.parametrize("case", ["cornell", "mesh_fused_compact"])
def test_wavefront_render_jit(cuda, case):
    """The wavefront through its step graphs equals the eager wavefront:
    Cornell through B1 bit for bit; a 4,516-triangle sphere (above the
    brute-force limit, so the BVH walk) fused and compacted through B2,
    whose ladder scatters the film with atomics."""
    if case == "cornell":
        scene, cam = builtin.cornell_box(64, 64, device=cuda)
        cfg, kw = common.RenderConfig(spp=8, max_depth=4), {}
    else:
        scene, cam = builtin.displaced_sphere(48, 48, 32, 32, device=cuda)
        cfg = common.RenderConfig(spp=8, max_depth=4, rr_depth=3)
        kw = dict(lanes_per_pixel=4, compact=True, fuse=True)
    wavefront.render_jit(scene, cam, cfg, **kw)
    _reset()
    ref = wavefront.render(scene, cam, cfg, **kw)
    eager = _counts()
    _reset()
    img = wavefront.render_jit(scene, cam, cfg, **kw)
    tol = dict(atol=0.0, rtol=0.0) if case == "cornell" else \
        dict(atol=ATOMICS_ATOL, rtol=ATOMICS_RTOL)
    torch.testing.assert_close(img, ref, **tol)
    assert _counts() == eager and sum(eager.values()) > 0
    if case != "cornell":
        assert eager["bvh_closest_and_any"] > 0 and eager["brute_closest"] == 0
    (entry,) = wavefront._WAVEFRONT_GRAPHS.entries.values()
    assert graphs.STATS["captures"] == len(entry.steps) == (1 if case == "cornell" else 3)


def test_threads_share_the_cache(cuda):
    """The CLI's -j renders scenes from a thread pool: two threads render
    two scenes of one key through the same graph, and a third loads a
    scene onto the card meanwhile; each image equals its eager render."""
    import concurrent.futures as cf

    scenes = [builtin.cornell_box(64, 64, light_scale=s, device=cuda) for s in (1.0, 2.0)]
    cfg = common.RenderConfig(spp=8, spp_chunk=2, max_depth=4)
    refs = [common.render(s, c, path.li, cfg) for s, c in scenes]

    def render(i):
        return [common.render_jit(*scenes[i], path.li, cfg) for _ in range(3)]

    with cf.ThreadPoolExecutor(max_workers=3) as pool:
        futures = [pool.submit(render, i) for i in (0, 1)]
        loads = pool.submit(lambda: [builtin.displaced_sphere(48, 48, 16, 16, device=cuda)
                                     for _ in range(3)])
        images = [f.result() for f in futures]
        loads.result()
    for imgs, ref in zip(images, refs):
        assert all(torch.equal(img, ref) for img in imgs)
    assert graphs.STATS["captures"] == 1
