"""The compiled renders' capture and replay on the card: one capture serves
every pass of a progressive render, a second scene of the same shapes
renders its own image through the same graph, a capture that reads the
device back raises, the kernels' launches are counted per replay, the
graphs are shared by threads, and the replayed images equal the eager
ones: bit for bit where no atomics sum them, and where they do (the
Gaussian film's and the compaction ladder's `index_add_`) at ROADMAP
C31's rtol 1e-5 / atol 1e-6.

The film renderers' render_jit: ptracer, the light image and bre against
their eager renders at C31's bar, their launches per replay equal; the
Metropolis renderers (pssmlt, erpt, mlt with five and six kernels) under
torch's deterministic algorithms, where `index_add_` sums in a fixed
order: the first and the replayed call equal the eager render of the same
seed bit for bit (the generator, registered with each graph, advances as
the eager draws do), another seed differs, a second scene of the key
renders through the same graphs, MLT's kernel graphs replay in the eager
order; a draws hook raises ValueError. The sharded render_jit over two
gloo ranks sharing the card equals the one-process render at
tests/test_sharded.py's bar (C44). Imports no JAX, so the card's tests run
where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_jit_card.py
"""
import dataclasses
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from mitsuba_tpu_torch.film import film
from mitsuba_tpu_torch.integrators import (bdpt, bre, common, erpt, mlt, path, pssmlt, ptracer,
                                           wavefront)
from mitsuba_tpu_torch.models import medium
from mitsuba_tpu_torch.ops import brute_kernel, bvh_kernel
from mitsuba_tpu_torch.scene import builtin
from mitsuba_tpu_torch.utils import checkpoint, graphs

ATOMICS_RTOL, ATOMICS_ATOL = 1e-5, 1e-6
SHARDED_RTOL, SHARDED_ATOL = 1e-4, 1e-5     # tests/test_sharded.py (C44)
ROOT = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cache in (common._CHUNK_GRAPHS, wavefront._WAVEFRONT_GRAPHS, ptracer._GRAPHS,
                  bdpt._GRAPHS, bre._GRAPHS, pssmlt._GRAPHS, erpt._GRAPHS, mlt._GRAPHS):
        cache.clear()
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


# ---------------------------------------------------------------------------
# the film renderers
# ---------------------------------------------------------------------------

def _fog_box(dev, width=32):
    scene, cam = builtin.cornell_box(width, width, device=dev)
    return scene.replace(medium=medium.make_homogeneous([0.6] * 3, [0.05] * 3, g=0.0,
                                                        device=dev)), cam


FILM = {
    # name: (scene maker, jit render, eager render)
    "ptracer": (lambda dev: builtin.cornell_box(32, 32, device=dev),
                lambda s, c, k: ptracer.render_jit(s, c, k),
                lambda s, c, k: ptracer.render(s, c, k)),
    "bdpt": (lambda dev: builtin.cornell_box(32, 32, device=dev),
             bdpt.render_jit, bdpt.render),
    "bdpt_caustic": (lambda dev: builtin.caustic_box(32, 32, device=dev),
                     bdpt.render_jit, bdpt.render),
    "bre": (_fog_box, lambda s, c, k: bre.render_jit(s, c, k, n_paths=1 << 12, steps=6),
            lambda s, c, k: bre.render(s, c, k, n_paths=1 << 12, steps=6)),
}


@pytest.mark.parametrize("name", sorted(FILM))
def test_film_render_jit_replays_the_eager_render(cuda, name):
    """The first call captures, the second only replays; both images at
    C31's bar of the eager render (the splats' atomics), the replayed
    call's launches equal the eager render's."""
    make, jit, eager = FILM[name]
    scene, cam = make(cuda)
    cfg = common.RenderConfig(spp=8, spp_chunk=2, max_depth=3, seed=1)
    first = jit(scene, cam, cfg)
    captures = graphs.STATS["captures"]
    _reset()
    ref = eager(scene, cam, cfg)
    want = _counts()
    _reset()
    graphs.reset_counts()
    img = jit(scene, cam, cfg)
    assert graphs.STATS["captures"] == 0 and graphs.STATS["replays"] > 0 and captures >= 1
    assert _counts() == want and sum(want.values()) > 0
    for got in (first, img):
        torch.testing.assert_close(got, ref, atol=ATOMICS_ATOL, rtol=ATOMICS_RTOL)
    assert float(ref.mean()) > 0.0


@pytest.fixture
def deterministic():
    """index_add_ in a fixed order (a sort, not atomics), eager and in the
    graphs alike; warn only where an op has no such form."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


CHAINS = {
    # name: (scene maker, jit render, eager render, graphs per key)
    "pssmlt": (lambda dev, **kw: builtin.cornell_box(32, 32, device=dev, **kw),
               lambda s, c, k, **kw: pssmlt.render_jit(s, c, k, n_chains=1024, n_mutations=8,
                                                       n_bootstrap=4096, **kw),
               lambda s, c, k: pssmlt.render(s, c, k, n_chains=1024, n_mutations=8,
                                             n_bootstrap=4096), 1),
    "erpt": (lambda dev, **kw: builtin.cornell_box(32, 32, device=dev, **kw),
             lambda s, c, k, **kw: erpt.render_jit(s, c, k, n_chains=1024, chain_length=8,
                                                   n_bootstrap=4096, **kw),
             lambda s, c, k: erpt.render(s, c, k, n_chains=1024, chain_length=8,
                                         n_bootstrap=4096), 1),
    "mlt": (lambda dev, **kw: builtin.cornell_box(32, 32, device=dev, **kw),
            lambda s, c, k, **kw: mlt.render_jit(s, c, k, n_chains=1024, n_mutations=10,
                                                 n_bootstrap=4096, **kw),
            lambda s, c, k: mlt.render(s, c, k, n_chains=1024, n_mutations=10,
                                       n_bootstrap=4096), 5),
    "mlt_caustic": (lambda dev, **kw: builtin.caustic_box(32, 32, rough=False, device=dev,
                                                          **kw),
                    lambda s, c, k, **kw: mlt.render_jit(s, c, k, n_chains=1024,
                                                         n_mutations=12, n_bootstrap=4096,
                                                         **kw),
                    lambda s, c, k: mlt.render(s, c, k, n_chains=1024, n_mutations=12,
                                               n_bootstrap=4096), 6),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_replayed_chains_equal_the_eager_chains(cuda, deterministic, name):
    """The first call (each graph's first step eager, the rest replayed)
    and a replayed call equal the eager render of the same seed bit for
    bit; seed 2 renders another image through the same graphs."""
    make, jit, eager, n_graphs = CHAINS[name]
    scene, cam = make(cuda)
    cfg = common.RenderConfig(spp=1, max_depth=3, seed=1)
    ref = eager(scene, cam, cfg)
    first = jit(scene, cam, cfg)
    assert graphs.STATS["captures"] == n_graphs
    graphs.reset_counts()
    replayed = jit(scene, cam, cfg)
    assert graphs.STATS["captures"] == 0 and graphs.STATS["replays"] > 0
    assert torch.equal(first, ref) and torch.equal(replayed, ref) and float(ref.mean()) > 0
    other = jit(scene, cam, dataclasses.replace(cfg, seed=2))
    assert not torch.equal(other, ref)
    assert torch.equal(other, eager(scene, cam, dataclasses.replace(cfg, seed=2)))


@pytest.mark.parametrize("module", [pssmlt, mlt], ids=["pssmlt", "mlt"])
def test_seed_chains_on_card_equal_cpu(cuda, module):
    """ROADMAP C48: the chains' seeds from a 2^17-path bootstrap (the JAX
    defaults' size) are the CPU's, on every call: the luminance CDF is
    summed and searched on the host, where the card's scan of that length
    rounded otherwise from run to run."""
    import numpy as np

    rs = np.random.RandomState(3)
    lum = rs.exponential(1.0, 1 << 17).astype(np.float32) * (rs.uniform(size=1 << 17) < 0.6)
    pick = rs.uniform(size=1 << 15).astype(np.float32)
    want = module.seed_chains(torch.from_numpy(lum), torch.from_numpy(pick))
    for _ in range(3):
        got = module.seed_chains(torch.from_numpy(lum).to(cuda), torch.from_numpy(pick).to(cuda))
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", ["pssmlt", "mlt"])
def test_second_scene_through_the_same_chain_graphs(cuda, deterministic, name):
    make, jit, eager, _ = CHAINS[name]
    (a, cam), (b, _) = make(cuda), make(cuda, light_scale=2.0)
    cfg = common.RenderConfig(spp=1, max_depth=3, seed=1)
    img_a = jit(a, cam, cfg)
    graphs.reset_counts()
    img_b = jit(b, cam, cfg)
    assert graphs.STATS["captures"] == 0
    assert torch.equal(img_a, eager(a, cam, cfg)) and torch.equal(img_b, eager(b, cam, cfg))
    assert float(img_b.mean()) > 1.5 * float(img_a.mean())


def test_mlt_kernel_graphs_replay_in_order(cuda, monkeypatch):
    """Six kernel graphs (F's walks inside), replayed step % 6 in the eager
    order: the second call replays kernels 0..5, 0..5."""
    make, jit, _, _ = CHAINS["mlt_caustic"]
    scene, cam = make(cuda)
    cfg = common.RenderConfig(spp=1, max_depth=3, seed=1)
    jit(scene, cam, cfg)
    (entry,) = mlt._GRAPHS.entries.values()
    order = []
    for i, piece in enumerate(entry.pieces):
        monkeypatch.setattr(piece.graph, "replay",
                            lambda i=i, f=piece.graph.replay: (order.append(i), f())[1])
    jit(scene, cam, cfg)
    assert order == [i % 6 for i in range(12)]


@pytest.mark.parametrize("name", ["pssmlt", "erpt", "mlt"])
def test_draws_hook_raises_on_the_card(cuda, name):
    scene, cam = builtin.cornell_box(16, 16, device=cuda)
    cfg = common.RenderConfig(spp=1, max_depth=3)
    hook = lambda *a, **k: None   # noqa: E731
    with pytest.raises(ValueError, match="replayed"):
        if name == "mlt":
            mlt.render_jit(scene, cam, cfg, n_chains=64, n_mutations=5, draws=hook)
        else:
            {"pssmlt": pssmlt, "erpt": erpt}[name].render_jit(scene, cam, cfg, n_chains=64,
                                                                uniforms=hook)
    assert graphs.STATS["captures"] == 0


def test_sharded_render_jit_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """Two ranks sharing the card (gloo): render_sharded_jit over mesh
    (2, 1) with the box film and (1, 2) with the Gaussian film, each rank
    replaying its chunk graph on a second call (equal to the first: bit
    for bit on the box film, at C31's bar on the Gaussian film's atomics),
    against common.render at tests/test_sharded.py's bar."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    script = tmp_path / "ranks.py"
    script.write_text(textwrap.dedent(f"""\
        import sys
        import numpy as np
        import torch
        sys.path.insert(0, {str(ROOT)!r})
        from mitsuba_tpu_torch.integrators import common, path
        from mitsuba_tpu_torch.parallel import render_sharded as rs
        from mitsuba_tpu_torch.scene import builtin
        from mitsuba_tpu_torch.utils import graphs
        rank = int(sys.argv[1])
        dev, backend = rs.start_group("tcp://127.0.0.1:{port}", 2, rank)
        assert backend == "gloo" and dev.type == "cuda", (backend, dev)
        scene, cam = builtin.cornell_box(32, 32, device=dev)
        out = {{}}
        for name, sp, filt in (("box", 1, 0), ("gaussian", 2, 2)):
            mesh = rs.make_mesh(2, sp=sp, device=dev)
            cfg = common.RenderConfig(spp=8, spp_chunk=2, max_depth=3, seed=0, filter=filt)
            first = rs.render_sharded_jit(scene, cam, path.li, cfg, mesh)
            graphs.reset_counts()
            out[name] = rs.render_sharded_jit(scene, cam, path.li, cfg, mesh).cpu().numpy()
            assert graphs.STATS["captures"] == 0 and graphs.STATS["replays"] > 0
            # the Gaussian film splats with atomics: C31's bar there
            tol = (0.0, 0.0) if filt == 0 else ({ATOMICS_RTOL}, {ATOMICS_ATOL})
            assert torch.allclose(first.cpu(), torch.from_numpy(out[name]), *tol)
        if rank == 0:
            np.savez(sys.argv[2], **out)
        torch.distributed.destroy_process_group()
    """))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "o.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    import numpy as np

    got = np.load(tmp_path / "o.npz")
    scene, cam = builtin.cornell_box(32, 32, device=cuda)
    for name, filt in (("box", film.FILTER_BOX), ("gaussian", film.FILTER_GAUSSIAN)):
        cfg = common.RenderConfig(spp=8, spp_chunk=2, max_depth=3, seed=0, filter=filt)
        ref = common.render(scene, cam, path.li, cfg).cpu().numpy()
        np.testing.assert_allclose(got[name], ref, rtol=SHARDED_RTOL, atol=SHARDED_ATOL)
