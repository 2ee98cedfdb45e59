"""The sharded render's compiled and cached entry,
`parallel.render_sharded_jit`, on the CPU (the card's capture and replay
is tests/test_torch_jit_card.py and `chip_smoke.py` [jit_sharded]).

On the CPU render_sharded_jit is render_sharded. One two-rank gloo group
(two spawned processes, as tests/test_torch_sharded.py's) renders the
16x16 Cornell box through both over mesh (2, 1) and (1, 2) with the box
film and (1, 2) with the Gaussian film: bit for bit alike, and each
within tests/test_sharded.py's rtol=1e-4, atol=1e-5 of the port's
common.render and of JAX's render_sharded_jit on the conftest's 8 devices
(tests/test_torch_sharded.py's programs: the compilation cache serves
them). What the card captures, a shard's chunk over its own pixel ids,
runs under tests/test_torch_jit.py's host-traffic guard; the CLI's --mesh
route calls render_sharded_jit.
"""
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mitsuba_tpu.film import film as jfilm
from mitsuba_tpu.integrators import common as jcommon, path as jpath
from mitsuba_tpu.parallel import render_sharded as jrs
from mitsuba_tpu.scene import builtin as jbuiltin
from mitsuba_tpu_torch import parallel
from mitsuba_tpu_torch.film import film
from mitsuba_tpu_torch.integrators import common, path
from mitsuba_tpu_torch.parallel import render_sharded as rs
from mitsuba_tpu_torch.scene import builtin
from test_torch_cli import run, write_scene
from test_torch_jit import _NoHostTraffic
from test_torch_sharded import ATOL, CFG, MESHES, ROOT, RTOL, WIDTH, _free_port

torch.set_num_threads(1)

WORKER = textwrap.dedent("""\
    import sys

    import numpy as np
    import torch

    sys.path.insert(0, {root!r})
    from mitsuba_tpu_torch.integrators import common, path
    from mitsuba_tpu_torch.parallel import render_sharded as rs
    from mitsuba_tpu_torch.scene import builtin

    torch.set_num_threads(1)
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    rs.start_group(f"tcp://127.0.0.1:{{port}}", 2, rank, cpu=True)
    scene, cam = builtin.cornell_box({width}, {width}, device="cpu")
    res = {{}}
    for name, dp, sp, filt in {meshes!r}:
        mesh = rs.make_mesh(2, sp=sp, device="cpu")
        cfg = common.RenderConfig(**{cfg!r}, filter=filt)
        res[name] = rs.render_sharded_jit(scene, cam, path.li, cfg, mesh).numpy()
        res["eager:" + name] = rs.render_sharded(scene, cam, path.li, cfg, mesh).numpy()
    if rank == 0:
        np.savez(out, **res)
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("jit_ranks")
    script = d / "worker.py"
    script.write_text(WORKER.format(root=str(ROOT), width=WIDTH, meshes=MESHES, cfg=CFG))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port, str(d / "out.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def jax_images():
    """JAX's render_sharded_jit of each filter on the conftest's 8 devices
    (tests/test_torch_sharded.py's: box over (8, 1), Gaussian over (4, 2))."""
    jscene, jcam = jbuiltin.cornell_box(width=WIDTH, height=WIDTH)
    return {filt: np.asarray(jrs.render_sharded_jit(
        jscene, jcam, jpath.li, jcommon.RenderConfig(**CFG, filter=filt),
        jrs.make_mesh(8, sp=sp))) for filt, sp in ((jfilm.FILTER_BOX, 1),
                                                   (jfilm.FILTER_GAUSSIAN, 2))}


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_render_sharded_jit_is_render_sharded_on_cpu(two_ranks, name):
    img = two_ranks[name]
    assert img.shape == (WIDTH, WIDTH, 3) and img.mean() > 0.01
    np.testing.assert_array_equal(img, two_ranks["eager:" + name])


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_render_sharded_jit_matches_one_device_and_jax(two_ranks, jax_images, name):
    filt = next(m[3] for m in MESHES if m[0] == name)
    scene, cam = builtin.cornell_box(WIDTH, WIDTH, device="cpu")
    single = common.render(scene, cam, path.li, common.RenderConfig(**CFG, filter=filt))
    np.testing.assert_allclose(two_ranks[name], single.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(two_ranks[name], jax_images[filt], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("filt", [film.FILTER_BOX, film.FILTER_GAUSSIAN],
                         ids=["box", "gaussian"])
def test_captured_shard_chunk_has_no_host_traffic(filt):
    """The chunk a rank captures, over its pixel range (the second half of
    a dp = 2 split), after a first eager chunk."""
    scene, cam = builtin.cornell_box(8, 8, device="cpu")
    cfg = common.RenderConfig(spp=4, max_depth=3, filter=filt)
    pixel_ids = torch.arange(32, 64, dtype=torch.int64)
    entry = common.ChunkGraph(scene, cam, path.li, cfg, pixel_ids, chunk=2)
    base = common._base(2, "cpu")
    layout = common.chunk_layout(pixel_ids, 2, cam.width)
    common.chunk_sum(scene, cam, path.li, cfg, layout, base, 2)
    guard = _NoHostTraffic()
    with guard:
        common.chunk_sum(scene, cam, path.li, cfg, layout, base, 2)
    assert not guard.seen, guard.seen
    assert len(entry.acc) == (1 if filt == film.FILTER_BOX else 2)
    assert entry.acc[0].shape[0] == (32 if filt == film.FILTER_BOX else cam.height)


def test_leaf_requiring_grad_raises():
    scene, cam = builtin.cornell_box(8, 8, device="cpu")
    scene = scene.replace(vertices=scene.vertices.clone().requires_grad_())
    with pytest.raises(NotImplementedError, match="render_grad"):
        parallel.render_sharded_jit(scene, cam, path.li, common.RenderConfig(spp=2), None)


def test_cli_mesh_route_calls_render_sharded_jit(tmp_path, monkeypatch):
    """--mesh 1,1 --cpu: this process is the one rank of a gloo group and
    renders through render_sharded_jit (a spy around it); the EXR equals
    common.render of the same scene within the sharded bar."""
    from mitsuba_tpu_torch.io import image
    from mitsuba_tpu_torch.scene import xml

    calls = []
    real = rs.render_sharded_jit

    def spy(scene, cam, li_fn, cfg, mesh):
        calls.append((li_fn, mesh["dp"].size(), mesh["sp"].size()))
        return real(scene, cam, li_fn, cfg, mesh)

    monkeypatch.setattr(rs, "render_sharded_jit", spy)
    p = write_scene(tmp_path)
    assert run(p, "-o", tmp_path / "o.exr", "-q", "--mesh", "1,1") == 0
    assert calls == [(path.li, 1, 1)]
    scene, cam, cfg, _ = xml.load_xml(p, device="cpu")
    np.testing.assert_allclose(image.read_exr(tmp_path / "o.exr"),
                               common.render(scene, cam, path.li, cfg).numpy(),
                               rtol=RTOL, atol=ATOL)
