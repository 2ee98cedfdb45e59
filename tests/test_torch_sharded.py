"""The port's sharded rendering over torch.distributed
(mitsuba_tpu_torch/parallel/render_sharded.py) on the CPU: the shard sums
_radiance_sum and _film_sum against the JAX package's on given pixel
ranges and sample bases (no collectives); then one two-rank gloo group
(two spawned processes) rendering the 16x16 Cornell box sharded over
mesh (2, 1), (1, 2) and (1, 2) with the Gaussian filter, each equal to the
port's common.render and to JAX's render_sharded_jit on the conftest's
8-device mesh within tests/test_sharded.py's rtol=1e-4, atol=1e-5, and a
15x15 Gaussian film over dp = 2 (a padded pixel id) equal to
common.render's (C45); and
the train step: its first update over mesh (1, 2), over (2, 1) and over
(2, 1) with a 15x15 Gaussian film against JAX's train_step within
TRAIN_RTOL, and three steps lowering the loss (tests/test_sharded.py's
protocol); and the backend each rank picks from its node's rank count."""
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.film import film as jfilm
from mitsuba_tpu.integrators import common as jcommon, path as jpath
from mitsuba_tpu.parallel import render_sharded as jrs
from mitsuba_tpu.scene import builtin as jbuiltin
from mitsuba_tpu_torch.film import film
from mitsuba_tpu_torch.integrators import common, path
from mitsuba_tpu_torch.parallel import render_sharded as rs
from mitsuba_tpu_torch.scene import builtin, ir

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-4, 1e-5          # tests/test_sharded.py
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6  # one shard's sums: the same samples, summed alike
# the first SGD update of each float leaf against JAX's, relative to the
# leaf's largest update
TRAIN_RTOL = 1e-4
WIDTH = 16
CFG = dict(spp=8, max_depth=3, seed=0)
TRAIN_CFG = dict(spp=4, max_depth=2, seed=1)
TARGET, LR = 0.05, 0.1
# (name, dp, sp, filter) of the two-rank renders; the JAX references are
# tests/test_sharded.py's own programs on the conftest's 8 devices: the box
# film over mesh (8, 1), the Gaussian over (4, 2), the train step over
# (4, 2) of 4 devices, and the 15x15 Gaussian film's train step over (1, 2)
MESHES = (("dp", 2, 1, film.FILTER_BOX), ("sp", 1, 2, film.FILTER_BOX),
          ("sp_gaussian", 1, 2, film.FILTER_GAUSSIAN))

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
    dev, backend = rs.start_group(f"tcp://127.0.0.1:{{port}}", 2, rank, cpu=True)
    scene, cam = builtin.cornell_box({width}, {width}, device="cpu")
    res = {{"backend": np.asarray(backend)}}
    for name, dp, sp, filt in {meshes!r}:
        mesh = rs.make_mesh(2, sp=sp, device="cpu")
        cfg = common.RenderConfig(**{cfg!r}, filter=filt)
        res[name] = rs.render_sharded(scene, cam, path.li, cfg, mesh).numpy()
    # 15x15: 225 pixels padded to 226 for dp = 2 (C45)
    scene15, cam15 = builtin.cornell_box(15, 15, device="cpu")
    cfg = common.RenderConfig(**{cfg!r}, filter=2)
    res["dp_gaussian_odd"] = rs.render_sharded(scene15, cam15, path.li, cfg,
                                               rs.make_mesh(2, sp=1, device="cpu")).numpy()
    mesh = rs.make_mesh(2, sp=2, device="cpu")
    target = torch.full(({width}, {width}, 3), {target})
    s, losses = scene, []
    for step in range(3):
        s, loss = rs.train_step(s, cam, target, path.li, common.RenderConfig(**{train!r}), mesh,
                                lr={lr})
        losses.append(float(loss))
        if step == 0:
            res.update({{"leaf:" + ".".join(p): v.numpy() for p, v in rs._float_leaves(s)}})
    res["losses"] = np.asarray(losses)
    # the first update over dp = 2: the box film's per-rank pixel ranges,
    # then a 15x15 Gaussian film (a padded id) through the film branch
    mesh = rs.make_mesh(2, sp=1, device="cpu")
    for name, sc, cm, filt in (("dp", scene, cam, 0), ("dp_gaussian_odd", scene15, cam15, 2)):
        tgt = torch.full((cm.height, cm.width, 3), {target})
        s, loss = rs.train_step(sc, cm, tgt, path.li,
                                common.RenderConfig(**{train!r}, filter=filt), mesh, lr={lr})
        res.update({{f"{{name}}:leaf:" + ".".join(p): v.numpy() for p, v in rs._float_leaves(s)}})
        res[f"{{name}}:loss"] = np.asarray(float(loss))
    try:
        rs.make_mesh(4, sp=1, device="cpu")
    except ValueError as e:
        res["refused"] = np.asarray(str(e))
    if rank == 0:
        np.savez(out, **res)
    torch.distributed.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The worker above as ranks 0 and 1 of a gloo group: its renders, the
    train step's first update and three losses."""
    d = tmp_path_factory.mktemp("ranks")
    script = d / "worker.py"
    script.write_text(WORKER.format(root=str(ROOT), width=WIDTH, meshes=MESHES, cfg=CFG,
                                    train=TRAIN_CFG, target=TARGET, lr=LR))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port, str(d / "out.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's render_sharded_jit of each filter on the conftest's 8 devices
    and its train_step's first update of each filter (the meshes of
    MESHES' note)."""
    jscene, jcam = jbuiltin.cornell_box(width=WIDTH, height=WIDTH)
    imgs = {filt: np.asarray(jrs.render_sharded_jit(
        jscene, jcam, jpath.li, jcommon.RenderConfig(**CFG, filter=filt),
        jrs.make_mesh(8, sp=sp))) for filt, sp in ((jfilm.FILTER_BOX, 1),
                                                   (jfilm.FILTER_GAUSSIAN, 2))}
    steps = {}
    for filt, width, mesh in ((jfilm.FILTER_BOX, WIDTH, jrs.make_mesh(4, sp=2)),
                              (jfilm.FILTER_GAUSSIAN, 15, jrs.make_mesh(2, sp=2))):
        scene, cam = jbuiltin.cornell_box(width=width, height=width)
        target = jnp.zeros((width, width, 3)) + TARGET
        cfg = jcommon.RenderConfig(**TRAIN_CFG, filter=filt)
        new, loss = jax.jit(lambda s: jrs.train_step(
            s, cam, target, jpath.li, cfg, mesh, lr=LR))(scene)
        steps[filt] = (ir.from_jax(new, device="cpu"), float(loss))
    return jscene, imgs, steps


@pytest.fixture(scope="module")
def single():
    """The port's common.render of each filter on one device."""
    scene, cam = builtin.cornell_box(WIDTH, WIDTH, device="cpu")
    return {filt: common.render(scene, cam, path.li, common.RenderConfig(**CFG, filter=filt))
            .numpy() for filt in (film.FILTER_BOX, film.FILTER_GAUSSIAN)}


def test_two_ranks_run_on_gloo(two_ranks):
    assert str(two_ranks["backend"]) == "gloo"


def _check(two_ranks, jax_refs, single, name):
    _, dp, sp, filt = next(m for m in MESHES if m[0] == name)
    img = two_ranks[name]
    assert img.shape == (WIDTH, WIDTH, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, single[filt], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(img, jax_refs[1][filt], rtol=RTOL, atol=ATOL)


def test_sharded_matches_single_device(two_ranks, jax_refs, single):
    """dp: the pixel ranges of two ranks (tests/test_sharded.py)."""
    _check(two_ranks, jax_refs, single, "dp")


def test_sample_parallel_axis(two_ranks, jax_refs, single):
    """sp: disjoint sample ranges of the same global set, summed."""
    _check(two_ranks, jax_refs, single, "sp")


def test_sharded_filtered_splatting_matches_single_device(two_ranks, jax_refs, single):
    """A Gaussian film: per-rank full films summed over the group."""
    _check(two_ranks, jax_refs, single, "sp_gaussian")


def test_padded_pixels_do_not_splat(two_ranks):
    """A film whose pixel count is not a multiple of dp (15x15 over dp = 2,
    one padded id): the Gaussian film equals common.render's (the padded id
    is not rendered; JAX's film splats it into the last rows, C45)."""
    scene, cam = builtin.cornell_box(15, 15, device="cpu")
    ref = common.render(scene, cam, path.li, common.RenderConfig(**CFG,
                                                                 filter=film.FILTER_GAUSSIAN))
    np.testing.assert_allclose(two_ranks["dp_gaussian_odd"], ref.numpy(), rtol=RTOL, atol=ATOL)


def test_train_step_runs_and_reduces_loss(two_ranks):
    losses = two_ranks["losses"]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def _check_first_update(two_ranks, jscene, step, prefix):
    """Every float leaf of the scene after one step against JAX's step
    (new, loss): the update (new - old) within TRAIN_RTOL of the leaf's
    largest, and the loss."""
    jnew, jloss = step
    old = dict(rs._float_leaves(ir.from_jax(jscene, device="cpu")))
    moved = 0
    for p, want in rs._float_leaves(jnew):
        got = two_ranks[prefix + "leaf:" + ".".join(p)]
        d_want = (want - old[p]).numpy()
        d_got = got - old[p].numpy()
        scale = max(float(np.abs(d_want).max()), 1e-12)
        assert np.abs(d_got - d_want).max() <= TRAIN_RTOL * scale, p
        moved += bool(np.abs(d_want).max() > 0)
    assert moved >= 4
    loss = two_ranks[prefix + "loss"] if prefix else two_ranks["losses"][0]
    np.testing.assert_allclose(loss, jloss, rtol=TRAIN_RTOL)


def test_train_step_first_update_matches_jax(two_ranks, jax_refs):
    """The step over mesh (1, 2) against JAX's step on mesh (4, 2)."""
    jscene, _, steps = jax_refs
    _check_first_update(two_ranks, jscene, steps[film.FILTER_BOX], "")


@pytest.mark.parametrize("name", ["dp", "dp_gaussian_odd"])
def test_train_step_dp_first_update_matches_jax(two_ranks, jax_refs, name):
    """The step over mesh (2, 1): the box film's per-rank pixel ranges and
    their gradient sum over dp, against JAX's step on mesh (4, 2); and the
    15x15 Gaussian film (its padded id not rendered, C45) through the
    film branch, against JAX's step on mesh (1, 2), whose one pixel range
    has no padding. The scene's float leaves do not depend on the film's
    size."""
    jscene, _, steps = jax_refs
    filt = film.FILTER_BOX if name == "dp" else film.FILTER_GAUSSIAN
    _check_first_update(two_ranks, jscene, steps[filt], name + ":")


@pytest.mark.parametrize("cards, backend", [(2, "nccl"), (1, "gloo")])
def test_backend_from_node_layout(monkeypatch, cards, backend):
    """Four ranks on two nodes of `cards` cards each: each rank's local rank
    and the node's rank count come from the node names the ranks publish
    in the store, so the backend is NCCL where each node has a card for
    each of its two ranks, whatever the world size, and gloo where two
    ranks share a card; the local rank picks the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    store = torch.distributed.HashStore()
    nodes = ("a", "b", "a", "b")
    for r, node in enumerate(nodes):
        store.set(f"node/{r}", node)
    layouts = [rs.node_layout(store, 4, r, node=node) for r, node in enumerate(nodes)]
    assert layouts == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert {rs.backend_for(size) for _, size in layouts} == {backend}
    assert [rs.rank_device(local).index for local, _ in layouts] == [0, 0, 1 % cards,
                                                                     1 % cards]
    assert rs.backend_for(2, cpu=True) == "gloo" and rs.rank_device(0, cpu=True).type == "cpu"


@pytest.mark.parametrize("filt", [film.FILTER_BOX, film.FILTER_GAUSSIAN])
def test_shard_sums_match_jax(filt):
    """_radiance_sum / _film_sum of the pixel ids [64, 128) of a 16x16
    film, samples [4, 8) in chunks of 2, at depth 2 (the sums' layout is
    under test; path.li's depth is the renders'): the JAX package's sums of
    the same samples."""
    jscene, jcam = jbuiltin.cornell_box(width=WIDTH, height=WIDTH)
    scene, cam = builtin.cornell_box(WIDTH, WIDTH, device="cpu")
    cfg = common.RenderConfig(**{**CFG, "max_depth": 2}, filter=filt)
    jcfg = jcommon.RenderConfig(**{**CFG, "max_depth": 2}, filter=filt)
    ids = np.arange(64, 128)
    args = (torch.as_tensor(ids), 4, 4, 2)
    jargs = (jnp.asarray(ids, jnp.uint32), jnp.uint32(4), 4, 2)
    if filt == film.FILTER_BOX:
        got = [rs._radiance_sum(scene, cam, path.li, cfg, *args)]
        want = [jrs._radiance_sum(jscene, jcam, jpath.li, jcfg, *jargs)]
    else:
        got = rs._film_sum(scene, cam, path.li, cfg, *args)
        want = jrs._film_sum(jscene, jcam, jpath.li, jcfg, *jargs)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=SUM_RTOL, atol=SUM_ATOL)
        assert float(a.abs().sum()) > 0


def test_make_mesh_needs_every_rank(two_ranks):
    """make_mesh takes every rank of the group (one rank a device): a mesh
    of another size raises."""
    assert str(two_ranks["refused"]) == "make_mesh: 4 devices but the group has 2 ranks " \
        "(one rank a device)"
