"""`ops/gather.gather_rows`: the row gather whose backward is a
hand-written CUDA kernel pair for small tables that require grad.

CPU: the gather equals `table[idx]` in value, shape and dtype, and its
gradient (the plain twin, PyTorch's own `index_put_(accumulate=True)`)
equals `table[idx]`'s bit for bit, over 1-D, (R, 3) and (R, 7) tables,
int32 and int64 indices, 1-D and 2-D index shapes, an empty index and
every lane on one row; the routing (no grad, over the cap, not float32,
the twin) and its counters; an out-of-range index raises; path, direct,
volpath and reparam read no leaf through a plain gather, and their
gradients equal plain indexing's.

Card (marked `cuda`, skipped without a device; imports no JAX):

    python -m pytest --noconftest -q -m cuda tests/test_torch_gather.py

the kernel against a float64 `index_put_(accumulate=True)` at the main
path's shapes, bit-equal over two runs, and `boundary.render_grad`'s
gradients on the Cornell box through the kernel against plain indexing.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mitsuba_tpu_torch.core.rng import SampleStream
from mitsuba_tpu_torch.integrators import boundary, common, direct, path, reparam, volpath
from mitsuba_tpu_torch.models import sensor
from mitsuba_tpu_torch.ops import gather
from mitsuba_tpu_torch.scene import builtin

# float32 sums of up to 2^21 terms in two different orders (the kernel's
# tree and block order against a float64 sum, or against the sort-based
# index_put_): each side's rounding error is below its summation depth
# (< 100 sequential adds in the kernel) x 2^-24 x the sum of |terms|.
SUM_RTOL = 1e-5
# render_grad's gradients through the kernel against plain indexing: the
# forward is the same; only the backward's summation order differs, over
# 2^12 lanes a gather here, and the vertices' gradient mixes signs.
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def counts():
    gather.reset_counts()
    yield
    gather.reset_counts()


def _case(shape, rows, idx_dtype, idx_shape, seed=0, device="cpu"):
    rs = np.random.RandomState(seed)
    table = torch.tensor(rs.uniform(-1, 1, (rows, *shape)), dtype=torch.float32, device=device)
    idx = torch.tensor(rs.randint(0, rows, idx_shape), dtype=idx_dtype, device=device)
    return table, idx


def _grads(table, idx, fn, seed=1):
    leaf = table.clone().requires_grad_(True)
    out = fn(leaf, idx)
    g = torch.tensor(np.random.RandomState(seed).uniform(-1, 1, tuple(out.shape)),
                     dtype=torch.float32, device=table.device)
    out.backward(g)
    return out.detach(), leaf.grad


def _plain(table, idx):
    return table[idx]


@pytest.mark.parametrize("shape", [(), (3,), (7,)], ids=["1d", "r3", "r7"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("idx_shape", [(257,), (19, 23)], ids=["idx1d", "idx2d"])
def test_equals_indexing(shape, idx_dtype, idx_shape):
    table, idx = _case(shape, 11, idx_dtype, idx_shape)
    out, g = _grads(table, idx, gather.gather_rows)
    ref_out, ref_g = _grads(table, idx, _plain)
    assert out.dtype == ref_out.dtype and out.shape == ref_out.shape
    assert torch.equal(out, ref_out)
    assert torch.equal(g, ref_g)
    assert gather.PLAIN_CALLS["backward"] == 1


@pytest.mark.parametrize("shape", [(), (3,)], ids=["1d", "r3"])
def test_empty_index(shape):
    table, _ = _case(shape, 4, torch.int64, (1,))
    idx = torch.zeros((0,), dtype=torch.int64)
    out, g = _grads(table, idx, gather.gather_rows)
    assert out.shape == (0, *shape)
    assert torch.equal(g, torch.zeros_like(table))


@pytest.mark.parametrize("rows", [1, 64])
def test_every_lane_one_row(rows):
    table, _ = _case((3,), rows, torch.int64, (1,))
    idx = torch.full((5000,), rows - 1, dtype=torch.int32)
    out, g = _grads(table, idx, gather.gather_rows)
    ref_out, ref_g = _grads(table, idx, _plain)
    assert torch.equal(out, ref_out) and torch.equal(g, ref_g)
    assert torch.count_nonzero(g[:rows - 1]) == 0


def test_derived_table():
    """A table built from a leaf (the emitter triangles' p0 from the
    vertices) passes its gradient on to the leaf."""
    table, idx = _case((3,), 8, torch.int64, (300,))

    def through(fn):
        leaf = table.clone().requires_grad_(True)
        fn(leaf * 2.0 + 1.0, idx).sum().backward()
        return leaf.grad

    assert torch.equal(through(gather.gather_rows), through(_plain))


INTEGRATORS = {"path": path.li, "direct": direct.li, "volpath": volpath.li,
               "reparam": lambda *a: reparam.li_reparam(*a, reparam.ReparamConfig(n_aux=4))}


def _integrator_grads(li):
    """d/d (vertices, reflectance, radiance) of an 8x8 x 2 spp Cornell box's
    mean radiance through one integrator."""
    scene, cam = builtin.cornell_box(8, 8, device="cpu")
    leaves = [x.clone().requires_grad_(True) for x in
              (scene.vertices, scene.materials.reflectance, scene.emitters.radiance)]
    scene = scene.replace(vertices=leaves[0],
                          materials=scene.materials.replace(reflectance=leaves[1]),
                          emitters=scene.emitters.replace(radiance=leaves[2]))
    pix = torch.repeat_interleave(torch.arange(64), 2)
    smp = torch.arange(2).repeat(64)
    st = SampleStream(5, pix, smp, 0)
    jx, jy = st.next_1d(), st.next_1d()
    o, d, _ = sensor.sample_rays(cam, (pix % 8).float() + jx, (pix // 8).float() + jy,
                                 st.next_2d())
    L = li(scene, cam, o, d, SampleStream(5, pix, smp, 4), common.RenderConfig(max_depth=4))
    loss = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0).mean()
    plain_reads = _plain_leaf_gathers(loss.grad_fn, leaves)
    loss.backward()
    return [x.grad for x in leaves], plain_reads


def _plain_leaf_gathers(root, leaves):
    """The IndexBackward0 nodes (plain `table[idx]`) that read a leaf
    directly: the graph from `root`, walked once."""
    ids = {id(x) for x in leaves}
    seen, stack, n = set(), [root], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        nxt = [f for f, _ in node.next_functions]
        if type(node).__name__ == "IndexBackward0":
            n += sum(id(getattr(f, "variable", None)) in ids for f in nxt if f is not None)
        stack.extend(nxt)
    return n


@pytest.mark.parametrize("name", sorted(INTEGRATORS))
def test_integrator_gathers(name, monkeypatch):
    """Each gradient integrator's gathers of the leaves, and of what is
    built from them, take the Function (its CPU twin): no plain gather
    reads a leaf, and the gradients equal plain indexing's everywhere."""
    grads, plain_reads = _integrator_grads(INTEGRATORS[name])
    assert plain_reads == 0
    assert gather.PLAIN_CALLS["backward"] > 0 and gather.ROUTED_PLAIN["over_cap"] == 0
    monkeypatch.setattr(gather, "CAP", -1)
    gather.reset_counts()
    plain, plain_reads = _integrator_grads(INTEGRATORS[name])
    assert plain_reads > 0
    assert gather.PLAIN_CALLS["backward"] == 0 and gather.ROUTED_PLAIN["over_cap"] > 0
    for g, ref in zip(grads, plain):
        assert torch.equal(g, ref)


def test_routing_no_grad():
    table, idx = _case((3,), 4, torch.int64, (10,))
    assert gather.gather_rows(table, idx).grad_fn is None
    leaf = table.clone().requires_grad_(True)
    with torch.no_grad():
        out = gather.gather_rows(leaf, idx)
    assert out.grad_fn is None and torch.equal(out, table[idx])
    assert gather.ROUTED_PLAIN == {"over_cap": 0, "dtype": 0}
    assert gather.PLAIN_CALLS["backward"] == 0


def test_routing_function():
    table, idx = _case((3,), 4, torch.int64, (10,))
    out = gather.gather_rows(table.clone().requires_grad_(True), idx)
    assert type(out.grad_fn).__name__ == "GatherRowsBackward"


def test_routing_over_cap():
    rows = gather.CAP // 3 + 1
    table, idx = _case((3,), rows, torch.int64, (50,))
    out, g = _grads(table, idx, gather.gather_rows)
    assert gather.ROUTED_PLAIN["over_cap"] == 1
    assert gather.PLAIN_CALLS["backward"] == 0
    assert torch.equal(g, _grads(table, idx, _plain)[1])
    # at the cap: the Function
    table, idx = _case((3,), gather.CAP // 3, torch.int64, (50,))
    _grads(table, idx, gather.gather_rows)
    assert gather.ROUTED_PLAIN["over_cap"] == 1 and gather.PLAIN_CALLS["backward"] == 1


def test_routing_dtype():
    table, idx = _case((3,), 4, torch.int64, (10,))
    leaf = table.double().requires_grad_(True)
    out = gather.gather_rows(leaf, idx)
    assert out.dtype == torch.float64 and type(out.grad_fn).__name__ == "IndexBackward0"
    assert gather.ROUTED_PLAIN["dtype"] == 1


def test_out_of_range_raises():
    table, _ = _case((3,), 4, torch.int64, (1,))
    leaf = table.requires_grad_(True)
    with pytest.raises(IndexError):
        gather.gather_rows(leaf, torch.tensor([0, 4]))


def test_backward_checks_shapes():
    with pytest.raises(ValueError):
        gather.gather_backward(torch.zeros((5, 2), device="meta"),
                               torch.zeros((5,), dtype=torch.int64, device="meta"),
                               torch.Size((4, 3)))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _launch(g, idx, rows):
    return gather.gather_backward(g, idx, torch.Size((rows, *g.shape[idx.dim():])))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 18, 1 << 21])
@pytest.mark.parametrize("rows", [1, 4, 64])
def test_kernel_against_float64(cuda, n, rows):
    gen = torch.Generator(device=cuda).manual_seed(n + rows)
    g = torch.rand((n, 3), generator=gen, device=cuda) * 2.0 - 1.0
    idx = torch.randint(0, rows, (n,), generator=gen, device=cuda)
    ref = torch.zeros((rows, 3), dtype=torch.float64, device=cuda).index_put_(
        (idx,), g.double(), accumulate=True)
    scale = torch.zeros_like(ref).index_put_((idx,), g.double().abs(), accumulate=True)
    for ix in (idx, idx.int()):
        before = gather.KERNEL_LAUNCHES["backward"]
        out = _launch(g, ix, rows)
        assert gather.KERNEL_LAUNCHES["backward"] == before + 1
        assert out.dtype == torch.float32 and out.shape == (rows, 3)
        assert bool(((out.double() - ref).abs() <= SUM_RTOL * scale).all())
    assert gather.KERNEL_LANES["backward"] == 2 * n


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 1000, 4097, 1 << 21])
def test_kernel_deterministic(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    rows = 64
    g = torch.randn((n, 3), generator=gen, device=cuda)
    # neighbouring lanes on a few rows, as the renderer's gathers are
    idx = (torch.arange(n, device=cuda) // 97 + torch.randint(0, 3, (n,), generator=gen,
                                                                device=cuda)) % rows
    a = _launch(g, idx, rows)
    b = _launch(g, idx, rows)
    torch.cuda.synchronize(cuda)
    assert torch.equal(a, b)
    ref = torch.zeros((rows, 3), dtype=torch.float64, device=cuda).index_put_(
        (idx,), g.double(), accumulate=True)
    scale = torch.zeros_like(ref).index_put_((idx,), g.double().abs(), accumulate=True)
    assert bool(((a.double() - ref).abs() <= SUM_RTOL * scale).all())


@pytest.mark.cuda
def test_kernel_shapes(cuda):
    """1-D and (R, 7) tables, a 2-D index, negative indices, through the
    autograd Function on the card against table[idx]."""
    for shape, idx_shape in (((), (300, 5)), ((7,), (4099,)), ((3,), (2, 2000))):
        table, idx = _case(shape, 13, torch.int64, idx_shape, device=cuda)
        idx = torch.where(idx % 2 == 0, idx - 13, idx)       # half of them negative
        out, g = _grads(table, idx, gather.gather_rows)
        ref_out, ref_g = _grads(table, idx, _plain)
        assert torch.equal(out, ref_out)
        torch.testing.assert_close(g, ref_g, rtol=SUM_RTOL, atol=SUM_RTOL * float(ref_g.abs().max()))
    assert gather.KERNEL_LAUNCHES["backward"] == 3 and gather.PLAIN_CALLS["backward"] == 0


def _cornell_grads(dev):
    scene, cam = builtin.cornell_box(32, 32, device=dev)
    leaves = {"vertices": scene.vertices, "reflectance": scene.materials.reflectance,
              "radiance": scene.emitters.radiance}
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
    scene = scene.replace(
        vertices=leaves["vertices"],
        materials=scene.materials.replace(reflectance=leaves["reflectance"]),
        emitters=scene.emitters.replace(radiance=leaves["radiance"]))
    cfg = dataclasses.replace(common.RenderConfig(), spp=4, seed=7)
    img = boundary.render_grad(scene, cam, cfg, boundary.BoundaryConfig(n_primary=4096))
    (img ** 2).mean().backward()
    return {k: v.grad for k, v in leaves.items()}


@pytest.mark.cuda
def test_render_grad_through_kernel(cuda, monkeypatch):
    kernel = _cornell_grads(cuda)
    launches = gather.KERNEL_LAUNCHES["backward"]
    assert launches > 0 and gather.ROUTED_PLAIN["over_cap"] == 0
    # every gather over the cap: plain indexing, PyTorch's own backward
    monkeypatch.setattr(gather, "CAP", -1)
    plain = _cornell_grads(cuda)
    assert gather.KERNEL_LAUNCHES["backward"] == launches
    for k in kernel:
        scale = float(plain[k].abs().max())
        assert scale > 0.0, k
        torch.testing.assert_close(kernel[k], plain[k], rtol=GRAD_RTOL, atol=GRAD_RTOL * scale)
