"""`core/rng`'s draw: `hash_u32` and `uniform` route to the hand-written
kernel of `csrc/rng_draw.cu` for CUDA parts and to the int64 twin
(`hash_u32_plain`, `uniform_plain`) for CPU ones, with the same bits.

CPU: the routing and its counters (CPU parts run the twin, all-int parts
give a Python int, parts on two devices raise); `kernel_parts`, the
wrapper's view of the parts that the kernel reads, run through a numpy
copy of the kernel's uint32 chain, equals the twin over 1 to 4 parts,
int32, int64, bool and float tensors, scalars at every position, 0-dim,
broadcast, transposed and odd-offset parts, values at 2^32 - 1 and
negative ones; its scalars are `_u32`'s; `SampleStream.at_dim` makes one
draw a dimension in every sampler kind; a graph's held draws are added at
each replay.

Card (marked `cuda`, skipped without a device; imports no JAX):

    python -m pytest --noconftest -q -m cuda tests/test_torch_rng_draw.py

the kernel against the twin bit for bit over the same layouts and at 0 to
2^19 lanes; parts on the CPU and the card raise; a draw captured in a
CUDA graph equals its replay and is counted at each replay; a render_jit
Cornell image and a boundary.render_grad step's gradients equal the same
runs with every draw through the twin, bit for bit.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mitsuba_tpu_torch.core import rng
from mitsuba_tpu_torch.integrators import boundary, common, path
from mitsuba_tpu_torch.samplers import qmc
from mitsuba_tpu_torch.scene import builtin
from mitsuba_tpu_torch.utils import graphs

CU = Path(rng.__file__).resolve().parent.parent / "csrc" / "rng_draw.cu"
# the chain's constants, as csrc/rng_draw.cu and hash_u32_plain have them
INIT, MUL, ADD, MIX1, MIX2 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x7FEB352D, 0x846CA68B


@pytest.fixture(autouse=True)
def counts():
    rng.reset_counts()
    yield
    rng.reset_counts()


def _layout(name, device="cpu"):
    """The parts of one draw, by name: the main path's (a scalar seed,
    int64 pixel and sample, a scalar dim) and the layouts the wrapper
    must bring to the kernel's three kinds."""
    rs = np.random.RandomState(sum(map(ord, name)))
    n = 1031                                            # odd: the last lane has no pair

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    i64 = t(rs.randint(-2 ** 62, 2 ** 62, n, dtype=np.int64))
    i64[:4] = t([2 ** 32 - 1, -1, -2 ** 63, 2 ** 32])
    i32 = t(rs.randint(-2 ** 31, 2 ** 31, n, dtype=np.int64), torch.int32)
    pix, smp = t(rs.randint(0, 1 << 16, n)), t(rs.randint(0, 64, n))
    layouts = {
        "main_path": (7, pix, smp, 5),
        "one_part": (i64,),
        "two_parts_i32": (i32, i32.flip(0)),
        "three_parts_mixed": (i64, i32, 3),
        "scalar_first": (2 ** 40 + 3, i64, i32, 9),
        "scalar_second": (i64, -5, i32, 2 ** 33),
        "scalar_third": (i32, i64, 2 ** 32 - 1, i64),
        "scalar_last": (i64, i32, i64, -2 ** 31),
        "zero_dim": (t(123456789), pix, t(-7, torch.int32), smp),
        "one_element": (t([11]), pix, smp, t([[3]], torch.int32)),
        "broadcast": (1, t(rs.randint(0, 99, (37, 1))), t(rs.randint(0, 99, (1, 29)),
                                                           torch.int32), 4),
        "transposed": (i64[:1024].reshape(32, 32).t(), 5, i32[:1024].reshape(32, 32), 6),
        "odd_offset": (i64[1:], i32[1:], i64[:-1], 0),
        "bool_float": (7, pix, smp > 31, (pix.double() * 0.37 - 500.0)),
        "bounce_counter": (3, pix, smp, t(rs.randint(-5, 80, n), torch.int32)),
    }
    return layouts[name]


LAYOUTS = ["main_path", "one_part", "two_parts_i32", "three_parts_mixed", "scalar_first",
           "scalar_second", "scalar_third", "scalar_last", "zero_dim", "one_element",
           "broadcast", "transposed", "odd_offset", "bool_float", "bounce_counter"]


def _emulate(kinds, values, loads, shape):
    """csrc/rng_draw.cu's chain in numpy uint32 over kernel_parts' output:
    what each kind makes the kernel read, mixed as the kernel mixes."""
    n = int(np.prod(shape, dtype=np.int64))
    acc = np.full(n, INIT, np.uint32)
    with np.errstate(over="ignore"):
        for kind, value, p in zip(kinds, values, loads):
            if kind == rng.SCALAR:
                assert p is None and 0 <= value <= 0xFFFFFFFF
                part = np.full(n, value, np.uint32)
            else:
                assert p.dtype == (torch.int32, torch.int64)[(kind - 1) % 2]
                if kind >= rng.FULL_I32:
                    assert p.shape == shape and p.is_contiguous()
                    assert p.data_ptr() % (2 * p.element_size()) == 0
                else:
                    assert p.numel() == 1
                part = np.broadcast_to(p.numpy().reshape(-1).astype(np.int64), n) \
                    .astype(np.uint32)                  # the low word, as the kernel's cast
            x = part + acc * np.uint32(MUL) + np.uint32(ADD)
            x = (x ^ (x >> np.uint32(16))) * np.uint32(MIX1)
            x = (x ^ (x >> np.uint32(15))) * np.uint32(MIX2)
            acc = x ^ (x >> np.uint32(16))
    return acc.reshape(shape)


@pytest.mark.parametrize("name", LAYOUTS)
def test_kernel_parts_emulated(name):
    """The wrapper's parts, read as the kernel reads them, hash to the
    twin's bits."""
    parts = _layout(name)
    shape = torch.broadcast_shapes(*(p.shape for p in parts if isinstance(p, torch.Tensor)))
    kinds, values, loads = rng.kernel_parts(parts, shape)
    bits = _emulate(kinds, values, loads, shape)
    ref = rng.hash_u32_plain(*parts)
    assert ref.shape == shape
    assert np.array_equal(bits.astype(np.int64), ref.numpy())


def test_kernel_constants():
    """The numpy copy above and the twin use the .cu's constants."""
    src = CU.read_text()
    for c in (INIT, MUL, ADD, MIX1, MIX2):
        assert re.search(f"0x{c:08X}u", src), hex(c)
    assert rng.hash_u32_plain(0) == int(_emulate([rng.SCALAR], [0], [None], (1,))[0])


@pytest.mark.parametrize("value", [0, 5, -1, -2 ** 31, 2 ** 31, 2 ** 32 - 1, 2 ** 32,
                                   2 ** 40 + 17, -2 ** 63, np.int32(-9), np.uint32(4e9)])
def test_scalar_reduction(value):
    """A Python or numpy int part reaches the kernel as _u32's value."""
    kinds, values, loads = rng.kernel_parts((value, torch.zeros(4, dtype=torch.int64)),
                                            torch.Size((4,)))
    assert kinds[0] == rng.SCALAR and loads[0] is None
    assert values[0] == rng._u32(value)
    # and the int32 tensor of the same bits is the same part
    if -2 ** 31 <= int(value) < 2 ** 31:
        t = torch.full((4,), int(value), dtype=torch.int32)
        assert torch.equal(rng.hash_u32_plain(value, t), rng.hash_u32_plain(t, t))


@pytest.mark.parametrize("fn", ["hash_u32", "uniform"])
@pytest.mark.parametrize("name", ["main_path", "broadcast", "bounce_counter"])
def test_cpu_parts_run_the_twin(fn, name):
    parts = _layout(name)
    out = getattr(rng, fn)(*parts)
    ref = getattr(rng, f"{fn}_plain")(*parts)
    assert out.dtype == ref.dtype and torch.equal(out, ref)
    assert rng.PLAIN_CALLS["draw"] == 1
    assert rng.KERNEL_LAUNCHES["draw"] == rng.CAPTURED_LAUNCHES["draw"] == 0


@pytest.mark.parametrize("parts", [(1,), (7, 3, 2, 1), (-1, 2 ** 32, 2 ** 40), (0, 0, 0)])
def test_int_parts_give_an_int(parts):
    out = rng.hash_u32(*parts)
    assert type(out) is int and out == rng.hash_u32_plain(*parts)
    assert 0 <= out <= 0xFFFFFFFF
    assert rng.PLAIN_CALLS["draw"] == 0


@pytest.mark.parametrize("fn", ["hash_u32", "uniform"])
def test_two_devices_raise(fn):
    a = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="one device a draw"):
        getattr(rng, fn)(1, a, a.to("meta"), 2)


def test_too_many_parts_raise():
    a = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="1 to 4"):
        rng.kernel_parts((a, a, a, a, a), a.shape)


def _stream(kind, device="cpu"):
    pix = torch.arange(300, device=device) // 3
    smp = torch.arange(300, device=device) % 3
    return rng.SampleStream(11, pix, smp, 0, kind=kind, spp=3)


@pytest.mark.parametrize("kind", sorted(qmc.SAMPLER_NAMES))
@pytest.mark.parametrize("dim", [0, 1, 6, "tensor"])
def test_at_dim_one_draw(kind, dim, monkeypatch):
    """Each sampler kind makes exactly one draw a dimension, and next_2d
    two; a tensor dim (a bounce counter) is one hashed draw."""
    calls = []
    draw = rng._draw
    monkeypatch.setattr(rng, "_draw", lambda parts, as_float: calls.append(len(parts))
                        or draw(parts, as_float))
    st = _stream(kind)
    d = torch.full((300,), 4, dtype=torch.int32) if dim == "tensor" else dim
    u = st.at_dim(d)
    assert calls == [4] and u.dtype == torch.float32 and u.shape == (300,)
    assert bool(((u >= 0) & (u < 1)).all())
    st.next_2d()
    assert len(calls) == 3


def test_graph_replay_adds_held_draws():
    """utils/graphs counts rng among the kernel modules: a module with no
    rays holds none, and a replay adds the draws its capture held."""
    mods = graphs._kernel_modules()
    assert rng in mods
    held = graphs._captured()[mods.index(rng)]
    assert held == ({"draw": 0}, {})

    class Replayed:
        def replay(self):
            pass

    launches = tuple({"draw": 64} if m is rng else {} for m in mods)
    g = graphs.Graph(Replayed(), launches, tuple({} for _ in mods))
    g.replay()
    g.replay()
    assert rng.KERNEL_LAUNCHES["draw"] == 128 and rng.KERNEL_LANES["draw"] == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    common._CHUNK_GRAPHS.clear()
    return torch.device("cuda", 0)


def _twin(parts, as_float):
    return rng.uniform_plain(*parts) if as_float else rng.hash_u32_plain(*parts)


@pytest.mark.cuda
@pytest.mark.parametrize("name", LAYOUTS)
def test_kernel_equals_twin(cuda, name):
    parts = _layout(name, cuda)
    for fn in ("hash_u32", "uniform"):
        before = rng.KERNEL_LAUNCHES["draw"]
        out = getattr(rng, fn)(*parts)
        ref = getattr(rng, f"{fn}_plain")(*parts)
        assert rng.KERNEL_LAUNCHES["draw"] == before + 1
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert torch.equal(out, ref), (fn, name)
    assert rng.PLAIN_CALLS["draw"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 2, 3, 255, 257, 1 << 18, (1 << 19) + 1])
def test_kernel_lanes(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    pix = torch.randint(0, 1 << 20, (n,), generator=gen, device=cuda)
    smp = torch.randint(-2 ** 40, 2 ** 40, (n,), generator=gen, device=cuda)
    for as_float in (False, True):
        out = rng._draw((2 ** 31 + 5, pix, smp, 7), as_float)
        assert out.shape == (n,)
        assert torch.equal(out, _twin((2 ** 31 + 5, pix, smp, 7), as_float))
    assert rng.KERNEL_LAUNCHES["draw"] == (2 if n else 0)
    assert rng.KERNEL_LANES["draw"] == 2 * n


@pytest.mark.cuda
def test_cpu_and_card_parts_raise(cuda):
    a = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="one device a draw"):
        rng.uniform(1, a.to(cuda), a, 2)


@pytest.mark.cuda
def test_captured_draw_equals_replay(cuda):
    pix = torch.arange(1 << 16, device=cuda)
    base = torch.zeros((), dtype=torch.int64, device=cuda)
    out = torch.empty(1 << 16, device=cuda)

    def work():
        out.copy_(rng.uniform(3, pix, pix % 7 + base, 2))
        rng.hash_u32(3, pix, base, 9)

    work()
    graph = graphs.capture(work)
    assert rng.CAPTURED_LAUNCHES["draw"] == 2
    held = graph.launches[graphs._kernel_modules().index(rng)]
    assert held == {"draw": 2}
    rng.reset_counts()
    for b in (5, 6):
        base.fill_(b)
        graph.replay()
        torch.cuda.synchronize(cuda)
        assert torch.equal(out, rng.uniform_plain(3, pix, pix % 7 + b, 2))
    assert rng.KERNEL_LAUNCHES["draw"] == 4 and rng.PLAIN_CALLS["draw"] == 0


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(was, warn_only=warn)


@pytest.mark.cuda
def test_render_jit_image_equals_twin(cuda, deterministic, monkeypatch):
    """A Cornell render_jit image (the images cell's path at 64x64, 16 spp
    in two chunks, the Gaussian film) through the kernel and through the
    twin: the same bits. Every draw of the replayed image is a kernel
    launch held by the graph, none a plain call."""
    scene, cam = builtin.cornell_box(64, 64, device=cuda)
    cfg = common.RenderConfig(spp=16, spp_chunk=8, max_depth=8, rr_depth=5, seed=3,
                              filter=common.filmlib.FILTER_GAUSSIAN)
    common.render_jit(scene, cam, path.li, cfg)
    rng.reset_counts()
    graphs.reset_counts()
    img = common.render_jit(scene, cam, path.li, cfg, sample_offset=16)
    launches = rng.KERNEL_LAUNCHES["draw"]
    assert graphs.STATS["replays"] == 2 and launches > 0 and launches % 2 == 0
    assert rng.PLAIN_CALLS["draw"] == 0
    common._CHUNK_GRAPHS.clear()
    monkeypatch.setattr(rng, "_draw", _twin)
    twin = common.render_jit(scene, cam, path.li, cfg, sample_offset=16)
    assert rng.KERNEL_LAUNCHES["draw"] == launches
    assert torch.equal(img, twin)


def _grads(scene, cam):
    leaves = [x.detach().clone().requires_grad_(True) for x in
              (scene.vertices, scene.materials.reflectance, scene.emitters.radiance)]
    s = scene.replace(vertices=leaves[0],
                      materials=scene.materials.replace(reflectance=leaves[1]),
                      emitters=scene.emitters.replace(radiance=leaves[2]))
    cfg = dataclasses.replace(common.RenderConfig(), spp=4, seed=7, max_depth=8, rr_depth=5)
    img = boundary.render_grad(s, cam, cfg, boundary.BoundaryConfig(n_primary=4096))
    (img ** 2).mean().backward()
    return [x.grad for x in leaves]


@pytest.mark.cuda
def test_render_grad_equals_twin(cuda, deterministic, monkeypatch):
    """A boundary.render_grad step's gradients (vertices, reflectances,
    radiance) through the kernel and through the twin: the same bits."""
    scene, cam = builtin.cornell_box(32, 32, device=cuda)
    kernel = _grads(scene, cam)
    launches = rng.KERNEL_LAUNCHES["draw"]
    assert launches > 0 and rng.PLAIN_CALLS["draw"] == 0
    monkeypatch.setattr(rng, "_draw", _twin)
    twin = _grads(scene, cam)
    assert rng.KERNEL_LAUNCHES["draw"] == launches
    for k, t in zip(kernel, twin):
        assert torch.equal(k, t)
