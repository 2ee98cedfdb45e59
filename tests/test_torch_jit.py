"""The port's compiled and cached renders on the CPU: `common.render_jit`,
`wavefront.render_jit` and the progressive renderer through them, against
the eager renders and the JAX package's render_jit (the card's capture and
replay is tests/test_torch_jit_card.py).

On the CPU render_jit is render, as jax.jit on the CPU is the same
function: the renders are bit-equal. What the card captures is
`common.chunk_sum` and `wavefront._step`; here they run eagerly with their
sample base as a tensor, chunk for chunk against the renders' sums, and
under a guard that fails on any operation that would read the device back
to the host or copy host data to it (neither may run inside a capture).

Bars: the goldens' rtol = atol = 1e-4 with at most GOLDEN_MAX_FLIPS pixels
off (tests/test_torch_render.py) against JAX's render_jit; the wavefront
against JAX's at 1e-5 (test_wavefront_matches_jax_wavefront); progressive
against one shot at 1e-6 (tests/test_checkpoint.py).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from mitsuba_tpu.integrators import common as jcom, path as jpath, wavefront as jwf
from mitsuba_tpu.models import sensor as jsens
from mitsuba_tpu.scene import builtin as jb
from mitsuba_tpu.utils import checkpoint as jckpt
from mitsuba_tpu_torch.film import film
from mitsuba_tpu_torch.integrators import (aov, bdpt, common, direct, lvcbpt, path, spectral,
                                           volpath, vpl, wavefront)
from mitsuba_tpu_torch.models import sensor
from mitsuba_tpu_torch.samplers import qmc
from mitsuba_tpu_torch.scene import builtin
from mitsuba_tpu_torch.utils import checkpoint, graphs

torch.set_num_threads(1)

GOLDEN_RTOL = GOLDEN_ATOL = 1e-4
GOLDEN_MAX_FLIPS = 1
WAVEFRONT_ATOL = 1e-5
PROGRESSIVE_ATOL = 1e-6
FILMS = {"box": dict(filter=film.FILTER_BOX),
         "gaussian": dict(filter=film.FILTER_GAUSSIAN, sampler=qmc.SAMPLER_LD)}


def _golden_close(img, ref):
    diff = np.abs(img - ref)
    off = (diff > GOLDEN_ATOL + GOLDEN_RTOL * np.abs(ref)).any(-1)
    assert off.sum() <= GOLDEN_MAX_FLIPS, (np.argwhere(off), diff.max())


@pytest.fixture(scope="module")
def thinlens():
    """The Cornell box at 16x16 through a thin lens (aperture 0.03, focus
    1.9) in both packages."""
    jscene, jcam = jb.cornell_box(width=16, height=16)
    jcam = jcam.replace(kind=jsens.SENSOR_THINLENS, aperture=jnp.float32(0.03),
                        focus_dist=jnp.float32(1.9))
    scene, _ = builtin.cornell_box(16, 16, device="cpu")
    return jscene, jcam, scene, sensor.camera_from_jax(jcam, device="cpu")


def _cfg(film_name, **kw):
    return dict(spp=8, max_depth=3, seed=3, **FILMS[film_name], **kw)


@pytest.mark.parametrize("offset", [0, 8])
@pytest.mark.parametrize("film_name", list(FILMS))
def test_render_jit_is_render_on_cpu(thinlens, film_name, offset):
    _, _, scene, cam = thinlens
    cfg = common.RenderConfig(**_cfg(film_name))
    img = common.render_jit(scene, cam, path.li, cfg, sample_offset=offset)
    ref = common.render(scene, cam, path.li, cfg, sample_offset=offset)
    assert torch.equal(img, ref) and img.mean() > 0.01


@pytest.mark.parametrize("film_name", list(FILMS))
def test_render_jit_matches_jax(thinlens, film_name):
    """JAX's render_jit (jitted once, sample_offset traced) at offsets 0
    and 8 against the port's, at the goldens' bar."""
    jscene, jcam, scene, cam = thinlens
    jcfg, cfg = jcom.RenderConfig(**_cfg(film_name)), common.RenderConfig(**_cfg(film_name))
    for offset in (0, 8):
        ref = np.asarray(jcom.render_jit(jscene, jcam, jpath.li, jcfg, sample_offset=offset))
        img = common.render_jit(scene, cam, path.li, cfg, sample_offset=offset).numpy()
        _golden_close(img, ref)


@pytest.mark.parametrize("film_name", list(FILMS))
def test_chunk_sum_chunk_for_chunk(thinlens, film_name):
    """The captured chunk function, run eagerly with its sample base as a
    0-dim tensor, equals radiance_sum / film_sum of that chunk alone, bit
    for bit, and the chunks added in order equal the render's sums."""
    _, _, scene, cam = thinlens
    cfg = common.RenderConfig(**_cfg(film_name, spp_chunk=2))
    w, h, chunk, offset = cam.width, cam.height, 2, 8
    pixel_ids = torch.arange(w * h, dtype=torch.int64)
    layout = common.chunk_layout(pixel_ids, chunk, w)
    sums = common.radiance_sum if film_name == "box" else common.film_sum
    total = None
    for ci in range(cfg.spp // chunk):
        base = offset + ci * chunk
        got = common.chunk_sum(scene, cam, path.li, cfg, layout,
                               torch.tensor(base, dtype=torch.int64), chunk)
        ref = sums(scene, cam, path.li, cfg, pixel_ids, base, chunk, chunk)
        ref = (ref,) if film_name == "box" else ref
        assert all(torch.equal(a, b) for a, b in zip(got, ref, strict=True))
        total = list(got) if total is None else [a + b for a, b in zip(total, got)]
    whole = sums(scene, cam, path.li, cfg, pixel_ids, offset, cfg.spp, chunk)
    whole = (whole,) if film_name == "box" else whole
    assert all(torch.equal(a, b) for a, b in zip(total, whole, strict=True))


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compact"])
def test_wavefront_render_jit(compact):
    """wavefront.render_jit equals wavefront.render bit for bit and JAX's
    wavefront.render_jit at the wavefront bar. The compacted render
    (fuse, 4 lanes a pixel: 4,096 lanes) against JAX's plain one, which
    renders no ladder without a BVH: the same samples, summed in another
    order."""
    jscene, jcam = jb.cornell_box(width=32, height=32)
    scene, cam = builtin.cornell_box(32, 32, device="cpu")
    kw = dict(spp=8, max_depth=4, rr_depth=3, seed=3)
    lanes = 4 if compact else 1
    fuse = True if compact else None
    img = wavefront.render_jit(scene, cam, common.RenderConfig(**kw), lanes_per_pixel=lanes,
                               compact=compact, fuse=fuse)
    eager = wavefront.render(scene, cam, common.RenderConfig(**kw), lanes_per_pixel=lanes,
                             compact=compact, fuse=fuse)
    ref = np.asarray(jwf.render_jit(jscene, jcam, jcom.RenderConfig(**kw),
                                    lanes_per_pixel=lanes, compact=compact))
    assert torch.equal(img, eager) and img.mean() > 0.01
    assert np.abs(img.numpy() - ref).max() <= WAVEFRONT_ATOL, np.abs(img.numpy() - ref).max()


def test_render_progressive_through_render_jit():
    """4 passes of 4 spp equal the one-shot 16-spp render_jit (each pass
    its own chunk: the sums differ in order only) and JAX's
    render_progressive at the goldens' bar."""
    jscene, jcam = jb.cornell_box(width=16, height=16)
    scene, cam = builtin.cornell_box(16, 16, device="cpu")
    kw = dict(spp=16, max_depth=3, seed=5)
    state = checkpoint.render_progressive(scene, cam, path.li, common.RenderConfig(**kw),
                                          total_spp=16, pass_spp=4)
    oneshot = common.render_jit(scene, cam, path.li, common.RenderConfig(**kw)).numpy()
    assert state.spp_done == 16
    np.testing.assert_allclose(state.image, oneshot, atol=PROGRESSIVE_ATOL, rtol=0)
    jstate = jckpt.render_progressive(jscene, jcam, jpath.li, jcom.RenderConfig(**kw),
                                      total_spp=16, pass_spp=4)
    _golden_close(state.image, jstate.image)


@pytest.mark.parametrize("entry", ["common", "wavefront"])
def test_leaf_requiring_grad_raises(entry):
    scene, cam = builtin.cornell_box(8, 8, device="cpu")
    scene = scene.replace(vertices=scene.vertices.clone().requires_grad_())
    cfg = common.RenderConfig(spp=2, max_depth=2)
    with pytest.raises(NotImplementedError, match="render_grad"):
        if entry == "common":
            common.render_jit(scene, cam, path.li, cfg)
        else:
            wavefront.render_jit(scene, cam, cfg)


def test_static_key_and_statics():
    """A scene of the same shapes and static fields keys the same graph and
    loads into its copies; a changed static field or shape keys another."""
    a, cam = builtin.cornell_box(8, 8, device="cpu")
    b, _ = builtin.cornell_box(8, 8, light_scale=2.0, device="cpu")
    assert graphs.static_key(a, cam) == graphs.static_key(b, cam)
    assert graphs.static_key(a, cam) != graphs.static_key(a.replace(has_env=True), cam)
    assert graphs.static_key(a, cam) != graphs.static_key(a, cam.replace(width=9))
    statics = graphs.Statics(a, cam)
    s_scene, s_cam = statics.trees
    assert s_scene.vertices is not a.vertices and torch.equal(s_scene.vertices, a.vertices)
    statics.load(b, cam)
    assert torch.equal(s_scene.emitters.radiance, b.emitters.radiance)
    assert not torch.equal(s_scene.emitters.radiance, a.emitters.radiance)
    with pytest.raises(ValueError):
        statics.load(a)


# --------------------------------------------------------------------------
# what the card captures makes no host read and no host copy
# --------------------------------------------------------------------------

_HOST_OPS = {"aten._local_scalar_dense.default", "aten.nonzero.default",
             "aten.masked_select.default", "aten.unique.default", "aten._unique2.default",
             "aten.unique_consecutive.default", "aten.unique_dim.default",
             "aten.repeat_interleave.Tensor", "aten.equal.default", "aten.is_nonzero.default",
             "aten.lift_fresh.default", "aten.bincount.default"}


class _NoHostTraffic(TorchDispatchMode):
    """Records the operations that on a CUDA tensor read the device back
    (.item(), a bool of a tensor, nonzero, a boolean mask index) or copy
    host data to it (torch.tensor / as_tensor of Python or numpy data)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name in _HOST_OPS or (
                name.startswith(("aten.index.Tensor", "aten.index_put"))
                and any(i is not None and i.dtype == torch.bool for i in args[1])):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


_LIS = {"path": path.li, "direct": direct.li, "volpath": volpath.li, "depth": aov.li_depth,
        "normal": aov.li_normal, "ao": aov.li_ao, "motion": aov.li_motion, "bdpt": bdpt.li,
        "lvcbpt": lvcbpt.li, "vpl": vpl.li, "spectral": spectral.li}


@pytest.mark.parametrize("name", list(_LIS))
def test_captured_chunk_has_no_host_traffic(thinlens, name):
    """Each integrator the CLI routes through render_jit: its chunk, after
    a first eager chunk (which makes the cached tables, as on the card),
    under the guard. On the veach_mis plates (GGX) for the shading
    families; the thin-lens box for the rest."""
    scene, cam = builtin.veach_mis(8, 6, device="cpu") if name == "path" else thinlens[2:]
    cfg = common.RenderConfig(spp=2, max_depth=3, filter=film.FILTER_GAUSSIAN)
    layout = common.chunk_layout(torch.arange(cam.width * cam.height), 2, cam.width)
    base = torch.tensor(0, dtype=torch.int64)
    common.chunk_sum(scene, cam, _LIS[name], cfg, layout, base, 2)
    guard = _NoHostTraffic()
    with guard:
        common.chunk_sum(scene, cam, _LIS[name], cfg, layout, base, 2)
    assert not guard.seen, guard.seen


def test_captured_wavefront_step_has_no_host_traffic():
    scene, cam = builtin.cornell_box(16, 16, device="cpu")
    cfg = common.RenderConfig(spp=4, max_depth=3)
    state = wavefront._initial_state(scene, cam, cfg, 1, True)
    wavefront._step(scene, cam, cfg, True, 4, state)
    guard = _NoHostTraffic()
    with guard:
        new = wavefront._step(scene, cam, cfg, True, 4, state)
        wavefront._busy(new, 4, True).sum()
    assert not guard.seen, guard.seen
