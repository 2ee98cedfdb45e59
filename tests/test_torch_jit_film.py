"""The film renderers' compiled and cached entries on the CPU:
`ptracer.render_jit`, `bdpt.render_jit` (the light image), `bre.render_jit`,
`pssmlt.render_jit`, `erpt.render_jit`, `mlt.render_jit`, irrcache's film
through `common.render_jit`, the graph-safe manifold walk, and the CLI's
routes to them (the card's capture and replay is
tests/test_torch_jit_card.py; the sharded render's is
tests/test_torch_jit_sharded.py).

On the CPU each render_jit is its module's render, as jax.jit on the CPU is
the same function: the images are bit-equal. Against the JAX package's
render_jit the bars are the modules' parity tests' own, at their sizes and
with JAX's draws injected where the renderer draws from a generator:
tests/test_torch_bidir.py's (C36: 1e-4, at most RENDER_MAX_OFF pixels off)
for ptracer and the light image, tests/test_torch_photon.py's (every
pixel at 1e-4) for bre, tests/test_torch_mcmc.py's (C38, C39) and
tests/test_torch_mlt.py's (C42) for the Metropolis renderers. Their JAX
programs are those files' own (the same shapes), so the compilation cache
serves them.

What the card captures (a particle chunk, an spp chunk of the light image,
the beam prologue and one beam step, one pssmlt or erpt mutation, one MLT
mutation of each kernel, F's walks in the fixed form) runs here eagerly
after a first eager run, under the guard of tests/test_torch_jit.py that
fails on any operation that would read the device back or copy host data
to it. The fixed manifold walk equals the `while` walk bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators import bre as jbre, common as jcom, mlt as jmlt
from mitsuba_tpu.scene import builtin as jb
from mitsuba_tpu_torch import cli
from mitsuba_tpu_torch.integrators import (bdpt, bre, common, erpt, irrcache, mlt, pssmlt,
                                           ptracer)
from mitsuba_tpu_torch.io import image
from mitsuba_tpu_torch.models import sensor
from mitsuba_tpu_torch.ops import manifold
from mitsuba_tpu_torch.scene import builtin, ir, xml
from mitsuba_tpu_torch.utils import graphs
from test_torch_bidir import CFG as BIDIR_CFG
from test_torch_bidir import RENDERS, _render_close
from test_torch_bidir import scenes  # noqa: F401  (fixture)
from test_torch_cli import FOG, run, write_scene
from test_torch_jit import _NoHostTraffic
from test_torch_manifold import CASES
from test_torch_mcmc import PARITY, box, jeval  # noqa: F401  (fixtures)
from test_torch_mcmc import N_BOOT as MCMC_BOOT
from test_torch_mcmc import N_CHAINS as MCMC_CHAINS
from test_torch_mcmc import RENDER_TOL as MCMC_TOL
from test_torch_mcmc import CFG as MCMC_CFG
from test_torch_mcmc import jax_draws as mcmc_draws
from test_torch_mlt import CFG as MLT_CFG
from test_torch_mlt import MAX_PIXELS_OFF as MLT_MAX_OFF
from test_torch_mlt import N_BOOT as MLT_BOOT
from test_torch_mlt import N_CHAINS as MLT_CHAINS
from test_torch_mlt import RENDER_TOL as MLT_TOL
from test_torch_mlt import SCENES as MLT_SCENES
from test_torch_mlt import SEED as MLT_SEED
from test_torch_mlt import boxes  # noqa: F401  (fixture)
from test_torch_mlt import jax_draws as mlt_draws
from test_torch_photon import _cfg as photon_cfg
from test_torch_photon import _fog, _image_off

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _fog_box(width=8):
    """The Cornell box in tests/test_bre.py's homogeneous fog, in both
    packages."""
    jscene, jcam = jb.cornell_box(width=width, height=width)
    jscene = jscene.replace(medium=_fog("homogeneous"))
    return jscene, jcam, ir.from_jax(jscene, device="cpu"), \
        sensor.camera_from_jax(jcam, device="cpu")


# --------------------------------------------------------------------------
# render_jit is render on the CPU
# --------------------------------------------------------------------------

def _small(scene_name):
    if scene_name == "caustic":
        return builtin.caustic_box(8, 8, rough=False, device="cpu")
    return builtin.cornell_box(8, 8, device="cpu")


ENTRIES = {
    # name: (scene, jit render, eager render)
    "ptracer": ("cornell", lambda s, c, k: ptracer.render_jit(s, c, k, n_particles=1536),
                lambda s, c, k: ptracer.render(s, c, k, n_particles=1536)),
    "bdpt": ("cornell", bdpt.render_jit, bdpt.render),
    "pssmlt": ("cornell",
               lambda s, c, k: pssmlt.render_jit(s, c, k, n_chains=64, n_mutations=4,
                                                 n_bootstrap=256),
               lambda s, c, k: pssmlt.render(s, c, k, n_chains=64, n_mutations=4,
                                             n_bootstrap=256)),
    "erpt": ("cornell",
             lambda s, c, k: erpt.render_jit(s, c, k, n_chains=64, chain_length=4,
                                             n_bootstrap=256),
             lambda s, c, k: erpt.render(s, c, k, n_chains=64, chain_length=4,
                                         n_bootstrap=256)),
    "mlt": ("cornell",
            lambda s, c, k: mlt.render_jit(s, c, k, n_chains=64, n_mutations=5,
                                           n_bootstrap=256),
            lambda s, c, k: mlt.render(s, c, k, n_chains=64, n_mutations=5, n_bootstrap=256)),
    "mlt_caustic": ("caustic",
                    lambda s, c, k: mlt.render_jit(s, c, k, n_chains=64, n_mutations=6,
                                                   n_bootstrap=256),
                    lambda s, c, k: mlt.render(s, c, k, n_chains=64, n_mutations=6,
                                               n_bootstrap=256)),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_render_jit_is_render_on_cpu(name):
    scene_name, jit, eager = ENTRIES[name]
    scene, cam = _small(scene_name)
    cfg = common.RenderConfig(spp=4, max_depth=3, seed=2)
    img = jit(scene, cam, cfg)
    assert torch.equal(img, eager(scene, cam, cfg)) and float(img.mean()) > 0.0


def test_bre_render_jit_is_render_on_cpu():
    scene, cam = _fog_box()[2:]
    cfg = common.RenderConfig(spp=1, max_depth=3, seed=0)
    kw = dict(n_paths=1 << 9, steps=3)
    img = bre.render_jit(scene, cam, cfg, **kw)
    assert torch.equal(img, bre.render(scene, cam, cfg, **kw)) and float(img.mean()) > 0.0
    # a given radius (a Python float) takes the same path
    kw["radius"] = 0.05
    assert torch.equal(bre.render_jit(scene, cam, cfg, **kw), bre.render(scene, cam, cfg, **kw))


@pytest.mark.parametrize("mode", range(6))
def test_mlt_fixed_walk_mutation_is_the_early_exit_mutation(mode):
    """The graph-safe walk changes no result of MLT: each kernel's mutation
    (F's walks in either form) gives the same state, splats and acceptance
    bit for bit, on the perfect-mirror caustic box at 256 chains."""
    scene, cam = _small("caustic")
    cfg = common.RenderConfig(spp=1, max_depth=3, seed=1)
    state, b = mlt._start(scene, cam, cfg, mlt.generator_draws(1, "cpu"), 256, 1024)
    outs = []
    for fixed in (False, True):
        img, acc = torch.zeros((64, 3)), torch.zeros((6,))
        new = mlt._mutate(scene, cam, cfg, mlt.generator_draws(5, "cpu"), mode, True, state,
                          img, acc, b, fixed_walk=fixed)
        outs.append((*new, img, acc))
    assert all(torch.equal(x, y) for x, y in zip(*outs))
    assert mode != 5 or float(outs[0][-1][5]) > 0.0     # F's proposals are accepted


def test_irrcache_renders_through_render_jit(monkeypatch):
    """irrcache.render's film goes through common.render_jit (as the JAX
    package's does) with the Li of its own cache, and equals common.render
    with that Li."""
    scene, cam = _small("cornell")
    cfg = common.RenderConfig(spp=2, max_depth=3, seed=0)
    calls = []

    def spy(scene, cam, li_fn, cfg, *a, **kw):
        calls.append(li_fn)
        return common.render(scene, cam, li_fn, cfg, *a, **kw)

    monkeypatch.setattr(common, "render_jit", spy)
    img = irrcache.render(scene, cam, cfg, n_points=128, n_hemi=4)
    cache = irrcache.build_cache(scene, cfg, 128, 4, seed=cfg.seed + 77)
    assert len(calls) == 1 and calls[0].__qualname__ == "li_factory.<locals>.li"
    assert torch.equal(img, common.render(scene, cam, irrcache.li_factory(cache), cfg))


# --------------------------------------------------------------------------
# against the JAX package's render_jit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ptracer", "bdpt_render", "bdpt_render_caustic"])
def test_bidir_render_jit_matches_jax(scenes, name):  # noqa: F811
    """tests/test_torch_bidir.py's renders (its configs and scenes) through
    the port's render_jit, against JAX's render_jit at C36's bar."""
    fixture, jfn, _, changes = RENDERS[name]
    jscene, jcam, scene, cam = scenes[fixture]
    cfg = {**BIDIR_CFG, **changes}
    ref = np.asarray(jfn(jscene, jcam, jcom.RenderConfig(**cfg)))
    entry = ptracer.render_jit if name == "ptracer" else bdpt.render_jit
    img = entry(scene, cam, common.RenderConfig(**cfg)).numpy()
    _render_close(img, ref)
    assert img.mean() > 0.01


def test_bre_render_jit_matches_jax():
    """tests/test_torch_photon.py's bre render (the homogeneous fog, 2^10
    paths, 4 steps): every pixel at 1e-4."""
    jscene, jcam, scene, cam = _fog_box()
    jcfg, cfg = photon_cfg()
    jimg = jbre.render_jit(jscene, jcam, jcfg, n_paths=1 << 10, steps=4)
    img = bre.render_jit(scene, cam, cfg, n_paths=1 << 10, steps=4)
    assert float(img.mean()) > 0 and _image_off(jimg, img) == 0


@pytest.mark.parametrize("name", sorted(PARITY))
def test_mcmc_render_jit_matches_jax(box, name):  # noqa: F811
    """tests/test_torch_mcmc.py's protocol through the port's render_jit
    with JAX's threefry uniforms: every pixel at 1e-4 (0 seeds flip at
    these draws, ROADMAP C39)."""
    jmod, step_names, seed, kw = PARITY[name]
    port = {"pssmlt": pssmlt, "erpt": erpt}[name]
    jscene, jcam, scene, cam = box
    want = np.asarray(jmod.render_jit(jscene, jcam, jcom.RenderConfig(**MCMC_CFG),
                                      n_chains=MCMC_CHAINS, n_bootstrap=MCMC_BOOT, **kw))
    draw, _ = mcmc_draws(seed, step_names)
    got = port.render_jit(scene, cam, common.RenderConfig(**MCMC_CFG), n_chains=MCMC_CHAINS,
                          n_bootstrap=MCMC_BOOT, uniforms=draw, **kw).numpy()
    assert np.isfinite(got).all() and got.mean() > 0.05
    np.testing.assert_allclose(got, want, rtol=MCMC_TOL, atol=MCMC_TOL)


@pytest.mark.parametrize("name", sorted(MLT_SCENES))
def test_mlt_render_jit_matches_jax(boxes, name):  # noqa: F811
    """tests/test_torch_mlt.py's protocol (two kernel cycles, JAX's draws)
    through the port's render_jit: at most MAX_PIXELS_OFF of 64 pixels
    beyond 1e-4 (C42), every kernel's acceptance within 1e-5."""
    jscene, jcam, scene, cam, n_mut, n_modes = boxes[name]
    kw = dict(n_chains=MLT_CHAINS, n_mutations=n_mut, n_bootstrap=MLT_BOOT, return_stats=True)
    jimg, jst = jmlt.render_jit(jscene, jcam, jcom.RenderConfig(**MLT_CFG), **kw)
    draw, _, _ = mlt_draws(MLT_SEED, n_mut, n_modes)
    img, st = mlt.render_jit(scene, cam, common.RenderConfig(**MLT_CFG), draws=draw, **kw)
    got, want = img.numpy(), np.asarray(jimg)
    off = int((~np.isclose(got, want, rtol=MLT_TOL, atol=MLT_TOL)).any(-1).sum())
    assert np.isfinite(got).all() and got.mean() > 0.05
    assert off <= MLT_MAX_OFF, (off, float(np.abs(got - want).max()))
    np.testing.assert_allclose(st["acceptance"].numpy(), np.asarray(jst["acceptance"]),
                               rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# what the card captures makes no host read and no host copy
# --------------------------------------------------------------------------

def _guarded(fn):
    """fn() eagerly (which makes the cached tables, as the card's first
    piece does), then again under the guard; returns what it saw."""
    fn()
    guard = _NoHostTraffic()
    with guard:
        fn()
    return guard.seen


def test_captured_particle_chunk_has_no_host_traffic():
    scene, cam = _small("cornell")
    cfg = common.RenderConfig(spp=1, max_depth=3)
    film = torch.zeros((64, 3))
    pid = torch.arange(256) + torch.tensor(256)
    assert not _guarded(lambda: ptracer._trace_chunk(scene, cam, cfg, pid, film))


@pytest.mark.parametrize("scene_name", ["cornell", "caustic"])
def test_captured_light_image_chunk_has_no_host_traffic(scene_name):
    scene, cam = _small(scene_name)
    cfg = common.RenderConfig(spp=4, max_depth=3, spp_chunk=2)
    chunk, layout = bdpt._layout(scene, cam, cfg)
    base = torch.tensor(2, dtype=torch.int64)
    assert not _guarded(lambda: bdpt._chunk_image(scene, cam, cfg, layout, base, chunk))


@pytest.mark.parametrize("radius", [None, 0.05])
def test_captured_beam_prologue_and_step_have_no_host_traffic(radius):
    scene, cam = _fog_box()[2:]
    cfg = common.RenderConfig(spp=1, max_depth=3)
    assert not _guarded(lambda: bre._prologue(scene, cam, cfg, 1 << 9, 3, radius))
    beams = bre._prologue(scene, cam, cfg, 1 << 9, 3, radius)
    k = torch.tensor(1.0)
    assert not _guarded(lambda: bre._beam_step(scene, cfg, beams, k, 1 << 9, 64))


def _generator_draw(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return lambda name, shape: torch.rand(shape, generator=gen)


@pytest.mark.parametrize("name", ["pssmlt", "erpt"])
def test_captured_mutation_has_no_host_traffic(name):
    scene, cam = _small("cornell")
    cfg = common.RenderConfig(spp=1, max_depth=3, seed=1)
    draw = _generator_draw(1)
    state, b = pssmlt.bootstrap(scene, cam, cfg, draw, 64, 256)
    img = torch.zeros((64, 3))
    if name == "pssmlt":
        def step():
            return pssmlt._mutate(scene, cam, cfg, draw, state, img, b, 0.3)
    else:
        def step():
            return erpt._mutate(scene, cam, cfg, draw, state, img, b / 4)
    assert not _guarded(step)


@pytest.mark.parametrize("mode", range(6))
def test_captured_mlt_kernel_has_no_host_traffic(mode):
    """Each kernel's mutation (F with both walks in the fixed form) on the
    perfect-mirror caustic box, whose paths hold delta chains."""
    scene, cam = _small("caustic")
    cfg = common.RenderConfig(spp=1, max_depth=3, seed=1)
    draw = mlt.generator_draws(1, "cpu")
    state, b = mlt._start(scene, cam, cfg, draw, 64, 256)
    img, acc = torch.zeros((64, 3)), torch.zeros((6,))
    assert mlt._scene_has_spec(scene)
    assert not _guarded(lambda: mlt._mutate(scene, cam, cfg, draw, mode, True, state, img, acc,
                                            b, fixed_walk=True))


def test_early_exit_walk_reads_the_host():
    """The guard sees the `while` walk's host read (what keeps it out of a
    graph), and not the fixed walk's."""
    make, case = CASES["mirror"]
    scene = ir.from_jax(make(), "cpu")
    args = [_t(a) for a in case()]
    assert "aten.is_nonzero.default" in _guarded(lambda: manifold.walk(scene, *args)) or \
        "aten._local_scalar_dense.default" in _guarded(lambda: manifold.walk(scene, *args))
    assert not _guarded(lambda: manifold.walk(scene, *args, fixed=True))


# --------------------------------------------------------------------------
# the graph-safe manifold walk
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_fixed_walk_equals_while_walk(name):
    """tests/test_manifold.py's flat mirror, glass slab and sphere mirror
    (its pole): ok, iterations, positions and prims bit for bit, the fixed
    form paying max_iterations iterations for the while form's count."""
    make, case = CASES[name]
    scene = ir.from_jax(make(), "cpu")
    args = [_t(a) for a in case()]
    res = manifold.walk(scene, *args)
    fixed = manifold.walk(scene, *args, fixed=True)
    for field in res._fields:
        a, b = getattr(res, field), getattr(fixed, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field
    assert int(res.iterations[0]) >= 1 and bool(res.ok.any())


def test_fixed_walk_stops_counting_at_the_condition():
    """The sphere mirror's walk runs 3 iterations: max_iterations 2 cuts
    both forms alike (the global condition still holds there:
    iterations = 2, the lanes not yet done), and the fixed form's 17
    iterations after the condition has fallen change nothing."""
    make, case = CASES["sphere"]
    scene = ir.from_jax(make(), "cpu")
    args = [_t(a) for a in case()]
    cut = manifold.walk(scene, *args, max_iterations=2)
    cut_fixed = manifold.walk(scene, *args, max_iterations=2, fixed=True)
    assert all(torch.equal(getattr(cut, f), getattr(cut_fixed, f)) for f in cut._fields)
    assert int(cut.iterations[0]) == 2 and not bool(cut.ok.all())
    full = manifold.walk(scene, *args, fixed=True)
    assert int(full.iterations[0]) == 3 and bool(full.ok.all())


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def _grad_scene():
    scene, cam = _small("cornell")
    return scene.replace(vertices=scene.vertices.clone().requires_grad_()), cam


GRAD_ENTRIES = {
    "ptracer": lambda s, c, k: ptracer.render_jit(s, c, k),
    "bdpt": lambda s, c, k: bdpt.render_jit(s, c, k),
    "bre": lambda s, c, k: bre.render_jit(s.replace(medium=_fog_box()[2].medium), c, k),
    "pssmlt": lambda s, c, k: pssmlt.render_jit(s, c, k),
    "erpt": lambda s, c, k: erpt.render_jit(s, c, k),
    "mlt": lambda s, c, k: mlt.render_jit(s, c, k),
}


@pytest.mark.parametrize("name", sorted(GRAD_ENTRIES))
def test_leaf_requiring_grad_raises(name):
    scene, cam = _grad_scene()
    with pytest.raises(NotImplementedError, match="render_grad"):
        GRAD_ENTRIES[name](scene, cam, common.RenderConfig(spp=1, max_depth=2))


def test_draws_hook_refused():
    """The card's render_jit refuses a draws hook (tests/test_torch_jit_card.py
    holds the entries to it on the card): graphs.refuse_hook raises
    ValueError naming the hook, and passes None."""
    graphs.refuse_hook("pssmlt.render_jit", uniforms=None)
    with pytest.raises(ValueError, match="`draws`"):
        graphs.refuse_hook("mlt.render_jit", draws=lambda *a: None)


# --------------------------------------------------------------------------
# the CLI's film routes
# --------------------------------------------------------------------------

CLI_ROUTES = {
    # --integrator: (module, keywords the CLI passes at -s 8, extra scene XML)
    "ptracer": (ptracer, {}, ""),
    "bre": (bre, {}, FOG),
    "pssmlt": (pssmlt, {"n_mutations": 64}, ""),
    "erpt": (erpt, {"chain_length": 64}, ""),
    "mlt": (mlt, {"n_mutations": 64}, ""),
}


@pytest.mark.parametrize("name", sorted(CLI_ROUTES))
def test_cli_film_routes_call_render_jit(tmp_path, monkeypatch, name):
    """--integrator NAME at 8x8 renders through NAME's render_jit (a spy
    that renders with render at reduced chain counts) with the JAX CLI's
    counts; the EXR is the spy's image."""
    mod, kw, extra = CLI_ROUTES[name]
    calls = []
    small = {"pssmlt": dict(n_chains=64, n_bootstrap=256), "erpt": dict(n_chains=64,
                                                                          n_bootstrap=256),
             "mlt": dict(n_chains=64, n_bootstrap=256), "bre": dict(n_paths=1 << 9)}
    real = functools.partial(mod.render, **small.get(name, {}))

    def spy(scene, cam, cfg, **k):
        calls.append(k)
        return real(scene, cam, cfg, **k)

    monkeypatch.setattr(mod, "render_jit", spy)
    p = write_scene(tmp_path, extra=extra)
    assert run(p, "-o", tmp_path / "o.exr", "-q", "--integrator", name) == 0
    assert calls == [kw]
    scene, cam, cfg, _ = xml.load_xml(p, device="cpu")
    np.testing.assert_array_equal(image.read_exr(tmp_path / "o.exr"),
                                  real(scene, cam, cfg, **kw).numpy())


def test_cli_mlt_env_lit_route_calls_pssmlt_render_jit(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(mlt, "render_jit", lambda *a, **k: pytest.fail("mlt on an env-lit scene"))
    monkeypatch.setattr(pssmlt, "render_jit", lambda scene, cam, cfg, **k: (
        calls.append(k), torch.full((cam.height, cam.width, 3), 0.5))[1])
    p = write_scene(tmp_path, extra='<emitter type="constant"><rgb name="radiance" '
                                    'value="0.5, 0.5, 0.5"/></emitter>')
    assert run(p, "-o", tmp_path / "o.exr", "-q", "--integrator", "mlt") == 0
    assert calls == [{"n_mutations": 64}]


def test_cli_irrcache_route_calls_common_render_jit(tmp_path, monkeypatch):
    calls = []
    real = common.render

    def spy(scene, cam, li_fn, cfg, *a, **k):
        calls.append(li_fn.__qualname__)
        return real(scene, cam, li_fn, cfg, *a, **k)

    monkeypatch.setattr(common, "render_jit", spy)
    p = write_scene(tmp_path)
    assert run(p, "-o", tmp_path / "o.exr", "-q", "--integrator", "irrcache") == 0
    assert calls == ["li_factory.<locals>.li"]
    assert cli.resolve_integrator("irrcache") == "irrcache"
