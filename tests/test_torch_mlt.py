"""Parity of the port's path-space MLT (mitsuba_tpu_torch/integrators/
mlt.py) with the JAX package on the CPU.

Two scenes at 8x8, depth 3: the Cornell box (five kernels, A-E) and
caustic_box with a perfect mirror (six kernels: F and the manifold walk
run, and eval_path's quotient-manifold terms). Every draw is the JAX
package's own: the threefry keys split as mlt.render splits them, served
to the port's `draws=` hook by name (ROADMAP C42).

- `_regen` on the bootstrap (cut 0, connect mode) with the JAX draws:
  positions within 1e-5 (atol + rtol), prims, lengths and flags equal.
- `eval_path` on those paths: colour and luminance within 1e-5, the pixel
  index equal; `regen_pdf` within 1e-5 relative, at cut 0 in connect mode
  and at a random cut per path with half the lanes in hit mode.
- The bootstrap's seeds: the chains each package's CDF picks from its own
  weights. torch's cumsum rounds otherwise than XLA's, so a pick within a
  rounding of a bin edge may take the neighbouring path (C39): at most
  MAX_SEED_FLIPS of 256.
- `render` (256 chains, 1,024 bootstrap paths, two full kernel cycles:
  10 and 12 mutations) against `mlt.render_jit`: at most 4 of 64 pixels
  beyond the goldens' 1e-4, `b` within 1e-5 relative, every kernel's
  acceptance within 1e-5.
- tests/test_mlt_manifold.py's mirror-chain path: eval_path against the
  JAX package's and its closed form, and zero off the reflection law.

The JAX unit functions run eagerly on the bootstrap (1,024 lanes), and
jitted on the one-lane mirror path; each JAX render is jitted once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.integrators import common as jcom, mlt as jmlt
from mitsuba_tpu.scene import builtin as jb
from mitsuba_tpu_torch.integrators import common, mlt
from mitsuba_tpu_torch.models import sensor
from mitsuba_tpu_torch.scene import ir

torch.set_num_threads(1)

EVAL_TOL = 1e-5
RENDER_TOL = 1e-4
MAX_PIXELS_OFF = 4
MAX_SEED_FLIPS = 2
WIDTH, DEPTH, SEED = 8, 3, 1
N_BOOT, N_CHAINS = 1024, 256
CFG = dict(spp=1, max_depth=DEPTH, seed=SEED)
# (scene constructor, mutations = two cycles of the scene's kernels, kernels)
SCENES = {"cornell": (lambda: jb.cornell_box(width=WIDTH, height=WIDTH), 10, 5),
          "caustic": (lambda: jb.caustic_box(width=WIDTH, height=WIDTH, rough=False), 12, 6)}


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_draws(seed, n_mutations, n_modes):
    """The JAX render's draws by the port's names (mlt.py:606-632, :642,
    :652, :703, :758, :908, :921; _regen's split at :532), and a `draws`
    hook serving them in order."""
    K = DEPTH
    out = {}
    kb, kr, km = jax.random.split(jax.random.PRNGKey(seed), 3)
    kb1, kb2, _ = jax.random.split(kb, 3)
    out["boot_length"] = [jax.random.randint(kb1, (N_BOOT,), 1, K + 1)]
    ks = jax.random.split(kb2, K + 2)
    out["boot_regen"] = [jax.random.uniform(ks[j], (N_BOOT, 4)) for j in range(K)]
    out["boot_light"] = [jax.random.uniform(ks[K], (N_BOOT, 3))]
    out["boot_key"] = [kb2]
    out["pick"] = [jax.random.uniform(kr, (N_CHAINS,))]
    for i, kk in enumerate(jax.random.split(km, n_mutations)):
        k1, k2, k3, k4, k5 = jax.random.split(kk, 5)
        ks = jax.random.split(k2, K + 2)
        steps = {"cut": [jax.random.uniform(k1, (N_CHAINS, 4))],
                 "regen": [jax.random.uniform(ks[j], (N_CHAINS, 4)) for j in range(K)],
                 "regen_light": [jax.random.uniform(ks[K], (N_CHAINS, 3))],
                 "perturb": [jax.random.uniform(k3, (N_CHAINS, 4))],
                 "accept": [jax.random.uniform(k4, (N_CHAINS,))]}
        if i % n_modes == 5:
            steps["manifold"] = [jax.random.uniform(k5, (N_CHAINS, 1))]
        for name, v in steps.items():
            out.setdefault(name, []).extend(v)
    served = {name: iter(v) for name, v in out.items()}

    def draw(name, shape, low=None, high=None):
        a = _t(next(served[name]))
        assert tuple(a.shape) == tuple(shape), (name, a.shape, shape)
        if high is not None:
            assert a.dtype == torch.int32 and int(a.min()) >= low and int(a.max()) < high
        return a

    return draw, out, served


@pytest.fixture(scope="module")
def boxes():
    out = {}
    for name, (make, n_mut, n_modes) in SCENES.items():
        jscene, jcam = make()
        out[name] = (jscene, jcam, ir.from_jax(jscene, "cpu"), sensor.camera_from_jax(jcam, "cpu"),
                     n_mut, n_modes)
    return out


@pytest.fixture(scope="module")
def boots(boxes):
    """Per scene: the JAX bootstrap (eager, from the render's own keys) and
    the port's functions on the same paths."""
    K = DEPTH
    out = {}
    for name, (jscene, jcam, scene, cam, n_mut, n_modes) in boxes.items():
        _, raw, _ = jax_draws(SEED, n_mut, n_modes)
        zero = jnp.zeros((N_BOOT,), jnp.int32)
        no_hit = jnp.zeros((N_BOOT,), bool)
        pos0 = jnp.zeros((N_BOOT, K + 1, 3)).at[:, 0].set(jcam.to_world[:3, 3])
        prim0 = jnp.full((N_BOOT, K + 1), -1, jnp.int32)
        k_new0 = raw["boot_length"][0]
        jpaths = jmlt._regen(jscene, jcam, raw["boot_key"][0], pos0, prim0, zero + 1, zero,
                             k_new0, K, no_hit)
        tz = torch.zeros((N_BOOT,), dtype=torch.int32)
        paths = mlt._regen(scene, cam, [_t(u) for u in raw["boot_regen"]],
                           _t(raw["boot_light"][0]), _t(pos0), _t(prim0), tz + 1, tz,
                           _t(k_new0), K, torch.zeros((N_BOOT,), dtype=torch.bool))
        jev = jmlt.eval_path(jscene, jcam, *jpaths[:3], K)
        ev = mlt.eval_path(scene, cam, *(_t(a) for a in jpaths[:3]), K)
        # regen_pdf at cut 0 (connect), then at a random cut per path with
        # half the lanes in hit mode
        rs = np.random.default_rng(3)
        k = np.asarray(jpaths[2])
        cut = np.minimum((rs.uniform(size=N_BOOT) * k).astype(np.int32), np.maximum(k - 1, 0))
        hit = rs.uniform(size=N_BOOT) < 0.5
        pdfs = []
        for c, mh in ((np.zeros(N_BOOT, np.int32), np.zeros(N_BOOT, bool)), (cut, hit)):
            want = jmlt.regen_pdf(jscene, jcam, *jpaths[:3], jnp.asarray(c), K, jnp.asarray(mh))
            got = mlt.regen_pdf(scene, cam, *(_t(a) for a in jpaths[:3]), _t(c), K, _t(mh))
            pdfs.append((got, want))
        out[name] = (jpaths, paths, jev, ev, pdfs, raw)
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_regen_matches_jax(boots, name):
    jpaths, paths = boots[name][:2]
    for i in (1, 2, 3):
        np.testing.assert_array_equal(paths[i].numpy(), np.asarray(jpaths[i]))
    np.testing.assert_allclose(paths[0].numpy(), np.asarray(jpaths[0]), rtol=EVAL_TOL,
                               atol=EVAL_TOL)
    assert paths[3].float().mean() > 0.5


@pytest.mark.parametrize("name", sorted(SCENES))
def test_eval_path_matches_jax(boots, name):
    jev, ev = boots[name][2:4]
    assert (ev[1].numpy() > 0).sum() > N_BOOT // 8       # the paths carry light
    for got, want in zip(ev[:2], jev[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=EVAL_TOL, atol=EVAL_TOL)
    np.testing.assert_array_equal(ev[2].numpy(), np.asarray(jev[2]))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_regen_pdf_matches_jax(boots, name):
    for got, want in boots[name][4]:
        want = np.asarray(want)
        assert (want > 0).sum() > N_BOOT // 4
        np.testing.assert_allclose(got.numpy(), want, rtol=EVAL_TOL, atol=0)


@pytest.fixture(scope="module")
def renders(boxes):
    out = {}
    for name, (jscene, jcam, scene, cam, n_mut, n_modes) in boxes.items():
        kw = dict(n_chains=N_CHAINS, n_mutations=n_mut, n_bootstrap=N_BOOT, return_stats=True)
        jimg, jst = jmlt.render_jit(jscene, jcam, jcom.RenderConfig(**CFG), **kw)
        draw, _, served = jax_draws(SEED, n_mut, n_modes)
        img, st = mlt.render(scene, cam, common.RenderConfig(**CFG), draws=draw, **kw)
        unused = {k: sum(1 for _ in v) for k, v in served.items() if k != "boot_key"}
        out[name] = (img.numpy(), st, np.asarray(jimg), jst, unused)
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bootstrap_seeds_match_jax(boxes, boots, name):
    """The chains' seeds: each package's CDF over its own bootstrap
    weights, searched with the same picks."""
    jscene, jcam, scene, cam = boxes[name][:4]
    jpaths, _, jev, ev, pdfs, raw = boots[name]
    seeds = []
    for lum, t0, ok, cum in ((jev[1], pdfs[0][1], jpaths[3], jnp.cumsum),
                             (ev[1], pdfs[0][0], _t(jpaths[3]), None)):
        if cum is None:
            lb = torch.where(ok, lum, 0.0)
            t0 = t0 / DEPTH
            wgt = torch.where((t0 > 0) & (lb > 0), lb / torch.clamp_min(t0, 1e-30), 0.0)
            seeds.append(mlt.seed_chains(wgt, _t(raw["pick"][0])).numpy())
        else:
            lb = jnp.where(ok, lum, 0.0)
            t0 = t0 / jnp.float32(DEPTH)
            wgt = jnp.where((t0 > 0) & (lb > 0), lb / jnp.maximum(t0, 1e-30), 0.0)
            cdf = cum(wgt)
            picks = raw["pick"][0] * jnp.maximum(cdf[-1], 1e-30)
            seeds.append(np.asarray(jnp.clip(jnp.searchsorted(cdf, picks), 0, N_BOOT - 1)))
    assert int((seeds[0] != seeds[1]).sum()) <= MAX_SEED_FLIPS


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_jax_with_its_draws(boxes, renders, name):
    n_modes = boxes[name][5]
    got, st, want, jst, unused = renders[name]
    assert not any(unused.values()), unused               # every JAX draw consumed
    assert np.isfinite(got).all() and got.min() >= 0 and got.mean() > 0.05
    off = int((~np.isclose(got, want, rtol=RENDER_TOL, atol=RENDER_TOL)).any(-1).sum())
    assert off <= MAX_PIXELS_OFF, (off, float(np.abs(got - want).max()))
    jb_ = float(jst["b"])
    assert abs(float(st["b"]) - jb_) <= EVAL_TOL * jb_
    acc, jacc = st["acceptance"].numpy(), np.asarray(jst["acceptance"])
    assert acc.shape == (n_modes,)
    np.testing.assert_allclose(acc, jacc, rtol=0, atol=EVAL_TOL)
    assert (acc > 0).all(), acc


def test_eval_path_mirror_chain():
    """tests/test_mlt_manifold.py's E -> mirror -> emitter path: the
    port's f equals the JAX package's (1e-5) and the closed form We x
    F_conductor x G_gen x Le (the JAX test's 5e-3); off the reflection law
    f is zero."""
    from mitsuba_tpu.ops import trace as jtrace
    from test_mlt_manifold import mirror_emitter_scene

    jscene, jcam, le = mirror_emitter_scene()
    scene, cam = ir.from_jax(jscene, "cpu"), sensor.camera_from_jax(jcam, "cpu")
    K = 3
    eye = np.asarray(jcam.to_world[:3, 3], np.float32)
    v1 = np.asarray([[0.08, 0.02, 0.0]], np.float32)
    dir1 = (v1[0] - eye) / np.linalg.norm(v1[0] - eye)
    dref = dir1 * np.asarray([1, 1, -1], np.float32)
    v2 = v1[0] + (2.0 / dref[2]) * dref
    its1 = jtrace.closest_hit(jscene, jnp.asarray(eye[None, :]), jnp.asarray(dir1[None, :]))
    its2 = jtrace.closest_hit(jscene, jnp.asarray(v1 + 1e-3 * dref), jnp.asarray(dref[None, :]))
    pos = np.zeros((1, K + 1, 3), np.float32)
    pos[:, 0], pos[:, 1], pos[:, 2] = eye, v1, v2
    prim = np.full((1, K + 1), -1, np.int32)
    prim[:, 1], prim[:, 2] = np.asarray(its1.prim), np.asarray(its2.prim)
    k = np.asarray([2], np.int32)
    jeval = jax.jit(lambda s, c, p, pr, kk: jmlt.eval_path(s, c, p, pr, kk, K)[0])
    want = np.asarray(jeval(jscene, jcam, jnp.asarray(pos), jnp.asarray(prim), jnp.asarray(k)))
    got = mlt.eval_path(scene, cam, _t(pos), _t(prim), _t(k), K)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=EVAL_TOL, atol=EVAL_TOL)
    d1 = float(np.linalg.norm(v1[0] - eye))
    d2 = float(np.linalg.norm(v2 - v1[0]))
    we = float(mlt._cam_we(cam, _t(dir1[None, :]))[0][0])
    fcond = mlt.m.fresnel_conductor(torch.tensor([abs(float(dir1[2]))]),
                                    torch.tensor([[0.2, 0.92, 1.1]]),
                                    torch.tensor([[3.9, 2.45, 2.14]])).numpy()[0]
    expect = we * fcond * (abs(float(dref[2])) / (d1 + d2) ** 2) * np.asarray(le)
    assert got.min() > 0
    np.testing.assert_allclose(got[0], expect, rtol=5e-3)
    pos[:, 2, 0] += 0.4
    assert float(mlt.eval_path(scene, cam, _t(pos), _t(prim), _t(k), K)[0].max()) == 0.0


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_glass_box_is_the_jax_tests():
    """chip_smoke.py's [mlt_glass] scene and camera, built by the port,
    equal tests/test_mlt_manifold.py's glass_box carried across."""
    from test_mlt_manifold import glass_box

    jscene, jcam = glass_box(width=10, height=10)
    scene, cam = _chip_smoke().glass_box(10, "cpu")
    want = ir.from_jax(jscene, "cpu")
    for field in ("vertices", "indices", "normals", "tri_material", "tri_emitter"):
        assert torch.equal(getattr(scene, field), getattr(want, field)), field
    for field in ("type", "reflectance", "specular", "eta"):
        assert torch.equal(getattr(scene.materials, field), getattr(want.materials, field))
    assert torch.equal(scene.emitters.radiance, want.emitters.radiance)
    assert scene.bsdf_families == want.bsdf_families
    assert torch.equal(cam.to_world, sensor.camera_from_jax(jcam, "cpu").to_world)
