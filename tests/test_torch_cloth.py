"""Parity of the port's woven cloth (mitsuba_tpu_torch/models/cloth.py, the
Irawan family of models/bsdf.py) and its noise (core/noise.py) with the JAX
package on the CPU, on inputs drawn with numpy from a seed.

Bars:
- noise (perlin_noise, perlin_noise_1d, fbm, turbulence): 1e-6 absolute;
- the numpy threefry copy (core/rng.py) against jax.random: bit for bit;
- parse_weave (both presets, `$var` substitution) and build_tables: exact;
- gather_yarn on 4,096 uvs in [-2, 3)^2 (negative and > 1 coordinates,
  which the int32 -> uint32 casts wrap), with the Perlin umax perturbation
  and the intensity variation on: C10's bar (atol + rtol 1e-6), the yarn
  picks exact;
- eval_packed, and the bsdf family's eval_pdf and sample on packed records
  of both presets: C23's bars (atol + rtol 1e-5 on eval, rtol 1e-4 on
  sample), at most MAX_FLIPS of 4,096 lanes per output beyond them;
- compute_normalization's spec_norm: 1e-6 relative;
- the irawan quad of tests/test_irawan.py rendered at 8x8 by path.li
  against the JAX render: the goldens' 1e-4 on every pixel.

Measured: gather_yarn's outputs equal but `specular` (1.6e-7 relative,
through the intensity variation's log); 0 lanes beyond the bars in eval
and sample (the largest gap 1.5e-6, in a sampled wo); spec_norm 1.2e-7 and
1.6e-7 relative for cotton and silk.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.core import noise as jnoise
from mitsuba_tpu.integrators import common as jcom, path as jpath
from mitsuba_tpu.models import bsdf as jB, cloth as jcloth
from mitsuba_tpu.scene import ir as jir, xml as jxml
from mitsuba_tpu_torch.core import noise, rng
from mitsuba_tpu_torch.integrators import common, path
from mitsuba_tpu_torch.models import bsdf as tB, cloth
from mitsuba_tpu_torch.scene import xml

torch.set_num_threads(1)

NOISE_ATOL = 1e-6
C10 = 1e-6
ATOL = RTOL = 1e-5
SAMPLE_RTOL = 1e-4
MAX_FLIPS = 4
RENDER_TOL = 1e-4
N = 4096
# a cotton weave with every optional term on: the Perlin umax perturbation
# (period > 0) and the intensity variation (fineness > 0)
PERTURBED = jcloth.PRESET_COTTON.replace(
    "fineness = 0.0, period = 0.0",
    "fineness = 3.0, period = 2.0, dWarpUmaxOverDWarp = 10.0, "
    "dWarpUmaxOverDWeft = 8.0, dWeftUmaxOverDWarp = 6.0, dWeftUmaxOverDWeft = 4.0")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_noise_matches_jax():
    rs = np.random.RandomState(0)
    p = rs.uniform(-20, 20, (N, 3)).astype(np.float32)
    lattice = rs.randint(-10, 10, (256, 3)).astype(np.float32)
    x = np.linspace(-8.0, 8.0, 4097, dtype=np.float32)
    for fn, jfn, arg in ((noise.perlin_noise, jnoise.perlin_noise, p),
                         (noise.perlin_noise, jnoise.perlin_noise, lattice),
                         (noise.perlin_noise_1d, jnoise.perlin_noise_1d, x),
                         (noise.fbm, jnoise.fbm, p[:512] / 4),
                         (noise.turbulence, jnoise.turbulence, p[:512] / 4)):
        got, want = fn(_t(arg)).numpy(), np.asarray(jfn(jnp.asarray(arg)))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=NOISE_ATOL, err_msg=fn.__name__)
    assert np.abs(noise.perlin_noise(_t(lattice)).numpy()).max() <= NOISE_ATOL


@pytest.mark.parametrize("seed", [0, 1, 0xE897])
def test_threefry_copy_is_bit_exact(seed):
    """The keys and uniforms compute_normalization draws, and pssmlt's
    shapes, against jax.random."""
    key = jax.random.PRNGKey(seed)
    nkey = rng.threefry_key(seed)
    assert np.array_equal(np.asarray(key), nkey)
    for num in (3, 5):
        assert np.array_equal(np.asarray(jax.random.split(key, num)),
                              rng.threefry_split(nkey, num))
    for k, nk in zip(jax.random.split(key, 3), rng.threefry_split(nkey, 3)):
        for shape in ((10000, 2), (256, 28), (7,)):
            want = np.asarray(jax.random.uniform(k, shape))
            got = rng.threefry_uniform(nk, shape)
            assert got.dtype == np.float32 and got.shape == want.shape
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), shape


def _pattern_fields(pat):
    out = {k: v for k, v in vars(pat).items() if k != "yarns"}
    out["yarns"] = [vars(y) for y in pat.yarns]
    return out


def _assert_same(a, b, where="pattern"):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), where
        for k in b:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("text,props", [
    (jcloth.PRESET_COTTON, None), (jcloth.PRESET_SILK, None),
    (jcloth.PRESET_SILK.replace("beta = 10.0", "beta = $myBeta").replace(
        "kd = {0.20, 0.25, 0.33}", "kd = {$r, 0.25, 0.33}"), {"myBeta": 7.5, "r": 0.4}),
    (PERTURBED, None)], ids=["cotton", "silk", "var", "perturbed"])
def test_parse_weave_matches_jax(text, props):
    want = _pattern_fields(jcloth.parse_weave(text, props))
    got = _pattern_fields(cloth.parse_weave(text, props))
    _assert_same(got, want)
    assert cloth.PRESETS == jcloth.PRESETS


def _entries(pkg):
    """Three slots (perturbed cotton, silk, cotton) on five materials, each
    pattern with a fixed spec_norm so build_tables alone is compared."""
    out = []
    for text, ru, rv, norm in ((PERTURBED, 6.0, 6.0, 1.5), (pkg.PRESET_SILK, 2.0, 3.0, 2.25),
                               (pkg.PRESET_COTTON, 1.0, 1.0, 0.75)):
        pat = pkg.parse_weave(text)
        pat.spec_norm = norm
        out.append((pat, ru, rv))
    return out


MAT_SLOTS = {1: 0, 3: 1, 4: 2}


def test_build_tables_exact():
    jtab = jcloth.build_tables(_entries(jcloth), 5, MAT_SLOTS)
    tab = cloth.build_tables(_entries(cloth), 5, MAT_SLOTS, device="cpu")
    for f in cloth.ClothTables._fields:
        want, got = np.asarray(getattr(jtab, f)), getattr(tab, f).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f


@pytest.fixture(scope="module")
def yarns():
    """gather_yarn of both packages on 4,096 uvs over the three slots."""
    rs = np.random.RandomState(3)
    uv = rs.uniform(-2.0, 3.0, (N, 2)).astype(np.float32)
    mat = rs.choice(sorted(MAT_SLOTS), N).astype(np.int32)
    jover = jcloth.gather_yarn(jcloth.build_tables(_entries(jcloth), 5, MAT_SLOTS),
                               jnp.asarray(mat), jnp.asarray(uv))
    over = cloth.gather_yarn(cloth.build_tables(_entries(cloth), 5, MAT_SLOTS, device="cpu"),
                             _t(mat), _t(uv))
    return {k: np.asarray(v) for k, v in jover.items()}, over, mat


def test_gather_yarn_matches_jax(yarns):
    jover, over, mat = yarns
    assert sorted(over) == sorted(jover)
    for k in jover:
        np.testing.assert_allclose(over[k].numpy(), jover[k], rtol=C10, atol=C10, err_msg=k)
    # every slot, both yarn kinds, the perturbation and the variation ran
    assert set(np.unique(over["eta"][:, 2].numpy())) == {0.0, 1.0}
    cotton = mat == 1
    umax = over["k"][:, 0].numpy()
    assert umax[cotton].std() > 1e-3 and np.unique(over["specular"][cotton, 0].numpy()).size > 100


def _sp(over, pkg_sp, fam_type, T):
    n = over["eta"].shape[0]
    return pkg_sp(type=T(np.full(n, fam_type, np.int32)),
                  **{k: T(np.asarray(over[k])) for k in
                     ("reflectance", "specular", "eta", "k", "alpha", "extra")})


def _off(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    bad = ~np.isclose(a, b, atol=ATOL, rtol=rtol)
    return int((bad.reshape(bad.shape[0], -1).any(-1) if bad.ndim > 1 else bad).sum())


def test_eval_and_family_match_jax(yarns):
    """eval_packed and the Irawan family through bsdf.eval_pdf / sample, on
    the packed records of all three slots."""
    jover, over, _ = yarns
    rs = np.random.RandomState(4)
    wi = rs.normal(size=(N, 3))
    wi[:, 2] = np.abs(wi[:, 2]) * np.where(rs.uniform(size=N) < 0.9, 1, -1)
    wi = (wi / np.linalg.norm(wi, axis=-1, keepdims=True)).astype(np.float32)
    wo = rs.normal(size=(N, 3))
    wo[:, 2] = np.abs(wo[:, 2])
    wo = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(np.float32)
    u = rs.uniform(size=(N, 3)).astype(np.float32)
    J, T = jnp.asarray, torch.as_tensor
    jsp = _sp(jover, jB.ShadePoint, jir.BSDF_IRAWAN, J)
    sp = _sp({k: v.numpy() for k, v in over.items()}, tB.ShadePoint, jir.BSDF_IRAWAN, T)
    fams = (jir.BSDF_IRAWAN,)
    pairs = [("eval_f", cloth.eval_packed(sp, T(wi), T(wo))[0],
              jcloth.eval_packed(jsp, J(wi), J(wo))[0], RTOL)]
    for name, a, b in zip(("f", "pdf"), tB.eval_pdf(sp, T(wi), T(wo), fams),
                          jB.eval_pdf(jsp, J(wi), J(wo), fams)):
        pairs.append((name, a, b, RTOL))
    out = tB.sample(sp, T(wi), T(u[:, 0]), T(u[:, 1:3]), fams)
    jout = jB.sample(jsp, J(wi), J(u[:, 0]), J(u[:, 1:3]), fams)
    for name, a, b in zip(("wo", "weight", "pdf_s"), out[:3], jout[:3]):
        pairs.append((name, a, b, SAMPLE_RTOL))
    assert not out[3].any() and not np.asarray(jout[3]).any()
    for name, a, b, rtol in pairs:
        a = a.numpy()
        assert np.isfinite(a).all(), name
        assert _off(a, b, rtol) <= MAX_FLIPS, (name, _off(a, b, rtol))
    # the specular integrand contributes beyond the kd/pi floor on some lanes
    f = pairs[0][1].numpy()
    floor = (over["reflectance"].numpy() / np.pi) * np.clip(wo[:, 2:3], 0, None)
    assert ((f - floor).max(-1) > 1e-3).sum() > 100


@pytest.mark.parametrize("preset", ["cotton", "silk"])
def test_spec_norm_matches_jax(preset):
    want = jcloth.compute_normalization(jcloth.parse_weave(jcloth.PRESETS[preset]))
    pat = cloth.parse_weave(cloth.PRESETS[preset])
    got = cloth.compute_normalization(pat)
    assert got == pat.spec_norm and got > 0
    assert abs(got - want) <= 1e-6 * want, (got, want)


QUAD = """<scene version="0.6.0">
    <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
    <sensor type="perspective">
        <float name="fov" value="40"/>
        <transform name="toWorld">
            <lookat origin="0, 0.4, 2.2" target="0, 0, 0" up="0, 1, 0"/>
        </transform>
        <sampler type="independent"><integer name="sampleCount" value="8"/></sampler>
        <film type="hdrfilm">
            <integer name="width" value="8"/><integer name="height" value="8"/>
        </film>
    </sensor>
    <emitter type="constant"><rgb name="radiance" value="1, 1, 1"/></emitter>
    <shape type="rectangle">
        <transform name="toWorld"><rotate x="1" angle="-90"/></transform>
        <bsdf type="irawan">
            <string name="preset" value="silk"/>
            <float name="repeatU" value="6"/>
            <float name="repeatV" value="6"/>
        </bsdf>
    </shape>
</scene>
"""


def test_irawan_quad_render_matches_jax(tmp_path):
    """tests/test_irawan.py's quad (silk here: the filament integrand; the
    staple one is cotton's) at 8x8 x 8 spp through path.li."""
    p = tmp_path / "cloth.xml"
    p.write_text(QUAD)
    jscene, jcam, jcfg, _ = jxml.load_xml(p)
    want = np.asarray(jcom.render_jit(jscene, jcam, jpath.li, jcfg))
    scene, cam, cfg, _ = xml.load_xml(p, device="cpu")
    got = common.render(scene, cam, path.li, cfg).numpy()
    assert np.isfinite(got).all() and got.mean() > 0.03
    np.testing.assert_allclose(got, want, rtol=RENDER_TOL, atol=RENDER_TOL)
