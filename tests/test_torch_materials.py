"""Parity of the port's materials with the JAX package: the microfacet
distributions, every ported BSDF family's eval_pdf and sample, the coating
and blend adapters, and a family code outside every table raising. Inputs are drawn
with numpy from a seed and sent through both packages' functions (eager
JAX on the CPU).

Bars (ROADMAP C23): atol 1e-5 plus rtol 1e-5 on eval's f and pdf, rtol
1e-4 on sample's wo, weight and pdf, delta flags equal. The microfacet
terms go through sqrt, rsqrt, atan2, exp and log, where XLA:CPU and torch
differ in the last bit, and a sampled microfacet normal carries that into
a sharp lobe: sampled pdfs of 0.05-rough Beckmann lobes reach ~50 and
differ by up to 6e-5 relative (the port's float32 values lie as close to
a float64 evaluation as JAX's or closer). At most MAX_FLIPS of N lanes
per output may exceed the bar: lanes on the other side of a one-ulp
decision (a lobe pick u <= F, a side test) or at a grazing microfacet."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mitsuba_tpu.models import bsdf as jB, microfacet as jmf
from mitsuba_tpu.scene import ir as jir
from mitsuba_tpu_torch.models import bsdf as tB, microfacet as tmf
from mitsuba_tpu_torch.scene import ir as tir

torch.set_num_threads(1)

N = 4096
ATOL = RTOL = 1e-5
SAMPLE_RTOL = 1e-4
# lanes allowed on the other side of a one-ulp decision, per output
MAX_FLIPS = 4


def _dirs(rs, n, upper=False):
    w = rs.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    if upper:
        w[:, 2] = np.abs(w[:, 2])
    return w.astype(np.float32)


def _off(a, b, atol=ATOL, rtol=RTOL):
    """Lanes where a (port) and b (JAX) differ beyond the bars."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    bad = ~np.isclose(a, b, atol=atol, rtol=rtol)
    return bad.reshape(bad.shape[0], -1).any(-1) if bad.ndim > 1 else bad


def _check(port, ref, what, flips=0, rtol=RTOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, what
    assert np.isfinite(port).all(), what
    off = _off(port, ref, rtol=rtol) if ref.dtype != bool else (port != ref)
    assert off.sum() <= flips, (what, int(off.sum()), np.argwhere(off)[:4].ravel())
    return int(off.sum())


def _shade_point(rs, fam, n=N):
    """A random ShadePoint record of family `fam` as numpy fields."""
    rec = dict(
        type=np.full(n, fam, np.int32),
        reflectance=rs.uniform(0.05, 0.95, (n, 3)),
        specular=rs.uniform(0.2, 1.0, (n, 3)),
        eta=np.repeat(rs.uniform(1.1, 2.4, (n, 1)), 3, 1),
        k=rs.uniform(0.0, 4.0, (n, 3)),
        alpha=rs.uniform(0.04, 0.6, (n, 2)),
        extra=np.stack([rs.uniform(0.0, 1.0, n), np.zeros(n),
                        (rs.uniform(size=n) < 0.3).astype(np.float64),
                        rs.randint(0, 2, n).astype(np.float64)], -1),
    )
    if fam == jir.BSDF_CONDUCTOR or fam == jir.BSDF_ROUGH_CONDUCTOR:
        rec["eta"] = rs.uniform(0.2, 2.0, (n, 3))
    if fam == jir.BSDF_PHONG:
        rec["extra"][:, 0] = rs.uniform(1.0, 60.0, n)
    if fam in (jir.BSDF_ROUGH_DIELECTRIC, jir.BSDF_ROUGH_PLASTIC):
        # a share of the rough dielectrics seen from inside (eta < 1)
        inside = rs.uniform(size=n) < 0.3
        rec["eta"][inside] = 1.0 / rec["eta"][inside]
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in rec.items()}


def _pair(rec, nested=None):
    jsp = jB.ShadePoint(**{k: jnp.asarray(v) for k, v in rec.items()},
                        nested=None if nested is None else nested[0])
    tsp = tB.ShadePoint(**{k: torch.as_tensor(v) for k, v in rec.items()},
                        nested=None if nested is None else nested[1])
    return jsp, tsp


def _inputs(seed, n=N):
    rs = np.random.RandomState(seed)
    return rs, _dirs(rs, n), _dirs(rs, n), rs.uniform(size=(n, 3)).astype(np.float32)


def _compare(jsp, tsp, fams, wi, wo, u, flips=0):
    """eval_pdf and sample of both packages on the same inputs; returns
    the number of flipped lanes per output."""
    T, J = torch.as_tensor, jnp.asarray
    jf, jpdf = jB.eval_pdf(jsp, J(wi), J(wo), fams)
    f, pdf = tB.eval_pdf(tsp, T(wi), T(wo), fams)
    n_off = {"f": _check(f, jf, "f", flips), "pdf": _check(pdf, jpdf, "pdf", flips)}
    jout = jB.sample(jsp, J(wi), J(u[:, 0]), J(u[:, 1:3]), fams)
    out = tB.sample(tsp, T(wi), T(u[:, 0]), T(u[:, 1:3]), fams)
    for name, a, b in zip(("wo", "weight", "pdf_s", "delta"), out, jout):
        n_off[name] = _check(a, b, name, flips, SAMPLE_RTOL)
    # both the eval and the sampled outputs must exercise the family
    assert (f.amax(-1) > 0).any() or fams[0] in tB.DELTA_FAMILIES
    assert (out[1].amax(-1) > 0).any()
    return n_off


FAMILIES = [tir.BSDF_DIFFUSE, tir.BSDF_CONDUCTOR, tir.BSDF_ROUGH_CONDUCTOR,
            tir.BSDF_DIELECTRIC, tir.BSDF_ROUGH_DIELECTRIC, tir.BSDF_PLASTIC,
            tir.BSDF_ROUGH_PLASTIC, tir.BSDF_PHONG, tir.BSDF_THIN_DIELECTRIC,
            tir.BSDF_ROUGH_DIFFUSE, tir.BSDF_WARD, tir.BSDF_MASK,
            tir.BSDF_DIFFUSE_TRANSMITTER, tir.BSDF_NULL, tir.BSDF_HK]


@pytest.mark.parametrize("fam", FAMILIES, ids=[tir.BSDF_NAMES[f] for f in FAMILIES])
def test_family_matches_jax(fam):
    """eval_pdf and sample of one family on 4,096 random (wi, wo, u) over
    the whole sphere, a third of the lanes twosided."""
    rs, wi, wo, u = _inputs(10 + fam)
    jsp, tsp = _pair(_shade_point(rs, fam))
    _compare(jsp, tsp, (fam,), wi, wo, u, flips=MAX_FLIPS)


def test_mixed_families_dispatch():
    """The masked dispatch over a scene's family set: every family at once,
    each lane its own."""
    rs, wi, wo, u = _inputs(3)
    parts = [_shade_point(rs, f, N // len(FAMILIES) + 1) for f in FAMILIES]
    rec = {k: np.concatenate([p[k] for p in parts])[:N] for k in parts[0]}
    jsp, tsp = _pair(rec)
    _compare(jsp, tsp, tuple(sorted(FAMILIES)), wi, wo, u, flips=MAX_FLIPS)


@pytest.mark.parametrize("child", [tir.BSDF_DIFFUSE, tir.BSDF_ROUGH_CONDUCTOR,
                                   tir.BSDF_DIELECTRIC])
def test_coating_matches_jax(child):
    """The coating adapter over a nested diffuse, rough-conductor or smooth
    dielectric base; half the coats rough (roughcoating), half delta."""
    rs, wi, wo, u = _inputs(20 + child)
    coat = _shade_point(rs, tir.BSDF_COATING)
    coat["reflectance"] *= 0.5                              # sigmaA * thickness
    coat["alpha"][:, 0] = np.where(rs.uniform(size=N) < 0.5, 0.0, coat["alpha"][:, 0])
    jn, tn = _pair(_shade_point(rs, child))
    jsp, tsp = _pair(coat, nested=(jn, tn))
    _compare(jsp, tsp, tuple(sorted({tir.BSDF_COATING, child})), wi, wo, u,
             flips=MAX_FLIPS)


def _material_scene(pkg_ir, build, records, textures=None, device=None):
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    kw = {} if device is None else {"device": device}
    return build(verts, np.asarray([[0, 1, 2]], np.int32), np.zeros(1, np.int32),
                 records, uvs=np.asarray([[0, 0], [1, 0], [0, 1]], np.float32),
                 textures=textures, **kw)


def test_blend_and_gather_match_jax():
    """gather_shade_point's blend adapter (a flat and a textured weight)
    resolves to the same child on every lane with u_blend, and the
    gathered record, nested coating child included, equals JAX's."""
    recs = [
        {"type": jir.BSDF_DIFFUSE, "reflectance": [0.7, 0.2, 0.1]},
        {"type": jir.BSDF_ROUGH_CONDUCTOR, "alpha": [0.2, 0.3], "eta": [0.2, 0.9, 1.1],
         "k": [3.9, 2.4, 2.1], "extra": [0, 0, 0, 1]},
        {"type": jir.BSDF_BLEND, "extra": [0.3, 0, 0, 0], "nested": (0, 1)},
        {"type": jir.BSDF_BLEND, "extra": [0.5, 0, 0, 0], "nested": (1, 4),
         "tex_reflectance": 0},
        {"type": jir.BSDF_COATING, "eta": [1.5] * 3, "extra": [0.5, 0, 0, 1],
         "alpha": [0.1, 0.1], "nested": (1, -1), "reflectance": [0.1, 0.2, 0.3]},
    ]
    rs = np.random.RandomState(5)
    tex = [{"data": rs.uniform(0, 1, (8, 8, 3)).astype(np.float32)}]
    jscene = _material_scene(jir, jir.build_scene, recs, tex)
    scene = _material_scene(tir, tir.build_scene, recs, tex, device="cpu")
    mat = rs.randint(0, len(recs), N).astype(np.int32)
    uv = rs.uniform(-0.5, 1.5, (N, 2)).astype(np.float32)
    ub = rs.uniform(size=N).astype(np.float32)
    jsp = jB.gather_shade_point(jscene, jnp.asarray(mat), jnp.asarray(uv), u_blend=jnp.asarray(ub))
    sp = tB.gather_shade_point(scene, torch.as_tensor(mat), torch.as_tensor(uv),
                               u_blend=torch.as_tensor(ub))
    for f in ("type", "specular", "eta", "k", "alpha", "extra"):
        assert np.array_equal(np.asarray(getattr(jsp, f)), getattr(sp, f).numpy()), f
        assert np.array_equal(np.asarray(getattr(jsp.nested, f)), getattr(sp.nested, f).numpy()), f
    _check(sp.reflectance, jsp.reflectance, "reflectance")
    # both children of both blends were taken
    blended = (mat == 2) | (mat == 3)
    assert set(sp.type.numpy()[blended].tolist()) == {
        tir.BSDF_DIFFUSE, tir.BSDF_ROUGH_CONDUCTOR, tir.BSDF_COATING}
    _, wi, wo, u = _inputs(6)
    fams = scene.bsdf_families
    assert fams == jscene.bsdf_families
    _compare(jsp, sp, fams, wi, wo, u, flips=MAX_FLIPS)


def test_microfacet_matches_jax():
    """d_eval, smith_g1, g_eval, sample and pdf of both distributions,
    anisotropic, on 4,096 random (wi, h, u)."""
    rs = np.random.RandomState(7)
    wi = _dirs(rs, N, upper=True)
    wo = _dirs(rs, N)
    h = _dirs(rs, N, upper=True)
    u = rs.uniform(size=(N, 2)).astype(np.float32)
    dist = rs.randint(0, 2, N).astype(np.int32)
    au = rs.uniform(0.01, 0.8, N).astype(np.float32)
    av = rs.uniform(0.01, 0.8, N).astype(np.float32)
    T, J = torch.as_tensor, jnp.asarray
    cases = [
        ("d_eval", jmf.d_eval(J(dist), J(au), J(h), J(av)), tmf.d_eval(T(dist), T(au), T(h), T(av))),
        ("d_eval_iso", jmf.d_eval(J(dist), J(au), J(h)), tmf.d_eval(T(dist), T(au), T(h))),
        ("smith_g1", jmf.smith_g1(J(dist), J(au), J(wo), J(h), J(av)),
         tmf.smith_g1(T(dist), T(au), T(wo), T(h), T(av))),
        ("g_eval", jmf.g_eval(J(dist), J(au), J(wi), J(wo), J(h), J(av)),
         tmf.g_eval(T(dist), T(au), T(wi), T(wo), T(h), T(av))),
        ("pdf", jmf.pdf(J(dist), J(au), J(wi), J(h), J(av)),
         tmf.pdf(T(dist), T(au), T(wi), T(h), T(av))),
    ]
    jh, jp = jmf.sample(J(dist), J(au), J(wi), J(u), J(av))
    th, tp = tmf.sample(T(dist), T(au), T(wi), T(u), T(av))
    for name, ref, got in cases:
        _check(got, ref, name)
    _check(th, jh, "sample_h", MAX_FLIPS, SAMPLE_RTOL)
    _check(tp, jp, "sample_pdf", MAX_FLIPS, SAMPLE_RTOL)
    assert (th[:, 2] > 0).all() and (tp > 0).any()


@pytest.mark.parametrize("fam", [tir.BSDF_IRAWAN])
def test_unported_families_raise(fam):
    """Irawan, the last family that raised, now dispatches (its parity with
    the JAX package on packed yarn records is tests/test_torch_cloth.py);
    a family code outside every table still raises naming it."""
    sp = tB.ShadePoint(**{k: torch.as_tensor(v) for k, v in
                          _shade_point(np.random.RandomState(0), fam, 8).items()})
    w = torch.zeros(8, 3)
    w[:, 2] = 1.0
    assert torch.isfinite(tB.eval_pdf(sp, w, w, (fam,))[0]).all()
    assert torch.isfinite(tB.sample(sp, w, w[:, 0], w[:, :2], (fam,))[1]).all()
    unknown = max(tir.BSDF_NAMES) + 1
    with pytest.raises(NotImplementedError, match=str(unknown)):
        tB.eval_pdf(sp, w, w, (unknown,))
    with pytest.raises(NotImplementedError, match=str(unknown)):
        tB.sample(sp, w, w[:, 0], w[:, :2], (unknown,))


GRAD_FAMILIES = [tir.BSDF_ROUGH_CONDUCTOR, tir.BSDF_ROUGH_DIELECTRIC,
                 tir.BSDF_ROUGH_PLASTIC, tir.BSDF_WARD, tir.BSDF_ROUGH_DIFFUSE,
                 tir.BSDF_PLASTIC, tir.BSDF_PHONG, tir.BSDF_COATING, tir.BSDF_HK]
# lanes of 4,096 whose roughness gradient is NaN in both packages: the
# coating's sample over a rough conductor, where the bent direction meets
# the conductor's Fresnel at a zero square root (C24)
SHARED_NAN_LANES = {tir.BSDF_COATING: 2}


@pytest.mark.parametrize("fam", GRAD_FAMILIES, ids=[tir.BSDF_NAMES[f] for f in GRAD_FAMILIES])
def test_family_gradients_finite_and_match_jax(fam):
    """Masked dispatch evaluates every branch on every lane, and a NaN on a
    discarded lane still poisons reverse mode. The gradient of eval's and
    sample's outputs with respect to each lane's roughness, reflectance and
    eta: finite on every lane but SHARED_NAN_LANES, and equal to jax.grad's
    within 1e-4 of its largest entry on every lane where jax.grad's is
    finite. (It is not everywhere: on lanes with wi below the horizon, the
    rough dielectric's and rough plastic's sample give JAX NaN roughness
    gradients through jnp.maximum's adjoint at a zero sqrt argument, where
    torch's clamp masks the infinite adjoint; C24.)"""
    import jax

    rs, wi, wo, u = _inputs(40 + fam)
    rec = _shade_point(rs, fam)
    child = _shade_point(rs, tir.BSDF_ROUGH_CONDUCTOR)
    fams = (fam,) if fam != tir.BSDF_COATING else (tir.BSDF_ROUGH_CONDUCTOR, fam)
    leaves = ("alpha", "reflectance", "eta")
    T, J = torch.as_tensor, jnp.asarray

    def loss(pkg, conv, xs):
        r = dict(rec, **dict(zip(leaves, xs)))
        nested = pkg.ShadePoint(**{k: conv(v) for k, v in child.items()})
        sp = pkg.ShadePoint(**{k: v if k in leaves else conv(v) for k, v in r.items()},
                            nested=nested)
        f, pdf = pkg.eval_pdf(sp, conv(wi), conv(wo), fams)
        _, w, p, _ = pkg.sample(sp, conv(wi), conv(u[:, 0]), conv(u[:, 1:3]), fams)
        return f.sum() + pdf.sum() + w.sum() + p.sum()

    xs = [T(rec[k]).clone().requires_grad_(True) for k in leaves]
    loss(tB, T, xs).backward()
    jg = jax.grad(lambda *a: loss(jB, J, a), argnums=(0, 1, 2))(*(J(rec[k]) for k in leaves))
    nan_lanes = 0
    for name, x, g in zip(leaves, xs, jg):
        g = np.asarray(g).reshape(N, -1)
        mine = np.zeros_like(g) if x.grad is None else x.grad.numpy().reshape(N, -1)
        jfin = np.isfinite(g).all(-1)
        fin = np.isfinite(mine).all(-1)
        assert fin[jfin].all(), (name, np.argwhere(jfin & ~fin).ravel()[:4])
        nan_lanes = max(nan_lanes, int((~fin).sum()))
        scale = max(np.abs(g[jfin]).max(), 1e-6)
        assert np.abs(mine[jfin] - g[jfin]).max() <= 1e-4 * scale, (
            name, np.abs(mine[jfin] - g[jfin]).max(), scale)
    assert nan_lanes == SHARED_NAN_LANES.get(fam, 0), nan_lanes
