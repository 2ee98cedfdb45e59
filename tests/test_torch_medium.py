"""Parity of the port's phase functions and media with the JAX package:
every phase kind's eval_pdf, sample and sample_weight, the micro-flake
table, the density and orientation lookups, bake_dense, the grid's
quadrature transmittance, the homogeneous closed forms, both tracking
walks on the JAX package's uniforms, and from_jax carrying a medium and
delta emitters. Inputs are drawn with numpy
from a seed and sent through both packages (eager JAX on the CPU).

Bars (ROADMAP C23): atol 1e-5 plus rtol 1e-5 on values and pdfs, rtol 1e-4
on sampled directions; the closed forms and lookups at 1e-6. Micro-flake
sampling goes through erfinv, whose XLA and torch approximations differ in
the last bits, hence atol 1e-5 there. A sampled or tracked lane that lies
on the other side of a one-ulp decision (a rejection test, a real/null
collision, the surface crossing) takes another branch: at most MAX_FLIPS of
N lanes per output may exceed the bar (measured on the CPU: none does)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mitsuba_tpu.core.rng import uniform as juniform
from mitsuba_tpu.models import medium as jmed, phase as jph
from mitsuba_tpu.scene import builtin as jb, ir as jir
from mitsuba_tpu_torch.models import medium as tmed, phase as tph
from mitsuba_tpu_torch.scene import ir as tir

torch.set_num_threads(1)

N = 4096
ATOL = RTOL = 1e-5
SAMPLE_RTOL = 1e-4
CLOSED_TOL = 1e-6
MAX_FLIPS = 4

KKAY = (0.3, 0.8, 0.2, 0.6, 0.4, 12.0)
MIXTURE = (tph.PHASE_HG, 0.7, 0.6, tph.PHASE_RAYLEIGH, 0.3, 0.0)
MICROFLAKE = tph.make_microflake_params(0.3, axis=(0.2, 0.9, 0.1))


def _dirs(rs, n):
    w = rs.normal(size=(n, 3))
    return (w / np.linalg.norm(w, axis=-1, keepdims=True)).astype(np.float32)


def _check(port, ref, what, atol=ATOL, rtol=RTOL, flips=0):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.isfinite(port).all(), what
    if ref.dtype == bool:
        off = port != ref
    else:
        off = ~np.isclose(port.astype(np.float64), ref.astype(np.float64), atol=atol, rtol=rtol)
        off = off.reshape(off.shape[0], -1).any(-1) if off.ndim > 1 else off
    assert off.sum() <= flips, (what, int(off.sum()), np.argwhere(off).ravel()[:4])


PHASES = {
    "isotropic": (tph.PHASE_ISOTROPIC, (), False),
    "hg": (tph.PHASE_HG, (), False),
    "rayleigh": (tph.PHASE_RAYLEIGH, (), False),
    "kkay": (tph.PHASE_KKAY, KKAY, False),
    "kkay_axis": (tph.PHASE_KKAY, KKAY, True),
    "mixture": (tph.PHASE_MIXTURE, MIXTURE, False),
    "microflake": (tph.PHASE_MICROFLAKE, MICROFLAKE, False),
    "microflake_axis": (tph.PHASE_MICROFLAKE, MICROFLAKE, True),
}


@pytest.mark.parametrize("name", list(PHASES))
def test_phase_matches_jax(name):
    """eval_pdf, sample and sample_weight of one kind on 4,096 random (wi,
    wo, u2) over the sphere; g per lane in (-0.9, 0.9), a tenth of the
    lanes at g = 0 (HG's isotropic branch); `_axis` cases give every lane
    its own fiber axis (an orientation volume's lookup)."""
    kind, params, per_lane = PHASES[name]
    rs = np.random.RandomState(sum(map(ord, name)))
    wi, wo = _dirs(rs, N), _dirs(rs, N)
    u2 = rs.uniform(size=(N, 2)).astype(np.float32)
    g = np.where(rs.uniform(size=N) < 0.1, 0.0, rs.uniform(-0.9, 0.9, N)).astype(np.float32)
    axis = _dirs(rs, N) if per_lane else None
    T, J = torch.as_tensor, jnp.asarray
    tax = None if axis is None else T(axis)
    jax_ = None if axis is None else J(axis)
    mf = kind == tph.PHASE_MICROFLAKE
    atol = 1e-5 if mf else ATOL

    jv, jp = jph.eval_pdf(kind, J(g), J(wi), J(wo), params, jax_)
    v, p = tph.eval_pdf(kind, T(g), T(wi), T(wo), params, tax)
    _check(v, jv, "value", atol)
    _check(p, jp, "pdf", atol)
    assert float(v.max()) > 0.0

    jwo, jpdf = jph.sample(kind, J(g), J(wi), J(u2), params, jax_)
    two, tpdf = tph.sample(kind, T(g), T(wi), T(u2), params, tax)
    flips = MAX_FLIPS if mf else 0
    _check(two, jwo, "wo", atol, SAMPLE_RTOL, flips)
    _check(tpdf, jpdf, "pdf_s", atol, SAMPLE_RTOL, flips)
    jw = jph.sample_weight(kind, J(g), J(wi), jwo, jpdf, params, jax_)
    w = tph.sample_weight(kind, T(g), T(wi), T(np.array(jwo)), T(np.array(jpdf)), params, tax)
    _check(w, jw, "weight", atol, SAMPLE_RTOL)
    # a sampled direction is a unit vector with a positive pdf
    assert np.allclose(np.linalg.norm(two.numpy(), axis=-1)[tpdf.numpy() > 0], 1.0, atol=1e-5)
    assert (tpdf > 0).float().mean() > 0.9


@pytest.mark.parametrize("stddev", [0.05, 0.3, 1.0])
def test_microflake_params_match_jax(stddev):
    a = np.asarray(tph.make_microflake_params(stddev, axis=(1.0, 2.0, 0.5)))
    b = np.asarray(jph.make_microflake_params(stddev, axis=(1.0, 2.0, 0.5)))
    assert a.shape == b.shape == (6 + 16,)
    assert np.allclose(a, b, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        tph.make_microflake_params(2.0)


def _hgrid_arrays(rs):
    table = np.arange(12, dtype=np.int32).reshape(2, 3, 2)
    table[0, 1, 1] = table[1, 2, 0] = -1
    blocks = rs.uniform(0.0, 3.0, (12, 4, 5, 3)).astype(np.float32)
    return table, blocks


def _media(rs):
    """(JAX, port) pairs: a dense grid with an orientation volume, and a
    block-sparse grid, both over the box [-0.5, 1.5]^3."""
    dens = rs.uniform(0.0, 2.0, (5, 6, 7)).astype(np.float32)
    orient = rs.normal(size=(4, 5, 6, 3)).astype(np.float32)
    orient[0, 0, 0] = 0.0                      # a degenerate voxel
    box = dict(box_min=(-0.5, -0.5, -0.5), box_max=(1.5, 1.5, 1.5))
    grid = (jmed.make_grid(dens, [0.5, 1.0, 1.5], 0.7, 0.2, orientation=orient, **box),
            tmed.make_grid(dens, [0.5, 1.0, 1.5], 0.7, 0.2, orientation=orient,
                           device="cpu", **box))
    table, blocks = _hgrid_arrays(rs)
    hgrid = (jmed.make_hgrid(table, blocks, 2.0, 0.6, 0.1, **box),
             tmed.make_hgrid(table, blocks, 2.0, 0.6, 0.1, device="cpu", **box))
    return grid, hgrid


def test_lookups_match_jax():
    """density_at (dense and block-sparse), orientation_at and bake_dense
    at 1e-6, on points over a box 10% larger than the medium's (outside
    points give 0); transmittance_grid (a 32-step sum of lookups) at 1e-5."""
    rs = np.random.RandomState(1)
    (jg, tg), (jh, th) = _media(rs)
    p = rs.uniform(-0.7, 1.7, (N, 3)).astype(np.float32)
    for jm, tm in ((jg, tg), (jh, th)):
        ref = np.asarray(jmed.density_at(jm, jnp.asarray(p)))
        _check(tmed.density_at(tm, torch.as_tensor(p)), ref, f"density kind {tm.kind}",
               CLOSED_TOL, CLOSED_TOL)
        assert (ref == 0).any() and (ref > 0).any()
        jb_ = jmed.bake_dense(jm, (6, 7, 8))
        tb = tmed.bake_dense(tm, (6, 7, 8))
        assert tb.kind == tmed.MEDIUM_GRID and tb.density.shape == (6, 7, 8)
        _check(tb.density.reshape(-1), np.asarray(jb_.density).reshape(-1), "bake_dense",
               CLOSED_TOL, CLOSED_TOL)
    _check(tmed.orientation_at(tg, torch.as_tensor(p)),
           jmed.orientation_at(jg, jnp.asarray(p)), "orientation", CLOSED_TOL, CLOSED_TOL)
    assert tmed.phase_axis(th, torch.as_tensor(p)) is None
    # the jittered Riemann-sum transmittance over 256 segments
    o, d = p[:256], _dirs(rs, 256)
    dist, u = rs.uniform(0.0, 2.0, 256).astype(np.float32), rs.uniform(size=256).astype(np.float32)
    T, J = torch.as_tensor, jnp.asarray
    _check(tmed.transmittance_grid(tg, T(o), T(d), T(dist), T(u)),
           jmed.transmittance_grid(jg, J(o), J(d), J(dist), J(u)), "Tr_grid", 1e-5, 1e-5)


def test_homogeneous_closed_forms_match_jax():
    """transmittance and sample_distance (t, the event split, both weights)
    at 1e-6, misses (t_surface 1e30) included."""
    rs = np.random.RandomState(2)
    jm = jmed.make_homogeneous([0.5, 1.0, 2.0], [0.1, 0.2, 0.3], 0.4)
    tm = tmed.make_homogeneous([0.5, 1.0, 2.0], [0.1, 0.2, 0.3], 0.4, device="cpu")
    dist = np.concatenate([rs.uniform(0, 5, N - 2), [0.0, 1e30]]).astype(np.float32)
    _check(tmed.transmittance(tm, torch.as_tensor(dist)),
           jmed.transmittance(jm, jnp.asarray(dist)), "Tr", CLOSED_TOL, CLOSED_TOL)
    u = rs.uniform(size=(2, N)).astype(np.float32)
    t_surf = np.where(rs.uniform(size=N) < 0.2, 1e30, rs.uniform(0.1, 3.0, N)).astype(np.float32)
    ref = jmed.sample_distance(jm, *(jnp.asarray(x) for x in (u[0], u[1], t_surf)))
    got = tmed.sample_distance(tm, *(torch.as_tensor(x) for x in (u[0], u[1], t_surf)))
    for what, a, b in zip(("t", "is_medium", "w_med", "w_surf"), got, ref):
        _check(a, b, what, CLOSED_TOL, CLOSED_TOL)
    assert got[1].any() and not got[1].all()


def _jax_uniforms(seed, n, count):
    """The JAX package's stream uniforms for dims 0..count-1 of n lanes."""
    lanes = jnp.arange(n, dtype=jnp.uint32)
    return np.stack([np.asarray(juniform(jnp.uint32(seed), lanes, jnp.uint32(0), jnp.uint32(j)))
                     for j in range(count)])


@pytest.mark.parametrize("kind", ["grid", "hgrid"])
def test_tracking_matches_jax(kind):
    """sample_distance_grid (weighted delta tracking) and
    transmittance_track (ratio tracking), 48 steps each, on the JAX
    uniforms: rays from outside through the medium's box, surfaces at
    random depths. 1e-5, at most MAX_FLIPS lanes per output across a
    one-ulp collision decision."""
    rs = np.random.RandomState(3)
    (jg, tg), (jh, th) = _media(rs)
    jm, tm = (jg, tg) if kind == "grid" else (jh, th)
    n = 1024
    o = (rs.uniform(-0.3, 1.3, (n, 3)) - np.asarray([0.0, 0.0, 2.5])).astype(np.float32)
    d = _dirs(rs, n)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_surf = np.where(rs.uniform(size=n) < 0.2, 1e30, rs.uniform(1.5, 5.0, n)).astype(np.float32)
    steps = tmed.TRACK_STEPS
    u = _jax_uniforms(9, n, 3 * steps)
    ju = jnp.asarray(u)
    T, J = torch.as_tensor, jnp.asarray

    ref = jmed.sample_distance_grid(jm, lambda j: ju[j], J(o), J(d), J(t_surf))
    got = tmed.sample_distance_grid(tm, lambda j: T(u[j]), T(o), T(d), T(t_surf))
    for what, a, b in zip(("t", "is_medium", "w_med", "w_surf"), got, ref):
        _check(a, b, what, flips=MAX_FLIPS)
    assert got[1].any() and not got[1].all()

    dist = np.minimum(t_surf, 4.0).astype(np.float32)
    ref_tr = jmed.transmittance_track(jm, lambda j: ju[2 * steps + j], J(o), J(d), J(dist))
    tr = tmed.transmittance_track(tm, lambda j: T(u[2 * steps + j]), T(o), T(d), T(dist))
    _check(tr, ref_tr, "Tr_track", flips=MAX_FLIPS)
    assert float(tr.min()) < 0.5 and float(tr.max()) == 1.0


def test_from_jax_carries_medium_and_delta_emitters():
    """A JAX Cornell scene with a grid medium (orientation volume, kkay
    phase) and three delta lights crosses from_jax leaf for leaf; the
    static fields stay Python values; detach() detaches the medium."""
    rs = np.random.RandomState(4)
    (jg, _), (jh, _) = _media(rs)
    jg = jg.replace(phase=jph.PHASE_KKAY, phase_params=KKAY)
    recs = [{"kind": jir.DELTA_POINT, "position": [0.5, 0.8, 0.5], "intensity": 2.0},
            {"kind": jir.DELTA_SPOT, "position": [0.5, 0.95, 0.5], "direction": [0, -1, 0],
             "intensity": [4.0, 3.6, 3.0], "cutoff_deg": 40.0, "beam_deg": 30.0},
            {"kind": jir.DELTA_DIRECTIONAL, "direction": [0.2, -1, 0.1]}]
    jscene, _ = jb.cornell_box(width=4, height=4)
    for jm in (jg, jh):
        scene = tir.from_jax(jscene.replace(medium=jm,
                                            delta_emitters=jir.build_delta_emitters(recs)),
                             device="cpu")
        med = scene.medium
        assert (med.kind, med.phase, med.phase_params) == (jm.kind, jm.phase, tuple(jm.phase_params))
        for f in ("sigma_t", "albedo", "g", "density", "box_min", "box_max", "block_table",
                  "orientation"):
            a, b = getattr(med, f), getattr(jm, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert np.array_equal(a.numpy(), np.asarray(b)), f
        ref = tir.build_delta_emitters(recs, device="cpu")
        for f in ("kind", "position", "direction", "intensity", "cutoff"):
            assert np.array_equal(getattr(scene.delta_emitters, f).numpy(),
                                  np.asarray(getattr(jir.build_delta_emitters(recs), f))), f
            assert torch.equal(getattr(scene.delta_emitters, f), getattr(ref, f)), f
    s = scene.replace(medium=scene.medium.replace(
        sigma_t=scene.medium.sigma_t.clone().requires_grad_(True)))
    assert s.medium.sigma_t.requires_grad and not s.detach().medium.sigma_t.requires_grad
