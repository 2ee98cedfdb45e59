"""Parity of the port's bidirectional family with the JAX package on the
CPU: the emitter ray API (sample_emitter_ray, connect_emitter_vertex,
emitter_dir_pdf_area, emitter_hit_pdf) over every emitter kind, the
streaming MIS functions of bdptmis, and the renders of bdpt.li,
bdpt.render (the light image), lvcbpt.li in its three MIS modes, vpl.li
and ptracer.render, plus LVC-BPT's dependence on the spp chunk.

Each JAX render is jitted once, on a module-scoped cache, at Cornell
8x8 x 4 spp, depth 3 (a jit of lvcbpt.li costs ~9 s on the CPU).

Bars:
- emitter rays: ROADMAP C10 (atol 1e-6 + rtol 1e-6), the envmap fixture
  at the envmap's C25 bar (1e-5 + 1e-5), each output with at most
  EMIT_MAX_OFF of 4,096 lanes beyond it (C36: the cosine lift's sqrt near
  the hemisphere's rim and a spot's falloff ramp turn a last-bit
  difference of XLA:CPU's sin/cos into ~1e-6); kind, tri and the delta
  flags bit for bit;
- bdptmis: rtol 1e-6 + atol 1e-6;
- renders: the goldens' rtol = atol = 1e-4, at most one pixel beyond it
  (C8's allowance).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mitsuba_tpu.integrators import (bdpt as jbdpt, bdptmis as jmis, common as jcom,
                                     lvcbpt as jlvc, ptracer as jpt, vpl as jvpl)
from mitsuba_tpu.models import emitter as jem
from mitsuba_tpu.scene import builtin as jb, envmap as jenv, ir as jir
from mitsuba_tpu_torch.integrators import bdpt, bdptmis, common, lvcbpt, ptracer, vpl
from mitsuba_tpu_torch.models import emitter, sensor
from mitsuba_tpu_torch.scene import ir

torch.set_num_threads(1)

N = 4096
EMIT_ATOL = EMIT_RTOL = 1e-6
ENVMAP_TOL = 1e-5
EMIT_MAX_OFF = 4
MIS_TOL = 1e-6
RENDER_TOL = 1e-4
RENDER_MAX_OFF = 1
CFG = dict(spp=4, max_depth=3, seed=0)
J = jnp.asarray


def T(a):
    return torch.as_tensor(np.array(a))


def _env_image(seed=4, h=16, w=32):
    rs = np.random.RandomState(seed)
    img = rs.uniform(0.05, 1.0, (h, w, 3)).astype(np.float32)
    img[h // 3, w // 4] *= 40.0   # hot spot
    return img


DELTA_RECORDS = {
    "directional": [{"kind": jir.DELTA_DIRECTIONAL, "direction": [0.3, -1.0, 0.2],
                     "intensity": [1.0, 0.9, 0.8]}],
    "mixed": [{"kind": jir.DELTA_POINT, "position": [0.5, 0.8, 0.5],
               "intensity": [2.0, 1.8, 1.5]},
              {"kind": jir.DELTA_SPOT, "position": [0.5, 0.95, 0.5],
               "direction": [0.0, -1.0, 0.0], "intensity": [4.0, 3.6, 3.0],
               "cutoff_deg": 40.0, "beam_deg": 30.0},
              {"kind": jir.DELTA_DIRECTIONAL, "direction": [0.3, -1.0, 0.2],
               "intensity": [1.0, 1.0, 1.0]}],
}


def _jscene(light):
    """The JAX fixture of each emitter kind: the area-lit Cornell box, the
    box with an envmap beside its area light, cornell_box_lit's point,
    spot and constant-env boxes, its geometry under a directional light,
    and the area-lit box with all three delta kinds and a constant env."""
    if light == "area":
        return jb.cornell_box(width=8, height=8)[0]
    if light == "envmap":
        return jenv.attach_envmap(jb.cornell_box(width=8, height=8)[0], _env_image(), 2.0)
    if light in ("point", "spot", "env"):
        return jb.cornell_box_lit(light, width=8, height=8)[0]
    base = jb.cornell_box_lit("point", width=8, height=8)[0]
    if light == "mixed":
        base = jb.cornell_box(width=8, height=8)[0].replace(
            has_env=True, env_radiance=jnp.asarray([0.2, 0.3, 0.4]))
    return base.replace(delta_emitters=jir.build_delta_emitters(DELTA_RECORDS[light]))


def _within(a, b, atol, rtol, what, max_off=EMIT_MAX_OFF):
    a = np.asarray(a).astype(np.float32)
    b = b.numpy().astype(np.float32)
    assert a.shape == b.shape, what
    off = (np.abs(a - b) > atol + rtol * np.abs(a)).reshape(a.shape[0], -1).any(-1)
    assert off.sum() <= max_off, (what, int(off.sum()), float(np.abs(a - b).max()))


@pytest.mark.parametrize("light", ["area", "envmap", "env", "point", "spot", "directional",
                                   "mixed"])
def test_emitter_ray_api_matches_jax(light):
    jscene = _jscene(light)
    scene = ir.from_jax(jscene, device="cpu")
    tol = ENVMAP_TOL if light == "envmap" else EMIT_ATOL
    rs = np.random.RandomState(0)
    u = rs.uniform(size=(N, 5)).astype(np.float32)
    jr = jem.sample_emitter_ray(jscene, J(u[:, 0]), J(u[:, 1:3]), J(u[:, 3:5]))
    r = emitter.sample_emitter_ray(scene, T(u[:, 0]), T(u[:, 1:3]), T(u[:, 3:5]))
    for f in jr._fields:
        if f in ("kind", "tri", "delta_pos", "delta_dir", "is_env", "is_area"):
            assert np.array_equal(np.asarray(getattr(jr, f)), getattr(r, f).numpy()), f
        else:
            _within(getattr(jr, f), getattr(r, f), tol, tol, f)
    kinds = {"area": {0}, "envmap": {0, 1}, "env": {1}, "point": {2}, "spot": {3},
             "directional": {4}, "mixed": {0, 1, 2, 3, 4}}[light]
    assert set(np.unique(r.kind.numpy())) == kinds

    # the connection and pdf helpers at random surface points, on the
    # JAX package's emitter vertices
    p = rs.uniform(0.05, 0.95, (N, 3)).astype(np.float32)
    y_ng = rs.normal(size=(N, 3)).astype(np.float32)
    y_ng /= np.linalg.norm(y_ng, axis=1, keepdims=True)
    z0 = [np.asarray(getattr(jr, f)) for f in ("kind", "pos", "ng", "aux_dir", "cutoff")]
    jout = jem.connect_emitter_vertex(jscene, J(p), *map(J, z0))
    out = emitter.connect_emitter_vertex(scene, T(p), *map(T, z0))
    for what, a, b in zip(("cdir", "dist", "g"), jout[:3], out[:3]):
        _within(a, b, tol, tol, what)
    assert np.array_equal(np.asarray(jout[3]), out[3].numpy())
    r_bs = float(np.asarray(jem.scene_bsphere(jscene)[1]))
    disk_pdf = np.float32(1.0) / (np.float32(np.pi) * np.float32(r_bs) * np.float32(r_bs))
    _within(jem.emitter_dir_pdf_area(*map(J, z0), J(disk_pdf), J(p), J(y_ng)),
            emitter.emitter_dir_pdf_area(*map(T, z0), T(disk_pdf), T(p), T(y_ng)),
            tol, tol, "emitter_dir_pdf_area")
    pdf_sa = rs.uniform(0.0, 3.0, N).astype(np.float32)
    _within(jem.emitter_hit_pdf(*map(J, z0[:3]), J(p), J(pdf_sa)),
            emitter.emitter_hit_pdf(*map(T, z0[:3]), T(p), T(pdf_sa)), tol, tol,
            "emitter_hit_pdf")


def _mis_inputs(seed):
    rs = np.random.RandomState(seed)

    def pos(*shape, lo=0.0, hi=3.0):
        return rs.uniform(lo, hi, shape).astype(np.float32)

    def unit():
        v = rs.normal(size=(N, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    kind = rs.randint(0, 5, N).astype(np.int32)
    cut = np.stack([pos(N, lo=0.5, hi=0.8), pos(N, lo=0.85, hi=0.99)], -1)
    return dict(pos=pos, unit=unit, kind=kind, cut=cut, delta=rs.uniform(size=N) < 0.3)


@pytest.mark.parametrize("b", [1.0, 2.0])
def test_bdptmis_matches_jax(b):
    """Every bdptmis function on random states, at the balance and the
    power exponent."""
    x = _mis_inputs(int(b))
    pos, unit = x["pos"], x["unit"]
    st = (pos(N), pos(N))
    st_z = (pos(N), pos(N))
    js, ts = jmis.MisState(*map(J, st)), bdptmis.MisState(*map(T, st))
    jz, tz = jmis.MisState(*map(J, st_z)), bdptmis.MisState(*map(T, st_z))

    def both(name, *args, jstate=(), tstate=()):
        a = getattr(jmis, name)(*jstate, *[J(v) if isinstance(v, np.ndarray) else v
                                           for v in args])
        t = getattr(bdptmis, name)(*tstate, *[T(v) if isinstance(v, np.ndarray) else v
                                             for v in args])
        for ja, ta in zip(a if isinstance(a, tuple) else (a,),
                          t if isinstance(t, tuple) else (t,)):
            _within(ja, ta, MIS_TOL, MIS_TOL, name, max_off=0)

    ers_np = dict(d=unit(), ng=unit(), kind=x["kind"], pdf_pos=pos(N), pdf_dir=pos(N))
    jers = jem.EmitterRaySample(*[J(ers_np[f]) if f in ers_np else None
                                  for f in jem.EmitterRaySample._fields])
    ters = emitter.EmitterRaySample(*[T(ers_np[f]) if f in ers_np else None
                                      for f in emitter.EmitterRaySample._fields])
    ja, ta = jmis.light_start(jers, b), bdptmis.light_start(ters, b)
    for a, t in zip(ja, ta):
        _within(a, t, MIS_TOL, MIS_TOL, "light_start", max_off=0)
    for light_image in (False, True):
        both("camera_start", 65536, pos(N), b, light_image)
    both("on_hit", pos(N), pos(N, lo=-1, hi=1), b, jstate=(js,), tstate=(ts,))
    skip = x["delta"]
    a = jmis.on_hit(js, J(st[0]), J(st[1]), b, skip_dist2=J(skip))
    t = bdptmis.on_hit(ts, T(st[0]), T(st[1]), b, skip_dist2=T(skip))
    for ja_, ta_ in zip(a, t):
        _within(ja_, ta_, MIS_TOL, MIS_TOL, "on_hit skip", max_off=0)
    both("scatter", pos(N), pos(N), pos(N, lo=-1, hi=1), x["delta"], b,
         jstate=(js,), tstate=(ts,))
    both("weight_hit_area", pos(N), pos(N), b, jstate=(js,), tstate=(ts,))
    both("weight_hit_env", pos(N), np.float32(0.7), b, jstate=(js,), tstate=(ts,))
    both("weight_connect_z0", x["kind"], pos(N, 3), unit(), unit(), x["cut"], pos(N),
         np.float32(0.4), pos(N, 3), unit(), pos(N), pos(N), b, jstate=(js,), tstate=(ts,))
    both("weight_connect_inner", pos(N), pos(N), pos(N), pos(N), pos(N, lo=-1, hi=1),
         pos(N, lo=-1, hi=1), pos(N, lo=0.01), b, jstate=(js, jz), tstate=(ts, tz))
    both("weight_splat", pos(N), 4096, pos(N), b, jstate=(jz,), tstate=(tz,))
    both("weight_splat_z0", pos(N), pos(N), 4096, x["delta"], b)


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

def _fixture(name):
    if name == "cornell":
        return jb.cornell_box(width=8, height=8)
    if name == "cornell16":
        return jb.cornell_box(width=16, height=16)
    if name == "caustic":
        return jb.caustic_box(width=8, height=8)
    return jb.cornell_box_lit(name, width=8, height=8)


@pytest.fixture(scope="module")
def scenes():
    """{fixture: (JAX scene, JAX camera, port scene, port camera)}."""
    out = {}
    for name in ("cornell", "cornell16", "caustic", "point"):
        jscene, jcam = _fixture(name)
        out[name] = (jscene, jcam, ir.from_jax(jscene, device="cpu"),
                     sensor.camera_from_jax(jcam, device="cpu"))
    return out


RENDERS = {
    # name: (fixture, JAX render, port render, config changes)
    "bdpt_li": ("cornell", lambda s, c, k: jcom.render_jit(s, c, jbdpt.li, k),
                lambda s, c, k: common.render(s, c, bdpt.li, k), {}),
    "bdpt_render": ("cornell", lambda s, c, k: jbdpt.render_jit(s, c, k),
                    bdpt.render, {}),
    "bdpt_render_caustic": ("caustic", lambda s, c, k: jbdpt.render_jit(s, c, k),
                            bdpt.render, {}),
    # the power mode at 16x16 x 32 spp: one chunk of 8,192 rays (2,048 light
    # paths), or with spp_chunk=16 two of 4,096 (1,024 paths each)
    "lvcbpt_power": ("cornell16", lambda s, c, k: jcom.render_jit(s, c, jlvc.li, k),
                     lambda s, c, k: common.render(s, c, lvcbpt.li, k),
                     {"mis_mode": 0, "spp": 32}),
    "lvcbpt_power_chunk16": ("cornell16", lambda s, c, k: jcom.render_jit(s, c, jlvc.li, k),
                             lambda s, c, k: common.render(s, c, lvcbpt.li, k),
                             {"mis_mode": 0, "spp": 32, "spp_chunk": 16}),
    "lvcbpt_balance": ("cornell", lambda s, c, k: jcom.render_jit(s, c, jlvc.li, k),
                       lambda s, c, k: common.render(s, c, lvcbpt.li, k), {"mis_mode": 1}),
    "lvcbpt_uniform": ("cornell", lambda s, c, k: jcom.render_jit(s, c, jlvc.li, k),
                       lambda s, c, k: common.render(s, c, lvcbpt.li, k), {"mis_mode": 2}),
    "lvcbpt_point": ("point", lambda s, c, k: jcom.render_jit(s, c, jlvc.li, k),
                     lambda s, c, k: common.render(s, c, lvcbpt.li, k), {}),
    "vpl": ("cornell", lambda s, c, k: jcom.render_jit(s, c, jvpl.li, k),
            lambda s, c, k: common.render(s, c, vpl.li, k), {}),
    "ptracer": ("cornell", lambda s, c, k: jpt.render_jit(s, c, k), ptracer.render, {}),
}


@pytest.fixture(scope="module")
def rendered(scenes):
    """name -> (JAX image, port image), each rendered once."""
    cache = {}

    def get(name):
        if name not in cache:
            fixture, jfn, tfn, changes = RENDERS[name]
            jscene, jcam, scene, cam = scenes[fixture]
            cfg = {**CFG, **changes}
            ref = np.asarray(jfn(jscene, jcam, jcom.RenderConfig(**cfg)))
            img = tfn(scene, cam, common.RenderConfig(**cfg))
            assert img.dtype == torch.float32
            cache[name] = ref, img.numpy()
        return cache[name]
    return get


def _render_close(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    off = (np.abs(img - ref) > RENDER_TOL + RENDER_TOL * np.abs(ref)).any(-1)
    assert off.sum() <= RENDER_MAX_OFF, (np.argwhere(off), np.abs(img - ref).max())


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_matches_jax(rendered, name):
    ref, img = rendered(name)
    _render_close(img, ref)
    assert img.mean() > 0.01


def test_lvcbpt_image_depends_on_the_chunk(rendered):
    """lvcbpt.li sizes its light cache from its batch (max(N // 4, 1024)
    paths, a new cache each call), so spp_chunk=16 renders another image
    than the default chunk (all 32 spp in one call), in both packages
    alike."""
    ref32, img32 = rendered("lvcbpt_power")
    ref16, img16 = rendered("lvcbpt_power_chunk16")
    assert np.abs(ref16 - ref32).max() > 1e-3
    np.testing.assert_allclose(img16 - img32, ref16 - ref32, rtol=0, atol=2 * RENDER_TOL)


def test_mis_modes_differ_but_agree_in_mean(rendered):
    """The balance and uniform modes weigh the same strategies
    differently: other images, the same expectation (loosely, at 256
    samples)."""
    (_, bal), (_, uni) = rendered("lvcbpt_balance"), rendered("lvcbpt_uniform")
    assert np.abs(bal - uni).max() > 1e-3
    assert abs(bal.mean() - uni.mean()) < 0.15 * bal.mean()
