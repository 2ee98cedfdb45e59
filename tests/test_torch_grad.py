"""Parity of the port's gradient path with the JAX package: the scene's edge
tables, the differentiable hit, the direct integrator, the path gradient
past Russian roulette, the edge-sampled boundary terms (boundary.py) and
the warped-area reparameterization (reparam.py).

Gradients are compared on the same camera rays and sample streams: the
port's rays are handed to the JAX function as numpy arrays, so both walk
the same paths, and the loss is the mean radiance of the batch (the
image's mean when every pixel has the same spp). Tolerances are stated at
each test (ROADMAP C15-C21).
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mitsuba_tpu.core.rng import SampleStream as JStream
from mitsuba_tpu.integrators import boundary as jbd, common as jcom, direct as jdirect
from mitsuba_tpu.integrators import path as jpath, reparam as jrp
from mitsuba_tpu.models import sensor as jsens
from mitsuba_tpu.ops import trace as jtrace
from mitsuba_tpu.scene import builtin as jb, ir as jir
from mitsuba_tpu_torch.core.rng import SampleStream
from mitsuba_tpu_torch.integrators import boundary, common, direct, path, reparam
from mitsuba_tpu_torch.models import sensor
from mitsuba_tpu_torch.ops import brute_kernel, bvh_kernel, trace
from mitsuba_tpu_torch.scene import builtin, ir
from test_vertex_grad import BLOCKER_ROWS, IND_BLOCKER_ROWS, indirect_shadow_scene, shadow_scene

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _port(jscene, jcam):
    return ir.from_jax(jscene, device="cpu"), sensor.camera_from_jax(jcam, device="cpu")


def _rays(cam, spp, seed):
    """Every pixel x spp camera rays in the renderer's order: (pixel ids,
    sample ids, o, d), the port's sensor."""
    w, h = cam.width, cam.height
    pix = torch.repeat_interleave(torch.arange(w * h), spp)
    smp = torch.arange(spp).repeat(w * h)
    st = SampleStream(seed, pix, smp, 0)
    jx, jy = st.next_1d(), st.next_1d()
    u_lens = st.next_2d()
    o, d, _ = sensor.sample_rays(cam, (pix % w).float() + jx, (pix // w).float() + jy, u_lens)
    return pix, smp, o, d


def _batch(cam, spp, seed):
    """The same rays and streams for both packages."""
    pix, smp, o, d = _rays(cam, spp, seed)
    port = (o, d, SampleStream(seed, pix, smp, 4))
    jax_ = (jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            JStream(jnp.uint32(seed), jnp.asarray(pix.numpy().astype(np.uint32)),
                    jnp.asarray(smp.numpy().astype(np.uint32)), 4))
    return port, jax_


def _with(scene, V, R, E):
    return scene.replace(vertices=V, materials=scene.materials.replace(reflectance=R),
                         emitters=scene.emitters.replace(radiance=E))


def _port_grads(scene, cam, li, cfg, batch):
    """(loss, [d/d vertices, d/d reflectance, d/d radiance]) of the batch's
    mean radiance through the port."""
    leaves = [x.clone().requires_grad_(True) for x in
              (scene.vertices, scene.materials.reflectance, scene.emitters.radiance)]
    o, d, st = batch
    L = li(_with(scene, *leaves), cam, o, d, st, cfg)
    loss = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0).mean()
    loss.backward()
    return loss.item(), [x.grad.numpy() for x in leaves]


def _jax_grads(jscene, jcam, li, cfg, batch, jit=True):
    """The same through jax.grad; jitted by default, as one XLA compile is
    cheaper on the CPU than compiling every primitive of an eager run."""
    o, d, st = batch

    def loss(V, R, E):
        L = li(_with(jscene, V, R, E), jcam, o, d, st, cfg)
        return jnp.mean(jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0))

    grad = jax.value_and_grad(loss, argnums=(0, 1, 2))
    val, g = (jax.jit(grad) if jit else grad)(
        jscene.vertices, jscene.materials.reflectance, jscene.emitters.radiance)
    return float(val), [np.asarray(x) for x in g]


def _close(a, b, rtol):
    """|a - b| <= rtol * max|b| elementwise: gradients are sums of many
    per-lane terms, so the bar scales with the largest entry."""
    return np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-12)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------------
# scene IR
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cornell", "quad_blocker", "sphere_shadow_24"])
def test_edge_tables_match_jax(name):
    """face_adj and edge_table, built by the port's build_scene, equal the
    JAX package's array for array."""
    if name == "cornell":
        jscene = jb.cornell_box(width=8, height=8)[0]
        scene = builtin.cornell_box(8, 8, device="cpu")[0]
    elif name == "quad_blocker":
        jscene = shadow_scene()[0]
        scene = _chip_smoke().shadow_scene("cpu")[0]
    else:
        jscene = jb.sphere_shadow(24, 24)[0]
        scene = builtin.sphere_shadow(24, 24, device="cpu")[0]
    for field in ("face_adj", "edge_table", "vertices", "indices", "tri_emitter"):
        assert np.array_equal(getattr(scene, field).numpy(), np.asarray(getattr(jscene, field))), field
    assert np.array_equal(scene.emitters.radiance.numpy(), np.asarray(jscene.emitters.radiance))
    assert np.array_equal(scene.materials.reflectance.numpy(),
                          np.asarray(jscene.materials.reflectance))
    # carried across by from_jax, and rebuilt where a JAX scene lacks them
    carried = ir.from_jax(jscene, device="cpu")
    rebuilt = ir.from_jax(jscene.replace(face_adj=None, edge_table=None), device="cpu")
    for s in (carried, rebuilt):
        assert torch.equal(s.edge_table, scene.edge_table)
        assert torch.equal(s.face_adj, scene.face_adj)


def test_scene_detach_and_search_record_no_history():
    """A search records no autograd history on either route's CPU twin
    (brute force and the BVH walk, which writes into tensors in place),
    whatever requires grad, BVH tables attached to moving vertices
    included; scene.detach() cuts every leaf."""
    from mitsuba_tpu_torch.scene import bvh as bvhlib

    for scene in (builtin.cornell_box(8, 8, device="cpu")[0],
                  builtin.sphere_shadow(12, 12, attach_bvh=True, device="cpu")[0]):
        V = scene.vertices.clone().requires_grad_(True)
        s = scene.replace(vertices=V)
        if scene.bvh is not None:
            s = bvhlib.attach(s, scene.bvh)
            assert not s.bvh.leaf_tris.requires_grad
        rs = np.random.RandomState(0)
        o = torch.as_tensor(rs.uniform(0.2, 0.8, (64, 3)), dtype=torch.float32).requires_grad_(True)
        d = torch.nn.functional.normalize(torch.as_tensor(rs.normal(size=(64, 3)),
                                                          dtype=torch.float32), dim=-1)
        d.requires_grad_(True)
        its = trace.closest_hit(s, o, d)
        blocked = trace.shadow_blocked(s, o, d, torch.full((64,), 2.0, requires_grad=True))
        for x in (its.t, its.prim, its.valid, blocked):
            assert not x.requires_grad and x.grad_fn is None
        assert its.valid.any()
        si = trace.surface_interaction(s, o, d, its)
        assert si["p"].requires_grad and si["ng"].requires_grad
        assert not s.detach().vertices.requires_grad


def test_surface_interaction_vjp_matches_jax():
    """The differentiable hit (t re-attached, barycentrics and normals
    recomputed) against JAX's: the VJP of p, ng, ns, uv with respect to
    the vertices, on Cornell camera and bounce rays. Bar: 1e-5 of the
    largest entry (measured 2.4e-7)."""
    jscene, jcam = jb.cornell_box(width=16, height=16)
    scene, cam = _port(jscene, jcam)
    _, _, o, d = _rays(cam, 2, 3)
    rs = np.random.RandomState(1)
    # add rays from inside the box in random directions (bounce-like)
    o2 = rs.uniform(0.05, 0.95, (256, 3)).astype(np.float32)
    d2 = rs.normal(size=(256, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    o = torch.cat([o, torch.as_tensor(o2)])
    d = torch.cat([d, torch.as_tensor(d2)])
    n = o.shape[0]
    cots = [rs.normal(size=(n, k)).astype(np.float32) for k in (3, 3, 3, 2)]

    V = scene.vertices.clone().requires_grad_(True)
    s = scene.replace(vertices=V)
    its = trace.closest_hit(s, o, d)
    si = trace.surface_interaction(s, o, d, its)
    loss = sum((si[k] * torch.as_tensor(c)).sum() for k, c in zip(("p", "ng", "ns", "uv"), cots))
    loss.backward()

    oj, dj = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    jits = jtrace.closest_hit(jscene, oj, dj)
    assert np.array_equal(np.asarray(jits.prim), its.prim.numpy())

    def jloss(Vj):
        sj = jtrace.surface_interaction(jscene.replace(vertices=Vj), oj, dj, jits)
        return sum(jnp.sum(sj[k] * c) for k, c in zip(("p", "ng", "ns", "uv"), cots))

    g = np.asarray(jax.grad(jloss)(jscene.vertices))
    assert _close(V.grad.numpy(), g, 1e-5), np.abs(V.grad.numpy() - g).max()


def test_world_to_raster_and_ray_differentials_match_jax():
    jscene, jcam = jb.cornell_box(width=24, height=16)
    _, cam = _port(jscene, jcam)
    rs = np.random.RandomState(2)
    p = rs.uniform(-0.2, 1.2, (512, 3)).astype(np.float32)
    px, py, valid, imp = sensor.world_to_raster(cam, torch.as_tensor(p))
    jpx, jpy, jvalid, jimp = jsens.world_to_raster(jcam, jnp.asarray(p))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid)) and valid.any() and not valid.all()
    for a, b in ((px, jpx), (py, jpy), (imp, jimp)):
        assert np.allclose(a.numpy()[valid.numpy()], np.asarray(b)[valid.numpy()],
                           rtol=1e-5, atol=1e-5)
    _, _, _, d = _rays(cam, 1, 0)
    for a, b in zip(sensor.ray_differentials(cam, d),
                    jsens.ray_differentials(jcam, jnp.asarray(d.numpy()))):
        assert np.allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# integrators: path (the repair), direct
# --------------------------------------------------------------------------

def test_path_grad_past_rr_depth_matches_jax():
    """The mean of a 16x16 Cornell render at max_depth 6, rr_depth 2,
    differentiated with respect to the reflectances (and the vertices and
    radiances), against jax.grad. Russian roulette's survival probability
    carries no gradient in either (JAX path.py:154-155); with it attached
    (the port before its repair) the reflectance gradient is off by 46% of
    its largest entry. Bars: loss 1e-6 relative, gradients 1e-4 of the
    largest entry (measured 8e-7, 4e-7, 1e-7)."""
    jscene, jcam = jb.cornell_box(width=16, height=16)
    scene, cam = _port(jscene, jcam)
    cfg = dict(spp=2, max_depth=6, rr_depth=2, seed=3)
    pb, jbatch = _batch(cam, 2, 3)
    loss, g = _port_grads(scene, cam, path.li, common.RenderConfig(**cfg), pb)
    jloss, jg = _jax_grads(jscene, jcam, jpath.li, jcom.RenderConfig(**cfg), jbatch)
    assert abs(loss - jloss) <= 1e-6 * abs(jloss)
    for name, a, b in zip(("vertices", "reflectance", "radiance"), g, jg):
        assert np.isfinite(a).all() and np.abs(b).max() > 0, name
        assert _close(a, b, 1e-4), (name, np.abs(a - b).max(), np.abs(b).max())


# cornell_direct golden bar (tools/golden_scenes.py:17-20): rtol = atol =
# 1e-4, except at most DIRECT_MAX_FLIPS pixels, each off by less than
# DIRECT_MAX_FLIP. Measured on the CPU: 1 of 1,024 pixels, (21, 25), off by
# 0.0052: C8's pixel, whose camera ray grazes the short block's top edge
# and differs from the JAX package's in the last bit (ROADMAP C16).
DIRECT_TOL = 1e-4
DIRECT_MAX_FLIPS = 1
DIRECT_MAX_FLIP = 0.01


def test_direct_matches_golden():
    ref = np.load(ROOT / "tests" / "golden" / "cornell_direct.npy")
    scene, cam = builtin.cornell_box(width=32, height=32, device="cpu")
    cfg = common.RenderConfig(spp=64, max_depth=2, seed=7)
    img = common.render(scene, cam, direct.li, cfg).numpy()
    assert img.shape == ref.shape and img.dtype == np.float32
    diff = np.abs(img - ref)
    off = (diff > DIRECT_TOL + DIRECT_TOL * np.abs(ref)).any(-1)
    assert off.sum() <= DIRECT_MAX_FLIPS, np.argwhere(off)
    assert diff.max() < DIRECT_MAX_FLIP, diff.max()


def test_direct_matches_jax_with_env():
    """direct.li on the same rays as JAX's, with an environment (the BSDF
    strategy's env branch), and its gradients. Bars: radiance atol 1e-5,
    gradients 1e-4 of the largest entry."""
    jscene, jcam = jb.cornell_box(width=8, height=8)
    jscene = jscene.replace(env_radiance=jnp.asarray([0.2, 0.3, 0.4]), has_env=True)
    scene, cam = _port(jscene, jcam)
    cfg = dict(spp=4, max_depth=2, seed=1)
    pb, jbatch = _batch(cam, 4, 1)
    L = direct.li(scene, cam, *pb[:2], pb[2], common.RenderConfig(**cfg))
    jL = jdirect.li(jscene, jcam, *jbatch[:2], jbatch[2], jcom.RenderConfig(**cfg))
    assert np.allclose(L.numpy(), np.asarray(jL), atol=1e-5)
    _, g = _port_grads(scene, cam, direct.li, common.RenderConfig(**cfg), pb)
    _, jg = _jax_grads(jscene, jcam, jdirect.li, jcom.RenderConfig(**cfg), jbatch)
    for a, b in zip(g, jg):
        assert _close(a, b, 1e-4), np.abs(a - b).max()


# --------------------------------------------------------------------------
# boundary.py
# --------------------------------------------------------------------------

def test_edge_importance_and_emitter_anchor_match_jax():
    """Bars: rtol 1e-6, except the edges of sphere_shadow's zero-area pole
    triangles (C7, C21): their normals are rounding noise (vertices 1e-17
    apart), so their silhouette flags may differ (measured: 8 of 864
    edges at 12x12, all of them such edges)."""
    edge_w = jax.jit(jbd.edge_importance)
    for jscene in (shadow_scene()[0], jb.cornell_box(width=8, height=8)[0],
                   jb.sphere_shadow(12, 12)[0]):
        scene = ir.from_jax(jscene, device="cpu")
        anchor = boundary.emitter_anchor(scene)
        janchor = np.asarray(jbd.emitter_anchor(jscene))
        assert np.allclose(anchor.numpy(), janchor, rtol=1e-6, atol=1e-6)
        V = np.asarray(jscene.vertices, np.float64)
        tri = V[np.asarray(jscene.indices)]
        area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
        et = np.asarray(jscene.edge_table)
        degenerate = (area[et[:, 2]] < 1e-9) | ((et[:, 3] >= 0) & (area[et[:, 3]] < 1e-9))
        for at in (anchor, torch.tensor([0.5, 0.5, -1.4])):
            w = boundary.edge_importance(scene, at).numpy()
            jw = np.asarray(edge_w(jscene, jnp.asarray(at.numpy())))
            off = ~np.isclose(w, jw, rtol=1e-6, atol=0.0)
            assert not (off & ~degenerate).any(), np.nonzero(off & ~degenerate)


def _li_grad(bc):
    return (lambda s, c, o, d, st, cf: boundary.li_grad(s, c, o, d, st, cf, bc),
            lambda s, c, o, d, st, cf: jbd.li_grad(s, c, o, d, st, cf, jbd.BoundaryConfig(**bc._asdict())))


@pytest.mark.parametrize("scene_name,lookahead", [
    ("quad_blocker", 0), ("quad_blocker", 1), ("indirect_shadow", 1)])
def test_li_grad_matches_jax(scene_name, lookahead):
    """li_grad on the quad-blocker scene, and with the lookahead on the
    indirect-shadow scene, where it changes the gradient (fixtures from
    tests/test_vertex_grad.py through from_jax): the primal equals
    path.li's (zero-primal terms), and the vertex, reflectance and radiance
    gradients equal jax.grad's. Bars: primal 1e-6 absolute, loss 1e-6
    relative, gradients 1e-4 of the largest entry (measured 3e-7 / 1e-7 /
    1.3e-7 on the quad blocker). On the indirect-shadow scene the JAX side
    runs eagerly: jitted, XLA's fusion rounds this scene's boundary terms
    otherwise, and its vertex gradient moves by 35% of its largest entry
    from JAX's own eager one, which the port equals (C17)."""
    jscene, jcam = (shadow_scene if scene_name == "quad_blocker" else indirect_shadow_scene)()
    rows = slice(*(BLOCKER_ROWS if scene_name == "quad_blocker" else IND_BLOCKER_ROWS))
    scene, cam = _port(jscene, jcam)
    cfg = dict(spp=2, max_depth=3, seed=5)
    bc = boundary.BoundaryConfig(n_edge=4, primary=False, lookahead=lookahead, n_la=1)
    li, jli = _li_grad(bc)
    pb, jbatch = _batch(cam, 2, 5)
    with torch.no_grad():
        a = path.li(scene, cam, *pb[:2], pb[2], common.RenderConfig(**cfg))
        b = li(scene, cam, *pb[:2], pb[2], common.RenderConfig(**cfg))
    assert (a - b).abs().max() <= 1e-6
    loss, g = _port_grads(scene, cam, li, common.RenderConfig(**cfg), pb)
    jloss, jg = _jax_grads(jscene, jcam, jli, jcom.RenderConfig(**cfg), jbatch,
                           jit=scene_name == "quad_blocker")
    assert abs(loss - jloss) <= 1e-6 * abs(jloss)
    assert np.abs(jg[0][rows, 0]).max() > 1e-3     # the shadow's edge term
    for name, a, b in zip(("vertices", "reflectance", "radiance"), g, jg):
        assert np.isfinite(a).all(), name
        assert _close(a, b, 1e-4), (name, np.abs(a - b).max(), np.abs(b).max())
    if scene_name == "indirect_shadow":
        # the order-1 lookahead is what carries this boundary's gradient
        g0 = _port_grads(scene, cam, _li_grad(bc._replace(lookahead=0))[0],
                         common.RenderConfig(**cfg), pb)[1][0]
        assert np.abs(g0[rows, 0]).max() < 0.5 * np.abs(g[0][rows, 0]).max()


def silhouette_scene():
    """tests/test_vertex_grad.py:test_primary_silhouette_gradient's scene
    (JAX): a quad blocker the camera sees against a lit floor."""
    verts, tris, tri_mat, tri_rad = [], [], [], {}

    def add_quad(p0, p1, p2, p3, mat, rad=None):
        b = len(verts)
        verts.extend([p0, p1, p2, p3])
        for t in ([b, b + 1, b + 2], [b, b + 2, b + 3]):
            if rad is not None:
                tri_rad[len(tris)] = rad
            tris.append(t)
            tri_mat.append(mat)

    white = {"type": jir.BSDF_DIFFUSE, "reflectance": [0.8, 0.8, 0.8]}
    dark = {"type": jir.BSDF_DIFFUSE, "reflectance": [0.25, 0.25, 0.25]}
    lm = {"type": jir.BSDF_DIFFUSE, "reflectance": [0.0, 0.0, 0.0]}
    add_quad([-2, 0, -2], [-2, 0, 2], [2, 0, 2], [2, 0, -2], 0)
    add_quad([-0.3, 0.5, -0.25], [-0.3, 0.5, 0.25], [0.1, 0.5, 0.25], [0.1, 0.5, -0.25], 1)
    add_quad([-0.15, 1.5, -0.15], [0.15, 1.5, -0.15], [0.15, 1.5, 0.15],
             [-0.15, 1.5, 0.15], 2, rad=[20.0, 20.0, 20.0])
    scene = jir.build_scene(np.asarray(verts, np.float32), np.asarray(tris, np.int32),
                            np.asarray(tri_mat, np.int32), [white, dark, lm],
                            tri_radiance=tri_rad)
    cam = jsens.make_camera(origin=[0.0, 1.1, 0.0], target=[0.0, 0.0, 0.0], up=[0, 0, 1],
                            fov_x=50.0, width=24, height=24)
    return scene, cam


def test_primary_boundary_image_matches_jax():
    """The camera-silhouette splat pass with the JAX package's threefry
    uniforms injected: a zero image whose VJP with respect to the vertices
    equals JAX's. Bar: 1e-4 of the largest entry (measured 2.4e-6). Not on
    the Cornell box (C18): its light hangs 1.2 mm below the ceiling, and an
    edge point that XLA rounds otherwise (its FMA) sends the camera ray to
    the light in one package and the ceiling in the other (measured: 2 of
    4,096 samples eager, more jitted; up to 5% of the largest entry)."""
    jscene, jcam = silhouette_scene()
    scene, cam = _port(jscene, jcam)
    n, seed = 4096, 7 ^ 0x5EED
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    u = np.array(jax.random.uniform(k1, (n, 2)))
    u_la = np.array(jax.random.uniform(k2, (n, 4, 3)))
    cot = np.random.RandomState(3).normal(size=(cam.height, cam.width, 3)).astype(np.float32)

    V = scene.vertices.clone().requires_grad_(True)
    img = boundary.primary_boundary_image(scene.replace(vertices=V), cam, n, seed,
                                          u=torch.as_tensor(u), u_la=torch.as_tensor(u_la))
    assert img.shape == (cam.height, cam.width, 3) and not img.detach().abs().any()
    (img * torch.as_tensor(cot)).sum().backward()

    def jloss(Vj):
        jimg = jbd.primary_boundary_image(jscene.replace(vertices=Vj), jcam, n,
                                          jax.random.PRNGKey(seed))
        return jnp.sum(jimg * cot)

    g = np.asarray(jax.jit(jax.grad(jloss))(jscene.vertices))
    assert np.abs(g).max() > 1.0
    assert _close(V.grad.numpy(), g, 1e-4), np.abs(V.grad.numpy() - g).max()
    # the default uniforms come from a torch.Generator seeded with `seed`:
    # the same call twice gives the same image gradient
    grads = []
    for _ in range(2):
        V.grad = None
        img = boundary.primary_boundary_image(scene.replace(vertices=V), cam, 512, seed)
        (img * torch.as_tensor(cot)).sum().backward()
        grads.append(V.grad.clone())
    assert torch.equal(*grads) and grads[0].abs().max() > 0


def test_render_grad_primal_and_bvh_route():
    """render_grad's primal equals the plain path render, its gradients are
    finite, and on sphere_shadow(24, 24) the BVH twin gives the gradient
    the brute-force twin gives (the same hits, bit for bit)."""
    scene, cam, rows = builtin.sphere_shadow(24, 24, width=8, height=8, device="cpu")
    scene_bvh = builtin.sphere_shadow(24, 24, width=8, height=8, attach_bvh=True,
                                      device="cpu")[0]
    cfg = common.RenderConfig(spp=2, max_depth=2, seed=3)
    bc = boundary.BoundaryConfig(n_edge=2, n_primary=256)
    grads = []
    for s in (scene, scene_bvh):
        bvh_kernel.reset_counts()
        brute_kernel.reset_counts()
        V = s.vertices.clone().requires_grad_(True)
        img = boundary.render_grad(s.replace(vertices=V), cam, cfg, bc)
        with torch.no_grad():
            ref = common.render(s, cam, path.li, cfg)
        assert (img - ref).abs().max() <= 1e-6
        img.mean().backward()
        assert torch.isfinite(V.grad).all()
        grads.append(V.grad)
        walked = bvh_kernel.PLAIN_CALLS["closest"] > 0
        assert walked == (s.bvh is not None)
        assert (brute_kernel.PLAIN_CALLS["closest"] > 0) == (s.bvh is None)
    assert torch.allclose(grads[0], grads[1], rtol=0, atol=1e-7)
    assert grads[0][rows[0]:rows[1]].abs().max() > 0


# --------------------------------------------------------------------------
# reparam.py
# --------------------------------------------------------------------------

def test_field_jvp_matches_jax_jvp():
    """The closed-form JVP of the warp field against jax.jvp of the JAX
    package's field (reparam.py:245-254, its four lines restated here), on
    random inputs with a primal off the cloud's centre. Bars: the field
    rtol 1e-4, the JVP 1e-4 of its largest entry."""
    rs = np.random.RandomState(4)
    n, k, kappa = 64, 8, 3.0e3
    d0 = rs.normal(size=(n, 3))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    w_dirs = d0[:, None] + 0.02 * rs.normal(size=(n, k, 3))
    w_dirs /= np.linalg.norm(w_dirs, axis=-1, keepdims=True)
    d = d0 + 0.005 * rs.normal(size=(n, 3))
    u = rs.normal(size=(n, k, 3))
    g = rs.uniform(0.5, 30.0, (n, k))
    tan = rs.normal(size=(n, 3))
    d0, w_dirs, d, u, g, tan = (a.astype(np.float32) for a in (d0, w_dirs, d, u, g, tan))
    base = np.sum(d0[:, None] * w_dirs, -1)

    def field(dd):
        lw = kappa * (jnp.sum(dd[:, None] * w_dirs, -1) - base)
        wgt = jnp.exp(lw) * g
        return jnp.sum(wgt[..., None] * u, axis=1) \
            / jnp.maximum(jnp.sum(wgt, axis=1), 1e-20)[..., None]

    jv, jjv = jax.jvp(field, (jnp.asarray(d),), (jnp.asarray(tan),))
    T = torch.as_tensor
    v, (jv_t,) = reparam.field_jvps(T(d), T(w_dirs), T(base), T(g), T(u), kappa, (T(tan),))
    assert np.allclose(v.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-6)
    scale = np.abs(np.asarray(jjv)).max()
    assert scale > 1.0 and np.abs(jv_t.numpy() - np.asarray(jjv)).max() <= 1e-4 * scale


def _nee_rays():
    """Rays from floor points of the quad-blocker scene toward the light:
    the shadow boundary runs through them."""
    xs, zs = np.meshgrid(np.linspace(-0.6, 0.3, 12), np.linspace(-0.5, 0.5, 8))
    o = np.stack([xs.ravel(), np.full(xs.size, 1e-3), zs.ravel()], -1).astype(np.float32)
    d = np.asarray([0.0, 1.5, 0.0], np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_reparam_ray_matches_jax():
    """reparam_ray's (d_warp, w_div) and their VJPs with respect to the
    vertices, against JAX's, on rays that cross the blocker's shadow
    boundary; each ray's origin is attached too (the NEE case). Bars:
    primal rtol 1e-6; VJP 1e-3 of the largest entry (measured 1.4e-5: the
    field's exponent kappa (d . w_k - base_k) amplifies the last bit of d;
    C19)."""
    jscene, jcam = shadow_scene()
    scene, _ = _port(jscene, jcam)
    o, d = _nee_rays()
    n = o.shape[0]
    rp = reparam.ReparamConfig(n_aux=8)
    rs = np.random.RandomState(5)
    u_aux = rs.uniform(size=(n, 8, 2)).astype(np.float32)
    c1 = rs.normal(size=(n, 3)).astype(np.float32)
    c2 = rs.normal(size=(n,)).astype(np.float32)
    active = np.arange(n) % 5 != 0

    V = scene.vertices.clone().requires_grad_(True)
    s = scene.replace(vertices=V)
    o_t = torch.as_tensor(o) + 0.0 * V[0]     # an attached origin
    dw, wd = reparam.reparam_ray(s, o_t, torch.as_tensor(d), torch.as_tensor(u_aux), rp,
                                 active=torch.as_tensor(active))
    ((dw * torch.as_tensor(c1)).sum() + (wd * torch.as_tensor(c2)).sum()).backward()

    def jfn(Vj):
        sj = jscene.replace(vertices=Vj)
        return jrp.reparam_ray(sj, jnp.asarray(o) + 0.0 * Vj[0], jnp.asarray(d),
                               jnp.asarray(u_aux), jrp.ReparamConfig(n_aux=8),
                               active=jnp.asarray(active))

    def jloss(Vj):
        jdw, jwd = jfn(Vj)
        return jnp.sum(jdw * c1) + jnp.sum(jwd * c2), (jdw, jwd)

    g, (jdw, jwd) = jax.jit(jax.grad(jloss, has_aux=True))(jscene.vertices)
    assert np.allclose(dw.detach().numpy(), np.asarray(jdw), rtol=1e-6, atol=1e-7)
    assert np.allclose(wd.detach().numpy(), np.asarray(jwd), rtol=1e-6, atol=1e-7)
    g = np.asarray(g)
    assert np.abs(g[slice(*BLOCKER_ROWS)]).max() > 1e-3
    assert _close(V.grad.numpy(), g, 1e-3), np.abs(V.grad.numpy() - g).max()


def test_li_reparam_matches_jax():
    """li_reparam on the quad-blocker scene: the primal equals path.li's
    within 1e-4 (as tests/test_vertex_grad.py holds JAX's), and its vertex,
    reflectance and radiance gradients equal jax.grad's. Bars: loss 1e-6
    relative; gradients 1e-3 of the largest entry (measured 1.7e-5, 1e-7,
    2.5e-7; C19)."""
    jscene, jcam = shadow_scene()
    scene, cam = _port(jscene, jcam)
    cfg = dict(spp=1, max_depth=2, seed=5)
    rp = reparam.ReparamConfig(n_aux=4)
    pb, jbatch = _batch(cam, 1, 5)
    with torch.no_grad():
        a = path.li(scene, cam, *pb[:2], pb[2], common.RenderConfig(**cfg))
        b = reparam.li_reparam(scene, cam, *pb[:2], pb[2], common.RenderConfig(**cfg), rp)
    assert (a - b).abs().max() < 1e-4
    loss, g = _port_grads(scene, cam, lambda *x: reparam.li_reparam(*x, rp),
                          common.RenderConfig(**cfg), pb)
    jloss, jg = _jax_grads(jscene, jcam,
                           lambda *x: jrp.li_reparam(*x, jrp.ReparamConfig(n_aux=4)),
                           jcom.RenderConfig(**cfg), jbatch)
    assert abs(loss - jloss) <= 1e-6 * abs(jloss)
    for name, a, b in zip(("vertices", "reflectance", "radiance"), g, jg):
        assert np.isfinite(a).all(), name
        assert _close(a, b, 1e-3), (name, np.abs(a - b).max(), np.abs(b).max())


# --------------------------------------------------------------------------
# materials: roughness and texel gradients
# --------------------------------------------------------------------------

def _leaf_grad_pair(jscene, jcam, leaf, spp, cfg, seed):
    """(port loss, port gradient, JAX loss, JAX gradient) of the batch's
    mean radiance through path.li with respect to one scene leaf: "alpha"
    (materials.alpha) or "textures"; the same rays and streams."""
    scene, cam = _port(jscene, jcam)
    pb, jbatch = _batch(cam, spp, seed)

    def swap(s, x):
        if leaf == "alpha":
            return s.replace(materials=s.materials.replace(alpha=x))
        return s.replace(textures=x)

    x = (scene.materials.alpha if leaf == "alpha" else scene.textures).clone().requires_grad_(True)
    L = path.li(swap(scene, x), cam, *pb[:2], pb[2], common.RenderConfig(**cfg))
    loss = L.mean()
    loss.backward()

    def jloss(xj):
        o, d, st = jbatch
        return jnp.mean(jpath.li(swap(jscene, xj), jcam, o, d, st, jcom.RenderConfig(**cfg)))

    x0 = jscene.materials.alpha if leaf == "alpha" else jscene.textures
    jval, jg = jax.jit(jax.value_and_grad(jloss))(x0)
    return loss.item(), x.grad.numpy(), float(jval), np.asarray(jg)


def test_roughness_grad_matches_jax():
    """tests/test_grad_coverage.py:60's scene (a 0.25-rough conductor floor
    under a quad light, 16x16, depth 2, seed 7) at 4 spp: d(mean)/d(alpha)
    against jax.grad on the same rays. Bars: loss 1e-6 relative, gradient
    1e-4 of its largest entry."""
    verts = np.asarray([[-2, 0, -2], [-2, 0, 2], [2, 0, 2], [2, 0, -2], [-0.4, 1.5, -0.4],
                        [0.4, 1.5, -0.4], [0.4, 1.5, 0.4], [-0.4, 1.5, 0.4]], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    jscene = jir.build_scene(verts, tris, np.zeros(4, np.int32),
                             [{"type": jir.BSDF_ROUGH_CONDUCTOR, "alpha": [0.25, 0.25],
                               "eta": [0.2, 0.92, 1.1], "k": [3.9, 2.45, 2.14]}],
                             tri_radiance={2: [8.0] * 3, 3: [8.0] * 3})
    jcam = jsens.make_camera(origin=[0, 1.0, 2.5], target=[0, 0, 0], fov_x=50.0,
                             width=16, height=16)
    loss, g, jloss, jg = _leaf_grad_pair(jscene, jcam, "alpha", 4,
                                         dict(spp=4, max_depth=2, seed=7), 7)
    assert abs(loss - jloss) <= 1e-6 * abs(jloss)
    assert np.isfinite(g).all() and np.abs(jg).max() > 1e-3
    assert _close(g, jg, 1e-4), (np.abs(g - jg).max(), np.abs(jg).max())


TEXEL_NAN = 6


@pytest.mark.parametrize("mips", [False, True], ids=["bilinear", "mips_ewa"])
def test_texel_grad_matches_jax(mips):
    """tests/test_baseline_configs.py:42's textured quad under a constant
    8x16 envmap (12x12, depth 2, seed 0) at 4 spp: d(mean)/d(texels)
    against jax.grad on the same rays; with mips, the primary hit's EWA
    and the trilinear footprint after it, whose base level (below lod 1)
    carries the texel gradient (the mip strip is a constant, in both
    packages). Bars: loss 1e-6
    relative, gradient 1e-4 of its largest entry. With mips, JAX's texel
    gradient is NaN at the texels that its missed rays' overflowing uv
    partials index (C26; measured TEXEL_NAN of 64); the port's is finite
    everywhere and is compared on the others."""
    from mitsuba_tpu.scene import envmap as jenv

    cs = _chip_smoke()
    verts, tris, uvs = cs.TEXTURED_QUAD
    tex = np.full((8, 8, 3), 0.5, np.float32)
    jcam = jsens.make_camera(**cs.TEXTURED_QUAD_CAMERA, width=12, height=12)
    jscene = jenv.attach_envmap(jir.build_scene(
        verts, tris, np.zeros(2, np.int32), [{"type": jir.BSDF_DIFFUSE, "tex_reflectance": 0}],
        uvs=uvs, textures=[{"data": tex}],
        lod_scale=cs.lod_scale(sensor.camera_from_jax(jcam, device="cpu")) if mips else None),
        np.ones((8, 16, 3), np.float32))
    loss, g, jloss, jg = _leaf_grad_pair(jscene, jcam, "textures", 4,
                                         dict(spp=4, max_depth=2, seed=0), 0)
    assert abs(loss - jloss) <= 1e-6 * abs(jloss)
    assert np.isfinite(g).all()
    jfin = np.isfinite(jg).all(-1)
    assert (~jfin).sum() == (TEXEL_NAN if mips else 0), np.argwhere(~jfin)
    g, jg = g[jfin], jg[jfin]
    assert np.abs(jg).max() > 1e-5
    assert _close(g, jg, 1e-4), (np.abs(g - jg).max(), np.abs(jg).max())
