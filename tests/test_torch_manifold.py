"""Parity of the port's specular manifold walk (mitsuba_tpu_torch/ops/
manifold.py) with the JAX package on the CPU, on tests/test_manifold.py's
scenes: the mirror floor, the glass slab and the tessellated sphere mirror.

Bars (ROADMAP C10 for positions and G; the Jacobians at 1e-5):
- `walk`: `ok`, `iterations`, `chain_prim` and `end_prim` equal; the chain
  positions within 1e-6 (atol + rtol), and the end positions within 1e-6
  or, where the port misses that, within the JAX package's own spread:
  its eager walk (jax.disable_jit) against its compiled loop. On the sphere's pole the
  triangles are slivers, the Gram system of `_interp_ns` cancels, and
  XLA's fused multiply-adds move the Newton steps: the JAX walks differ
  by 1.3e-5 in the end positions there, the port from the compiled one by
  4.8e-6 (ROADMAP C42). The JAX walk's loop condition is global (any lane
  not done, ok and with a step above 1e-5), and the port's Python loop
  runs the same one, so the counts agree;
- the forward-mode Jacobians of `_fixed_chain` (its closed-form tangents
  against jax.jvp and against torch's dual numbers, both tangents) within
  1e-5 of the largest entry;
- `generalized_G` within 1e-6 on the empty chain (with ns0), the flat
  mirror's one-bounce chain and the walks' converged chains;
- `scatter_dir`, `_interp_ns` and `_real_retrace` on the walks' inputs at
  1e-6, their prims and flags equal.

The inputs are the JAX tests' own (numpy seeds 3, 5, 11 and 7), at their
sizes; the JAX functions run as those tests run them (eagerly, the loop a
lax.while_loop).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwad

from mitsuba_tpu.ops import manifold as jman, trace as jtrace
from mitsuba_tpu_torch.ops import manifold, trace
from mitsuba_tpu_torch.scene import ir
from test_manifold import glass_slab_scene, mirror_floor_scene, sphere_mirror_scene

torch.set_num_threads(1)

POS_TOL = 1e-6
JAC_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=POS_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def mirror_case():
    rng = np.random.default_rng(3)
    n = 8
    x0 = np.column_stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                          rng.uniform(0.5, 1.5, n)]).astype(np.float32)
    tgt = np.column_stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                           np.full(n, 2.0)]).astype(np.float32)
    x1 = np.column_stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                          np.zeros(n)]).astype(np.float32)
    return x0, x1, np.zeros((n, 1), np.int32), np.ones((n,), np.int32), tgt


def glass_case():
    rng = np.random.default_rng(5)
    n = 6
    x0 = np.column_stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                          np.full(n, 1.0)]).astype(np.float32)
    tgt = np.column_stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                           np.full(n, -2.0)]).astype(np.float32)
    return x0, np.zeros((n, 3), np.float32), np.ones((n, 2), np.int32), \
        np.full((n,), 2, np.int32), tgt


def sphere_case():
    rng = np.random.default_rng(11)
    n = 8
    x0 = np.column_stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                          np.full(n, 1.5)]).astype(np.float32)
    tgt = np.column_stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                           np.full(n, 2.0)]).astype(np.float32)
    x1 = np.tile(np.asarray([[0.02, 0.01, 0.5]], np.float32), (n, 1))
    return x0, x1, np.zeros((n, 1), np.int32), np.ones((n,), np.int32), tgt


CASES = {"mirror": (mirror_floor_scene, mirror_case),
         "glass": (glass_slab_scene, glass_case),
         "sphere": (sphere_mirror_scene, sphere_case)}


@pytest.fixture(scope="module")
def walks():
    """Each case's scenes, inputs and both packages' walks, computed once."""
    out = {}
    for name, (make, case) in CASES.items():
        jscene = make()
        scene = ir.from_jax(jscene, "cpu")
        args = case()
        jres = jman.walk(jscene, *(jnp.asarray(a) for a in args))
        res = manifold.walk(scene, *(_t(a) for a in args))
        out[name] = (jscene, scene, args, jres, res)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_walk_matches_jax(walks, name):
    jscene, _, args, jres, res = walks[name]
    np.testing.assert_array_equal(res.ok.numpy(), np.asarray(jres.ok))
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(jres.iterations))
    np.testing.assert_array_equal(res.chain_prim.numpy(), np.asarray(jres.chain_prim))
    np.testing.assert_array_equal(res.end_prim.numpy(), np.asarray(jres.end_prim))
    _close(res.chain_pos, jres.chain_pos)
    err = float(np.abs(res.end_pos.numpy() - np.asarray(jres.end_pos)).max())
    if err > POS_TOL:
        with jax.disable_jit():
            eager = jman.walk(jscene, *(jnp.asarray(a) for a in args))
        spread = float(np.abs(np.asarray(eager.end_pos) - np.asarray(jres.end_pos)).max())
        _close(res.end_pos, jres.end_pos, spread)
    assert res.ok.float().mean() >= 0.75 and int(res.iterations[0]) >= 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_fixed_chain_jacobians_match_jax(walks, name):
    """Both tangents of the endpoint's map from a direction offset near the
    converged chains (the Newton system's columns, generalized_G's dp1 and
    dp2): the port's closed form against jax.jvp, and against torch's own
    dual numbers (torch.autograd.forward_ad) through the port's primal
    retrace."""
    jscene, scene, args, jres, res = walks[name]
    x0, _, modes, m_len, _ = args
    n = x0.shape[0]
    rs = np.random.default_rng(17)
    du = (rs.normal(size=(n, 3)) * 0.05).astype(np.float32)
    d0 = np.asarray(jres.chain_pos[:, 0]) - x0 + du
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    a, b = (np.asarray(v) for v in jman._onb(jnp.asarray(d0)))
    chain = (res.chain_prim, _t(modes), _t(m_len), res.end_prim)

    def jfn(v):
        return jman._fixed_chain(jscene, jnp.asarray(x0), d0 + v[:, 0:1] * a + v[:, 1:2] * b,
                                 jres.chain_prim, jnp.asarray(modes), jnp.asarray(m_len),
                                 jres.end_prim)[0]

    dd = torch.stack([_t(a), _t(b)])
    end, ok, dend = manifold._fixed_chain(scene, _t(x0), _t(d0), *chain, dd0=dd)
    for i, tangent in enumerate(([1.0, 0.0], [0.0, 1.0])):
        tan = np.tile(np.asarray([tangent], np.float32), (n, 1))
        jend, jjac = jax.jvp(jfn, (jnp.zeros((n, 2)),), (jnp.asarray(tan),))
        _close(end, jend)
        scale = float(np.abs(np.asarray(jjac)).max())
        assert scale > 0
        np.testing.assert_allclose(dend[i].numpy(), np.asarray(jjac), rtol=JAC_TOL,
                                   atol=JAC_TOL * scale)
        with fwad.dual_level():
            dual = manifold._fixed_chain(scene, _t(x0), fwad.make_dual(_t(d0), dd[i]),
                                         *chain)[0]
            fw = fwad.unpack_dual(dual).tangent
        np.testing.assert_allclose(dend[i].numpy(), fw.numpy(), rtol=JAC_TOL,
                                   atol=JAC_TOL * scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_retrace_and_scatter_match_jax(walks, name):
    jscene, scene, args, _, _ = walks[name]
    x0, x1, modes, m_len, _ = args
    jout = jman._real_retrace(jscene, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(modes),
                              jnp.asarray(m_len))
    out = manifold._real_retrace(scene, _t(x0), _t(x1), _t(modes), _t(m_len))
    for i in (1, 3, 4):
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(jout[i]))
    _close(out[0], jout[0])
    _close(out[2], jout[2])
    prim = out[1][:, 0]
    ns = manifold._interp_ns(scene, prim, out[0][:, 0])
    jns = jman._interp_ns(jscene, jout[1][:, 0], jout[0][:, 0])
    _close(ns, jns)
    d = torch.nn.functional.normalize(out[0][:, 0] - _t(x0), dim=1)
    eta = manifold._tri_eta(scene, prim)
    got = manifold.scatter_dir(d, ns, _t(modes[:, 0]), eta)
    want = jman.scatter_dir(jnp.asarray(d.numpy()), jns, jnp.asarray(modes[:, 0]),
                            jman._tri_eta(jscene, jout[1][:, 0]))
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_generalized_G_matches_jax():
    """The empty chain with ns0 (the classical term), the flat mirror's
    one-bounce chain, and the three walks' converged chains."""
    jscene = mirror_floor_scene()
    scene = ir.from_jax(jscene, "cpu")
    n = 5
    rng = np.random.default_rng(7)
    x0 = np.column_stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                          rng.uniform(0.5, 2.0, n)]).astype(np.float32)
    pb = np.column_stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                          np.zeros(n)]).astype(np.float32)
    d = pb - x0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ns0 = np.tile(np.asarray([[0, 0, -1.0]], np.float32), (n, 1))
    zi = np.zeros((n, 1), np.int32)
    args = (x0, d, zi, zi, np.zeros((n,), np.int32), np.zeros((n,), np.int32))
    want = jman.generalized_G(jscene, *(jnp.asarray(a) for a in args), ns0=jnp.asarray(ns0))
    got = manifold.generalized_G(scene, *(_t(a) for a in args), ns0=_t(ns0))
    assert (got.numpy() > 0).all()
    _close(got, want)

    # one flat mirror bounce, then the z=2 receiver
    x0 = np.asarray([[0.2, -0.3, 1.0]], np.float32)
    d = -x0 / np.linalg.norm(x0)
    its = jtrace.closest_hit(jscene, jnp.asarray(x0), jnp.asarray(d))
    d_ref = d * np.asarray([1, 1, -1], np.float32)
    its2 = trace.closest_hit(scene, _t(1e-3 * d_ref), _t(d_ref))
    chain = np.asarray(its.prim, np.int32)[:, None]
    end = its2.prim.to(torch.int32).numpy()
    args = (x0, d, chain, np.zeros((1, 1), np.int32), np.ones((1,), np.int32), end)
    want = jman.generalized_G(jscene, *(jnp.asarray(a) for a in args))
    got = manifold.generalized_G(scene, *(_t(a) for a in args))
    assert float(got[0]) > 0
    _close(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_generalized_G_on_walked_chains(walks, name):
    jscene, scene, args, jres, res = walks[name]
    x0, _, modes, m_len, _ = args
    d = np.asarray(jres.chain_pos[:, 0]) - x0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    want = jman.generalized_G(jscene, jnp.asarray(x0), jnp.asarray(d), jres.chain_prim,
                              jnp.asarray(modes), jnp.asarray(m_len), jres.end_prim)
    got = manifold.generalized_G(scene, _t(x0), _t(d), res.chain_prim, _t(modes), _t(m_len),
                                 res.end_prim)
    ok = res.ok.numpy()
    assert (got.numpy()[ok] > 0).all()
    _close(got, want)


def test_chip_smoke_walk_case_is_the_jax_tests():
    """chip_smoke.py's [manifold_walk] scene equals the mirror floor of
    tests/test_manifold.py, and its inputs are the JAX test's at n = 8
    (seed 3) with their closed-form reflection points."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    (args, nrm), x0, x1, tgt, p_ref = cs.mirror_floor_walk_case(8, 3)
    scene = ir.build_scene(*args, normals=nrm, device="cpu")
    want = ir.from_jax(mirror_floor_scene(), "cpu")
    for field in ("vertices", "indices", "normals", "tri_material"):
        assert torch.equal(getattr(scene, field), getattr(want, field)), field
    jx0, jx1, _, _, jtgt = mirror_case()
    for a, b in ((x0, jx0), (x1, jx1), (tgt, jtgt)):
        np.testing.assert_array_equal(a, b)
    res = manifold.walk(scene, _t(x0), _t(x1), torch.zeros((8, 1), dtype=torch.int32),
                        torch.ones((8,), dtype=torch.int32), _t(tgt))
    assert bool(res.ok.all())
    np.testing.assert_allclose(res.chain_pos[:, 0].numpy(), p_ref, atol=2e-3)
