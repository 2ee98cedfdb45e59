"""Specular manifold walk (port of ops/manifold.py).

The analog of SpecularManifold (include/mitsuba/bidir/manifold.h:35,
src/libbidir/manifold.cpp): init/move/update and the generalized geometric
term G/multiG that the manifold perturbation (mut_manifold.cpp) needs.

As in the JAX package, N chains advance in lockstep, one batched Newton
iteration per loop step, and the 2x2 transfer Jacobian of the chain comes
from forward-mode differentiation through a retrace of
the whole specular chain against FIXED triangle planes (`_fixed_chain`):
deterministic reflect/refract plus ray/plane intersections, so no kernel
sits under the derivative. The JAX package takes it with `jax.jvp`; the
port propagates both tangents in closed form through the same operations
(`_fixed_chain(..., dd0=)`), as integrators/reparam.py's `field_jvps`
does for its field. The re-projection onto the true geometry is a real
scene trace (`_real_retrace`, through ops/trace.py: the brute-force kernel,
or the BVH walk on a mesh that has one), like SpecularManifold::update()'s
ray casts.

Parametrisation: the walk's free variable is the FIRST specular vertex x1,
moved in the tangent plane of its current triangle; everything downstream
is a deterministic function of x1 given the per-vertex modes. The Newton
target is the endpoint error in the target's tangent basis.

Conventions:
  * chains are padded to a static length M; `m_len` (N,) gives the true
    specular-vertex count, 1 <= m_len <= M (use `generalized_G` directly
    for m_len = 0);
  * `modes` (N,M) int32: 0 = mirror reflection, 1 = refraction (relative
    IOR gathered from the vertex material's eta, the fresnel convention of
    core/math.fresnel_dielectric);
  * positions are float32 world space; convergence is relative to the
    chain extent (MTS_MANIFOLD_EPSILON analog).

The loop: the JAX package's `lax.while_loop` runs while ANY lane is not
done, still ok and has a step above 1e-5 (a global condition), and every
lane's state is updated on every iteration it runs, so a lane whose step
has shrunk keeps moving while another lane holds the loop open.
`iterations` is that global count. The port's `walk` runs the same
condition as a Python `while`, one host read per Newton iteration; with
`fixed=True` it runs max_iterations iterations with the condition computed
on the device and every update gated on it, so an iteration after the
condition has fallen changes nothing and `iterations` is counted on the
device: the same results, bit for bit, with no host read (a CUDA graph can
hold it; MLT's render_jit does). That is the JAX `lax.while_loop` without
its early exit: the fixed form pays every iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m

MAX_ITERATIONS = 20          # MTS_MANIFOLD_MAX_ITERATIONS (manifold.h:27)
EPSILON = 1e-4               # MTS_MANIFOLD_EPSILON (relative)
_DET_EPS = 1e-12


def _tri(scene, prim):
    """Vertices + geometric normal of triangle `prim` ((N,3) gathers)."""
    vi = scene.indices[torch.clamp_min(prim, 0)]
    v0 = scene.vertices[vi[:, 0]]
    v1 = scene.vertices[vi[:, 1]]
    v2 = scene.vertices[vi[:, 2]]
    ngv = m.cross(v1 - v0, v2 - v0)
    ng = ngv * torch.rsqrt(torch.clamp_min(m.dot(ngv, ngv), 1e-24))[:, None]
    return v0, v1, v2, ng


def _normalize(v, dv=None):
    """v / |v| (core/math.normalize) and, given tangents dv (T,N,3), its
    derivative dv / |v| - v (v . dv) / |v|^3."""
    ln = m.length(v, keepdims=True)
    n = v / ln
    if dv is None:
        return n
    return n, dv / ln - v * (m.dot(v, dv, keepdims=True) / (ln * ln * ln))


def _interp_ns(scene, prim, p, dp=None):
    """Interpolated shading normal at point p on triangle `prim`,
    differentiable in p: the barycentrics come from the 2x2 Gram system of
    the triangle edges, so d(ns)/d(p) carries the curvature the reference
    stores as dndu/dndv. Given tangents dp (T,N,3), returns (ns, dns)."""
    vi = scene.indices[torch.clamp_min(prim, 0)]
    v0 = scene.vertices[vi[:, 0]]
    e1 = scene.vertices[vi[:, 1]] - v0
    e2 = scene.vertices[vi[:, 2]] - v0
    n0 = scene.normals[vi[:, 0]]
    n1 = scene.normals[vi[:, 1]]
    n2 = scene.normals[vi[:, 2]]
    dp_ = p - v0
    a11 = m.dot(e1, e1)
    a12 = m.dot(e1, e2)
    a22 = m.dot(e2, e2)
    r1 = m.dot(dp_, e1)
    r2 = m.dot(dp_, e2)
    det = torch.clamp_min(a11 * a22 - a12 * a12, 1e-20)
    b1 = (a22 * r1 - a12 * r2) / det
    b2 = (a11 * r2 - a12 * r1) / det
    ns = n0 + b1[:, None] * (n1 - n0) + b2[:, None] * (n2 - n0)
    if dp is None:
        return _normalize(ns)
    dr1 = m.dot(dp, e1)
    dr2 = m.dot(dp, e2)
    db1 = (a22 * dr1 - a12 * dr2) / det
    db2 = (a11 * dr2 - a12 * dr1) / det
    return _normalize(ns, db1[..., None] * (n1 - n0) + db2[..., None] * (n2 - n0))


def _tri_eta(scene, prim):
    """Relative IOR (int/ext) of the material on triangle `prim`."""
    mat = scene.tri_material[torch.clamp_min(prim, 0)]
    return scene.materials.eta[mat, 0]


def scatter_dir(d_in, ns, mode, eta, dd=None, dns=None):
    """Deterministic specular scatter of travel direction d_in at normal ns.

    mode 0 = mirror, 1 = refract (eta = int/ext relative IOR, entering or
    exiting from the sign of cos, as fresnelDielectricExt). Returns
    (d_out, ok): ok is False on total internal reflection of a refract
    lane (the move fails there, as the reference's update()). Given the
    tangents dd and dns (T,N,3), returns (d_out, ok, d_out's tangents)."""
    wi = -d_in
    ci = m.dot(wi, ns)
    wo_r = m.reflect(wi, ns)
    fr, cos_t, _, eta_ti = m.fresnel_dielectric(ci, eta)
    wo_t = eta_ti[:, None] * (ci[:, None] * ns - wi) + cos_t[:, None] * ns
    tir = fr >= 1.0 - 1e-6
    refr = mode == 1
    wo = torch.where(refr[:, None], wo_t, wo_r)
    ok = ~(refr & tir)
    if dd is None:
        return _normalize(wo), ok
    dwi = -dd
    dci = m.dot(dwi, ns) + m.dot(wi, dns)
    dwo_r = 2.0 * (dci[..., None] * ns + ci[:, None] * dns) - dwi
    # cos_t = -+sqrt(1 - sin2_t), sin2_t = eta_ti^2 max(1 - ci^2, 0), as
    # fresnel_dielectric computes them
    e2 = eta_ti * eta_ti
    dsin2 = torch.where(1.0 - ci * ci > 0.0, -2.0 * e2 * ci * dci, 0.0)
    cos_t0 = torch.abs(cos_t)
    dcos_t0 = torch.where(cos_t0 > 0.0, -0.5 * dsin2 / torch.where(cos_t0 > 0.0, cos_t0, 1.0),
                          0.0)
    dcos_t = torch.where(ci >= 0.0, -dcos_t0, dcos_t0)
    dwo_t = eta_ti[:, None] * (dci[..., None] * ns + ci[:, None] * dns - dwi) \
        + dcos_t[..., None] * ns + cos_t[:, None] * dns
    wo, dwo = _normalize(wo, torch.where(refr[:, None], dwo_t, dwo_r))
    return wo, ok, dwo


def _plane_hit(scene, p, d, prim, dp=None, dd=None):
    """Ray/plane intersection with triangle `prim`'s supporting plane (the
    fixed-triangle stand-in for a scene trace). Returns (hit, ok), and
    given tangents dp, dd (T,N,3) the hit's tangents too."""
    v0, _, _, ng = _tri(scene, prim)
    denom = m.dot(d, ng)
    safe = torch.abs(denom) > 1e-9
    den = torch.where(safe, denom, 1.0)
    t = m.dot(v0 - p, ng) / den
    hit = p + t[:, None] * d
    ok = safe & (t > 1e-5)
    if dd is None:
        return hit, ok
    dt = (-m.dot(dp, ng) - t * torch.where(safe, m.dot(dd, ng), 0.0)) / den
    return hit, ok, dp + dt[..., None] * d + t[:, None] * dd


def _fixed_chain(scene, p0, d0, chain_prim, modes, m_len, end_prim, dd0=None):
    """Retrace of the whole chain against FIXED triangles: from p0 along
    d0, plane-hit chain_prim[i] and scatter for i < m_len, then plane-hit
    end_prim. Returns (end_pos, ok).

    Given tangents dd0 (T,N,3) of d0 (p0 fixed), also returns end_pos's
    tangents (T,N,3): the forward-mode derivative that the JAX package
    takes with jax.jvp, in closed form. torch's dual numbers
    (torch.autograd.forward_ad) give the same, but dispatch each
    multiply, add and divide through Python decompositions, some hundred
    times a plain op's host cost, and a walk runs thousands of them; all
    T tangents ride in one pass here."""
    p, d = p0, d0
    ok = torch.ones(p0.shape[0], dtype=torch.bool, device=p0.device)
    dp = dd = None
    if dd0 is not None:
        dp, dd = torch.zeros_like(dd0), dd0
    for i in range(chain_prim.shape[1]):
        active = i < m_len
        prim = chain_prim[:, i]
        eta = _tri_eta(scene, prim)
        if dd is None:
            p_hit, h_ok = _plane_hit(scene, p, d, prim)
            d_new, s_ok = scatter_dir(d, _interp_ns(scene, prim, p_hit), modes[:, i], eta)
        else:
            p_hit, h_ok, dp_hit = _plane_hit(scene, p, d, prim, dp, dd)
            ns, dns = _interp_ns(scene, prim, p_hit, dp_hit)
            d_new, s_ok, dd_new = scatter_dir(d, ns, modes[:, i], eta, dd, dns)
            dp = torch.where(active[:, None], dp_hit, dp)
            dd = torch.where(active[:, None], dd_new, dd)
        ok = ok & (~active | (h_ok & s_ok))
        p = torch.where(active[:, None], p_hit, p)
        d = torch.where(active[:, None], d_new, d)
    if dd is None:
        end, e_ok = _plane_hit(scene, p, d, end_prim)
        return end, ok & e_ok
    end, e_ok, dend = _plane_hit(scene, p, d, end_prim, dp, dd)
    return end, ok & e_ok, dend


def _real_retrace(scene, x0, x1_target, modes, m_len, expect_mat=None):
    """Scene-intersection retrace (SpecularManifold::update()'s ray casts):
    from x0 toward x1_target, scattering specularly m_len times. Chain
    vertices must land on triangles of the expected material (expect_mat
    (N,M), None = no check): the walk must not wander off the specular
    object. Returns (chain_pos (N,M,3), chain_prim (N,M), end_pos (N,3),
    end_prim (N,), ok (N,))."""
    from . import trace

    N, M = modes.shape
    dev = x0.device
    d = m.normalize(x1_target - x0)
    p = x0
    chain_pos = [torch.zeros((N, 3), dtype=torch.float32, device=dev) for _ in range(M)]
    chain_prim = [torch.full((N,), -1, dtype=torch.int32, device=dev) for _ in range(M)]
    end_pos = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    end_prim = torch.full((N,), -1, dtype=torch.int32, device=dev)
    ok = torch.ones((N,), dtype=torch.bool, device=dev)
    for i in range(M + 1):
        active = i <= m_len
        its = trace.closest_hit(scene, p, d)
        prim_i = torch.where(its.valid, its.prim.to(torch.int32), -1)
        pos_i = p + its.t[:, None] * d
        is_chain = (i < m_len) & active
        is_end = (i == m_len) & active
        if i < M:
            if expect_mat is None:
                mat_ok = torch.ones((N,), dtype=torch.bool, device=dev)
            else:
                mat_ok = scene.tri_material[torch.clamp_min(prim_i, 0)] == expect_mat[:, i]
            chain_pos[i] = torch.where(is_chain[:, None], pos_i, chain_pos[i])
            chain_prim[i] = torch.where(is_chain, prim_i, chain_prim[i])
            ns = _interp_ns(scene, prim_i, pos_i)
            eta = _tri_eta(scene, prim_i)
            d_new, s_ok = scatter_dir(d, ns, modes[:, min(i, M - 1)], eta)
            ok = ok & (~is_chain | (its.valid & mat_ok & s_ok))
            d = torch.where(is_chain[:, None], d_new, d)
        end_pos = torch.where(is_end[:, None], pos_i, end_pos)
        end_prim = torch.where(is_end, prim_i, end_prim)
        ok = ok & (~is_end | its.valid)
        p = torch.where(active[:, None], pos_i, p)
    return torch.stack(chain_pos, 1), torch.stack(chain_prim, 1), end_pos, end_prim, ok


# orthonormal basis (b1, b2) perpendicular to n: the JAX module's own copy
# of core/math.coordinate_system, the same operations
_onb = m.coordinate_system


class WalkResult(NamedTuple):
    chain_pos: torch.Tensor    # (N,M,3) updated specular vertices
    chain_prim: torch.Tensor   # (N,M)
    end_pos: torch.Tensor      # (N,3) final movable endpoint (~= target)
    end_prim: torch.Tensor     # (N,)
    ok: torch.Tensor           # (N,) bool: converged and every retrace valid
    iterations: torch.Tensor   # (N,) int32


def _length2(e):
    """|e| of (N,2) errors, as core/math.length computes it in 3D."""
    return torch.sqrt(torch.clamp_min(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1], 1e-30))


def walk(scene, x0, x1, modes, m_len, target,
         max_iterations: int = MAX_ITERATIONS, fixed: bool = False) -> WalkResult:
    """Move the endpoint of N specular chains to `target`.

    SpecularManifold::move (manifold.cpp) as one batched Newton loop: x0
    the fixed endpoint, x1 the initial first specular vertex (ON the scene
    surface), modes/m_len the chain, target the desired new position of
    the non-specular endpoint after the chain. `fixed`: the graph-safe
    form (module note), max_iterations iterations and no host read."""
    N, _ = modes.shape
    dev = x0.device

    # establish the initial chain (unchecked), then snapshot its material
    # ids as the expectation every later retrace must satisfy
    cp, cpr, ep, epr, ok0 = _real_retrace(scene, x0, x1, modes, m_len)
    snap_mat = scene.tri_material[torch.clamp_min(cpr, 0)]

    # the target's tangent frame for the 2D error (move() projects onto the
    # destination plane, manifold.cpp)
    tol = EPSILON * (1.0 + m.length(target - x0))

    def err_of(end_pos, tb1, tb2):
        dv = end_pos - target
        return torch.stack([m.dot(dv, tb1), m.dot(dv, tb2)], -1)

    x1c, cpc, cprc, epc, eprc = cp[:, 0], cp, cpr, ep, epr
    step = torch.ones((N,), dtype=torch.float32, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    count = torch.zeros((N,), dtype=torch.int32, device=dev)
    it = 0
    while it < max_iterations:
        go = torch.any(~done & ok0 & (step > 1e-5))
        if not fixed and not bool(go):
            break
        _, _, _, ng_end = _tri(scene, eprc)
        tb1, tb2 = _onb(ng_end)
        e_cur = err_of(epc, tb1, tb2)
        # basis in the first chain triangle's plane
        _, _, _, ng1 = _tri(scene, cprc[:, 0])
        b1, b2 = _onb(ng1)

        # the Newton system's columns: the endpoint error's derivatives
        # along b1 and b2 at the current first vertex
        d0, dd0 = _normalize(x1c - x0, torch.stack([b1, b2]))
        _, _, dend = _fixed_chain(scene, x0, d0, cprc, modes, m_len, eprc, dd0)
        j1, j2 = (torch.stack([m.dot(de, tb1), m.dot(de, tb2)], -1) for de in dend)
        det = j1[:, 0] * j2[:, 1] - j1[:, 1] * j2[:, 0]
        inv_ok = torch.abs(det) > _DET_EPS
        inv_det = torch.where(inv_ok, 1.0 / torch.where(inv_ok, det, 1.0), 0.0)
        # solve J du = -e (columns j1, j2)
        du0 = (-e_cur[:, 0] * j2[:, 1] + e_cur[:, 1] * j2[:, 0]) * inv_det
        du1 = (-e_cur[:, 1] * j1[:, 0] + e_cur[:, 0] * j1[:, 1]) * inv_det

        x1_try = x1c + step[:, None] * (du0[:, None] * b1 + du1[:, None] * b2)
        cp_t, cpr_t, ep_t, epr_t, rt_ok = _real_retrace(scene, x0, x1_try, modes, m_len,
                                                        snap_mat)
        _, _, _, ng_t = _tri(scene, epr_t)
        tb1_t, tb2_t = _onb(ng_t)
        e_new = err_of(ep_t, tb1_t, tb2_t)
        improve = rt_ok & inv_ok & (_length2(e_new) < _length2(e_cur))

        upd = improve & ~done & go
        x1c = torch.where(upd[:, None], cp_t[:, 0], x1c)
        cpc = torch.where(upd[:, None, None], cp_t, cpc)
        cprc = torch.where(upd[:, None], cpr_t, cprc)
        epc = torch.where(upd[:, None], ep_t, epc)
        eprc = torch.where(upd, epr_t, eprc)
        # step-size control (manifold.cpp move(): halve on failure, restore
        # toward 1 on success)
        step = torch.where(done | ~go, step,
                           torch.where(improve, torch.clamp_max(step * 2.0, 1.0), step * 0.5))
        e_eff = torch.where(upd[:, None], e_new, e_cur)
        done = done | (go & (_length2(e_eff) < tol))
        count = count + go.to(torch.int32)
        it += 1
    return WalkResult(chain_pos=cpc, chain_prim=cprc, end_pos=epc, end_prim=eprc,
                      ok=ok0 & done, iterations=count)


def generalized_G(scene, x0, x1_dir, chain_prim, modes, m_len, end_prim, ns0=None):
    """Generalized geometric term through a specular chain.

    SpecularManifold::G / multiG (manifold.cpp): |cos theta_0| / |dA_b/dw|,
    dA_b/dw being the area the movable endpoint sweeps per unit solid angle
    at x0, the 2x2 Jacobian determinant of the fixed-triangle retrace. With
    m_len = 0 this is the classical cos_a cos_b / d^2.

    x1_dir: unit direction of the first chain segment at x0. ns0: shading
    normal at x0 (None omits the |cos theta_0| factor: x0 is a camera or
    medium vertex with no surface cosine)."""
    a, b = _onb(x1_dir)
    d0, dd0 = _normalize(x1_dir, torch.stack([a, b]))
    _, ok, (dp1, dp2) = _fixed_chain(scene, x0, d0, chain_prim, modes, m_len, end_prim, dd0)
    # dA/dw = area swept at the endpoint per unit solid angle at x0
    dA_dw = m.length(m.cross(dp1, dp2))
    cos0 = 1.0 if ns0 is None else torch.abs(m.dot(x1_dir, ns0))
    return torch.where(ok & (dA_dw > 1e-20), cos0 / torch.clamp_min(dA_dw, 1e-20), 0.0)
