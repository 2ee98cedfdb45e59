"""Path-space Metropolis light transport, Veach MLT (port of
integrators/mlt.py).

The analog of src/integrators/mlt/mlt.cpp over the libbidir mutators
(mut_bidir.h:38, mut_lens.h:36, mut_caustic.h:36, mut_mchain.h:36,
mut_manifold.cpp). Tens of thousands of short chains run in lockstep; the
path state is a dense array (positions, primitive ids, length), every
mutation is one batched proposal, and the film takes both states'
expected-value splats through one `index_add_` each. Mutations act on the
path's vertices, not on primary-sample numbers: that is what tells MLT
from pssmlt.py.

Mutation kernels, cycled per step (kernel i % n_modes at step i):

  A  tail regen / connect: delete the suffix after a uniform cut vertex,
     re-trace by BSDF sampling, connect to a fresh area-light point (cut 0
     is the independence sampler);
  B  tail regen / hit: the same deletion, ending where the BSDF-sampled
     suffix hits an emitter;
  C  lens perturbation: an exponential raster offset of v1;
  D  caustic perturbation: an exponential polar offset of v2 -> v1;
  E  multi-chain perturbation: C chained with D's offset of v1 -> v2;
  F  manifold perturbation (only on scenes with pure-delta BSDFs): perturb
     the direction out of a non-specular vertex, propagate through the
     specular chain, re-solve the next chain with the manifold walk
     (ops/manifold.py) so the far vertex stays put, walk back to check
     reversibility.

Acceptance uses the exact per-kernel transition densities; f(path) is
re-evaluated from the vertex arrays each proposal, visibility included.
On scenes with conductor, dielectric or thin-dielectric materials the
target lives on the quotient manifold: delta vertices contribute their
Fresnel coefficients and each maximal specular chain one generalized
geometric term (manifold.generalized_G) in place of its edges' cos / d^2.
Scope: paths end on AREA emitters (env- or delta-lit scenes: pssmlt, as
the CLI routes them); surfaces only.

The port computes only the active kernel's proposal at each step (the JAX
package computes A/B, C, D and E every step and selects one; the selected
values are the same). Every draw is still made every step, so the stream
does not depend on which kernel runs.

Random draws: the JAX package splits a tree of threefry keys; the port
draws from one torch.Generator seeded with cfg.seed (ROADMAP C15, C39,
C42), so its chains take other steps than the JAX package's for the same
seed. `draws` replaces the generator: a function (name, shape, low=None,
high=None) -> tensor on the scene's device, float32 uniforms in [0, 1),
or int32 integers in [low, high) where `high` is given. It is called
with these names, in this order:
  "boot_length" (n_bootstrap,) in [1, K + 1), the bootstrap's k;
  "boot_regen" (n_bootstrap, 4) K times, then "boot_light" (n_bootstrap, 3);
  "pick" (n_chains,);
  per mutation: "cut" (n, 4), "regen" (n, 4) K times, "regen_light"
  (n, 3), "perturb" (n, 4), "manifold" (n, 1) on kernel F's steps only,
  "accept" (n,).
The parity tests pass the JAX package's own draws through it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import math as m
from ..core import warp
from ..models import bsdf as bsdflib
from ..models import emitter as emitterlib
from ..models import sensor as sensorlib
from ..ops import manifold as manif
from ..ops import trace
from ..ops.intersect import Intersection
from ..scene import ir
from ..utils import graphs
from .common import RenderConfig

LUM = (0.2126, 0.7152, 0.0722)
_SPEC_DOT_TOL = 5e-4   # direction consistency: angle < ~0.03 rad


def generator_draws(seed: int, device, gen=None):
    """The default `draws`: one torch.Generator seeded with `seed` (or
    `gen`, as it stands), uniforms by torch.rand and integers by
    torch.randint, in call order."""
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))

    def draw(name, shape, low=None, high=None):
        if high is not None:
            return torch.randint(low, high, shape, generator=gen, device=device,
                                 dtype=torch.int32)
        return torch.rand(shape, generator=gen, device=device)

    return draw


# ---------------------------------------------------------------------------
# Path-state helpers. State: pos (N,K+1,3), prim (N,K+1) int32, k (N,)
# int32. Vertex 0 is the camera (pos = eye, prim unused); vertex k lies on
# an area emitter; k = number of edges, 1 <= k <= K.
# ---------------------------------------------------------------------------


def _take_v(arr, idx):
    """Gather per-chain vertex idx from (N, K+1, ...)."""
    return arr[torch.arange(arr.shape[0], device=arr.device), idx.long()]


def _set_v(arr, idx, val, mask):
    """Masked scatter of per-chain vertex idx into (N, K+1, ...)."""
    onehot = torch.arange(arr.shape[1], device=arr.device)[None, :] == idx[:, None]
    sel = onehot & mask[:, None]
    if arr.ndim == 3:
        return torch.where(sel[:, :, None], val[:, None, :], arr)
    return torch.where(sel, val[:, None], arr)


def _si_at(scene, v_prev, v, prim):
    """Surface data at vertex v approached from v_prev."""
    dvec = v - v_prev
    dist = torch.clamp_min(m.length(dvec), 1e-9)
    d = dvec / dist[:, None]
    zeros = torch.zeros_like(dist)
    its = Intersection(valid=prim >= 0, t=dist, prim=torch.clamp_min(prim, 0), b1=zeros,
                       b2=zeros)
    return trace.surface_interaction(scene, v_prev, d, its), d, dist


def _light_area_pdf(scene, prim):
    em = scene.emitters
    _, e1a, e2a = scene.tri_vertices()
    area_all = 0.5 * m.length(m.cross(e1a, e2a))
    pg_area, _, _ = emitterlib._group_probs(scene)
    pr = torch.clamp_min(prim, 0)
    return m.safe_div(em.select_pdf_full[pr] * pg_area, area_all[pr])


def _eye(cam, n):
    return cam.to_world[:3, 3].expand(n, 3)


def _npix(cam):
    return float(np.float32(cam.width * cam.height))


def _cam_we(cam, d):
    """(w*h) / (A_film cos^3): the per-PIXEL-uniform importance in solid
    angle, which makes eval_path's f integrate to per-pixel radiance."""
    fwd = cam.to_world[:3, 2]
    cos_c = torch.clamp_min(m.dot(d, fwd[None, :]), 1e-6)
    return _npix(cam) / (sensorlib.film_area(cam) * cos_c ** 3), cos_c


# ---------------------------------------------------------------------------
# Specular (delta) chain support: the manifold tier (mut_manifold.cpp,
# manifold.cpp). Paths may hold interior vertices on pure-delta BSDFs; the
# target then lives on the quotient manifold. Everything below is gated on
# `_scene_has_spec`, a Python bool of the scene's static family set.
# ---------------------------------------------------------------------------


def _spec_fams():
    return (ir.BSDF_CONDUCTOR, ir.BSDF_DIELECTRIC, ir.BSDF_THIN_DIELECTRIC)


def _scene_has_spec(scene) -> bool:
    return any(f in _spec_fams() for f in scene.bsdf_families)


def _is_spec_family(fam):
    return (fam == ir.BSDF_CONDUCTOR) | (fam == ir.BSDF_DIELECTRIC) \
        | (fam == ir.BSDF_THIN_DIELECTRIC)


def _spec_flags(scene, prim, k, K):
    """(N,K+1) bool: interior on-path vertices with a pure-delta BSDF."""
    fam = scene.materials.type[scene.tri_material[torch.clamp_min(prim, 0)]]
    is_spec = _is_spec_family(fam) & (prim >= 0)
    idx = torch.arange(K + 1, device=prim.device)[None, :]
    return is_spec & (idx >= 1) & (idx <= k[:, None] - 1)


def _chain_modes(scene, pos, prim, K):
    """(N,K+1) int32 per-vertex interaction mode: 0 reflect, 1 refract
    (from the path geometry: crossing the surface is refraction)."""
    cols = [torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)]
    for i in range(1, K):
        vi = scene.indices[torch.clamp_min(prim[:, i], 0)]
        v0 = scene.vertices[vi[:, 0]]
        ngv = m.cross(scene.vertices[vi[:, 1]] - v0, scene.vertices[vi[:, 2]] - v0)
        d_in = pos[:, i] - pos[:, i - 1]
        d_out = pos[:, i + 1] - pos[:, i]
        cols.append((m.dot(d_in, ngv) * m.dot(d_out, ngv) > 0).to(torch.int32))
    cols.append(cols[0])
    return torch.stack(cols, 1)


def _spec_eval(sp, wi_l, wo_l):
    """Delta-BSDF evaluation at a chain vertex with both directions known.

    Returns (w (N,3), prob (N,), consistent (N,)): w the measure-free delta
    coefficient (the sample weight times its lobe probability), prob the
    lobe-selection probability, consistent whether wo is the deterministic
    scatter of wi (off-manifold states have zero target)."""
    flip = bsdflib._apply_twosided(sp, wi_l)
    wi_l = wi_l * flip
    wo_l = wo_l * flip
    n = wi_l.shape[0]
    dev = wi_l.device
    w = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    prob = torch.zeros((n,), dtype=torch.float32, device=dev)
    cons = torch.zeros((n,), dtype=torch.bool, device=dev)
    fam = sp.type

    def close(a, b):
        return m.dot(a, b) > 1.0 - _SPEC_DOT_TOL

    # conductor: mirror lobe, prob 1 (conductor.cpp)
    sel = fam == ir.BSDF_CONDUCTOR
    ci = m.cos_theta(wi_l)
    ok_c = close(wo_l, m.reflect_local(wi_l)) & (ci > 0)
    f_c = m.fresnel_conductor(ci, sp.eta, sp.k) * sp.specular
    w = torch.where((sel & ok_c)[:, None], f_c, w)
    prob = torch.where(sel & ok_c, 1.0, prob)
    cons = torch.where(sel, ok_c, cons)

    # smooth dielectric: two lobes selected with prob F / 1-F
    # (dielectric.cpp:241 radiance compression on the transmit lobe)
    sel = fam == ir.BSDF_DIELECTRIC
    eta = sp.eta[..., 0]
    fr, cos_t, _, eta_ti = m.fresnel_dielectric(ci, eta)
    is_refl = close(wo_l, m.reflect_local(wi_l))
    is_refr = close(wo_l, m.refract_local(wi_l, eta, cos_t)) & (fr < 1.0)
    w_d = torch.where(is_refl[:, None], fr[:, None] * sp.specular,
                      ((1.0 - fr) * eta_ti * eta_ti)[:, None] * sp.reflectance)
    p_d = torch.where(is_refl, fr, 1.0 - fr)
    ok_d = is_refl | is_refr
    w = torch.where((sel & ok_d)[:, None], w_d, w)
    prob = torch.where(sel & ok_d, p_d, prob)
    cons = torch.where(sel, ok_d, cons)

    # thin dielectric: R' = 2R / (1 + R), transmission passes through
    sel = fam == ir.BSDF_THIN_DIELECTRIC
    fr_t, _, _, _ = m.fresnel_dielectric(torch.abs(ci), eta)
    fr2 = m.safe_div(2.0 * fr_t, 1.0 + fr_t)
    is_refl_t = close(wo_l, m.reflect_local(wi_l))
    is_pass = close(wo_l, -wi_l)
    w_t = torch.where(is_refl_t[:, None], fr2[:, None] * sp.specular,
                      (1.0 - fr2)[:, None] * sp.reflectance)
    p_t = torch.where(is_refl_t, fr2, 1.0 - fr2)
    ok_t = is_refl_t | is_pass
    w = torch.where((sel & ok_t)[:, None], w_t, w)
    prob = torch.where(sel & ok_t, p_t, prob)
    cons = torch.where(sel, ok_t, cons)
    return w, prob, cons


def _gather_chain_at(prim, spec, modes_all, raw, K):
    """The chain whose vertices would sit at indices `raw` (N, M): the
    leading run of specular vertices among them. Returns the padded prim
    and mode arrays, the run's length, and the end (non-spec) vertex's
    index and prim."""
    idxs = torch.clamp(raw, 0, K).long()
    run = torch.cumprod((torch.gather(spec, 1, idxs) & (raw <= K)).to(torch.int32), 1).bool()
    m_len = run.sum(1).to(torch.int32)
    chain_prim = torch.where(run, torch.gather(prim, 1, idxs), 0)
    ch_modes = torch.where(run, torch.gather(modes_all, 1, idxs), 0)
    end_idx = torch.clamp(raw[:, 0] + m_len, 0, K)
    return chain_prim, ch_modes, m_len, end_idx, _take_v(prim, end_idx)


def _gather_chain(prim, spec, modes_all, a, K):
    """Chain description starting at vertex a+1 (a Python int): padded
    prim / mode arrays (N, K-1), true length, and the end (non-spec)
    vertex."""
    M = max(K - 1, 1)
    raw = (a + 1 + torch.arange(M, device=prim.device))[None, :].expand(prim.shape[0], M)
    return _gather_chain_at(prim, spec, modes_all, raw, K)


def _gather_chain_dyn(prim, spec, modes_all, a, K):
    """_gather_chain with a per-lane start vertex a (N,)."""
    M = max(K - 1, 1)
    raw = a[:, None] + 1 + torch.arange(M, device=prim.device)[None, :]
    return _gather_chain_at(prim, spec, modes_all, raw, K)


def _chain_G_product(scene, pos, prim, k, K, spec, modes_all, gen_from=None):
    """Product over maximal specular chains of the generalized geometric
    term (dw at the chain start per dA at the first non-spec vertex after
    it). gen_from: optional (N,) cut; only chains whose start vertex
    a >= gen_from contribute (the transition-density use)."""
    g_prod = torch.ones((pos.shape[0],), dtype=torch.float32, device=pos.device)
    for a in range(K):
        nxt = min(a + 1, K)
        start = (~spec[:, a]) & (a <= k - 1) & spec[:, nxt]
        if gen_from is not None:
            start = start & (a >= gen_from)
        chain_prim, ch_modes, m_len, _, end_prim = _gather_chain(prim, spec, modes_all, a, K)
        x0 = pos[:, a]
        g = manif.generalized_G(scene, x0, m.normalize(pos[:, nxt] - x0), chain_prim, ch_modes,
                                torch.clamp_min(m_len, 1), end_prim)
        g_prod = g_prod * torch.where(start, g, 1.0)
    return g_prod


def eval_path(scene, cam, pos, prim, k, K):
    """f(path) with visibility -> (color (N,3), luminance (N,), pixel (N,)).

    With pure-delta materials in the scene, chain edges drop their cos/d^2
    factors, chain vertices contribute their delta coefficient
    (_spec_eval), and each maximal chain multiplies one generalized
    geometric term (manifold.cpp multiG)."""
    n = pos.shape[0]
    eye = _eye(cam, n)
    families = scene.bsdf_families

    v1 = pos[:, 1]
    we, _ = _cam_we(cam, m.normalize(v1 - eye))
    px, py, rvalid, _ = sensorlib.world_to_raster(cam, v1)
    xi = torch.clamp(px.to(torch.int32), 0, cam.width - 1)
    yi = torch.clamp(py.to(torch.int32), 0, cam.height - 1)
    pixel = yi * cam.width + xi

    has_spec = _scene_has_spec(scene)
    if has_spec:
        spec = _spec_flags(scene, prim, k, K)
        modes_all = _chain_modes(scene, pos, prim, K)

    f = torch.ones((n, 3), dtype=torch.float32, device=pos.device) * we[:, None]
    ok = rvalid & (k >= 1)
    prev = eye
    for i in range(1, K + 1):
        on_path = i <= k
        si, d_in, dist = _si_at(scene, prev, pos[:, i], prim[:, i])
        geom = torch.abs(m.dot(d_in, si["ng"])) / torch.clamp_min(dist * dist, 1e-12)
        if has_spec:
            # chain edges (touching a spec vertex) carry no cos/d^2: the
            # chain's generalized G replaces them
            geom = torch.where(spec[:, i - 1] | spec[:, i], 1.0, geom)
        f = torch.where(on_path[:, None], f * geom[:, None], f)
        blocked = trace.shadow_blocked(scene, prev, d_in, dist, False)
        ok = ok & (~blocked | ~on_path)

        is_end = i == k
        if i < K:
            # interior vertex: the BSDF toward the next vertex
            sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"])
            wi_l = m.to_local(si["ns"], -d_in)
            wo_l = m.to_local(si["ns"], m.normalize(pos[:, i + 1] - pos[:, i]))
            fs, _ = bsdflib.eval_pdf(sp, wi_l, wo_l, families)
            if has_spec:
                w_sp, _, cons = _spec_eval(sp, wi_l, wo_l)
                fs = torch.where(spec[:, i, None], torch.where(cons[:, None], w_sp, 0.0), fs)
            f = torch.where((on_path & ~is_end)[:, None], f * fs, f)
        # terminal vertex: the area emitter's radiance toward v_{k-1}
        em_id = si["emitter"]
        cos_e = m.dot(-d_in, si["ng"])
        le = scene.emitters.radiance[torch.clamp_min(em_id, 0)]
        hit_ok = (em_id >= 0) & (cos_e > 0.0)
        f = torch.where((on_path & is_end)[:, None],
                        torch.where(hit_ok[:, None], f * le, 0.0), f)
        prev = torch.where(on_path[:, None], pos[:, i], prev)

    if has_spec:
        f = f * _chain_G_product(scene, pos, prim, k, K, spec, modes_all)[:, None]
    f = torch.where(ok[:, None], f, 0.0)
    f = torch.nan_to_num(f, nan=0.0, posinf=0.0, neginf=0.0)
    return f, f @ m.const(LUM, f.device), pixel


def _bsdf_area_pdf(scene, v_prev, v, prim, v_next, prim_next, spec_here=None,
                   spec_next=None):
    """Area-measure pdf of generating v_next by BSDF-sampling at v.

    Specular-chain variants: at a delta vertex the factor is the
    lobe-selection probability alone; sampling INTO a chain keeps the
    solid-angle pdf (the chain's generalized G converts at its end)."""
    si, d_in, _ = _si_at(scene, v_prev, v, prim)
    sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"])
    wi_l = m.to_local(si["ns"], -d_in)
    dvec = v_next - v
    d2 = torch.clamp_min(m.dot(dvec, dvec), 1e-12)
    wo_l = m.to_local(si["ns"], dvec * torch.rsqrt(d2)[:, None])
    _, pdf_sa = bsdflib.eval_pdf(sp, wi_l, wo_l, scene.bsdf_families)
    si_n, d_n, _ = _si_at(scene, v, v_next, prim_next)
    p_area = pdf_sa * torch.abs(m.dot(d_n, si_n["ng"])) / d2
    if spec_here is None:
        return p_area
    _, prob_sp, cons = _spec_eval(sp, wi_l, wo_l)
    p = torch.where(spec_next, pdf_sa, p_area)       # into a chain: SA only
    return torch.where(spec_here, torch.where(cons, prob_sp, 0.0), p)


def _geom_jac(scene, v_from, v_to, prim_to):
    """Solid-angle -> area Jacobian |cos| / d^2 at v_to seen from v_from
    (the only asymmetric factor of the D/E angular proposal kernels)."""
    si, d_in, dist = _si_at(scene, v_from, v_to, prim_to)
    return torch.abs(m.dot(d_in, si["ng"])) / torch.clamp_min(dist * dist, 1e-12)


def _cam_area_pdf(scene, cam, v1, prim1):
    """Area pdf of v1 under uniform-raster camera sampling: uniform raster
    over the full film has pdf_sa = 1 / (A_film cos^3) = we / npix."""
    eye = _eye(cam, v1.shape[0])
    dvec = v1 - eye
    d2 = torch.clamp_min(m.dot(dvec, dvec), 1e-12)
    we, _ = _cam_we(cam, dvec * torch.rsqrt(d2)[:, None])
    pdf_sa = we / _npix(cam)
    si, d_in, _ = _si_at(scene, eye, v1, prim1)
    return pdf_sa * torch.abs(m.dot(d_in, si["ng"])) / d2


def regen_pdf(scene, cam, pos, prim, k, c, K, mode_hit):
    """Transition density of regenerating THIS path's suffix after cut c
    (both the forward and the reverse acceptance factor):

    connect mode: prod_{i=c..k-2} p_bsdf_area(v_{i+1}) * p_light_area(v_k)
    hit mode:     prod_{i=c..k-1} p_bsdf_area(v_{i+1})
    (at c = 0 the first factor is the camera area pdf of v1)."""
    n = pos.shape[0]
    eye = _eye(cam, n)
    has_spec = _scene_has_spec(scene)
    if has_spec:
        spec = _spec_flags(scene, prim, k, K)
        modes_all = _chain_modes(scene, pos, prim, K)
    p = torch.ones((n,), dtype=torch.float32, device=pos.device)
    # camera factor: v1 is camera-sampled iff c = 0 AND v1 is a traced
    # vertex (connect mode with k = 1 sets v1 from the LIGHT sampler)
    p_cam = _cam_area_pdf(scene, cam, pos[:, 1], prim[:, 1])
    if has_spec:
        # a spec v1: the solid-angle raster pdf only (the chain's G
        # converts at its end)
        we1, _ = _cam_we(cam, m.normalize(pos[:, 1] - eye))
        p_cam = torch.where(spec[:, 1], we1 / _npix(cam), p_cam)
    use_cam = (c == 0) & (mode_hit | (k >= 2))
    p = torch.where(use_cam, p * p_cam, p)
    lim = torch.where(mode_hit, k - 1, k - 2)
    for i in range(1, K):
        # the BSDF factor generating v_{i+1} by scattering at vertex i; the
        # traced targets are v_{c+1}..v_{k-1} (connect) or ..v_k (hit)
        gen = (i >= torch.clamp_min(c, 1)) & (i <= lim)
        nxt = min(i + 1, K)
        if has_spec:
            pb = _bsdf_area_pdf(scene, pos[:, i - 1], pos[:, i], prim[:, i], pos[:, nxt],
                                prim[:, nxt], spec_here=spec[:, i], spec_next=spec[:, nxt])
        else:
            pb = _bsdf_area_pdf(scene, pos[:, i - 1], pos[:, i], prim[:, i], pos[:, nxt],
                                prim[:, nxt])
        p = torch.where(gen, p * pb, p)
        # hit mode stops at the FIRST emitter: a path with an emissive
        # intermediate vertex is unreachable (its reverse density is 0)
        inter_emissive = (scene.tri_emitter[torch.clamp_min(prim[:, i], 0)] >= 0) \
            & (i >= c + 1) & (i <= k - 1)
        p = torch.where(mode_hit & inter_emissive, 0.0, p)
    end_prim = _take_v(prim, torch.clamp(k, 0, K))
    p = torch.where(mode_hit, p, p * _light_area_pdf(scene, end_prim))
    if has_spec:
        # chains generated within the suffix: the SA -> area conversion by
        # the generalized geometric term (eval_path's factor structure)
        p = p * _chain_G_product(scene, pos, prim, k, K, spec, modes_all, gen_from=c)
    return torch.clamp_min(p, 0.0)


def _sample_light_point(scene, u3):
    """A fresh area-light vertex (pos, prim) ~ the emitter area CDF."""
    em = scene.emitters
    idx = torch.clamp(torch.searchsorted(em.tri_cdf, u3[:, 0].contiguous(), right=False),
                      0, em.tri_cdf.shape[0] - 1)
    tri = em.tri_index[idx].long()
    p0, e1, e2 = scene.tri_vertices()
    b = warp.square_to_uniform_triangle(u3[:, 1:3])
    return p0[tri] + e1[tri] * b[:, 0:1] + e2[tri] * b[:, 1:2], tri.to(torch.int32)


def _regen(scene, cam, u_steps, u_light, pos, prim, k, c, k_new, K, mode_hit):
    """Regenerate the suffix after cut c -> the proposal state.

    connect mode: trace (k_new - c - 1) vertices, then a fresh light
    vertex; hit mode: trace until an emitter is hit. u_steps: K uniforms
    (n, 4), one per traced vertex; u_light (n, 3) the light point's (the
    JAX package's K+2 keys of one split). Returns (pos', prim', k', ok)."""
    n = pos.shape[0]
    eye = _eye(cam, n)
    families = scene.bsdf_families

    # the walk's current vertex is the cut vertex
    v_cur = torch.where((c == 0)[:, None], eye, _take_v(pos, c))
    v_prev = torch.where((c <= 1)[:, None], eye, _take_v(pos, torch.clamp_min(c - 1, 0)))
    prim_cur = _take_v(prim, c)

    pos_n, prim_n = pos, prim
    alive = torch.ones((n,), dtype=torch.bool, device=pos.device)
    done_hit = torch.zeros((n,), dtype=torch.bool, device=pos.device)
    k_hit = torch.full((n,), K + 1, dtype=torch.int32, device=pos.device)
    # stop tracing once a lane generated its last traced vertex
    n_trace = torch.where(mode_hit, K - c, k_new - c - 1)

    for j in range(K):
        tgt = c + 1 + j                     # the vertex index being generated
        u = u_steps[j]
        # direction: camera sampling when generating v1 from the eye, BSDF
        # sampling otherwise
        o_c, d_c, _ = sensorlib.sample_rays(cam, u[:, 0] * cam.width, u[:, 1] * cam.height,
                                            u[:, 2:4])
        si, d_in, _ = _si_at(scene, v_prev, v_cur, prim_cur)
        sp = bsdflib.gather_shade_point(scene, si["mat"], si["uv"])
        wo_l, _, pdf_s, _ = bsdflib.sample(sp, m.to_local(si["ns"], -d_in), u[:, 0], u[:, 1:3],
                                           families)
        d_b = m.to_world(si["ns"], wo_l)
        from_eye = tgt == 1
        d_new = torch.where(from_eye[:, None], d_c, d_b)
        o_new = torch.where(from_eye[:, None], o_c, v_cur)
        pdf_ok = from_eye | (pdf_s > 0)

        gen = alive & (j < n_trace) & ~done_hit
        its = trace.closest_hit(scene, o_new, d_new)
        v_next = o_new + its.t[:, None] * d_new
        lane_ok = gen & its.valid & pdf_ok
        pos_n = _set_v(pos_n, tgt, v_next, lane_ok)
        prim_n = _set_v(prim_n, tgt, its.prim, lane_ok)
        alive = torch.where(gen, lane_ok, alive)

        # hit-mode termination: an emitter reached
        em_hit = scene.tri_emitter[torch.clamp_min(its.prim, 0)] >= 0
        newly = lane_ok & mode_hit & em_hit
        k_hit = torch.where(newly & ~done_hit, tgt, k_hit)
        done_hit = done_hit | newly

        v_prev = torch.where(lane_ok[:, None], v_cur, v_prev)
        v_cur = torch.where(lane_ok[:, None], v_next, v_cur)
        prim_cur = torch.where(lane_ok, its.prim, prim_cur)

    # connect mode: a fresh light vertex at index k_new
    lpos, lprim = _sample_light_point(scene, u_light)
    pos_n = _set_v(pos_n, k_new, lpos, ~mode_hit & alive)
    prim_n = _set_v(prim_n, k_new, lprim, ~mode_hit & alive)

    k_out = torch.where(mode_hit, k_hit, k_new).to(torch.int32)
    ok = alive & (~mode_hit | done_hit) & (k_out <= K)
    return pos_n, prim_n, k_out, ok


def _regen_draws(draw, names, n, K):
    """One _regen's uniforms: K (n, 4) and the light point's (n, 3), drawn
    under the two names."""
    return [draw(names[0], (n, 4)) for _ in range(K)], draw(names[1], (n, 3))


# ---------------------------------------------------------------------------
# The proposals of the perturbation kernels C-F
# ---------------------------------------------------------------------------


def _raster_offset(cam, v1, u_r, u_phi):
    """C's and E's exponential raster offset of v1 (mut_lens.h:36) and the
    new primary ray. Returns (inside the film, o, d)."""
    w, h = cam.width, cam.height
    px0, py0, _, _ = sensorlib.world_to_raster(cam, v1)
    r2 = m.const(np.float32(0.05) * np.float32(max(w, h)), v1.device)
    r = r2 * torch.exp(-torch.log(r2 / 0.25) * u_r)
    phi = 2.0 * math.pi * u_phi
    pxn = px0 + r * torch.cos(phi)
    pyn = py0 + r * torch.sin(phi)
    o, d, _ = sensorlib.sample_rays(cam, pxn, pyn, torch.zeros((v1.shape[0], 2),
                                                              dtype=torch.float32,
                                                              device=v1.device))
    return (pxn >= 0) & (pxn < w) & (pyn >= 0) & (pyn < h), o, d


def _angular_offsets(cam, u2):
    """D's exponential polar offsets about +z (mut_caustic.cpp:103-110,
    Veach p.354: the theta range scaled from the per-pixel angle); E and F
    reuse them."""
    w, h = cam.width, cam.height
    rpp = cam.fov_x * (math.pi / 180.0) / float(w)          # rad per pixel
    th1 = 0.25 * rpp
    th2 = rpp * torch.sqrt(m.const(0.05 * w * h / math.pi, u2.device))
    theta = th2 * torch.exp(-torch.log(th2 / th1) * u2[:, 2])
    sphi = 2.0 * math.pi * u2[:, 3]
    return torch.stack([torch.sin(theta) * torch.cos(sphi), torch.sin(theta) * torch.sin(sphi),
                        torch.cos(theta)], dim=-1)


def _with_vertex(arr, i, val, mask):
    """arr with vertex column i set to val where mask."""
    out = arr.clone()
    out[:, i] = torch.where(mask[:, None] if arr.ndim == 3 else mask, val, arr[:, i])
    return out


def _propose_lens(scene, cam, pos_x, prim_x, u):
    """C: retrace the primary ray through the offset raster point."""
    inside, o, d = _raster_offset(cam, pos_x[:, 1], u[:, 1], u[:, 2])
    its = trace.closest_hit(scene, o, d)
    pos_y = _with_vertex(pos_x, 1, o + its.t[:, None] * d, its.valid)
    prim_y = _with_vertex(prim_x, 1, its.prim, its.valid)
    return pos_y, prim_y, its.valid & inside


def _propose_caustic(scene, pos_x, prim_x, k_x, offs):
    """D: the v2 -> v1 direction offset, one edge retraced, the eye link
    kept deterministic."""
    wo_new = m.to_world(m.normalize(pos_x[:, 1] - pos_x[:, 2]), offs)
    its = trace.closest_hit(scene, pos_x[:, 2], wo_new)
    pos_y = _with_vertex(pos_x, 1, pos_x[:, 2] + its.t[:, None] * wo_new, its.valid)
    prim_y = _with_vertex(prim_x, 1, its.prim, its.valid)
    return pos_y, prim_y, its.valid & (k_x >= 2)


def _propose_multichain(scene, cam, pos_x, prim_x, k_x, u2, offs):
    """E: C's raster offset of v1 chained with D's angular offset of the
    old v1 -> v2 direction; both retraced, v2 -> v3 reconnected
    (mut_mchain.h:36)."""
    inside, o, d = _raster_offset(cam, pos_x[:, 1], u2[:, 0], u2[:, 1])
    its1 = trace.closest_hit(scene, o, d)
    v1 = o + its1.t[:, None] * d
    wo12 = m.to_world(m.normalize(pos_x[:, 2] - pos_x[:, 1]), offs)
    its2 = trace.closest_hit(scene, v1, wo12)
    ok = its1.valid & its2.valid & (k_x >= 3) & inside
    pos_y = _with_vertex(_with_vertex(pos_x, 1, v1, ok), 2, v1 + its2.t[:, None] * wo12, ok)
    prim_y = _with_vertex(_with_vertex(prim_x, 1, its1.prim, ok), 2, its2.prim, ok)
    return pos_y, prim_y, ok


def _pick_nonspec(elig, cnt, uu):
    """A uniform pick among each lane's eligible (non-spec) vertices."""
    pk = torch.minimum(torch.clamp_min((uu * cnt).to(torch.int32), 0),
                       torch.clamp_min(cnt - 1, 0))
    ranks = torch.cumsum(elig.to(torch.int32), 1) - 1
    oh = elig & (ranks == pk[:, None])
    return (oh * torch.arange(elig.shape[1], device=elig.device)[None, :]).sum(1).to(torch.int32)


def _propose_manifold(scene, pos_x, prim_x, k_x, spec_x, modes_x, a_f, offs, K,
                      fixed_walk=False):
    """F: the manifold perturbation (mut_manifold.cpp). Perturb the
    direction out of the non-spec vertex a by D's angular kernel,
    propagate through the a..b delta chain (real retrace), re-solve the
    b..c chain with the manifold walk so c stays fixed, and walk back to
    the old b for reversibility (mut_manifold.cpp:510-520); `fixed_walk`:
    both walks in the graph-safe form (manifold.walk's fixed=True).
    Returns (pos_y, prim_y, ok, G of x's a..b chain, G of y's)."""
    MC = max(K - 1, 1)
    ch_prim_a, ch_modes_a, mlen_a, b_idx, bprim_x = _gather_chain_dyn(prim_x, spec_x, modes_x,
                                                                      a_f, K)
    pos_a = _take_v(pos_x, a_f)
    pos_a1 = _take_v(pos_x, torch.clamp(a_f + 1, 0, K))
    pos_b_old = _take_v(pos_x, b_idx)
    wo_old = m.normalize(pos_a1 - pos_a)
    exp_mat = scene.tri_material[torch.clamp_min(ch_prim_a, 0)]
    cp_ab, cpr_ab, b_new, bprim_new, ok_ab = manif._real_retrace(
        scene, pos_a, pos_a + m.to_world(wo_old, offs), ch_modes_a, mlen_a, exp_mat)
    # the moved endpoint must stay non-spec (isConnectable())
    b_nonspec = ~_is_spec_family(scene.materials.type[
        scene.tri_material[torch.clamp_min(bprim_new, 0)]])
    # the b..c chain, seen from the fixed anchor c
    _, _, mlen_bc, c_idx, _ = _gather_chain_dyn(prim_x, spec_x, modes_x, b_idx, K)
    need_walk = (mlen_bc >= 1) & (b_idx < k_x)
    pos_c = _take_v(pos_x, c_idx)
    # the reversed chain: its first spec vertex seen from c is c-1
    raw_r = c_idx[:, None] - 1 - torch.arange(MC, device=pos_x.device)[None, :]
    rev_modes = torch.where(raw_r >= (b_idx + 1)[:, None],
                            torch.gather(modes_x, 1, torch.clamp(raw_r, 0, K).long()), 0)
    x1_w = _take_v(pos_x, torch.clamp(c_idx - 1, 0, K))
    mlen_w = torch.clamp_min(mlen_bc, 1)
    resw = manif.walk(scene, pos_c, x1_w, rev_modes, mlen_w, b_new, fixed=fixed_walk)
    # reversibility: walking back to the old b must recover the old chain
    # head (mut_manifold.cpp statsNonReversible)
    resr = manif.walk(scene, pos_c, resw.chain_pos[:, 0], rev_modes, mlen_w, pos_b_old,
                      fixed=fixed_walk)
    scale = 1.0 + m.length(pos_b_old - pos_c)
    rev_ok = resr.ok & (m.length(resr.chain_pos[:, 0] - x1_w) < 1e-3 * scale)
    walk_ok = torch.where(need_walk, resw.ok & rev_ok, True)

    ok = ok_ab & b_nonspec & walk_ok & (k_x >= 1)
    pos_y, prim_y = pos_x, prim_x
    for j in range(MC):
        slot = torch.clamp(a_f + 1 + j, 0, K)
        mj = (j < mlen_a) & ok
        pos_y = _set_v(pos_y, slot, cp_ab[:, j], mj)
        prim_y = _set_v(prim_y, slot, cpr_ab[:, j], mj)
        slot2 = torch.clamp(c_idx - 1 - j, 0, K)
        mj2 = (j < mlen_bc) & need_walk & ok
        pos_y = _set_v(pos_y, slot2, resw.chain_pos[:, j], mj2)
        prim_y = _set_v(prim_y, slot2, resw.chain_prim[:, j], mj2)
    pos_y = _set_v(pos_y, b_idx, b_new, ok)
    prim_y = _set_v(prim_y, b_idx, bprim_new, ok)
    # the angular kernel is symmetric: only the dw_a -> dA_b conversions
    # (generalized G) remain in the acceptance ratio
    gx = manif.generalized_G(scene, pos_a, wo_old, ch_prim_a, ch_modes_a, mlen_a, bprim_x)
    y_a1 = torch.where((mlen_a >= 1)[:, None], cp_ab[:, 0], b_new)
    gy = manif.generalized_G(scene, pos_a, m.normalize(y_a1 - pos_a), cpr_ab, ch_modes_a,
                             mlen_a, bprim_new)
    return pos_y, prim_y, ok & (gx > 0) & (gy > 0), gx, gy


# ---------------------------------------------------------------------------
# The render loop
# ---------------------------------------------------------------------------


def _bootstrap(scene, cam, K, n_bootstrap, draw):
    """Independence proposals (kernel A at cut 0): the paths, their
    importance weights L / T and b, the mean weight."""
    nb = n_bootstrap
    dev = scene.device
    zero = torch.zeros((nb,), dtype=torch.int32, device=dev)
    no_hit = torch.zeros((nb,), dtype=torch.bool, device=dev)
    k_new0 = draw("boot_length", (nb,), 1, K + 1)
    # vertex slot 0 is the camera position (regen_pdf reads pos[:, 0] as
    # the predecessor of v1)
    pos0 = torch.zeros((nb, K + 1, 3), dtype=torch.float32, device=dev)
    pos0[:, 0] = cam.to_world[:3, 3]
    prim0 = torch.full((nb, K + 1), -1, dtype=torch.int32, device=dev)
    u_steps, u_light = _regen_draws(draw, ("boot_regen", "boot_light"), nb, K)
    posb, primb, kb, okb = _regen(scene, cam, u_steps, u_light, pos0, prim0, zero + 1, zero,
                                  k_new0, K, no_hit)
    _, lb, _ = eval_path(scene, cam, posb, primb, kb, K)
    lb = torch.where(okb, lb, 0.0)
    t0 = regen_pdf(scene, cam, posb, primb, kb, zero, K, no_hit) / float(K)   # uniform k_new
    wgt = torch.where((t0 > 0) & (lb > 0), lb / torch.clamp_min(t0, 1e-30), 0.0)
    return posb, primb, kb, wgt, torch.mean(wgt)


def seed_chains(wgt, u_pick):
    """Bootstrap indices drawn in proportion to `wgt`: u_pick scaled to the
    weights' total (at least 1e-30), searched (left) in the running sum.
    torch's cumsum rounds otherwise than XLA's (ROADMAP C39); the sum and
    the search run on the host, in order, as pssmlt.seed_chains's (C48)."""
    cdf = torch.cumsum(wgt.cpu(), 0)
    idx = torch.searchsorted(cdf, u_pick.cpu() * torch.clamp_min(cdf[-1], 1e-30))
    return torch.clamp(idx, 0, wgt.shape[0] - 1).to(wgt.device)


def _start(scene, cam, cfg: RenderConfig, draw, n_chains: int, n_bootstrap: int):
    """The bootstrap, its weights' CDF and the chains' seeds. Returns
    (state, b): state = (pos, prim, k, f, L, pixel) of every chain."""
    K = cfg.max_depth
    posb, primb, kb, wgt, b = _bootstrap(scene, cam, K, n_bootstrap, draw)
    sidx = seed_chains(wgt, draw("pick", (n_chains,)))
    pos_x, prim_x, k_x = posb[sidx], primb[sidx], kb[sidx]
    return (pos_x, prim_x, k_x, *eval_path(scene, cam, pos_x, prim_x, k_x, K)), b


def _mutate(scene, cam, cfg: RenderConfig, draw, mode_i: int, has_spec: bool, state, img,
            acc, b, fixed_walk: bool = False):
    """One mutation of every chain by kernel mode_i: the draws (all of a
    step's, whichever kernel runs), the proposal, eval_path, the
    transition densities, both states' splats into img, the kernel's
    acceptance into acc[mode_i], the accept. Returns the new state (the
    work render_jit captures, one graph per kernel)."""
    pos_x, prim_x, k_x, f_x, l_x, px_x = state
    K = cfg.max_depth
    n = pos_x.shape[0]
    dev = pos_x.device
    idxv = torch.arange(K + 1, device=dev)[None, :]
    u = draw("cut", (n, 4))
    u_steps, u_light = _regen_draws(draw, ("regen", "regen_light"), n, K)
    u2 = draw("perturb", (n, 4))
    uf = draw("manifold", (n, 1)) if mode_i == 5 else None
    u_acc = draw("accept", (n,))

    if has_spec:
        # cuts and perturbation anchors live on NON-SPEC vertices only
        # (delta vertices are derived state on the quotient manifold)
        spec_x = _spec_flags(scene, prim_x, k_x, K)
        modes_x = _chain_modes(scene, pos_x, prim_x, K)
        elig_x = (~spec_x) & (idxv <= (k_x - 1)[:, None])
        cnt_x = elig_x.sum(1).to(torch.int32)

    # ---- propose ----
    if mode_i <= 1:
        mode_hit = torch.full((n,), mode_i == 1, dtype=torch.bool, device=dev)
        if has_spec:
            c = _pick_nonspec(elig_x, cnt_x, u[:, 0])
        else:
            c = (u[:, 0] * k_x.to(torch.float32)).to(torch.int32)
            c = torch.minimum(torch.clamp_min(c, 0), torch.clamp_min(k_x - 1, 0))
        # A: k' uniform in [c+1, K]; B: set by the trace
        span = (K - c).to(torch.float32)
        k_new = c + 1 + (u[:, 1] * span).to(torch.int32)
        k_new = torch.clamp_max(torch.maximum(k_new, c + 1), K)
        pos_y, prim_y, k_y, ok_y = _regen(scene, cam, u_steps, u_light, pos_x, prim_x, k_x,
                                          c, k_new, K, mode_hit)
    elif mode_i == 2:
        pos_y, prim_y, ok_y = _propose_lens(scene, cam, pos_x, prim_x, u)
    elif mode_i == 3:
        pos_y, prim_y, ok_y = _propose_caustic(scene, pos_x, prim_x, k_x,
                                               _angular_offsets(cam, u2))
    elif mode_i == 4:
        pos_y, prim_y, ok_y = _propose_multichain(scene, cam, pos_x, prim_x, k_x, u2,
                                                  _angular_offsets(cam, u2))
    else:
        a_f = _pick_nonspec(elig_x, cnt_x, uf[:, 0])
        pos_y, prim_y, ok_y, g_x, g_y = _propose_manifold(
            scene, pos_x, prim_x, k_x, spec_x, modes_x, a_f, _angular_offsets(cam, u2), K,
            fixed_walk)
    if mode_i >= 2:
        k_y = k_x

    # ---- evaluate ----
    f_y, l_y, px_y = eval_path(scene, cam, pos_y, prim_y, k_y, K)
    l_y = torch.where(ok_y, l_y, 0.0)

    # ---- transition densities ----
    if mode_i <= 1:
        t_xy = regen_pdf(scene, cam, pos_y, prim_y, k_y, c, K, mode_hit)
        t_yx = regen_pdf(scene, cam, pos_x, prim_x, k_x, c, K, mode_hit)
        if has_spec:
            # the cut was uniform over NON-SPEC vertices
            spec_y = _spec_flags(scene, prim_y, k_y, K)
            cnt_y = ((~spec_y) & (idxv <= (k_y - 1)[:, None])).sum(1)
            den_x = torch.clamp_min(cnt_x.to(torch.float32), 1.0)
            den_y = torch.clamp_min(cnt_y.to(torch.float32), 1.0)
        else:
            den_x = torch.clamp_min(k_x.to(torch.float32), 1.0)
            den_y = torch.clamp_min(k_y.to(torch.float32), 1.0)
        if mode_i == 0:
            n_len = torch.clamp_min(span, 1.0)
            t_xy, t_yx = t_xy / n_len, t_yx / n_len
        t_xy, t_yx = t_xy / den_x, t_yx / den_y
    elif mode_i == 2:
        # the raster offset pdf is symmetric: the raster -> area Jacobians
        # remain
        t_xy = _cam_area_pdf(scene, cam, pos_y[:, 1], prim_y[:, 1])
        t_yx = _cam_area_pdf(scene, cam, pos_x[:, 1], prim_x[:, 1])
    elif mode_i == 3:
        # the angular kernel is symmetric: the angle -> area Jacobian at v1
        # remains
        t_xy = _geom_jac(scene, pos_y[:, 2], pos_y[:, 1], prim_y[:, 1])
        t_yx = _geom_jac(scene, pos_x[:, 2], pos_x[:, 1], prim_x[:, 1])
    elif mode_i == 4:
        # the raster Jacobian at v1 times the angle -> area one at v2
        t_xy = _cam_area_pdf(scene, cam, pos_y[:, 1], prim_y[:, 1]) \
            * _geom_jac(scene, pos_y[:, 1], pos_y[:, 2], prim_y[:, 2])
        t_yx = _cam_area_pdf(scene, cam, pos_x[:, 1], prim_x[:, 1]) \
            * _geom_jac(scene, pos_x[:, 1], pos_x[:, 2], prim_x[:, 2])
    else:
        # the dw -> dA conversion through each path's a..b chain
        t_xy, t_yx = g_y, g_x

    # ---- accept ----
    num = l_y * t_yx
    den = l_x * t_xy
    a = torch.clamp(m.safe_div(num, torch.clamp_min(den, 1e-30)), 0.0, 1.0)
    a = torch.where((l_x <= 0) | (den <= 0), torch.where(l_y > 0, 1.0, 0.0), a)
    a = torch.where(ok_y, a, 0.0)

    # expected-value splats of both states
    w_x = torch.where(l_x > 0, (1.0 - a) * b / torch.clamp_min(l_x, 1e-12), 0.0)
    w_y = torch.where(l_y > 0, a * b / torch.clamp_min(l_y, 1e-12), 0.0)
    img.index_add_(0, px_x.long(), f_x * w_x[:, None])
    img.index_add_(0, px_y.long(), f_y * w_y[:, None])
    acc[mode_i] += torch.mean(a)

    take = u_acc < a
    return (torch.where(take[:, None, None], pos_y, pos_x),
            torch.where(take[:, None], prim_y, prim_x),
            torch.where(take, k_y, k_x),
            torch.where(take[:, None], f_y, f_x),
            torch.where(take, l_y, l_x),
            torch.where(take, px_y, px_x))


def _n_modes(has_spec: bool) -> int:
    return 6 if has_spec else 5      # F only exists with delta chains


def _finish(img, acc, b, cam, n_chains: int, n_mutations: int, n_modes: int,
            return_stats: bool):
    # f carries the per-pixel-uniform camera importance, so the b-normalised
    # splat sum over chains x mutations IS the per-pixel radiance estimate
    w, h = cam.width, cam.height
    img = (img / float(np.float32(n_chains * n_mutations))).reshape(h, w, 3)
    if return_stats:
        per_mode = acc / max(float(np.float32(n_mutations)) / n_modes, 1.0)
        return img, {"acceptance": per_mode, "b": b}
    return img


def render(scene, cam, cfg: RenderConfig, n_chains: int = 1 << 14, n_mutations: int = 384,
           n_bootstrap: int = 1 << 16, return_stats: bool = False, draws=None):
    """MLT render -> (H, W, 3) [, {"acceptance": (n_modes,) per kernel, "b"}].
    Path evaluations: n_bootstrap + n_chains * (n_mutations + 1). Kernel
    F's manifold walks exit early (one host read a Newton iteration);
    render_jit's run the graph-safe form, with the same results."""
    dev = scene.device
    draw = draws or generator_draws(cfg.seed, dev)
    state, b = _start(scene, cam, cfg, draw, n_chains, n_bootstrap)
    has_spec = _scene_has_spec(scene)
    n_modes = _n_modes(has_spec)
    img = torch.zeros((cam.width * cam.height, 3), dtype=torch.float32, device=dev)
    acc = torch.zeros((n_modes,), dtype=torch.float32, device=dev)
    for step in range(n_mutations):
        state = _mutate(scene, cam, cfg, draw, step % n_modes, has_spec, state, img, acc, b)
    return _finish(img, acc, b, cam, n_chains, n_mutations, n_modes, return_stats)


class _ModeGraphs:
    """render_jit's cache entry: static copies of the scene and camera, a
    generator, the chains' state, b, the image and the kernels'
    acceptance sums, and one piece per mutation kernel (its first step
    eager, then captured; F's walks in the graph-safe form), each writing
    the new state into the static one."""

    def __init__(self, scene, cam, cfg: RenderConfig, n_chains: int, has_spec: bool):
        dev = scene.device
        K = cfg.max_depth
        n_modes = _n_modes(has_spec)
        self.statics = graphs.Statics(scene, cam)
        s_scene, s_cam = self.statics.trees
        self.gen = torch.Generator(device=dev)
        self.draw = generator_draws(None, dev, self.gen)
        self.state = (torch.zeros((n_chains, K + 1, 3), device=dev),
                      torch.zeros((n_chains, K + 1), dtype=torch.int32, device=dev),
                      torch.zeros((n_chains,), dtype=torch.int32, device=dev),
                      torch.zeros((n_chains, 3), device=dev),
                      torch.zeros((n_chains,), device=dev),
                      torch.zeros((n_chains,), dtype=torch.int64, device=dev))
        self.b = torch.zeros((), device=dev)
        self.img = torch.zeros((cam.width * cam.height, 3), device=dev)
        self.acc = torch.zeros((n_modes,), device=dev)

        def step(mode_i):
            new = _mutate(s_scene, s_cam, cfg, self.draw, mode_i, has_spec, self.state,
                          self.img, self.acc, self.b, fixed_walk=True)
            for dst, src in zip(self.state, new, strict=True):
                dst.copy_(src)

        self.pieces = [graphs.Piece(lambda i=i: step(i), generators=(self.gen,))
                       for i in range(n_modes)]

    def run(self, scene, cam, cfg: RenderConfig, n_chains: int, n_mutations: int,
            n_bootstrap: int):
        self.statics.load(scene, cam)
        self.gen.manual_seed(int(cfg.seed))
        with torch.no_grad():
            state, b = _start(*self.statics.trees, cfg, self.draw, n_chains, n_bootstrap)
        graphs.copy_leaves(self.state, state)
        self.b.copy_(b)
        self.img.zero_()
        self.acc.zero_()
        for step in range(n_mutations):
            self.pieces[step % len(self.pieces)].run()
        return self.img, self.acc, b


_GRAPHS = graphs.Cache()


def render_jit(scene, cam, cfg: RenderConfig, n_chains: int = 1 << 14, n_mutations: int = 384,
               n_bootstrap: int = 1 << 16, return_stats: bool = False, draws=None):
    """`render`, compiled and cached as the JAX package's render_jit is
    (utils/graphs.py). On the card the bootstrap and the seeding run
    eagerly once a call; the first call of a key (cfg, the counts, whether
    the scene has delta chains, hence 5 or 6 kernels, and the scene's and
    camera's static_key) runs each kernel's first mutation eagerly and
    captures that kernel's mutation, one graph a kernel, the entry's
    generator registered with each; every later step replays its kernel's
    graph, in the eager order (kernel step % n_modes). Kernel F's manifold
    walks run in the graph-safe form (manifold.walk's fixed=True: 20
    Newton iterations a walk in place of the eager walk's early exit, the
    same results), so the chains draw and step as `render`'s of the same
    seed do (pssmlt.render_jit's note on the splats' order). On the CPU
    this is `render`. `draws` (a host-made hook) raises ValueError
    on the card; a leaf that requires grad raises NotImplementedError; a
    failed capture raises."""
    graphs.refuse_grad("mlt.render_jit", scene, cam)
    if scene.device.type != "cuda":
        return render(scene, cam, cfg, n_chains, n_mutations, n_bootstrap, return_stats, draws)
    graphs.refuse_hook("mlt.render_jit", draws=draws)
    has_spec = _scene_has_spec(scene)
    key = (cfg, n_chains, n_mutations, n_bootstrap, has_spec, _n_modes(has_spec),
           graphs.static_key(scene, cam))
    with _GRAPHS.lock, torch.cuda.device(scene.device):
        entry = _GRAPHS.get(key, lambda: _ModeGraphs(scene, cam, cfg, n_chains, has_spec))
        img, acc, b = entry.run(scene, cam, cfg, n_chains, n_mutations, n_bootstrap)
        return _finish(img, acc, b, cam, n_chains, n_mutations, _n_modes(has_spec),
                       return_stats)
