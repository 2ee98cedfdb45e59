"""Irawan-Marschner woven cloth BRDF (port of models/cloth.py;
src/bsdfs/irawan.{h,cpp}).

The weave patterns live in dense padded tables (ClothTables) and the model
is two batched stages that slot into the masked BSDF dispatch:

  * gather_yarn(): at shade-point gather time, each lane's uv goes to its
    weave tile, its yarn record and its local (u, v) yarn coordinates,
    with the effective ks (specular normalization x warp/weft area scale x
    log-exponential intensity variation). What the directional stage
    needs is packed into the ShadePoint's generic fields
    (eta/k/alpha/extra).
  * eval_packed(): the filament (irawan.cpp:390 evalFilamentIntegrand) and
    staple (irawan.cpp:482 evalStapleIntegrand) specular integrands, both
    evaluated branch-free and selected per lane by psi != 0, plus the kd/pi
    diffuse floor. Sampling is cosine-hemisphere with weight = eval/pdf
    (irawan.cpp:336).

parse_weave() reads the reference's weave pattern text (irawan.h
WeavePatternGrammar: `weave { name=..., tileWidth=..., pattern {..},
yarn {..}, .. }` with `$var` references into the XML properties).

As in the JAX package, the Perlin umax perturbation (irawan.cpp:255-274,
`period > 0`) uses core/noise.py's hash-lattice Perlin and hash-derived
per-segment seeds in place of the reference's permutation table and TEA,
and the intensity variation keeps the min(-log(xi), 10) law but not TEA's
bits. Every float-to-integer cast wraps as the JAX package's int32 ->
uint32 casts do (in int64, masked by hash_u32).
"""
from __future__ import annotations

import copy
import math
import re
from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core import noise as noiselib
from ..core import rng
from ..core import warp as warplib

INV_PI = 1.0 / math.pi


# ---------------------------------------------------------------------------
# Host-side weave pattern representation + parser
# ---------------------------------------------------------------------------


class Yarn:
    def __init__(self, **kw):
        self.type = kw.get("type", 0)            # 0=warp, 1=weft
        self.psi = kw.get("psi", 0.0)            # radians
        self.umax = kw.get("umax", 0.0)          # radians
        self.kappa = kw.get("kappa", 0.0)
        self.width = kw.get("width", 1.0)
        self.length = kw.get("length", 1.0)
        self.centerU = kw.get("centerU", 0.5)
        self.centerV = kw.get("centerV", 0.5)
        self.kd = np.asarray(kw.get("kd", (0.5, 0.5, 0.5)), np.float32)
        self.ks = np.asarray(kw.get("ks", (0.5, 0.5, 0.5)), np.float32)


class WeavePattern:
    def __init__(self, **kw):
        self.name = kw.get("name", "")
        self.tile_width = int(kw.get("tileWidth", 1))
        self.tile_height = int(kw.get("tileHeight", 1))
        self.alpha = kw.get("alpha", 0.05)       # uniform scattering
        self.beta = kw.get("beta", 2.0)          # forward scattering
        self.ss = kw.get("ss", 0.0)              # filament smoothing
        self.h_width = kw.get("hWidth", 0.5)     # highlight width
        self.warp_area = kw.get("warpArea", 1.0)
        self.weft_area = kw.get("weftArea", 1.0)
        self.fineness = kw.get("fineness", 0.0)
        self.period = kw.get("period", 0.0)
        # Perlin umax perturbation slopes (irawan.cpp:255-274), radians
        self.dWarpUmaxOverDWarp = kw.get("dWarpUmaxOverDWarp", 0.0)
        self.dWarpUmaxOverDWeft = kw.get("dWarpUmaxOverDWeft", 0.0)
        self.dWeftUmaxOverDWarp = kw.get("dWeftUmaxOverDWarp", 0.0)
        self.dWeftUmaxOverDWeft = kw.get("dWeftUmaxOverDWeft", 0.0)
        self.pattern = np.asarray(kw.get("pattern", [1]), np.int32)
        self.yarns = kw.get("yarns", [])
        self.spec_norm = 0.0                     # filled by normalization


_TOKEN = re.compile(r"""
    "(?P<str>[^"]*)"            |
    \$(?P<var>[A-Za-z_]\w*)     |
    (?P<num>-?\d+(\.\d*)?([eE][-+]?\d+)?) |
    (?P<word>[A-Za-z_]\w*)      |
    (?P<punc>[{}=,])
""", re.VERBOSE)

_DEG_KEYS = {"psi", "umax", "dWarpUmaxOverDWarp", "dWarpUmaxOverDWeft",
             "dWeftUmaxOverDWarp", "dWeftUmaxOverDWeft"}


def _tokens(text):
    for t in _TOKEN.finditer(text):
        kind = t.lastgroup if t.lastgroup in ("str", "var") else (
            "num" if t.group("num") else
            "word" if t.group("word") else "punc")
        yield kind, (t.group("str") or t.group("var") or t.group("num")
                     or t.group("word") or t.group("punc"))


def parse_weave(text: str, props: dict | None = None) -> WeavePattern:
    """Parse the reference's weave pattern format (irawan.h grammar):
    `weave { key = value, ..., pattern {i, i, ...}, yarn {...}, ... }`.
    `$name` values resolve from `props` (the XML <bsdf> properties)."""
    props = props or {}
    toks = list(_tokens(text))
    pos = 0

    def peek():
        return toks[pos] if pos < len(toks) else ("eof", "")

    def take(expect=None):
        nonlocal pos
        k, v = peek()
        if expect and v != expect and k != expect:
            raise ValueError(f"weave parse error: expected {expect}, "
                             f"got {v!r} at token {pos}")
        pos += 1
        return k, v

    def value():
        k, v = take()
        if k == "num":
            return float(v)
        if k == "var":
            return float(props[v])
        if k in ("str", "word"):                 # a name; warp / weft
            return v
        if v == "{":                             # {r, g, b} or pattern ints
            vals = []
            while peek()[1] != "}":
                if peek()[1] == ",":
                    take()
                    continue
                kk, vv = take()
                vals.append(float(props[vv]) if kk == "var" else float(vv))
            take("}")
            return vals
        raise ValueError(f"weave parse error at {v!r}")

    take("weave")
    take("{")
    kw: dict = {"yarns": []}
    while peek()[1] != "}":
        if peek()[1] == ",":
            take()
            continue
        _, key = take()
        if key == "pattern":
            kw["pattern"] = [int(x) for x in value()]
            continue
        if key == "yarn":
            take("{")
            ykw: dict = {}
            while peek()[1] != "}":
                if peek()[1] == ",":
                    take()
                    continue
                _, yk = take()
                take("=")
                v = value()
                if yk == "type":
                    ykw["type"] = 0 if v == "warp" else 1
                elif yk in ("kd", "ks"):
                    ykw[yk] = v
                elif yk in _DEG_KEYS:
                    ykw[yk] = float(v) * np.pi / 180.0
                else:
                    ykw[yk] = float(v)
            take("}")
            kw["yarns"].append(Yarn(**ykw))
            continue
        take("=")
        v = value()
        if key in _DEG_KEYS:
            v = float(v) * np.pi / 180.0
        kw[key] = v
    pat = WeavePattern(**kw)
    if len(pat.pattern) != pat.tile_width * pat.tile_height:
        raise ValueError("pattern size must equal tileWidth * tileHeight")
    if pat.pattern.min() < 1 or pat.pattern.max() > len(pat.yarns):
        raise ValueError("pattern entries must reference yarns 1..N")
    return pat


# A compact plain-weave cotton-like preset (not from the reference's data
# files: parameter ranges follow the Irawan-Marschner paper's staple-yarn
# examples, so it exercises the staple integrand).
PRESET_COTTON = """weave {
    name = "cotton plain weave",
    tileWidth = 2, tileHeight = 2,
    alpha = 0.30, beta = 6.0, ss = 0.0,
    hWidth = 0.5, warpArea = 1.0, weftArea = 1.0,
    fineness = 0.0, period = 0.0,
    pattern { 1, 2, 2, 1 },
    yarn { type = warp, psi = 30, umax = 25, kappa = 0.5,
           width = 1.0, length = 1.0, centerU = 0.5, centerV = 0.5,
           kd = {0.35, 0.33, 0.30}, ks = {0.25, 0.25, 0.25} },
    yarn { type = weft, psi = 30, umax = 25, kappa = 0.5,
           width = 1.0, length = 1.0, centerU = 0.5, centerV = 0.5,
           kd = {0.30, 0.32, 0.35}, ks = {0.25, 0.25, 0.25} }
}"""

# Filament-yarn preset (psi = 0: evalFilamentIntegrand), silk-like.
PRESET_SILK = """weave {
    name = "silk plain weave",
    tileWidth = 2, tileHeight = 2,
    alpha = 0.10, beta = 10.0, ss = 0.2,
    hWidth = 0.5, warpArea = 1.0, weftArea = 1.0,
    fineness = 0.0, period = 0.0,
    pattern { 1, 2, 2, 1 },
    yarn { type = warp, psi = 0, umax = 20, kappa = -0.5,
           width = 1.0, length = 1.0, centerU = 0.5, centerV = 0.5,
           kd = {0.20, 0.25, 0.33}, ks = {0.45, 0.45, 0.45} },
    yarn { type = weft, psi = 0, umax = 20, kappa = -0.5,
           width = 1.0, length = 1.0, centerU = 0.5, centerV = 0.5,
           kd = {0.20, 0.25, 0.33}, ks = {0.45, 0.45, 0.45} }
}"""

PRESETS = {"cotton": PRESET_COTTON, "silk": PRESET_SILK}


# ---------------------------------------------------------------------------
# Device tables
# ---------------------------------------------------------------------------


class ClothTables(NamedTuple):
    """Padded per-cloth-slot weave tables (C slots, Y_max yarns), on one
    device."""

    slot_of_mat: torch.Tensor  # (M,) int32 material id -> slot, -1 if not cloth
    grid: torch.Tensor         # (C, TH_max, TW_max) int32 0-based yarn index
    tile: torch.Tensor         # (C, 2) int32 (tw, th)
    repeat: torch.Tensor       # (C, 2) f32 (repeatU, repeatV)
    # yarn rows: [is_weft, psi, umax, kappa, width, length, centerU,
    #             centerV, kd.rgb, ks.rgb]  (C, Y_max, 14)
    yarn: torch.Tensor
    # pattern rows: [alpha, beta, ss, hWidth, scaleWarp, scaleWeft,
    #                fineness, specNorm, period, dWarpUmaxOverDWarp,
    #                dWarpUmaxOverDWeft, dWeftUmaxOverDWarp,
    #                dWeftUmaxOverDWeft]  (C, 13)
    patp: torch.Tensor


def build_tables(entries, n_materials: int, mat_slots: dict,
                 device="cuda") -> ClothTables:
    """entries: a list of (WeavePattern, repeatU, repeatV), one per slot;
    mat_slots: material id -> slot index."""
    C = len(entries)
    tw_max = max(p.tile_width for p, _, _ in entries)
    th_max = max(p.tile_height for p, _, _ in entries)
    y_max = max(len(p.yarns) for p, _, _ in entries)
    grid = np.zeros((C, th_max, tw_max), np.int32)
    tile = np.zeros((C, 2), np.int32)
    repeat = np.zeros((C, 2), np.float32)
    yarn = np.zeros((C, y_max, 14), np.float32)
    patp = np.zeros((C, 13), np.float32)
    for c, (p, ru, rv) in enumerate(entries):
        tw, th = p.tile_width, p.tile_height
        grid[c, :th, :tw] = p.pattern.reshape(th, tw) - 1
        tile[c] = (tw, th)
        repeat[c] = (ru, rv)
        for yi, y in enumerate(p.yarns):
            yarn[c, yi] = [y.type, y.psi, y.umax, y.kappa, y.width,
                           y.length, y.centerU, y.centerV, *y.kd, *y.ks]
        total = p.warp_area + p.weft_area
        patp[c] = [p.alpha, p.beta, p.ss, p.h_width,
                   total / max(p.warp_area, 1e-9),
                   total / max(p.weft_area, 1e-9),
                   p.fineness, p.spec_norm, p.period,
                   p.dWarpUmaxOverDWarp, p.dWarpUmaxOverDWeft,
                   p.dWeftUmaxOverDWarp, p.dWeftUmaxOverDWeft]
    slot = np.full((n_materials,), -1, np.int32)
    for mid, s in mat_slots.items():
        slot[mid] = s
    return ClothTables(*(torch.as_tensor(a, device=device)
                         for a in (slot, grid, tile, repeat, yarn, patp)))


# ---------------------------------------------------------------------------
# Stage 1: uv -> yarn segment (gather time)
# ---------------------------------------------------------------------------


def _seed_float(*parts):
    """hash_u32 of the parts as a float in (0, 1), as the JAX package's
    (float32(hash) + 0.5) / 2^32."""
    return (rng.hash_u32(*parts).to(torch.float32) + 0.5) * (1.0 / 4294967296.0)


def gather_yarn(cloth: ClothTables, mat: torch.Tensor, uv: torch.Tensor):
    """Per-lane weave lookup (irawan.cpp eval's uv conditioning, lines
    190-281). Returns the packed ShadePoint overlay fields."""
    slot = torch.clamp_min(cloth.slot_of_mat[mat], 0).long()
    tw = cloth.tile[slot, 0].to(torch.float32)
    th = cloth.tile[slot, 1].to(torch.float32)
    ru = cloth.repeat[slot, 0]
    rv = cloth.repeat[slot, 1]

    u_t = uv[..., 0] * ru
    v_t = (1.0 - uv[..., 1]) * rv
    x = u_t * tw
    y = v_t * th
    # jnp.mod is a floored modulo: torch.remainder
    lx = torch.remainder(torch.floor(x), tw).long()
    ly = torch.remainder(torch.floor(y), th).long()
    yid = cloth.grid[slot, ly, lx].long()
    yr = cloth.yarn[slot, yid]
    is_weft = yr[..., 0]
    psi, umax, kappa = yr[..., 1], yr[..., 2], yr[..., 3]
    w_, l_ = yr[..., 4], yr[..., 5]
    center_u, center_v = yr[..., 6], yr[..., 7]
    kd, ks = yr[..., 8:11], yr[..., 11:14]

    cx = torch.floor(x / tw) * tw + center_u * tw
    cy = torch.floor(y / th) * th + (1.0 - center_v) * th
    xx = x - cx
    yy = -(y - cy)
    # weft yarns: rotate the tile frame 90deg (directions rotate in eval)
    weft = is_weft > 0.5
    xr = torch.where(weft, -yy, xx)
    yr_ = torch.where(weft, xx, yy)

    pp = cloth.patp[slot]
    alpha_sc, beta_sc, ss, hw = pp[..., 0], pp[..., 1], pp[..., 2], pp[..., 3]
    scale = torch.where(weft, pp[..., 5], pp[..., 4])
    fineness, spec_norm = pp[..., 6], pp[..., 7]

    # correlated Perlin umax perturbation per yarn segment
    # (irawan.cpp:255-274; period > 0 enables it); the per-segment seed
    # floats hash the segment's int32 centre in place of sampleTEAFloat.
    # A float goes to an integer by truncation (the int32 cast) and
    # hash_u32 wraps it mod 2^32 (the uint32 cast), in int64.
    period = pp[..., 8]
    d_uw = torch.where(weft, pp[..., 11], pp[..., 9])
    d_uf = torch.where(weft, pp[..., 12], pp[..., 10])
    px = cx.to(torch.int64)
    py = cy.to(torch.int64)
    tea1 = _seed_float(px, 2 * py)
    tea2 = _seed_float(px, 2 * py + 1)
    safe_p = torch.clamp_min(period, 1e-9)
    r1 = noiselib.perlin_noise_1d((cx * (th * rv + tea1) + cy) / safe_p)
    r2 = noiselib.perlin_noise_1d((cy * (tw * ru + tea2) + cx) / safe_p)
    umax = torch.where(period > 0.0, umax + r1 * d_uw + r2 * d_uf, umax)

    u_c = yr_ / (l_ / 2.0) * umax
    v_c = xr * math.pi / w_

    # log-exponential intensity variation (irawan.cpp:296-303; the hash in
    # place of TEA, the same min(-log xi, 10) law)
    i1 = ((cx + xx) * fineness).to(torch.int64)
    i2 = ((cy + yy) * fineness).to(torch.int64)
    xi = _seed_float(i1, i2)
    ivar = torch.clamp_max(-torch.log(torch.clamp_min(xi, 1e-12)), 10.0)
    ivar = torch.where(fineness > 0.0, ivar, 1.0)

    ks_eff = ks * (spec_norm * scale * ivar)[..., None]
    return dict(
        reflectance=kd, specular=ks_eff,
        eta=torch.stack([u_c, v_c, is_weft], -1),
        k=torch.stack([umax, kappa, psi], -1),
        alpha=torch.stack([w_, l_], -1),
        extra=torch.stack([ss, alpha_sc, beta_sc, hw], -1),
    )


# ---------------------------------------------------------------------------
# Stage 2: directional scattering (eval time)
# ---------------------------------------------------------------------------


def _von_mises(cos_x, b):
    """irawan.cpp vonMises: exp(b cos x) / (2 pi I0(b)), with the
    Abramowitz-Stegun I0 polynomial."""
    ab = torch.abs(b)
    t_small = (ab / 3.75) ** 2
    i0_small = 1.0 + t_small * (3.5156229 + t_small * (3.0899424 + t_small * (
        1.2067492 + t_small * (0.2659732 + t_small * (0.0360768
                                                      + t_small * 0.0045813)))))
    t_big = 3.75 / torch.clamp_min(ab, 3.75)
    poly = (0.39894228 + t_big * (0.01328592 + t_big * (0.00225319 + t_big * (
        -0.00157565 + t_big * (0.00916281 + t_big * (-0.02057706 + t_big * (
            0.02635537 + t_big * (-0.01647633 + t_big * 0.00392377))))))))
    i0_big = torch.exp(ab) / torch.sqrt(torch.clamp_min(ab, 1e-6)) * poly
    i0 = torch.where(ab <= 3.75, i0_small, i0_big)
    return torch.exp(b * cos_x) / (2.0 * math.pi * i0)


def _seeliger(c1, c2):
    """Lommel-Seeliger shadowing/masking (irawan.cpp seeliger, albedo 1)."""
    c1 = torch.clamp_min(c1, 0.0)
    c2 = torch.clamp_min(c2, 0.0)
    return torch.where((c1 > 0) & (c2 > 0),
                       (1.0 / (4.0 * math.pi)) * c1 * c2
                       / torch.clamp_min(c1 + c2, 1e-9), 0.0)


def _radius_of_curvature(u, umax, kappa, w_, l_):
    """Yarn spine radius of curvature (irawan.cpp:553, paper section 5.3):
    ellipse / parabola / hyperbola by the sign of rhat."""
    rhat = 1.0 + kappa * (1.0 + 1.0 / torch.tan(umax))
    a = 0.5 * w_
    arc = 0.5 * l_ - a * torch.sin(umax)

    # ellipse (rhat > 0; rhat == 1 degenerates to the circle formula,
    # which the general form reproduces)
    rt = torch.abs(rhat)
    tmax_e = torch.arctan(rt * torch.tan(umax))
    bhat_e = arc / torch.clamp_min(torch.sin(tmax_e), 1e-9)
    ahat_e = bhat_e / torch.clamp_min(rt, 1e-9)
    t_e = torch.arctan(rt * torch.tan(u))
    r_ell = ((bhat_e * torch.cos(t_e)) ** 2
             + (ahat_e * torch.sin(t_e)) ** 2) ** 1.5 / torch.clamp_min(
                 ahat_e * bhat_e, 1e-12)

    # hyperbola (rhat < 0)
    arg = torch.clamp(rt * torch.tan(umax), 0.0, 0.999999)
    tmax_h = torch.arctanh(arg)
    bhat_h = arc / torch.clamp_min(torch.sinh(tmax_h), 1e-9)
    ahat_h = bhat_h / torch.clamp_min(rt, 1e-9)
    t_h = torch.arctanh(torch.clamp(rt * torch.tan(u), -0.999999, 0.999999))
    r_hyp = ((bhat_h * torch.cosh(t_h)) ** 2
             + (ahat_h * torch.sinh(t_h)) ** 2) ** 1.5 / torch.clamp_min(
                 ahat_h * bhat_h, 1e-12)

    # parabola (rhat == 0)
    tmax_p = torch.tan(umax)
    ahat_p = arc / torch.clamp_min(2.0 * tmax_p, 1e-9)
    r_par = 2.0 * ahat_p * (1.0 + torch.tan(u) ** 2) ** 1.5

    return torch.where(rhat > 1e-6, r_ell,
                       torch.where(rhat < -1e-6, r_hyp, r_par))


def _smoothstep(e0: float, e1: float, x):
    t = torch.clamp((x - e0) / max(e1 - e0, 1e-9), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def eval_packed(sp, wi, wo):
    """(f including cos_theta_o, cosine pdf) for irawan lanes.

    sp fields (packed by gather_yarn): eta=[u, v, is_weft],
    k=[umax, kappa, psi], alpha=[w, l], extra=[ss, alpha, beta, hWidth],
    specular = ks * specNorm * areaScale * intensityVariation. The guards
    (the 1e-9 floors, the clipped arccos, nan_to_num then max(., 0)) sit
    where the JAX package has them, so masked lanes stay finite alike.
    """
    u_c, v_c, is_weft = sp.eta[..., 0], sp.eta[..., 1], sp.eta[..., 2]
    umax, kappa, psi = sp.k[..., 0], sp.k[..., 1], sp.k[..., 2]
    w_, l_ = sp.alpha[..., 0], sp.alpha[..., 1]
    ss, _alpha, beta, hw = (sp.extra[..., 0], sp.extra[..., 1],
                            sp.extra[..., 2], sp.extra[..., 3])

    ok = (m.cos_theta(wi) > 0) & (m.cos_theta(wo) > 0)
    weft = is_weft > 0.5

    # weft yarns: rotate directions pi/2 about z (irawan.cpp:246-253)
    def rot(d):
        return torch.stack([torch.where(weft, -d[..., 1], d[..., 0]),
                            torch.where(weft, d[..., 0], d[..., 1]),
                            d[..., 2]], -1)

    om_i = rot(wi)
    om_r = rot(wo)
    h = m.normalize(om_i + om_r)
    fc = _alpha + _von_mises(-m.dot(om_i, om_r), beta)
    len_ir = m.length(om_i + om_r)
    a_half = 0.5 * w_
    geom_ok = (w_ * torch.sin(umax) < l_) & (kappa > -1.0)

    # ---- filament integrand (psi == 0; irawan.cpp:390) -----------------
    u_of_v = torch.arctan(h[..., 1] / torch.where(torch.abs(h[..., 2]) < 1e-9,
                                                  1e-9, h[..., 2]))
    in_rng_f = torch.abs(u_of_v) < umax
    n_f = m.normalize(torch.stack([
        torch.sin(v_c), torch.sin(u_of_v) * torch.cos(v_c),
        torch.cos(u_of_v) * torch.cos(v_c)], -1))
    t_f = m.normalize(torch.stack([
        torch.zeros_like(u_of_v), torch.cos(u_of_v), -torch.sin(u_of_v)], -1))
    r_f = _radius_of_curvature(
        torch.minimum(torch.abs(u_of_v), (1.0 - ss) * umax),
        (1.0 - ss) * umax, kappa, w_, l_)
    tch = m.cross(t_f, h)
    gu = a_half * (r_f + a_half * torch.cos(v_c)) / torch.clamp_min(
        len_ir * torch.abs(tch[..., 0]), 1e-9)
    a_att = _seeliger(m.dot(n_f, om_i), m.dot(n_f, om_r))
    a_s = torch.where(
        ss > 0.0,
        a_att * (1.0 - _smoothstep(
            0.0, 1.0, (torch.abs(u_of_v) - (1.0 - ss) * umax)
            / torch.clamp_min(ss * umax, 1e-9))),
        a_att)
    fs_f = gu * fc * a_s * math.pi * l_
    dy = l_ * hw
    y_of_v = torch.clamp(u_of_v * 0.5 * l_ / umax,
                         0.5 * (dy - l_), 0.5 * (l_ - dy))
    hit_f = torch.abs(y_of_v - u_c * 0.5 * l_ / torch.clamp_min(umax, 1e-9)) \
        < 0.5 * dy
    integrand_f = torch.where(in_rng_f & hit_f & (ss < 1.0) & geom_ok,
                              fs_f / torch.clamp_min(dy, 1e-9), 0.0)

    # ---- staple integrand (psi != 0; irawan.cpp:482) --------------------
    sin_u, cos_u = torch.sin(u_c), torch.cos(u_c)
    tan_psi = torch.tan(torch.where(torch.abs(psi) < 1e-6, 1e-6, psi))
    dd = (h[..., 1] * cos_u - h[..., 2] * sin_u) / torch.clamp_min(
        torch.sqrt(h[..., 0] ** 2
                   + (h[..., 1] * sin_u + h[..., 2] * cos_u) ** 2)
        * tan_psi, 1e-12)
    v_of_u = torch.atan2(-h[..., 1] * sin_u - h[..., 2] * cos_u,
                         h[..., 0]) + torch.arccos(torch.clamp(dd, -1.0, 1.0))
    in_rng_s = (torch.abs(dd) < 1.0) & (torch.abs(v_of_u) < math.pi / 2.0)
    n_s = m.normalize(torch.stack([
        torch.sin(v_of_u), sin_u * torch.cos(v_of_u),
        cos_u * torch.cos(v_of_u)], -1))
    r_s = _radius_of_curvature(torch.abs(u_c), umax, kappa, w_, l_)
    gv = a_half * (r_s + a_half * torch.cos(v_of_u)) / torch.clamp_min(
        len_ir * m.dot(n_s, h) * torch.abs(torch.sin(psi)), 1e-9)
    a_att_s = _seeliger(m.dot(n_s, om_i), m.dot(n_s, om_r))
    fs_s = gv * fc * a_att_s * 2.0 * w_ * umax
    dx = w_ * hw
    x_of_u = torch.clamp(v_of_u * w_ / math.pi, 0.5 * (dx - w_), 0.5 * (w_ - dx))
    hit_s = torch.abs(x_of_u - v_c * w_ / math.pi) < 0.5 * dx
    integrand_s = torch.where(in_rng_s & hit_s & geom_ok,
                              fs_s / torch.clamp_min(dx, 1e-9), 0.0)

    integrand = torch.where(torch.abs(psi) > 1e-6, integrand_s, integrand_f)
    integrand = torch.clamp_min(torch.nan_to_num(integrand), 0.0)

    cos_o = torch.clamp_min(m.cos_theta(wo), 0.0)
    f = (sp.specular * integrand[..., None]
         + sp.reflectance * INV_PI) * cos_o[..., None]
    f = torch.where(ok[..., None], f, 0.0)
    pdf = torch.where(ok, warplib.square_to_cosine_hemisphere_pdf(wo), 0.0)
    return f, pdf


class _SpLike(NamedTuple):
    """The ShadePoint fields eval_packed reads (the normalization pass)."""

    specular: torch.Tensor
    reflectance: torch.Tensor
    eta: torch.Tensor
    k: torch.Tensor
    alpha: torch.Tensor
    extra: torch.Tensor


def compute_normalization(pat: WeavePattern, n: int = 10000, seed: int = 0) -> float:
    """Monte Carlo specular normalization (irawan.cpp configure(), lines
    139-171): cosine-sampled wi/wo, uniform uv; the mean specular integrand
    normalizes the furnace response to ~ks. The draws are the JAX package's
    (jax.random.PRNGKey(seed), split in 3, uniform (n, 2) each; the numpy
    threefry copy of core/rng.py), evaluated on the CPU, so every load of
    a pattern gets the JAX package's spec_norm on any device."""
    # unit-ks copy, so specular = areaScale * intensityVariation * 1:
    # the reference's m_initialization branch
    patc = copy.deepcopy(pat)
    for y in patc.yarns:
        y.ks = np.ones(3, np.float32)
        y.kd = np.zeros(3, np.float32)
    patc.spec_norm = 1.0
    tables = build_tables([(patc, 1.0, 1.0)], 1, {0: 0}, device="cpu")
    k1, k2, k3 = rng.threefry_split(rng.threefry_key(seed), 3)
    wi = warplib.square_to_cosine_hemisphere(torch.from_numpy(rng.threefry_uniform(k1, (n, 2))))
    wo = warplib.square_to_cosine_hemisphere(torch.from_numpy(rng.threefry_uniform(k2, (n, 2))))
    uv = torch.from_numpy(rng.threefry_uniform(k3, (n, 2)))
    over = gather_yarn(tables, torch.zeros((n,), dtype=torch.int64), uv)
    f, _ = eval_packed(_SpLike(over["specular"], over["reflectance"], over["eta"],
                               over["k"], over["alpha"], over["extra"]), wi, wo)
    # f includes cos_theta_o; configure() sums eval()/cosTheta(wo)
    cos_o = torch.clamp_min(wo[..., 2], 1e-6)
    mean = float(torch.mean(torch.amax(f, -1) / cos_o))
    norm = 0.0 if mean <= 0 else 1.0 / (mean * np.pi)
    pat.spec_norm = norm
    return norm
