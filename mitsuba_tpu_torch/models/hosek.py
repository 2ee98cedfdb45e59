"""Hosek-Wilkie 2012 analytic sky-dome model (port of models/hosek.py, a
numpy module; the RGB and the 11-band spectral states).

This is the model the reference's sky emitter actually evaluates
(src/emitters/sky.cpp:246-274 via sunsky/skymodel.h's
arhosek_rgb_skymodelstate_alloc_init / arhosek_tristim_skymodel_radiance)
— NOT Preetham, which models/sunsky.py keeps as an option. Implemented
from the published paper ("An Analytic Model for Full Spectral Sky-Dome
Radiance", Hosek & Wilkie, SIGGRAPH 2012):

  state: the 9 distribution parameters A..I and the radiance scale are
  looked up from the published dataset (the JAX package's
  mitsuba_tpu/models/data/hosek_rgb.npz, read in place; see
  tools/extract_hosek_data.py for provenance) by bilinear interpolation
  in (albedo, turbidity) and a quintic Bezier in x = (elevation /
  (pi/2))^(1/3) (skymodel.cpp ArHosekSkyModel_CookConfiguration);

  radiance(theta, gamma) =
      (1 + A e^{B/(cos theta + 0.01)}) *
      (C + D e^{E gamma} + F cos^2 gamma + G chi(H, gamma)
         + I sqrt(cos theta)) * radiance_scale
  with chi(H, g) = (1 + cos^2 g)/(1 + H^2 - 2 H cos g)^{3/2}.

The JAX package validates it against a grid of ground-truth values from
the authors' published reference implementation
(tests/test_sunsky.py::test_hosek_matches_reference_implementation);
tests/test_torch_sunsky.py holds this copy to the same grid.

Units: the RGB build divides by 106.856980 (the sum of the CIE Y curve,
sky.cpp:434) so the result is ordinary linear-RGB radiance compatible
with the rest of the renderer.
"""
from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

_CIE_Y_SUM = 106.856980
# the published dataset, read in place from the JAX package's data folder
_NPZ = Path(__file__).resolve().parents[2] / "mitsuba_tpu" / "models" / "data" / "hosek_rgb.npz"


@lru_cache(maxsize=1)
def _tables():
    with np.load(_NPZ) as z:
        return {k: z[k] for k in ("params", "rad", "spec_params", "spec_rad")}


def _data():
    t = _tables()
    return t["params"], t["rad"]          # (3,2,10,6,9), (3,2,10,6)


def cook_state(turbidity: float, albedo, elevation: float):
    """Interpolated model state: (3,9) params + (3,) radiance scales.
    albedo: scalar or per-channel (3,); elevation: solar elevation in
    radians (>= 0)."""
    params, rad = _data()
    t = float(np.clip(turbidity, 1.0, 10.0))
    alb = np.broadcast_to(np.asarray(albedo, np.float64), (3,))
    it = min(int(t), 9)                    # turbidity segment 1..9
    tr = t - it
    x = (max(float(elevation), 0.0) / (np.pi / 2.0)) ** (1.0 / 3.0)
    # quintic Bezier weights over the 6 altitude control points
    c5 = np.asarray([1.0, 5.0, 10.0, 10.0, 5.0, 1.0])
    bez = c5 * (1.0 - x) ** np.arange(5, -1, -1) * x ** np.arange(6)

    def interp(tab):                       # tab: (3,2,10,6,...)
        lo = np.tensordot(bez, tab[:, :, it - 1], axes=([0], [2]))
        out = (1.0 - tr) * lo
        if it < 10:
            hi = np.tensordot(bez, tab[:, :, it], axes=([0], [2]))
            out = out + tr * hi
        # tensordot moves the contracted axis out: shape (3, 2, ...)
        a0, a1 = out[:, 0], out[:, 1]
        w = alb.reshape(3, *([1] * (a0.ndim - 1)))
        return (1.0 - w) * a0 + w * a1

    return interp(params), interp(rad)     # (3,9), (3,)


def radiance(config, rad_scale, theta, gamma):
    """Evaluate the distribution: theta = view zenith angle, gamma =
    angle to the sun (radians; arrays broadcast). Returns (..., 3)."""
    # dataset coefficient order: [A, B, C, D, E, F, G, I, H] — the mie
    # anisotropy H lives in slot 8 and the zenith coefficient I in slot
    # 7 (skymodel.cpp GetRadianceInternal uses configuration[8] inside
    # the chi term and configuration[7] for the sqrt-zenith term)
    A, B, C, D, E, F, G, I, H = (config[:, i] for i in range(9))
    ct = np.clip(np.cos(theta), 0.0, 1.0)[..., None]
    cg = np.cos(gamma)[..., None]
    chi = (1.0 + cg * cg) / np.power(1.0 + H * H - 2.0 * H * cg, 1.5)
    val = (1.0 + A * np.exp(B / (ct + 0.01))) * (
        C + D * np.exp(E * gamma[..., None]) + F * cg * cg + G * chi
        + I * np.sqrt(ct))
    return val * rad_scale


def sky_radiance_rgb(d, sun_dir, turbidity=3.0, albedo=0.2):
    """Hosek-Wilkie sky radiance along directions d (...,3), y-up;
    zero below the horizon; linear RGB (tristimulus / sum(CIE Y), the
    reference's sky.cpp:434 convention)."""
    d = np.asarray(d, np.float64)
    s = np.asarray(sun_dir, np.float64)
    s = s / np.linalg.norm(s)
    elev = np.pi / 2.0 - np.arccos(np.clip(s[1], -1.0, 1.0))
    cfg, rad_scale = cook_state(turbidity, albedo, elev)

    cos_t = np.clip(d[..., 1], -1.0, 1.0)
    theta = np.arccos(np.minimum(np.abs(cos_t), 1.0) * np.sign(cos_t))
    theta = np.minimum(theta, np.pi / 2.0 - 1e-4)
    gamma = np.arccos(np.clip(d @ s, -1.0, 1.0))
    rgb = radiance(cfg, rad_scale, theta, gamma) / _CIE_Y_SUM
    rgb = np.maximum(rgb, 0.0)
    return rgb * (cos_t > 0.0)[..., None]


# ---------------------------------------------------------------------------
# Spectral variant: 11 bands at 320..720 nm (the reference's
# SPECTRUM_SAMPLES != 3 path, arhosekskymodel_radiance — same
# distribution formula per band, linear interpolation between bands).
# ---------------------------------------------------------------------------

SPEC_BANDS = np.arange(320.0, 721.0, 40.0)


def cook_state_spectral(turbidity: float, albedo: float, elevation: float):
    """(11,9) params + (11,) radiance scales for all bands (scalar
    albedo, like the reference's spectral state)."""
    t = _tables()
    params, rad = t["spec_params"], t["spec_rad"]   # (11,2,10,6,9) etc.
    t = float(np.clip(turbidity, 1.0, 10.0))
    a = float(np.clip(albedo, 0.0, 1.0))
    it = min(int(t), 9)
    tr = t - it
    x = (max(float(elevation), 0.0) / (np.pi / 2.0)) ** (1.0 / 3.0)
    c5 = np.asarray([1.0, 5.0, 10.0, 10.0, 5.0, 1.0])
    bez = c5 * (1.0 - x) ** np.arange(5, -1, -1) * x ** np.arange(6)

    def interp(tab):
        lo = np.tensordot(bez, tab[:, :, it - 1], axes=([0], [2]))
        out = (1.0 - tr) * lo
        if it < 10:
            out = out + tr * np.tensordot(bez, tab[:, :, it],
                                          axes=([0], [2]))
        return (1.0 - a) * out[:, 0] + a * out[:, 1]

    return interp(params), interp(rad)              # (11,9), (11,)


def radiance_spectral(cfgs, rads, theta, gamma, lam):
    """Spectral dome radiance at wavelengths `lam` (nm; arrays
    broadcast against theta/gamma). Linear band interpolation like
    arhosekskymodel_radiance; zero outside [320, 720]."""
    vals = radiance(cfgs, rads, theta, gamma)       # (..., 11)
    pos = (np.asarray(lam) - 320.0) / 40.0
    lo = np.clip(np.floor(pos).astype(np.int32), 0, 10)
    hi = np.minimum(lo + 1, 10)
    f = np.clip(pos - lo, 0.0, 1.0)
    out = vals[..., lo] * (1.0 - f) + vals[..., hi] * f
    return np.where((np.asarray(lam) >= 320.0) & (np.asarray(lam) <= 720.0),
                    out, 0.0)


def sky_radiance_spectral_bands(d, sun_dir, turbidity=3.0, albedo=0.2):
    """All-band dome radiance along directions d (..., 3), y-up; zero
    below the horizon. Returns (..., 11) in the model's raw spectral
    units (the bake applies the pipeline calibration)."""
    d = np.asarray(d, np.float64)
    s = np.asarray(sun_dir, np.float64)
    s = s / np.linalg.norm(s)
    elev = np.pi / 2.0 - np.arccos(np.clip(s[1], -1.0, 1.0))
    cfgs, rads = cook_state_spectral(turbidity, float(np.mean(albedo)),
                                     elev)
    cos_t = np.clip(d[..., 1], -1.0, 1.0)
    theta = np.minimum(np.arccos(cos_t), np.pi / 2.0 - 1e-4)
    gamma = np.arccos(np.clip(d @ s, -1.0, 1.0))
    vals = radiance(cfgs, rads, theta, gamma)       # (..., 11)
    return np.maximum(vals, 0.0) * (cos_t > 0.0)[..., None]
