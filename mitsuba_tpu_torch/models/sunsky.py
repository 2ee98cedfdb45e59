"""Procedural sun / sky / sunsky emitters (port of models/sunsky.py, a
numpy module but for the spectral bake's calibration).

The analog of src/emitters/{sky,sun,sunsky}.cpp: like the reference,
the procedural model is *baked into a lat-long environment map* at
scene-build time (sky.cpp configure() renders the model into a bitmap
at `resolution`), so at render time the sky is ordinary envmap
data with CDF importance sampling — no per-ray transcendental model
evaluation on device.

Sky-dome model: the reference's sky.cpp evaluates the Hosek-Wilkie 2012
model (sky.cpp:246-274 via sunsky/skymodel.h), NOT Preetham — this
module's dome is Preetham et al. 1999, which is a measurably different
radiance distribution (see `hosek.py` for the Hosek-Wilkie dome). The
*solar disk* uses Preetham's sun attenuation data in both the reference
(sunmodel.h:247) and here. RGB (CIE Yxy) rather than spectral, matching
the repo's RGB build mode.

Units: luminance is carried in kcd/m^2 (zenith luminance of a clear sky
is ~5-10 in these units, the solar disk ~1.6e6), converted to RGB
through CIE XYZ. `scale` multiplies the result, matching the reference's
`scale` parameter.

The date/time/lat-long PSA solar-position calculator is implemented
below (`sun_position_psa`) and wired into the XML loader; passing
`sun_direction` explicitly overrides it. The spectral renderer gets a
TRUE spectral sky: `bake_spectral` bakes the Hosek 11-band stack
(320..720 nm) onto the envmap for the hero-wavelength integrator —
the analog of the reference's SPECTRUM_SAMPLES>3 build. Its calibration
runs the port's core/spectrum (rgb_response, upsample) on CPU float32
tensors, where the JAX package calls its own through jax.numpy.
"""
from __future__ import annotations

import numpy as np

# Perez coefficients, linear in turbidity T: rows (A..E), columns (T, 1)
_PEREZ_Y = np.asarray([
    [0.17872, -1.46303], [-0.35540, 0.42749], [-0.02266, 5.32505],
    [0.12064, -2.57705], [-0.06696, 0.37027]], np.float64)
_PEREZ_x = np.asarray([
    [-0.01925, -0.25922], [-0.06651, 0.00081], [-0.00041, 0.21247],
    [-0.06409, -0.89887], [-0.00325, 0.04517]], np.float64)
_PEREZ_y = np.asarray([
    [-0.01669, -0.26078], [-0.09495, 0.00921], [-0.00792, 0.21023],
    [-0.04405, -1.65369], [-0.01092, 0.05291]], np.float64)

# Zenith chromaticity matrices (Preetham A.2): rows T^2, T, 1; cols th^3..1
_ZENITH_x = np.asarray([
    [0.00166, -0.00375, 0.00209, 0.0],
    [-0.02903, 0.06377, -0.03202, 0.00394],
    [0.11693, -0.21196, 0.06052, 0.25886]], np.float64)
_ZENITH_y = np.asarray([
    [0.00275, -0.00610, 0.00317, 0.0],
    [-0.04214, 0.08970, -0.04153, 0.00516],
    [0.15346, -0.26756, 0.06670, 0.26688]], np.float64)

# CIE XYZ -> linear sRGB
_XYZ2RGB = np.asarray([
    [3.2406, -1.5372, -0.4986],
    [-0.9689, 1.8758, 0.0415],
    [0.0557, -0.2040, 1.0570]], np.float64)

SUN_APP_RADIUS_DEG = 0.5358 / 2.0   # apparent solar radius (sun.cpp)
# mean luminance of the solar disk in kcd/m^2 (~1.9e9 cd/m^2 above the
# atmosphere; atmospheric transmittance is applied per-channel below)
_SUN_DISK_LUM = 1.9e6


def _perez(coeff, theta, gamma):
    A, B, C, D, E = coeff
    ct = np.maximum(np.cos(theta), 1e-3)
    return ((1.0 + A * np.exp(B / ct))
            * (1.0 + C * np.exp(D * gamma) + E * np.cos(gamma) ** 2))


def _zenith_luminance(T, theta_s):
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2.0 * theta_s)
    return (4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192


def _zenith_chroma(M, T, theta_s):
    tv = np.asarray([T * T, T, 1.0])
    sv = np.asarray([theta_s ** 3, theta_s ** 2, theta_s, 1.0])
    return float(tv @ M @ sv)


def _yxy_to_rgb(Y, x, y):
    """CIE Yxy -> linear RGB, Y in kcd/m^2. Shapes broadcast."""
    y = np.maximum(y, 1e-6)
    X = x / y * Y
    Z = (1.0 - x - y) / y * Y
    xyz = np.stack([X, Y, Z], axis=-1)
    rgb = xyz @ _XYZ2RGB.T
    return np.maximum(rgb, 0.0)


def sky_radiance_rgb(d, sun_dir, turbidity=3.0):
    """Preetham sky radiance along directions d (...,3), y-up. Zero below
    the horizon. Returns (...,3) linear RGB in kcd/m^2."""
    d = np.asarray(d, np.float64)
    s = np.asarray(sun_dir, np.float64)
    s = s / np.linalg.norm(s)
    theta_s = float(np.arccos(np.clip(s[1], -1.0, 1.0)))
    theta_s = min(theta_s, np.pi / 2.0 - 1e-3)
    T = float(turbidity)

    cos_t = np.clip(d[..., 1], -1.0, 1.0)
    theta = np.arccos(cos_t)
    gamma = np.arccos(np.clip(d @ s, -1.0, 1.0))

    tvec = np.asarray([T, 1.0])
    cY, cx, cy = _PEREZ_Y @ tvec, _PEREZ_x @ tvec, _PEREZ_y @ tvec
    Yz = max(_zenith_luminance(T, theta_s), 1e-4)
    xz = _zenith_chroma(_ZENITH_x, T, theta_s)
    yz = _zenith_chroma(_ZENITH_y, T, theta_s)

    # clamp view theta at the horizon so the horizon band stays finite
    th = np.minimum(theta, np.pi / 2.0 - 1e-3)
    Y = Yz * _perez(cY, th, gamma) / _perez(cY, 0.0, theta_s)
    x = xz * _perez(cx, th, gamma) / _perez(cx, 0.0, theta_s)
    y = yz * _perez(cy, th, gamma) / _perez(cy, 0.0, theta_s)
    rgb = _yxy_to_rgb(Y, x, y)
    return rgb * (cos_t > 0.0)[..., None]


def sun_transmittance_rgb(theta_s, turbidity=3.0):
    """Broadband atmospheric transmittance toward the sun (Rayleigh +
    aerosol terms of Preetham's solar model) at RGB wavelengths."""
    lam = np.asarray([0.62, 0.555, 0.465])            # um
    deg = np.degrees(theta_s)
    m_rel = 1.0 / (np.cos(theta_s) + 0.15 * (93.885 - deg) ** -1.253)
    beta = 0.04608 * float(turbidity) - 0.04586
    tau_r = np.exp(-m_rel * 0.008735 * lam ** -4.08)
    tau_a = np.exp(-m_rel * beta * lam ** -1.3)
    return tau_r * tau_a


def _latlong_dirs(h, w):
    """Pixel-center directions + solid angles of an (h, w) lat-long map in
    the envmap's y-up convention (scene/envmap.py uv_to_dir)."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi
    phi = (2.0 * u - 1.0) * np.pi
    st = np.sin(theta)[:, None]
    d = np.stack(np.broadcast_arrays(
        st * np.sin(phi)[None, :],
        np.cos(theta)[:, None] * np.ones_like(phi)[None, :],
        -st * np.cos(phi)[None, :]), axis=-1)
    omega = (2.0 * np.pi / w) * (np.pi / h) * st  # (h,1) broadcastable
    return d, np.broadcast_to(omega, (h, w))


def bake_sun(img, sun_dir, turbidity=3.0, scale=1.0, radius_scale=1.0):
    """Add the solar disk to a lat-long map, conserving irradiance.

    The disk's radiance * solid angle is distributed over the pixels it
    covers; if the map is too coarse for any pixel center to fall inside
    the disk, the full power lands in the nearest pixel (sun.cpp's
    sunRadiusScale semantics, including the delta-like limit)."""
    h, w = img.shape[:2]
    s = np.asarray(sun_dir, np.float64)
    s = s / np.linalg.norm(s)
    theta_s = float(np.arccos(np.clip(s[1], -1.0, 1.0)))
    if np.degrees(theta_s) >= 90.0:
        return img  # sun below horizon
    r = np.radians(SUN_APP_RADIUS_DEG) * float(radius_scale)
    disk_omega = 2.0 * np.pi * (1.0 - np.cos(r))
    L = _SUN_DISK_LUM * sun_transmittance_rgb(theta_s, turbidity) * scale
    power = L * disk_omega                              # irradiance (RGB)

    d, omega = _latlong_dirs(h, w)
    cosg = d @ s
    inside = cosg >= np.cos(r)
    covered = float((omega * inside).sum())
    if covered > 0.0:
        img[inside] += power / covered
    else:
        iy, ix = np.unravel_index(np.argmax(cosg), cosg.shape)
        img[iy, ix] += power / max(omega[iy, ix], 1e-12)
    return img


def bake(kind, sun_dir=(0.0, 0.7071, 0.7071), turbidity=3.0, scale=1.0,
         resolution=512, sun_radius_scale=1.0, sky_model="hosek",
         albedo=0.2):
    """Bake a `sky`, `sun`, or `sunsky` emitter into an (H, W, 3) float32
    lat-long radiance map (H = resolution//2, W = resolution).

    sky_model: "hosek" (the Hosek-Wilkie 2012 model the reference's
    sky.cpp actually evaluates — models/hosek.py, validated against the
    authors' published implementation) or "preetham" (this module's
    Preetham 1999 dome, kept as an option). albedo: ground albedo of
    the Hosek model (scalar or RGB), sky.cpp's `albedo` parameter."""
    w = int(resolution)
    h = max(w // 2, 2)
    img = np.zeros((h, w, 3), np.float64)
    if kind in ("sky", "sunsky"):
        d, _ = _latlong_dirs(h, w)
        if sky_model == "hosek":
            from . import hosek
            # unit bridge: hosek.sky_radiance_rgb carries the reference's
            # own convention (tristimulus / sum(CIE Y) = flat-spectrum-
            # equivalent W/m^2/sr/nm, sky.cpp:434); this module's maps are
            # in kcd/m^2 (the Preetham/sun convention the rest of the
            # bake shares). A flat spectrum of 1 W/m^2/sr/nm has
            # luminance 683 lm/W * integral(CIE y) 106.857 nm / 1000
            # = 72.98 kcd/m^2. Dome DISTRIBUTION is exactly the
            # reference's (validated vs the published implementation).
            kcd_bridge = 683.0 * 106.856980 / 1000.0
            img += hosek.sky_radiance_rgb(d, sun_dir, turbidity,
                                          albedo) * (scale * kcd_bridge)
        elif sky_model == "preetham":
            img += sky_radiance_rgb(d, sun_dir, turbidity) * scale
        else:
            raise ValueError(f"unknown sky_model '{sky_model}'")
    if kind in ("sun", "sunsky"):
        bake_sun(img, sun_dir, turbidity, scale, sun_radius_scale)
    return img.astype(np.float32)


def bake_spectral(kind, sun_dir=(0.0, 0.7071, 0.7071), turbidity=3.0,
                  scale=1.0, resolution=512, sun_radius_scale=1.0,
                  albedo=0.2):
    """Spectral companion of bake(): an (H, W, 11) stack of Hosek-Wilkie
    band radiances at 320..720 nm (hosek.SPEC_BANDS), luminance-
    calibrated to the kcd/m^2 RGB bake so the spectral renderer's
    resolved images agree with the RGB path in magnitude while carrying
    the model's true spectral shape (the reference's SPECTRUM_SAMPLES>3
    build is the analog). The solar disk (kind "sun"/"sunsky") is added
    via the pipeline's RGB upsampler at the band centers — the Hosek
    dataset only covers the dome."""
    from . import hosek
    w = int(resolution)
    h = max(w // 2, 2)
    d, _ = _latlong_dirs(h, w)
    spec = hosek.sky_radiance_spectral_bands(
        d, sun_dir, turbidity, albedo) if kind in ("sky", "sunsky")         else np.zeros((h, w, 11))
    # luminance calibration on the mean dome spectrum vs the RGB bake
    rgb_dome = hosek.sky_radiance_rgb(d, sun_dir, turbidity, albedo)         * (683.0 * 106.856980 / 1000.0)
    lum_rgb = float((rgb_dome @ np.asarray([0.2126, 0.7152, 0.0722])).mean())
    lam = np.linspace(400.0, 700.0, 61)
    mean_spec = spec.mean((0, 1))                       # (11,)
    pos = (lam - 320.0) / 40.0
    lo = np.clip(np.floor(pos).astype(int), 0, 10)
    f = np.clip(pos - lo, 0.0, 1.0)
    L_mean = mean_spec[lo] * (1 - f) + mean_spec[np.minimum(lo + 1, 10)] * f
    # calibrate against the SPECTRAL PIPELINE's own camera response
    # (core/spectrum.rgb_response): the hero-wavelength renderer's unit
    # convention is "spectra resolve to RGB" — a physically-scaled
    # spectrum would land a luminous-efficacy factor (~73x) off. The
    # spectral SHAPE stays the model's; only the scalar scale is pinned
    # so resolved renders agree with the RGB bake.
    import torch

    from ..core import spectrum as spc
    resp = spc.rgb_response(torch.as_tensor(lam, dtype=torch.float32)).numpy()  # (61, 3)
    resolved = np.trapezoid(resp * L_mean[:, None], lam, axis=0)  # (3,)
    lum_w = np.asarray([0.2126, 0.7152, 0.0722])
    C = lum_rgb / max(float(resolved @ lum_w), 1e-12)
    spec = spec * (C * scale)
    if kind in ("sun", "sunsky"):
        sun_rgb = np.zeros((h, w, 3), np.float64)
        bake_sun(sun_rgb, sun_dir, turbidity, scale, sun_radius_scale)
        if sun_rgb.max() > 0:
            su = spc.upsample(
                torch.as_tensor(sun_rgb.reshape(-1, 3), dtype=torch.float32),
                torch.as_tensor(hosek.SPEC_BANDS, dtype=torch.float32)).numpy()
            spec = spec + su.reshape(h, w, 11)
    return spec.astype(np.float32)


# ---------------------------------------------------------------------------
# Solar position (sunmodel.h computeSunCoordinates): the PSA algorithm
# of Blanco-Muriel et al. 2001, "Computing the solar vector" — published
# astronomy, re-derived from the paper's formulas.
# ---------------------------------------------------------------------------

_EARTH_MEAN_RADIUS_KM = 6371.01
_ASTRONOMICAL_UNIT_KM = 149597890.0


def sun_coordinates(year=2010, month=7, day=10, hour=15.0, minute=0.0,
                    second=0.0, latitude=35.6894, longitude=139.6917,
                    timezone=9.0):
    """-> (elevation-from-zenith theta, azimuth) in radians for the given
    civil date/time and observer location (defaults = the reference's
    Tokyo defaults, sunmodel.h:226-235)."""
    import math

    dec_hours = hour - timezone + (minute + second / 60.0) / 60.0
    aux1 = (month - 14) // 12
    aux2 = (1461 * (year + 4800 + aux1)) // 4 \
        + (367 * (month - 2 - 12 * aux1)) // 12 \
        - (3 * ((year + 4900 + aux1) // 100)) // 4 + day - 32075
    julian = aux2 - 0.5 + dec_hours / 24.0
    elapsed = julian - 2451545.0

    omega = 2.1429 - 0.0010394594 * elapsed
    mean_long = 4.8950630 + 0.017202791698 * elapsed
    anomaly = 6.2400600 + 0.0172019699 * elapsed
    ecl_long = (mean_long + 0.03341607 * math.sin(anomaly)
                + 0.00034894 * math.sin(2 * anomaly) - 0.0001134
                - 0.0000203 * math.sin(omega))
    ecl_obl = 0.4090928 - 6.2140e-9 * elapsed + 0.0000396 * math.cos(omega)

    sin_el = math.sin(ecl_long)
    ra = math.atan2(math.cos(ecl_obl) * sin_el, math.cos(ecl_long))
    if ra < 0:
        ra += 2 * math.pi
    decl = math.asin(math.sin(ecl_obl) * sin_el)

    gmst = 6.6974243242 + 0.0657098283 * elapsed + dec_hours
    lmst = math.radians(gmst * 15 + longitude)
    lat = math.radians(latitude)
    hour_angle = lmst - ra
    elevation = math.acos(math.cos(lat) * math.cos(hour_angle)
                          * math.cos(decl) + math.sin(decl) * math.sin(lat))
    azimuth = math.atan2(-math.sin(hour_angle),
                         math.tan(decl) * math.cos(lat)
                         - math.sin(lat) * math.cos(hour_angle))
    if azimuth < 0:
        azimuth += 2 * math.pi
    # parallax correction
    elevation += (_EARTH_MEAN_RADIUS_KM / _ASTRONOMICAL_UNIT_KM) \
        * math.sin(elevation)
    return elevation, azimuth


def sun_direction(**kw):
    """Unit sun direction in the scene's Y-up frame (sunmodel.h
    toSphere: x = sin(az) sin(theta), y = cos(theta),
    z = -cos(az) sin(theta))."""
    import math

    theta, az = sun_coordinates(**kw)
    st = math.sin(theta)
    import numpy as np

    return np.asarray([st * math.sin(az), math.cos(theta),
                       -st * math.cos(az)], np.float32)
