"""Sun and sky environment — counterpart of ``mitsuba3_tpu/emitters/sunsky.py``
(src/emitters/sunsky.cpp, timed_sunsky.cpp), a numpy copy of its host code.

As in the JAX package, the sky is the analytic Preetham et al. 1999 model
(not the reference's tabulated Hosek-Wilkie data), baked into a lat-long
environment map at load time, so the envmap's sampling, lookups and PRB
gradients apply unchanged; the sun is splatted into its nearest texel with
the power of a 0.2665-degree disk. ``timed_sunsky`` places the sun from a
date, a time and a location. The port's tables equal the JAX package's
(the same numpy arithmetic).
"""
from __future__ import annotations

import numpy as np

# Perez coefficient tables (Preetham et al. 1999, Table 1): rows A..E as
# linear functions of turbidity T: coeff = c1 * T + c2.
_PEREZ_Y = np.array([[0.1787, -1.4630], [-0.3554, 0.4275],
                     [-0.0227, 5.3251], [0.1206, -2.5771],
                     [-0.0670, 0.3703]])
_PEREZ_x = np.array([[-0.0193, -0.2592], [-0.0665, 0.0008],
                     [-0.0004, 0.2125], [-0.0641, -0.8989],
                     [-0.0033, 0.0452]])
_PEREZ_y = np.array([[-0.0167, -0.2608], [-0.0950, 0.0092],
                     [-0.0079, 0.2102], [-0.0441, -1.6537],
                     [-0.0109, 0.0529]])


def _perez(theta, gamma, c):
    return ((1.0 + c[0] * np.exp(c[1] / np.maximum(np.cos(theta), 1e-3)))
            * (1.0 + c[2] * np.exp(c[3] * gamma) + c[4] * np.cos(gamma) ** 2))


def _zenith(T, ts):
    """Zenith luminance (kcd/m2) and chromaticity (Preetham A.2)."""
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2 * ts)
    Yz = (4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192
    v_t = np.array([T * T, T, 1.0])
    v_s = np.array([ts ** 3, ts ** 2, ts, 1.0])
    xz = v_t @ np.array([[0.00166, -0.00375, 0.00209, 0.0],
                         [-0.02903, 0.06377, -0.03202, 0.00394],
                         [0.11693, -0.21196, 0.06052, 0.25886]]) @ v_s
    yz = v_t @ np.array([[0.00275, -0.00610, 0.00317, 0.0],
                         [-0.04214, 0.08970, -0.04153, 0.00516],
                         [0.15346, -0.26756, 0.06670, 0.26688]]) @ v_s
    return max(Yz, 0.0), xz, yz


_XYZ_TO_SRGB = np.array([[3.240479, -1.537150, -0.498535],
                         [-0.969256, 1.875991, 0.041556],
                         [0.055648, -0.204043, 1.057311]])


def build_sunsky_envmap(spec: dict, height: int = 128):
    """Bake the sun+sky model into a lat-long radiance map [H, 2H, 3]."""
    T = float(spec.get("turbidity", 3.0))
    sun_scale = float(spec.get("sun_scale", 1.0))
    sky_scale = float(spec.get("sky_scale", 1.0))
    sun_dir = spec.get("sun_direction")
    if sun_dir is None:
        # solar elevation ~ 30 deg toward +x by default
        sun_dir = [0.5, np.sin(np.deg2rad(30.0)), 0.5]
    sun_dir = np.asarray(sun_dir, np.float64)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)

    h, w = height, 2 * height
    theta = (np.arange(h) + 0.5) / h * np.pi          # polar from +Y
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    # lat-long convention of envmap.py: y = cos(theta)
    d = np.stack([np.sin(tt) * np.sin(pp), np.cos(tt),
                  -np.sin(tt) * np.cos(pp)], axis=-1)

    ts = np.arccos(np.clip(sun_dir[1], -1.0, 1.0))    # sun zenith angle
    cos_gamma = np.clip(d @ sun_dir, -1.0, 1.0)
    gamma = np.arccos(cos_gamma)
    view_theta = np.minimum(tt, np.pi / 2 - 1e-3)     # below-horizon clamp

    Yz, xz, yz = _zenith(T, ts)
    cy = _PEREZ_Y[:, 0] * T + _PEREZ_Y[:, 1]
    cx = _PEREZ_x[:, 0] * T + _PEREZ_x[:, 1]
    cyy = _PEREZ_y[:, 0] * T + _PEREZ_y[:, 1]

    def ratio(c, th, ga):
        return _perez(th, ga, c) / _perez(0.0, ts, c)

    Y = Yz * ratio(cy, view_theta, gamma)              # kcd/m^2
    x = xz * ratio(cx, view_theta, gamma)
    y = np.maximum(yz * ratio(cyy, view_theta, gamma), 1e-4)

    # xyY -> XYZ -> linear sRGB; scale kcd/m^2 into the renderer's
    # radiometric units (the reference normalizes its dataset similarly)
    X = x / y * Y
    Z = (1.0 - x - y) / y * Y
    xyz = np.stack([X, Y, Z], axis=-1)
    rgb = np.einsum("ij,hwj->hwi", _XYZ_TO_SRGB, xyz)
    rgb = np.maximum(rgb, 0.0) * (0.025 * sky_scale)

    # below the horizon: fade to ground albedo-ish gray
    below = d[..., 1] < 0.0
    horizon = rgb[np.abs(d[..., 1]) < 0.05].mean(axis=0) \
        if (np.abs(d[..., 1]) < 0.05).any() else np.array([1.0, 1.0, 1.0])
    rgb[below] = horizon * 0.3

    # sun: the 0.2665-deg disk is smaller than a texel at practical map
    # resolutions, so splat its POWER into the nearest texel — radiance
    # scaled by the solid-angle ratio keeps the irradiance correct
    att = np.exp(-0.15 * T / np.maximum(np.cos(ts), 0.05))
    omega_sun = 2 * np.pi * (1.0 - np.cos(np.deg2rad(0.2665)))
    i_flat = int(np.argmax(cos_gamma))
    iy, ix = np.unravel_index(i_flat, cos_gamma.shape)
    omega_texel = (np.sin(theta[iy]) * (np.pi / h) * (2 * np.pi / w))
    # disk radiance ~ 5e5 x clear-sky zenith luminance (the real sun/sky
    # radiance ratio is ~2e5; this puts direct solar irradiance at roughly
    # 5-10x the diffuse sky irradiance on a clear day), attenuated by the
    # turbidity optical mass toward the sun
    sun_radiance = np.array([1.0, 0.96, 0.90]) * (5.0e5 * Yz * 0.025) * att
    rgb[iy, ix] += sun_radiance * (omega_sun / max(omega_texel, 1e-9)) \
        * sun_scale
    return rgb.astype(np.float32)


def solar_position(year, month, day, hour, minute=0.0, second=0.0,
                   latitude=35.6894, longitude=139.6917, timezone=9.0):
    """Sun direction (unit, +Y up, +X east, -Z north-ish like the
    envmap frame) from date/time/location — the timed_sunsky emitter's
    astronomical core (sunsky.h / timed_sunsky.cpp role; Preetham et al.
    appendix solar position formulae)."""
    t = hour + minute / 60.0 + second / 3600.0 - timezone
    # Julian date (Preetham A.6)
    if month <= 2:
        month += 12
        year -= 1
    a = int(year / 100)
    b = 2 - a + int(a / 4)
    jd = (int(365.25 * (year + 4716)) + int(30.6001 * (month + 1))
          + day + b - 1524.5 + t / 24.0)
    d = jd - 2451545.0
    # solar coordinates (low-precision NOAA/Preetham)
    g = np.deg2rad((357.529 + 0.98560028 * d) % 360.0)
    q = (280.459 + 0.98564736 * d) % 360.0
    lam = np.deg2rad(q + 1.915 * np.sin(g) + 0.020 * np.sin(2 * g))
    e = np.deg2rad(23.439 - 0.00000036 * d)
    ra = np.arctan2(np.cos(e) * np.sin(lam), np.cos(lam))
    dec = np.arcsin(np.sin(e) * np.sin(lam))
    # local hour angle
    gmst = (18.697374558 + 24.06570982441908 * d) % 24.0
    lmst = np.deg2rad((gmst * 15.0 + longitude) % 360.0)
    ha = lmst - ra
    lat = np.deg2rad(latitude)
    elev = np.arcsin(np.sin(lat) * np.sin(dec)
                     + np.cos(lat) * np.cos(dec) * np.cos(ha))
    az = np.arctan2(-np.sin(ha),
                    np.tan(dec) * np.cos(lat) - np.sin(lat) * np.cos(ha))
    # to the renderer's frame: y = up, azimuth measured from north (-z)
    ce = np.cos(elev)
    return np.array([ce * np.sin(az), np.sin(elev), -ce * np.cos(az)])


def build_timed_sunsky_envmap(spec: dict, height: int = 128):
    """timed_sunsky: sun position from time/date/location properties
    (timed_sunsky.cpp), baked through the same sun+sky model."""
    sun = solar_position(
        int(spec.get("year", 2010)), int(spec.get("month", 7)),
        int(spec.get("day", 10)), float(spec.get("hour", 15.0)),
        float(spec.get("minute", 0.0)), float(spec.get("second", 0.0)),
        float(spec.get("latitude", 35.6894)),
        float(spec.get("longitude", 139.6917)),
        float(spec.get("timezone", 9.0)))
    sub = {k: v for k, v in spec.items()
           if k not in ("year", "month", "day", "hour", "minute",
                        "second", "latitude", "longitude", "timezone",
                        "type")}
    sub["sun_direction"] = [float(x) for x in sun]
    return build_sunsky_envmap(sub, height)
