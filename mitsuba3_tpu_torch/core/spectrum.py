"""Color and spectrum utilities — counterpart of
``mitsuba3_tpu/core/spectrum.py``.

The RGB constants (BT.709 luminance weights, sRGB <-> XYZ) and their
functions on tensors; and, on the host in float64 numpy, the projection of
a spectrum onto linear sRGB that the loader applies to ``blackbody``,
``regular`` and ``irregular`` spectra in an RGB scene (the CIE 1931 fits
of Wyman, Sloan and Shirley 2013). The host arithmetic is the JAX
package's, so the projected colors equal its own bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

# ITU-R BT.709 / sRGB primaries
LUMINANCE_WEIGHTS = np.array([0.212671, 0.715160, 0.072169], np.float32)

XYZ_TO_SRGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311]], np.float32)

SRGB_TO_XYZ = np.array([
    [0.412453, 0.357580, 0.180423],
    [0.212671, 0.715160, 0.072169],
    [0.019334, 0.119193, 0.950227]], np.float32)


def _on(table: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(table, device=x.device)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    return torch.sum(rgb * _on(LUMINANCE_WEIGHTS, rgb), dim=-1)


def srgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    return rgb @ _on(SRGB_TO_XYZ, rgb).T


def xyz_to_srgb(xyz: torch.Tensor) -> torch.Tensor:
    return xyz @ _on(XYZ_TO_SRGB, xyz).T


# ---------------------------------------------------------------------------
# Spectra projected to RGB on the host (float64 numpy)
# ---------------------------------------------------------------------------

def _gauss_piecewise(wl, alpha, mu, s1, s2):
    t = (wl - mu) * np.where(wl < mu, 1.0 / s1, 1.0 / s2)
    return alpha * np.exp(-0.5 * t * t)


def cie1931_xyz_bar(wl):
    """CIE 1931 color-matching functions at wavelength wl [nm]."""
    wl = np.asarray(wl, np.float64)
    x = (_gauss_piecewise(wl, 0.362, 442.0, 16.0, 26.7)
         + _gauss_piecewise(wl, 1.056, 599.8, 37.9, 31.0)
         + _gauss_piecewise(wl, -0.065, 501.1, 20.4, 26.2))
    y = (_gauss_piecewise(wl, 0.821, 568.8, 46.9, 40.5)
         + _gauss_piecewise(wl, 0.286, 530.9, 16.3, 31.1))
    z = (_gauss_piecewise(wl, 1.217, 437.0, 11.8, 36.0)
         + _gauss_piecewise(wl, 0.681, 459.0, 26.0, 13.8))
    return x, y, z


_XYZ_TO_SRGB = np.array([[3.240479, -1.537150, -0.498535],
                         [-0.969256, 1.875991, 0.041556],
                         [0.055648, -0.204043, 1.057311]])


def _trapezoid(y, x):
    """The trapezoid rule as numpy computes it (``np.trapezoid``, which
    numpy before 2.0 lacks; ``np.trapz`` is the same sum)."""
    return (np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum(-1)


def spd_to_rgb(wavelengths, values):
    """Project a sampled SPD onto linear sRGB, normalized so that a flat
    unit spectrum maps to RGB (1, 1, 1)."""
    wl = np.asarray(wavelengths, np.float64)
    sp = np.asarray(values, np.float64)
    grid = np.linspace(max(380.0, wl.min()), min(780.0, wl.max()), 256)
    spi = np.interp(grid, wl, sp)
    xb, yb, zb = cie1931_xyz_bar(grid)
    xyz = np.stack([_trapezoid(spi * xb, grid),
                    _trapezoid(spi * yb, grid),
                    _trapezoid(spi * zb, grid)])
    norm_grid = np.linspace(380.0, 780.0, 256)
    _, ynorm, _ = cie1931_xyz_bar(norm_grid)
    xyz /= _trapezoid(ynorm, norm_grid)
    rgb = _XYZ_TO_SRGB @ xyz
    return np.maximum(rgb, 0.0).astype(np.float32)


def blackbody_rgb(temperature: float) -> np.ndarray:
    """A Planck emitter projected to linear sRGB radiance."""
    wl = np.linspace(380.0, 780.0, 256)
    h = 6.62607015e-34
    c = 2.99792458e8
    kb = 1.380649e-23
    lam = wl * 1e-9
    planck = (2 * h * c * c) / (lam ** 5) / (
        np.expm1(h * c / (lam * kb * max(temperature, 1.0)))) * 1e-9
    return spd_to_rgb(wl, planck)


def d65_rgb(scale: float = 1.0) -> np.ndarray:
    """The CIE D65 illuminant in sRGB: its white point, so (1, 1, 1) *
    scale."""
    return np.full(3, scale, np.float32)
