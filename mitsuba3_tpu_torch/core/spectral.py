"""The spectral variant's wavelength machinery — counterpart of
``mitsuba3_tpu/core/spectral.py``.

Hero-wavelength transport with three stratified wavelengths per path: a
lane's ``Vec3`` radiance holds its radiance at those three wavelengths.
RGB scene colors are upsampled to smooth spectra through a linear basis
that ``_build_basis`` fits on the host once, at import (the JAX package's
numpy code, so the basis equals its own bit for bit); the film adds CIE
XYZ per sample, and ``spectrum.xyz_to_srgb`` turns the developed image
into linear sRGB. Sampled spectra (regular, irregular, blackbody, D65) keep
their SPD on a shared regular grid of ``SPD_N`` points, evaluated at the
path's wavelengths by ``eval_spd``.
"""
from __future__ import annotations

import numpy as np
import torch

from .spectrum import _XYZ_TO_SRGB, _trapezoid, cie1931_xyz_bar
from .vec import Vec3

LAMBDA_MIN = 380.0
LAMBDA_MAX = 760.0
LAMBDA_RANGE = LAMBDA_MAX - LAMBDA_MIN

_N_GRID = 128
_K_RBF = 16


def _build_basis():
    """The RGB -> spectrum basis [_N_GRID, 3] by constrained least squares:
    the film's projection of basis i is the unit color e_i, the three sum
    to a flat white, and a ridge keeps them smooth."""
    lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, _N_GRID)
    xb, yb, zb = cie1931_xyz_bar(lam)
    ynorm = _trapezoid(yb, lam)
    cmf = np.stack([xb, yb, zb])                      # [3, n]
    dl = lam[1] - lam[0]
    film = (_XYZ_TO_SRGB @ cmf) * dl / ynorm          # [3, n]: spectrum->rgb

    centers = np.linspace(LAMBDA_MIN, LAMBDA_MAX, _K_RBF)
    sig = (LAMBDA_MAX - LAMBDA_MIN) / _K_RBF * 1.2
    g = np.exp(-0.5 * ((lam[:, None] - centers[None, :]) / sig) ** 2)

    a_rt = np.kron(np.eye(3), film @ g)               # [9, 3K]
    b_rt = np.eye(3).reshape(-1)
    ones_c = np.kron(np.ones((1, 3)), g)              # [n, 3K]
    b_w = np.ones(_N_GRID)
    wc, ww, ridge = 1e4, 1.0, 1e-3
    a = np.concatenate([wc * a_rt, ww * ones_c,
                        ridge * np.eye(3 * _K_RBF)], axis=0)
    b = np.concatenate([wc * b_rt, ww * b_w, np.zeros(3 * _K_RBF)])
    w = np.linalg.lstsq(a, b, rcond=None)[0].reshape(3, _K_RBF).T  # [K, 3]
    basis = g @ w                                     # [n, 3]
    return (lam.astype(np.float32), basis.astype(np.float32),
            float(ynorm))


_LAM_GRID, _BASIS, _Y_NORM = _build_basis()
_LAM0 = float(_LAM_GRID[0])
_DLAM = float(_LAM_GRID[1] - _LAM_GRID[0])


def _on(table: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(table, device=x.device)


def sample_wavelengths(u: torch.Tensor):
    """Three stratified wavelengths from one uniform sample per lane (the
    hero and its shifts by 1/3 and 2/3 of the range). Returns (Vec3 [nm],
    pdf)."""
    def at(shift):
        return LAMBDA_MIN + LAMBDA_RANGE * torch.remainder(u + shift, 1.0)

    return Vec3(at(0.0), at(1.0 / 3.0), at(2.0 / 3.0)), 1.0 / LAMBDA_RANGE


def _basis_at(lmb: torch.Tensor):
    """The basis interpolated linearly at wavelengths `lmb` -> (b_r, b_g,
    b_b)."""
    f = torch.clamp((lmb - _LAM0) / _DLAM, 0.0, _N_GRID - 1 - 1e-4)
    i0 = f.to(torch.int32)
    t = (f - i0)[:, None]
    basis = _on(_BASIS, lmb)
    b0 = basis[i0.long()]
    b1 = basis[torch.clamp(i0 + 1, max=_N_GRID - 1).long()]
    b = b0 * (1.0 - t) + b1 * t
    return b[:, 0], b[:, 1], b[:, 2]


def rgb_to_spectrum(rgb: Vec3, wl: Vec3, reflectance: bool = True) -> Vec3:
    """The upsampled spectrum of `rgb` at the path's three wavelengths;
    a reflectance is clamped to [0, 1.05], an emission to >= 0."""
    out = []
    for lmb in (wl.x, wl.y, wl.z):
        br, bg, bb = _basis_at(lmb)
        s = rgb.x * br + rgb.y * bg + rgb.z * bb
        out.append(torch.clamp(s, 0.0, 1.05) if reflectance
                   else torch.clamp(s, min=0.0))
    return Vec3(*out)


def _cie_at(lmb: torch.Tensor):
    """The CIE 1931 fits of ``core/spectrum.py`` on a tensor."""
    def gp(alpha, mu, s1, s2):
        t = (lmb - mu) * torch.where(lmb < mu, 1.0 / s1, 1.0 / s2)
        return alpha * torch.exp(-0.5 * t * t)

    x = (gp(0.362, 442.0, 16.0, 26.7) + gp(1.056, 599.8, 37.9, 31.0)
         + gp(-0.065, 501.1, 20.4, 26.2))
    y = gp(0.821, 568.8, 46.9, 40.5) + gp(0.286, 530.9, 16.3, 31.1)
    z = gp(1.217, 437.0, 11.8, 36.0) + gp(0.681, 459.0, 26.0, 13.8)
    return x, y, z


def cie_xyz_weights(wl: Vec3):
    """(x_bar, y_bar, z_bar), each a Vec3 over the three wavelengths."""
    cols = [_cie_at(lmb) for lmb in (wl.x, wl.y, wl.z)]
    return tuple(Vec3(*(c[i] for c in cols)) for i in range(3))


def spectral_to_xyz(L: Vec3, wl: Vec3) -> Vec3:
    """One sample's XYZ estimate: channel i carries the radiance at
    wavelength i, each drawn with pdf 1 / range."""
    xw, yw, zw = cie_xyz_weights(wl)
    scale = LAMBDA_RANGE / (3.0 * _Y_NORM)
    return Vec3(L.dot(xw) * scale, L.dot(yw) * scale, L.dot(zw) * scale)


# ---------------------------------------------------------------------------
# Sampled spectra on the shared grid (host numpy, the JAX package's)
# ---------------------------------------------------------------------------

SPD_N = 64  # the shared regular grid over [LAMBDA_MIN, LAMBDA_MAX]


def resample_spd(wavelengths, values) -> np.ndarray:
    """(wavelength, value) samples -> [SPD_N] values on the shared grid
    (linear, zero outside the data)."""
    wl = np.asarray(wavelengths, np.float64)
    v = np.asarray(values, np.float64)
    order = np.argsort(wl)
    grid = np.linspace(LAMBDA_MIN, LAMBDA_MAX, SPD_N)
    return np.interp(grid, wl[order], v[order], left=0.0,
                     right=0.0).astype(np.float32)


def eval_spd(table: torch.Tensor, wl: Vec3) -> Vec3:
    """A [SPD_N] grid SPD interpolated linearly at the three wavelengths
    (JAX's one-hot compare-sum picks one nonzero term: a gather here)."""
    step = LAMBDA_RANGE / (SPD_N - 1)

    def interp(lmb):
        x = torch.clamp((lmb - LAMBDA_MIN) / step, 0.0, SPD_N - 1 - 1e-4)
        i0 = x.to(torch.int32)
        f = x - i0
        i0 = i0.long()
        return table[i0] * (1.0 - f) + table[i0 + 1] * f

    return Vec3(interp(wl.x), interp(wl.y), interp(wl.z))


def blackbody_spd(temperature: float) -> np.ndarray:
    """Planck's law on the shared grid, scaled to a peak of 1."""
    grid = np.linspace(LAMBDA_MIN, LAMBDA_MAX, SPD_N) * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    p = (2 * h * c ** 2) / grid ** 5 / np.expm1(h * c / (grid * kb *
                                                         temperature))
    return (p / p.max()).astype(np.float32)


def d65_spd() -> np.ndarray:
    """CIE D65 (its 10 nm table, 380-760 nm, over 100) on the shared
    grid."""
    data = np.array(
        [49.98, 54.65, 82.75, 91.49, 93.43, 86.68, 104.87, 117.01, 117.81,
         114.86, 115.92, 108.81, 109.35, 107.80, 104.79, 107.69, 104.41,
         104.05, 100.00, 96.33, 95.79, 88.69, 90.01, 89.60, 87.70, 83.29,
         83.70, 80.03, 80.21, 82.28, 78.28, 69.72, 71.61, 74.35, 61.60,
         69.89, 75.09, 63.59, 46.42], np.float64)
    wl = np.arange(380.0, 770.0, 10.0)
    return resample_spd(wl, data / 100.0)
