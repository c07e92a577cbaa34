"""Solar geometry: zenith angle and insolation averaging.

Port of geosradiation_gridcomp_tpu/driver/astronomy.py: the low-precision
solar ephemeris (declination / equation-of-time Fourier fits, Spencer
1971) and 4-point Gauss-Legendre means of max(cos zenith, 0) over an
interval. Scalars (day of year, UTC hours) are taken to float32 tensors,
so the arithmetic is the float32 sequence the reference's jitted step
runs: a Python float is filled into a scalar on the inputs' device (a
kernel argument, not a copy from host memory), a tensor is used as it is.
"""

import math

import numpy as np
import torch

_GL4_X = np.array([-0.8611363116, -0.3399810436, 0.3399810436, 0.8611363116])
_GL4_W = np.array([0.3478548451, 0.6521451549, 0.6521451549, 0.3478548451])


def float32_scalar(x, like):
    """x (a Python number or a 0-d tensor) as a float32 scalar on like's
    device, rounded as torch.as_tensor rounds it; nothing is copied from
    host memory unless x is a tensor on another device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def declination_eqtime(doy_frac):
    """Solar declination [rad] and equation of time [rad] (Spencer 1971).

    doy_frac: fractional day of year in [0, 366), a float32 tensor.
    """
    g = 2.0 * math.pi * doy_frac / 365.0
    decl = (0.006918 - 0.399912 * torch.cos(g) + 0.070257 * torch.sin(g)
            - 0.006758 * torch.cos(2 * g) + 0.000907 * torch.sin(2 * g)
            - 0.002697 * torch.cos(3 * g) + 0.00148 * torch.sin(3 * g))
    eqt = (0.000075 + 0.001868 * torch.cos(g) - 0.032077 * torch.sin(g)
           - 0.014615 * torch.cos(2 * g) - 0.040849 * torch.sin(2 * g))
    return decl, eqt


def earth_sun_factor(doy_frac):
    """(a/r)^2 inverse-square distance factor (Spencer 1971); doy_frac a
    float32 tensor."""
    g = 2.0 * math.pi * doy_frac / 365.0
    return (1.000110 + 0.034221 * torch.cos(g) + 0.001280 * torch.sin(g)
            + 0.000719 * torch.cos(2 * g) + 0.000077 * torch.sin(2 * g))


def cos_zenith(lon, lat, doy_frac, utc_hours):
    """Instantaneous cosine of solar zenith angle.

    lon/lat [ncol] radians; doy_frac, utc_hours float32 tensors.
    """
    decl, eqt = declination_eqtime(doy_frac)
    hour_angle = (2.0 * math.pi * (utc_hours - 12.0) / 24.0) + lon + eqt
    return (torch.sin(lat) * torch.sin(decl)
            + torch.cos(lat) * torch.cos(decl) * torch.cos(hour_angle))


def mean_cos_zenith(lon, lat, doy_frac, utc_hours, interval_hours):
    """Mean of max(cos zenith, 0) and lit fraction over an interval.

    4-point Gauss-Legendre over [utc_hours, utc_hours + interval_hours].
    Returns (mean_mu0, lit_fraction), each [ncol]; the reference's zenith
    over the lit part is mean_mu0 / lit_fraction.
    """
    doy_frac = float32_scalar(doy_frac, lon)
    utc_hours = float32_scalar(utc_hours, lon)
    half = 0.5 * interval_hours
    mid = utc_hours + half
    mu_acc = lit_acc = 0.0
    for x, w in zip(_GL4_X, _GL4_W):
        t = mid + float(np.float32(half * x))
        mu = cos_zenith(lon, lat, doy_frac + t / 24.0 - utc_hours / 24.0, t)
        mu_acc = mu_acc + float(0.5 * w) * torch.clamp(mu, min=0.0)
        lit_acc = lit_acc + float(0.5 * w) * (mu > 0.0).to(mu.dtype)
    return mu_acc, lit_acc
