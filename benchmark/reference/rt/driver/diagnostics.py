"""LW diagnostic products: band brightness temperatures and RATS forcing.

Port of geosradiation_gridcomp_tpu/driver/diagnostics.py:
  * the narrow-band Planck inversion of band OLR to a brightness
    temperature, GEOS_IrradGridComp.F90:4132-4212;
"""

import numpy as np
import torch

from ..tables import on_device

# RRTMG LW band bounds [cm^-1] (rrlw_wvn wavenum1/2)
LW_WAVENUM1 = np.array([10., 350., 500., 630., 700., 820., 980., 1080.,
                        1180., 1390., 1480., 1800., 2080., 2250., 2380.,
                        2600.])
LW_WAVENUM2 = np.array([350., 500., 630., 700., 820., 980., 1080., 1180.,
                        1390., 1480., 1800., 2080., 2250., 2380., 2600.,
                        3250.])

# fundamental constants (GEOS_IrradGridComp.F90:4146-4153)
_H = 6.626070040e-34   # Planck [J s]
_C = 2.99792458e8      # speed of light [m/s]
_KB = 1.38064852e-23   # Boltzmann [J/K]
_ALT = _H * _C / _KB
_BIGC = 2.0 * _H * _C * _C

# GEOS missing-data marker (MAPL_UNDEF)
UNDEF = 1.0e15

def invert_planck_for_t(b_wn, wn):
    """Temperature whose Planck radiance at wavenumber wn [m^-1] equals
    b_wn [W m^-2 sr^-1 / m^-1]."""
    return _ALT * wn / torch.log1p(_BIGC * wn ** 3 / b_wn)


def _band_midpoints(wavenum1, wavenum2, device, dtype):
    """Mid-point wavenumbers and widths [m^-1] of bands given in cm^-1,
    as tensors on device (copied from the host once per value, device
    and dtype: a copy in every heartbeat's update would synchronise the
    stream)."""
    wn1 = np.asarray(wavenum1) * 100.0
    wn2 = np.asarray(wavenum2) * 100.0
    return (on_device(0.5 * (wn1 + wn2), device, dtype),
            on_device(wn2 - wn1, device, dtype))


def band_brightness_temperature(olrb, wavenum1=None, wavenum2=None):
    """Brightness temperature per LW band from band OLR [W/m^2]: mean
    Planck radiance over the band inverted at the mid-point wavenumber.
    Zero or negative band fluxes map to UNDEF.

    olrb: [..., nband]; returns the same shape [K].
    """
    wn_mid, dwn = _band_midpoints(
        LW_WAVENUM1 if wavenum1 is None else wavenum1,
        LW_WAVENUM2 if wavenum2 is None else wavenum2, olrb.device,
        olrb.dtype)
    bmean = torch.clamp(olrb, min=1e-30) / (np.pi * dwn)
    tbr = invert_planck_for_t(bmean, wn_mid)
    return torch.where(olrb > 0.0, tbr, torch.full_like(tbr, UNDEF))
