"""RRTMG-LW McICA cloud optical depths (cldprmc), plain PyTorch.

Port of the gather branch of geosradiation_gridcomp_tpu/models/rrtmg/
cldprmc_lw.py: per-g-point absorption-only cloud optical depth from
in-cloud ice/liquid water paths and particle sizes. Ice: 0 constant,
1 Ebert-Curry 5-band, 2 Key, 3 Fu (1998), 4 extended table; liquid: Hu &
Stamnes (1993).

The tables come from `lw_cloud_tables` (or the RRTMGLW module's buffers):
a dict with absice0 (2,), absice1 (2, 5), absice2/3/4 (n, 16) and
absliq1 (58, 16).
"""

import numpy as np
import torch

from ...tables import load
from .tables_lw import NG_LW

# band -> 5-band index for iceflag==1 (rrlw_cld.F90:21-22)
_ICE1B = np.array([1, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5]) - 1
# g-point -> band (0-based)
NGB = np.repeat(np.arange(16), NG_LW)

CLOUD_TABLE_KEYS = ("absice0", "absice1", "absice2", "absice3", "absice4",
                    "absliq1")


def lw_cloud_tables(device="cuda"):
    """The rrtmg_lw_cld tables as float32 tensors on device."""
    t = load("rrtmg_lw_cld")
    return {k: torch.as_tensor(t[k], device=device) for k in CLOUD_TABLE_KEYS}


def _interp_rows(tab, index, fint):
    """tab (n, nb); index (1-based) / fint [...] -> [..., nb]."""
    lo = tab[index - 1]
    hi = tab[index]
    return lo + fint[..., None] * (hi - lo)


def band_abs_coeffs_lw(reice, reliq, tables, iceflag=3, liqflag=1):
    """Per-band mass-absorption coefficients [m^2/g] from particle sizes.

    reice/reliq [..., nlay] microns -> (absice [..., nlay, 16],
    absliq [..., nlay, 16]).
    """
    if iceflag == 0:
        a = tables["absice0"]
        absice = (a[0] + a[1] / torch.clamp(reice, min=1e-6))[..., None] \
            .expand(reice.shape + (16,))
    elif iceflag == 1:
        a = tables["absice1"]
        ice1b = torch.as_tensor(_ICE1B, device=reice.device)
        absice = a[0][ice1b] + a[1][ice1b] \
            / torch.clamp(reice, min=1e-6)[..., None]
    else:
        tab = tables[{2: "absice2", 3: "absice3", 4: "absice4"}[iceflag]]
        n = tab.shape[0]
        factor = (reice - 2.0) / 3.0
        index = torch.clamp(torch.floor(factor).to(torch.int64), 1, n - 1)
        fint = factor - index.to(reice.dtype)
        absice = _interp_rows(tab, index, fint)
    if liqflag != 1:
        raise NotImplementedError("only liqflag=1 (Hu & Stamnes) exists")
    tabl = tables["absliq1"]
    nl = tabl.shape[0]
    factor = reliq - 1.5
    index = torch.clamp(torch.floor(factor).to(torch.int64), 1, nl - 1)
    fint = factor - index.to(reliq.dtype)
    absliq = _interp_rows(tabl, index, fint)
    return absice, absliq


def cldprmc_from_band_coeffs(cldymc, ciwpmc, clwpmc, absice, absliq):
    """Cloud optical depth per g-point from per-band coefficients.

    cldymc, ciwpmc, clwpmc: [ncol, ngpt, nlay]; absice/absliq
    [ncol, nlay, 16]. Returns (taucmc [ncol, ngpt, nlay],
    cloudy [ncol, nlay] bool).
    """
    ngb = torch.as_tensor(NGB, device=absice.device)
    absice_g = absice[..., ngb].transpose(-1, -2)
    absliq_g = absliq[..., ngb].transpose(-1, -2)
    zero = torch.zeros((), dtype=ciwpmc.dtype, device=ciwpmc.device)
    tau_ice = torch.where(cldymc & (ciwpmc > 0.0), ciwpmc * absice_g, zero)
    tau_liq = torch.where(cldymc & (clwpmc > 0.0), clwpmc * absliq_g, zero)
    taucmc = tau_ice + tau_liq
    cloudy = (taucmc > 0.0).any(dim=-2)
    return taucmc, cloudy


def cldprmc_lw(cldymc, ciwpmc, clwpmc, reice, reliq, tables, iceflag=3,
               liqflag=1):
    """Cloud optical depth per g-point.

    cldymc: [ncol, ngpt, nlay] bool; ciwpmc/clwpmc same shape (g/m^2);
    reice/reliq: [ncol, nlay] microns.

    Returns (taucmc [ncol, ngpt, nlay], cloudy [ncol, nlay] bool).
    """
    absice, absliq = band_abs_coeffs_lw(reice, reliq, tables,
                                        iceflag=iceflag, liqflag=liqflag)
    return cldprmc_from_band_coeffs(cldymc, ciwpmc, clwpmc, absice, absliq)
