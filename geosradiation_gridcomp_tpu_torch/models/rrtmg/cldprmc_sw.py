"""RRTMG-SW McICA cloud optics with delta scaling (cldprmc_sw), plain
PyTorch.

Port of the gather branch of geosradiation_gridcomp_tpu/models/rrtmg/
cldprmc_sw.py: per-band extinction, single-scattering albedo, asymmetry
and forward fraction from particle sizes (ice: 1 Ebert-Curry, 2 Key,
3 Fu with the fdelta table; liquid: Hu & Stamnes with the low-radius
ssa overshoot clamp), then the per-g-point delta-scaled combination of
the two phases. The per-band half (`band_optics_coeffs_sw`) depends only
on (column, layer); the per-g half (`cldprmc_from_band_coeffs_sw`) is
what kernel K2 evaluates in its registers.

The tables come from `sw_cloud_tables` (or the RRTMGSW module's buffers).
"""

import numpy as np
import torch

from geosradiation_gridcomp_tpu.models.rrtmg.tables_sw import NG_SW
from geosradiation_gridcomp_tpu.tables import load

# g-point -> 0-based band
BAND_G = np.repeat(np.arange(14), NG_SW)
_CLDMIN = 1.0e-20

CLOUD_TABLE_KEYS = ("ice1_coeffs", "extice2", "ssaice2", "asyice2",
                    "extice3", "ssaice3", "asyice3", "fdlice3", "extliq1",
                    "ssaliq1", "asyliq1")


def sw_cloud_tables(device=None):
    """The rrtmg_sw_cld tables as float32 tensors on device; the six
    Ebert-Curry coefficients are taken per band (icxa) as ice1_coeffs
    (6, 14)."""
    t = load("rrtmg_sw_cld")
    ib5 = np.asarray(t["icxa"], np.int64) - 1
    out = {k: torch.as_tensor(t[k], device=device)
           for k in CLOUD_TABLE_KEYS[1:]}
    out["ice1_coeffs"] = torch.as_tensor(np.stack(
        [np.asarray(t[k + "bari"], np.float32)[ib5] for k in "abcdef"]),
        device=device)
    return out


def _interp_rows(tab, index, fint):
    """tab (n, 14); index (1-based) / fint [...] -> [..., 14]."""
    lo = tab[index - 1]
    hi = tab[index]
    return lo + fint[..., None] * (hi - lo)


def band_optics_coeffs_sw(reice, reliq, tables, iceflag=3, liqflag=1):
    """Per-band SW cloud-optics coefficients from particle sizes.

    reice/reliq [..., nlay] microns -> 8 planes [..., nlay, 14]:
    (extcoice, ssacoice, gice, forwice, extcoliq, ssacoliq, gliq,
    forwliq), not yet masked by where ice or liquid is present.
    """
    if iceflag == 1:
        a, b, c, d, e, f = tables["ice1_coeffs"]
        re_i = reice[..., None]
        extcoice = a + b / torch.clamp(re_i, min=1e-6)
        ssacoice = 1.0 - c - d * re_i
        gice = torch.clamp(e + f * re_i, max=1.0 - 1e-6)
        forwice = gice * gice
    elif iceflag in (2, 3):
        suff = str(iceflag)
        ext = tables["extice" + suff]
        n = ext.shape[0]
        factor = (reice - 2.0) / 3.0
        index = torch.clamp(torch.floor(factor).to(torch.int64), 1, n - 1)
        fint = factor - index.to(reice.dtype)
        extcoice = _interp_rows(ext, index, fint)
        ssacoice = _interp_rows(tables["ssaice" + suff], index, fint)
        gice = _interp_rows(tables["asyice" + suff], index, fint)
        if iceflag == 3:
            fdelta = _interp_rows(tables["fdlice3"], index, fint)
            forwice = torch.minimum(
                fdelta + 0.5 / torch.clamp(ssacoice, min=1e-12), gice)
        else:
            forwice = gice * gice
    else:
        raise ValueError(f"iceflag {iceflag} does not exist for RRTMG-SW")

    if liqflag != 1:
        raise NotImplementedError("only liqflag=1 (Hu & Stamnes) exists")
    ssal = tables["ssaliq1"]
    nl = ssal.shape[0]
    factor_l = reliq - 1.5
    index_l = torch.clamp(torch.floor(factor_l).to(torch.int64), 1, nl - 1)
    fint_l = factor_l - index_l.to(reliq.dtype)
    extcoliq = _interp_rows(tables["extliq1"], index_l, fint_l)
    ssacoliq = _interp_rows(ssal, index_l, fint_l)
    # clamp the low-radius extrapolation overshoot (cldprmc_sw.F90:230-231)
    ssacoliq = torch.where((fint_l[..., None] < 0.0) & (ssacoliq > 1.0),
                           ssal[index_l - 1], ssacoliq)
    gliq = _interp_rows(tables["asyliq1"], index_l, fint_l)
    forwliq = gliq * gliq
    return (extcoice, ssacoice, gice, forwice,
            extcoliq, ssacoliq, gliq, forwliq)


def cldprmc_from_band_coeffs_sw(cldymc, ciwpmc, clwpmc, coeffs):
    """Delta-scaled cloud optics per g-point from the 8 band planes.

    cldymc [..., ngpt, nlay] bool; ciwpmc/clwpmc same shape (g/m^2);
    coeffs: the 8 planes of band_optics_coeffs_sw, [..., nlay, 14].
    Returns (taucmc, ssacmc, asmcmc, taormc), each [..., ngpt, nlay].
    """
    band_g = torch.as_tensor(BAND_G, device=ciwpmc.device)
    (extcoice, ssacoice, gice, forwice,
     extcoliq, ssacoliq, gliq, forwliq) = (
        x[..., band_g].transpose(-1, -2) for x in coeffs)
    zero = torch.zeros((), dtype=ciwpmc.dtype, device=ciwpmc.device)

    has_ice = cldymc & (ciwpmc > 0.0)
    extcoice, ssacoice, gice, forwice = (
        torch.where(has_ice, x, zero)
        for x in (extcoice, ssacoice, gice, forwice))
    has_liq = cldymc & (clwpmc > 0.0)
    extcoliq, ssacoliq, gliq, forwliq = (
        torch.where(has_liq, x, zero)
        for x in (extcoliq, ssacoliq, gliq, forwliq))

    tauliqorig = clwpmc * extcoliq
    tauiceorig = ciwpmc * extcoice
    taormc = tauliqorig + tauiceorig

    denl = 1.0 - forwliq * ssacoliq
    deni = 1.0 - forwice * ssacoice
    ssaliq = ssacoliq * (1.0 - forwliq) / torch.clamp(denl, min=1e-12)
    ssaice = ssacoice * (1.0 - forwice) / torch.clamp(deni, min=1e-12)
    tauliq = denl * tauliqorig
    tauice = deni * tauiceorig
    scatliq = ssaliq * tauliq
    scatice = torch.maximum(ssaice * tauice,
                            torch.where(has_ice | has_liq, _CLDMIN, zero))
    taucmc = tauliq + tauice
    taucmc = torch.where(cldymc & (taucmc == 0.0), _CLDMIN, taucmc)
    ssacmc = torch.where(
        cldymc, (scatliq + scatice) / torch.clamp(taucmc, min=_CLDMIN),
        torch.ones((), dtype=zero.dtype, device=zero.device))

    gl_d = (gliq - forwliq) / torch.clamp(1.0 - forwliq, min=1e-12)
    gi_d = (gice - forwice) / torch.clamp(1.0 - forwice, min=1e-12)
    scat_tot = torch.clamp(scatliq + scatice, min=1e-30)
    asmcmc = torch.where(cldymc, (scatliq * gl_d + scatice * gi_d) / scat_tot,
                         zero)
    taucmc = torch.where(cldymc, taucmc, zero)
    taormc = torch.where(cldymc, taormc, zero)
    return taucmc, ssacmc, asmcmc, taormc


def cldprmc_sw(cldymc, ciwpmc, clwpmc, reice, reliq, tables, iceflag=3,
               liqflag=1):
    """Returns (taucmc, ssacmc, asmcmc, taormc), each [..., ngpt, nlay].

    cldymc: [..., ngpt, nlay] bool; ciwpmc/clwpmc g/m^2; reice/reliq
    [..., nlay] microns.
    """
    coeffs = band_optics_coeffs_sw(reice, reliq, tables, iceflag=iceflag,
                                   liqflag=liqflag)
    return cldprmc_from_band_coeffs_sw(cldymc, ciwpmc, clwpmc, coeffs)
