"""RRTMG-LW no-scattering radiative transfer with McICA clouds (rtrnmc),
plain PyTorch.

Port of geosradiation_gridcomp_tpu/models/rrtmg/rtrnmc.py: exact exp/tfn
instead of the reference's lookup tables, a TOA->surface down sweep and a
surface->TOA up sweep as loops over layers with (column, g-point) batched,
and the clear/total stream divergence as a cumulative-OR mask.

Vertical ordering: TOA first (index 0 = top layer), levels [0] = TOA.
"""

import numpy as np
import torch

from .tables_lw import NG_LW

_WTDIFF = 0.5
_FLUXFAC = np.pi * 2.0e4
_WAVENUM1 = np.array([10., 350., 500., 630., 700., 820., 980., 1080.,
                      1180., 1390., 1480., 1800., 2080., 2250., 2380., 2600.])
_WAVENUM2 = np.array([350., 500., 630., 700., 820., 980., 1080., 1180.,
                      1390., 1480., 1800., 2080., 2250., 2380., 2600., 3250.])
_DELWAVE = _WAVENUM2 - _WAVENUM1
NGB = np.repeat(np.arange(16), NG_LW)
# band width weight per g-point, float32 (W/m^2 per unit radiance)
DELWAVE_G = (_WTDIFF * _DELWAVE * _FLUXFAC)[NGB].astype(np.float32)

# variable diffusivity-angle coefficients (rtrnmc.F90:131-146)
_A0 = np.array([1.66, 1.55, 1.58, 1.66, 1.54, 1.454, 1.89, 1.33,
                1.668, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66], np.float32)
_A1 = np.array([0.00, 0.25, 0.22, 0.00, 0.13, 0.446, -0.10, 0.40,
                -0.006, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00], np.float32)
_A2 = np.array([0.00, -12.0, -11.7, 0.00, -0.72, -0.243, 0.19, -0.062,
                0.414, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00], np.float32)
_VARIABLE_SECDIFF = np.array(
    [False, True, True, False, True, True, True, True, True,
     False, False, False, False, False, False, False])


def secdiff_band(pwvcm):
    """Diffusivity secant per column and band, [ncol, 16]."""
    t = lambda a: torch.as_tensor(a, device=pwvcm.device)
    var = t(_VARIABLE_SECDIFF)[None, :]
    sec = torch.clamp(t(_A0)[None, :] + t(_A1)[None, :]
                      * torch.exp(t(_A2)[None, :] * pwvcm[:, None]),
                      1.5, 1.8)
    return torch.where(var, sec, torch.full_like(sec, 1.66))


def _tfn(tau, tr):
    """Linear-in-tau Planck transition function, exact; series form below
    the reference's 0.06 switch. tr = exp(-tau)."""
    safe_tau = torch.clamp(tau, min=1e-9)
    direct = 1.0 - 2.0 * (1.0 / safe_tau - tr / torch.clamp(1.0 - tr,
                                                           min=1e-12))
    return torch.where(tau < 0.06, tau / 6.0, direct)


def rtrnmc(semiss, taug, pfracs, cloudy, taucmc, planklay, planklev,
           plankbnd, dplankbnd_dts, pwvcm, dudts=True):
    """LW fluxes via diffusivity-angle RT.

    Shapes (TOA-first):
      semiss [ncol, 16]; taug, pfracs, taucmc [ncol, nlay, ngpt];
      cloudy [ncol, nlay] bool; planklay [ncol, nlay, 16];
      planklev [ncol, nlay+1, 16]; plankbnd, dplankbnd_dts [ncol, 16];
      pwvcm [ncol].

    Returns dict of [ncol, nlay+1] fluxes (W/m^2, TOA-first, positive):
    uflx, dflx, uflxc, dflxc, (duflx_dts, duflxc_dts if dudts), and
    [ncol, 16] band olrb (and dolrb_dts if dudts).
    """
    ncol, nlay, ngpt = taug.shape
    ngb = torch.as_tensor(NGB, device=taug.device)
    delwave_g = torch.as_tensor(DELWAVE_G, device=taug.device)
    secdiff = secdiff_band(pwvcm)[:, ngb][:, None, :]      # [ncol, 1, ngpt]

    blay = planklay[:, :, ngb]
    dplankup = planklev[:, :-1, :][:, :, ngb] - blay
    dplankdn = planklev[:, 1:, :][:, :, ngb] - blay

    odepth = torch.clamp(secdiff * taug, min=0.0)
    odtot = odepth + secdiff * taucmc
    trgas = torch.exp(-odepth)
    trtot = torch.exp(-odtot)
    agas = 1.0 - trgas
    atot = 1.0 - trtot
    tfacgas = _tfn(odepth, trgas)
    tfactot = _tfn(odtot, trtot)
    del trgas, trtot

    cld = taucmc > 0.0
    a_eff = torch.where(cld, atot, agas)
    bbdgas = pfracs * (blay + tfacgas * dplankdn)
    bbd_eff = torch.where(cld, pfracs * (blay + tfactot * dplankdn), bbdgas)
    bbugas = pfracs * (blay + tfacgas * dplankup)
    bbu_eff = torch.where(cld, pfracs * (blay + tfactot * dplankup), bbugas)
    del atot, tfacgas, tfactot, dplankup, dplankdn, blay

    # divergence mask: once a layer at or above is cloudy
    diverged = torch.cumsum(cloudy.to(torch.int32), dim=1) > 0

    # ---- downward sweep (TOA -> surface) ----
    radld_lev = taug.new_zeros((nlay + 1, ncol, ngpt))
    radclrd_lev = taug.new_zeros((nlay + 1, ncol, ngpt))
    radld = radclrd = taug.new_zeros((ncol, ngpt))
    for l in range(nlay):
        radld_n = radld + (bbd_eff[:, l] - radld) * a_eff[:, l]
        radclrd = torch.where(
            diverged[:, l, None],
            radclrd + (bbdgas[:, l] - radclrd) * agas[:, l], radld_n)
        radld = radld_n
        radld_lev[l + 1] = radld
        radclrd_lev[l + 1] = radclrd

    # ---- surface ----
    pf_sfc = pfracs[:, -1, :]
    rad0 = pf_sfc * plankbnd[:, ngb]
    reflect = (1.0 - semiss)[:, ngb]
    radlu = rad0 + reflect * radld
    radclru = rad0 + reflect * radclrd
    dlu = dclru = pf_sfc * dplankbnd_dts[:, ngb]

    # ---- upward sweep (surface -> TOA) ----
    # the divergence flag is not updated upward: it is the column's final
    # "any layer cloudy" (rtrnmc.F90:344-352)
    div_any = diverged[:, -1, None]
    radlu_lev = taug.new_empty((nlay + 1, ncol, ngpt))
    radclru_lev = taug.new_empty((nlay + 1, ncol, ngpt))
    dlu_lev = taug.new_empty((nlay + 1, ncol, ngpt))
    dclru_lev = taug.new_empty((nlay + 1, ncol, ngpt))
    radlu_lev[nlay], radclru_lev[nlay] = radlu, radclru
    dlu_lev[nlay], dclru_lev[nlay] = dlu, dclru
    for l in range(nlay - 1, -1, -1):
        a = a_eff[:, l]
        ag = agas[:, l]
        radlu_n = radlu + (bbu_eff[:, l] - radlu) * a
        dlu_n = dlu * (1.0 - a)
        radclru = torch.where(div_any,
                              radclru + (bbugas[:, l] - radclru) * ag,
                              radlu_n)
        dclru = torch.where(div_any, dclru * (1.0 - ag), dlu_n)
        radlu, dlu = radlu_n, dlu_n
        radlu_lev[l], radclru_lev[l] = radlu, radclru
        dlu_lev[l], dclru_lev[l] = dlu, dclru

    def flux(lev):
        return torch.einsum("lcg,g->cl", lev, delwave_g)

    def band_sum(x):
        return x.new_zeros((ncol, 16)).index_add_(1, ngb, x * delwave_g)

    out = dict(uflx=flux(radlu_lev), dflx=flux(radld_lev),
               uflxc=flux(radclru_lev), dflxc=flux(radclrd_lev),
               olrb=band_sum(radlu_lev[0]))
    if dudts:
        out["duflx_dts"] = flux(dlu_lev)
        out["duflxc_dts"] = flux(dclru_lev)
        out["dolrb_dts"] = band_sum(dlu_lev[0])
    return out
