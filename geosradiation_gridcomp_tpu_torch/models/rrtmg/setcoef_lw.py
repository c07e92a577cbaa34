"""RRTMG-LW setcoef: interpolation indices/fractions and Planck functions.

Port of geosradiation_gridcomp_tpu/models/rrtmg/setcoef_lw.py (gather form
of the Planck interpolation) for batched [ncol, nlay] tensors. The
troposphere/stratosphere split is the boolean mask `lower`.
"""

from typing import NamedTuple

import torch

from ...constants import GRAV, AVOGAD, AMD, AMW
from ...kernels.twins import use_kernel
from . import lw_rows_cuda

_STPFAC = 296.0 / 1013.0


class LWCoefs(NamedTuple):
    """Per-layer interpolation state (all [..., nlay] unless noted)."""
    lower: torch.Tensor          # bool: pavel > ~95.6 hPa
    jp: torch.Tensor             # int32, 1-based as in the reference
    jt: torch.Tensor
    jt1: torch.Tensor
    fac00: torch.Tensor
    fac01: torch.Tensor
    fac10: torch.Tensor
    fac11: torch.Tensor
    selffac: torch.Tensor
    selffrac: torch.Tensor
    indself: torch.Tensor
    forfac: torch.Tensor
    forfrac: torch.Tensor
    indfor: torch.Tensor
    minorfrac: torch.Tensor
    indminor: torch.Tensor
    scaleminor: torch.Tensor
    scaleminorn2: torch.Tensor
    coldry: torch.Tensor
    colbrd: torch.Tensor
    colh2o: torch.Tensor
    colco2: torch.Tensor
    colo3: torch.Tensor
    coln2o: torch.Tensor
    colch4: torch.Tensor
    colo2: torch.Tensor
    colco: torch.Tensor
    colcfc11: torch.Tensor
    colcfc12: torch.Tensor
    colcfc22: torch.Tensor
    colccl4: torch.Tensor
    pavel: torch.Tensor
    pwvcm: torch.Tensor          # [...]: precipitable water (cm)
    plankbnd: torch.Tensor       # [..., nbnd]
    dplankbnd_dts: torch.Tensor  # [..., nbnd]
    planklay: torch.Tensor       # [..., nlay, nbnd]
    planklev: torch.Tensor       # [..., nlay+1, nbnd]


def _i32(x):
    return x.to(torch.int32)


def _planck_interp(table, t):
    """Linear interpolation of a totplnk-style (181, nbnd) table at T [K]."""
    ind = torch.clamp(torch.floor(t - 159.0).to(torch.int64), 1, 180)
    frac = t - 159.0 - ind.to(t.dtype)
    lo = table[ind - 1]
    return lo + frac[..., None] * (table[ind] - lo)


def planck_rows_plain(tavel, tz, tbound, semiss, tables, dudts=True):
    """The Planck rows (plankbnd, dplankbnd, planklay, planklev) of
    setcoef_lw: plain twin of kernel K9's Planck launch
    (lw_rows_cuda.planck_rows). dplankbnd is zeros unless dudts."""
    totplnk = tables["totplnk"]
    plankbnd = semiss * _planck_interp(totplnk, tbound)
    dplankbnd = semiss * _planck_interp(tables["totplnkderiv"], tbound) \
        if dudts else torch.zeros_like(plankbnd)
    planklay = _planck_interp(totplnk, tavel)
    planklev = _planck_interp(totplnk, tz)
    return plankbnd, dplankbnd, planklay, planklev


def setcoef_lw(pavel, tavel, pz, tz, tbound, semiss,
               h2ovmr, o3vmr, co2vmr, ch4vmr, n2ovmr, o2vmr, covmr,
               cfc11vmr, cfc12vmr, cfc22vmr, ccl4vmr, tables, dudts=True):
    """Compute LWCoefs.

    pavel/tavel: [..., nlay] layer p [hPa] / T [K].
    pz/tz: [..., nlay+1] level p/T in one consistent order.
    tbound: [...] surface temperature; semiss: [..., 16].
    Gas vmrs: [..., nlay].
    tables: dict with preflog (59,), tref (59,), totplnk and
    totplnkderiv (181, 16) float32 tensors.

    The Planck rows come from kernel K9 (lw_rows_cuda.planck_rows) where
    kernels.twins.use_kernel, the same values bit for bit; otherwise from
    planck_rows_plain, its twin.
    """
    dtype = pavel.dtype
    preflog = tables["preflog"]
    tref = tables["tref"]
    zero = torch.zeros((), dtype=dtype, device=pavel.device)

    amm = (1.0 - h2ovmr) * AMD + h2ovmr * AMW
    dpz = torch.abs(pz[..., :-1] - pz[..., 1:])
    coldry = dpz * 1.0e3 * AVOGAD / (1.0e2 * GRAV * amm * (1.0 + h2ovmr))

    summol = co2vmr + o3vmr + n2ovmr + ch4vmr + o2vmr
    wbroad = coldry * (1.0 - summol)
    wv_mol = h2ovmr * coldry
    amttl = torch.sum(coldry + wv_mol, dim=-1)
    wvttl = torch.sum(wv_mol, dim=-1)
    wvsh = (AMW * wvttl) / (AMD * amttl)
    psfc = torch.maximum(pz[..., 0], pz[..., -1])
    pwvcm = wvsh * (1.0e3 * psfc) / (1.0e2 * GRAV)

    if use_kernel(tavel):
        plankbnd, dplankbnd, planklay, planklev = lw_rows_cuda.planck_rows(
            tavel.contiguous(), tz.contiguous(), tbound.contiguous(),
            semiss.contiguous(), tables["totplnk"], tables["totplnkderiv"],
            dudts)
    else:
        plankbnd, dplankbnd, planklay, planklev = planck_rows_plain(
            tavel, tz, tbound, semiss, tables, dudts)

    plog = torch.log(pavel)
    jp = torch.clamp(torch.floor(36.0 - 5.0 * (plog + 0.04)).to(torch.int64),
                     1, 58)
    fp = 5.0 * (preflog[jp - 1] - plog)
    tj = (tavel - tref[jp - 1]) / 15.0
    jt = torch.clamp(torch.floor(3.0 + tj).to(torch.int64), 1, 4)
    ft = tj - (jt - 3).to(dtype)
    tj1 = (tavel - tref[jp]) / 15.0
    jt1 = torch.clamp(torch.floor(3.0 + tj1).to(torch.int64), 1, 4)
    ft1 = tj1 - (jt1 - 3).to(dtype)

    lower = plog > 4.56

    water = h2ovmr
    scalefac = pavel * _STPFAC / tavel
    forfac = scalefac / (1.0 + water)

    # foreign continuum index (lower: 1-2; upper: fixed 3)
    fac_lo = (332.0 - tavel) / 36.0
    indfor_lo = torch.clamp(torch.floor(fac_lo).to(torch.int64), 1, 2)
    forfrac_lo = fac_lo - indfor_lo.to(dtype)
    fac_up = (tavel - 188.0) / 36.0
    indfor = torch.where(lower, indfor_lo, 3)
    forfrac = torch.where(lower, forfrac_lo, fac_up - 1.0)

    # self continuum (lower only)
    fac_s = (tavel - 188.0) / 7.2
    indself = torch.clamp(torch.floor(fac_s).to(torch.int64) - 7, 1, 9)
    selffrac = fac_s - (indself + 7).to(dtype)
    selffac = torch.where(lower, water * forfac, zero)

    scaleminor = pavel / tavel
    scaleminorn2 = scaleminor * (wbroad / (coldry + wv_mol))
    fac_m = (tavel - 180.8) / 7.2
    indminor = torch.clamp(torch.floor(fac_m).to(torch.int64), 1, 18)
    minorfrac = fac_m - indminor.to(dtype)

    def col(vmr):
        return 1.0e-20 * vmr * coldry

    def col_floor(vmr):
        c = col(vmr)
        return torch.where(c == 0.0, 1.0e-32 * coldry, c)

    colh2o = col(h2ovmr)
    compfp = 1.0 - fp
    return LWCoefs(
        lower=lower, jp=_i32(jp), jt=_i32(jt), jt1=_i32(jt1),
        fac00=compfp * (1.0 - ft), fac01=fp * (1.0 - ft1),
        fac10=compfp * ft, fac11=fp * ft1,
        selffac=colh2o * selffac, selffrac=selffrac, indself=_i32(indself),
        forfac=colh2o * forfac, forfrac=forfrac, indfor=_i32(indfor),
        minorfrac=minorfrac, indminor=_i32(indminor),
        scaleminor=scaleminor, scaleminorn2=scaleminorn2,
        coldry=coldry, colbrd=1.0e-20 * wbroad,
        colh2o=colh2o, colco2=col_floor(co2vmr), colo3=col_floor(o3vmr),
        coln2o=col_floor(n2ovmr), colch4=col_floor(ch4vmr),
        colo2=col(o2vmr), colco=col_floor(covmr),
        colcfc11=col(cfc11vmr), colcfc12=col(cfc12vmr),
        colcfc22=col(cfc22vmr), colccl4=col(ccl4vmr),
        pavel=pavel, pwvcm=pwvcm,
        plankbnd=plankbnd, dplankbnd_dts=dplankbnd,
        planklay=planklay, planklev=planklev)
