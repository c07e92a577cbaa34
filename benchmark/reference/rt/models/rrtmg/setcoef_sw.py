"""RRTMG-SW setcoef: interpolation indices, fractions and column amounts.

Port of geosradiation_gridcomp_tpu/models/rrtmg/setcoef_sw.py for batched
[ncol, nlay] tensors; the troposphere/stratosphere split is the boolean
mask `lower`, as in setcoef_lw.
"""

from typing import NamedTuple

import torch

from ...constants import AMD, AMW, AVOGAD, GRAV

_STPFAC = 296.0 / 1013.0


class SWCoefs(NamedTuple):
    """Per-layer interpolation state (all [..., nlay])."""
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
    coldry: torch.Tensor
    colh2o: torch.Tensor
    colco2: torch.Tensor
    colo3: torch.Tensor
    colch4: torch.Tensor
    colo2: torch.Tensor
    colmol: torch.Tensor
    pavel: torch.Tensor


def _i32(x):
    return x.to(torch.int32)


def setcoef_sw(pavel, tavel, pz, h2ovmr, o3vmr, co2vmr, ch4vmr, o2vmr,
               tables):
    """pavel/tavel [..., nlay] (hPa, K); pz [..., nlay+1] (hPa, TOA-first);
    gas vmrs [..., nlay]; tables: dict with the preflog (59,) and
    tref (59,) float32 tensors of the SW reference profile."""
    dtype = pavel.dtype
    preflog = tables["preflog"]
    tref = tables["tref"]
    zero = torch.zeros((), dtype=dtype, device=pavel.device)

    amm = (1.0 - h2ovmr) * AMD + h2ovmr * AMW
    dpz = torch.abs(pz[..., 1:] - pz[..., :-1])
    coldry = dpz * 1.0e3 * AVOGAD / (1.0e2 * GRAV * amm * (1.0 + h2ovmr))

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
    fac_lo = (332.0 - tavel) / 36.0
    indfor_lo = torch.clamp(torch.floor(fac_lo).to(torch.int64), 1, 2)
    forfrac_lo = fac_lo - indfor_lo.to(dtype)
    fac_up = (tavel - 188.0) / 36.0
    indfor = torch.where(lower, indfor_lo, 3)
    forfrac = torch.where(lower, forfrac_lo, fac_up - 1.0)

    fac_s = (tavel - 188.0) / 7.2
    indself = torch.where(
        lower, torch.clamp(torch.floor(fac_s).to(torch.int64) - 7, 1, 9), 1)
    selffrac = torch.where(lower, fac_s - (indself + 7).to(dtype), zero)
    selffac = torch.where(lower, water * forfac, zero)

    colh2o = 1.0e-20 * h2ovmr * coldry
    colmol = 1.0e-20 * coldry + colh2o

    def col_floor(vmr):
        c = 1.0e-20 * vmr * coldry
        return torch.where(c == 0.0, 1.0e-32 * coldry, c)

    compfp = 1.0 - fp
    return SWCoefs(
        lower=lower, jp=_i32(jp), jt=_i32(jt), jt1=_i32(jt1),
        fac00=compfp * (1.0 - ft), fac01=fp * (1.0 - ft1),
        fac10=compfp * ft, fac11=fp * ft1,
        selffac=selffac, selffrac=selffrac, indself=_i32(indself),
        forfac=forfac, forfrac=forfrac, indfor=_i32(indfor),
        coldry=coldry, colh2o=colh2o, colco2=col_floor(co2vmr),
        colo3=1.0e-20 * o3vmr * coldry, colch4=col_floor(ch4vmr),
        colo2=col_floor(o2vmr), colmol=colmol, pavel=pavel)
