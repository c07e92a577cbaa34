"""NRLSSI2 solar-variability model for RRTMG-SW.

Re-derivation of the GEOS NRLSSI2 module
(rrtmg_sw/gcm_model/src/NRLSSI2.F90:1-334) and the isolvar dispatch in
rrtmg_sw_rad.F90:880-1120. The spectral solar irradiance is modeled as

    SSI(g, t) = svar_i * Irradnce(g) + svar_f(t) * Facbrght(g)
              + svar_s(t) * Snsptdrk(g)

where the facular (Mg "Bremen" index) and sunspot (SB "SPOT67" index)
multipliers are linear in the indices, themselves read off an idealized
11-year mean solar cycle ("AvgCyc11", 134-point tables).

TPU-native design: all isolvar modes reduce to STATIC per-band weights
(w_ref, w_fac, w_sns, w_irr) applied to the four per-g-point source
tables (sfluxref / facbrght / snsptdrk / irradnce). The weights are
computed host-side in numpy from the static config, and taumol folds
them into one effective solar-source table per band at trace time, so
solar variability costs nothing at run time.

Modes (rrtmg_sw_rad.F90:968-1112):
  isolvar = -1  constant Kurucz sun, scon scaling (+ optional bndscl)
  isolvar =  0  constant NRLSSI2 mean sun
  isolvar =  1  mean cycle at solcycfrac, optional indsolvar amplitude
                scaling (unity at cycle min, indsolvar at cycle max)
  isolvar =  2  Mg/SB indices specified directly via indsolvar
  isolvar =  3  mean NRLSSI2 sun with per-band scaling (bndscl)
scon = 0 selects the scheme-internal solar constant (1368.22 Kurucz /
1360.85 NRLSSI2); scon > 0 rescales as in the reference.

The port's copy of geosradiation_gridcomp_tpu/models/rrtmg/nrlssi2.py,
function for function (numpy only; the weights are folded into the solar
source tables on the host).
"""

from typing import NamedTuple, Optional, Sequence

import numpy as np

from .tables_sw import NBNDSW

# spectrally integrated contributions to TSI (NRLSSI2.F90:48-51)
IINT = 1360.37        # mean quiet sun
FINT = 0.996047       # mean facular brightening
SINT = -0.511590      # mean sunspot dimming
MEAN_TSI = IINT + FINT + SINT   # 1360.85, the NRLSSI2 mean solar constant
KURUCZ_SCON = 1368.22           # rrsw_con solar constant

# index statistics over AvgCyc11 (NRLSSI2.F90:122-128)
MG_AVG = 0.1567652
SB_AVG = 909.71260
MG_0 = 0.14959542
SB_0 = 0.00066696

# timing of minimum/maximum within the mean cycle (NRLSSI2.F90:245-248)
SOLCYCFRAC_MIN = 0.0189
SOLCYCFRAC_MAX = 0.3750

_NSOLFRAC = 134
_INTRVL = 1.0 / (_NSOLFRAC - 2)


def _avgcyc_tables():
    from ...tables import load64
    d = load64("nrlssi2")
    return np.asarray(d["mgavgcyc"], np.float64), \
        np.asarray(d["sbavgcyc"], np.float64)


def adjust_solcyc_amplitudes(solcycfrac: float,
                             indsolvar: Sequence[float]) -> np.ndarray:
    """Amplitude scale factors: unity at solar min, indsolvar at solar max,
    linear in between (NRLSSI2.F90:233-272)."""
    f = float(solcycfrac)
    ind = np.asarray(indsolvar, np.float64)
    if not 0.0 <= f <= 1.0:
        raise ValueError("solcycfrac must be in [0, 1]")
    d_min2max = SOLCYCFRAC_MAX - SOLCYCFRAC_MIN
    d_max2min = 1.0 - d_min2max
    if f < SOLCYCFRAC_MIN:
        wgt = (f + 1.0 - SOLCYCFRAC_MAX) / d_max2min
        return ind + wgt * (1.0 - ind)
    if f <= SOLCYCFRAC_MAX:
        wgt = (f - SOLCYCFRAC_MIN) / d_min2max
        return 1.0 + wgt * (ind - 1.0)
    wgt = (f - SOLCYCFRAC_MAX) / d_max2min
    return ind + wgt * (1.0 - ind)


def interpolate_indices(solcycfrac: float):
    """Mg and SB indices at a fractional position in AvgCyc11
    (NRLSSI2.F90:275-331): 132 mid-month interior points plus matched
    half-interval endpoints."""
    mg, sb = _avgcyc_tables()
    f = float(solcycfrac)
    if not 0.0 <= f <= 1.0:
        raise ValueError("solcycfrac must be in [0, 1]")
    half = 0.5 * _INTRVL
    if f == 0.0:
        return float(mg[0]), float(sb[0])
    if f == 1.0:
        return float(mg[-1]), float(sb[-1])
    if f <= half:
        sfid, lo, hi = 0, 0.0, half
    elif f < 1.0 - half:
        sfid = int(np.floor((f - half) * (_NSOLFRAC - 2))) + 1
        lo = (sfid - 1) * _INTRVL + half
        hi = lo + _INTRVL
    else:
        sfid, lo, hi = _NSOLFRAC - 2, 1.0 - half, 1.0
    w = (f - lo) / (hi - lo)
    return (float(mg[sfid] + w * (mg[sfid + 1] - mg[sfid])),
            float(sb[sfid] + w * (sb[sfid + 1] - sb[sfid])))


def _isolvar1_mean_svars(indsolvar):
    """Cycle means <svar_f>, <svar_s> including the linearly-varying
    amplitude scaling (initialize_NRLSSI2, NRLSSI2.F90:160-225)."""
    mg, sb = _avgcyc_tables()
    ind = np.asarray(indsolvar, np.float64)
    mean_f, mean_s = 1.0, 1.0
    scl1, scl2 = ind[0] != 1.0, ind[1] != 1.0
    if scl1 or scl2:
        iscl_mean = (1.0 + ind) / 2.0
        mg_m, sb_m = 0.0, 0.0
        f = 0.5 * _INTRVL
        for n in range(1, _NSOLFRAC - 1):
            scl = adjust_solcyc_amplitudes(f, ind)
            mg_m += scl[0] * mg[n]
            sb_m += scl[1] * sb[n]
            f += _INTRVL
        mg_m /= _NSOLFRAC - 2
        sb_m /= _NSOLFRAC - 2
        if scl1:
            mean_f = (mg_m - iscl_mean[0] * MG_0) / (MG_AVG - MG_0)
        if scl2:
            mean_s = (sb_m - iscl_mean[1] * SB_0) / (SB_AVG - SB_0)
    return mean_f, mean_s


class SolarVarWeights(NamedTuple):
    """Static per-band weights on the four solar-source tables."""
    w_ref: np.ndarray   # [14] weight on sfluxref (Kurucz)
    w_fac: np.ndarray   # [14] weight on facbrght
    w_sns: np.ndarray   # [14] weight on snsptdrk
    w_irr: np.ndarray   # [14] weight on irradnce


def solar_source_weights(isolvar: int = -1, scon: float = 0.0,
                         solcycfrac: Optional[float] = None,
                         indsolvar: Optional[Sequence[float]] = None,
                         bndscl: Optional[Sequence[float]] = None
                         ) -> SolarVarWeights:
    """Per-band solar-source weights for the selected isolvar mode
    (rrtmg_sw_rad.F90:968-1112). scon=0 keeps the scheme-internal solar
    constant. Host-side numpy; feeds jit as static constants."""
    nb = NBNDSW
    ones = np.ones(nb)
    zeros = np.zeros(nb)
    bscl = ones if bndscl is None else np.asarray(bndscl, np.float64)
    if bscl.shape != (nb,):
        raise ValueError(f"bndscl must have shape ({nb},)")
    if scon < 0.0:
        raise ValueError("scon cannot be negative")

    if isolvar == -1:
        solvar = bscl if scon == 0.0 else (scon / KURUCZ_SCON) * bscl
        return SolarVarWeights(solvar, zeros, zeros, zeros)

    if isolvar == 0:
        r = 1.0 if scon == 0.0 else scon / MEAN_TSI
        return SolarVarWeights(zeros, r * ones, r * ones, r * ones)

    if isolvar == 1:
        if solcycfrac is None:
            raise ValueError("isolvar=1 requires solcycfrac")
        ind = np.ones(2) if indsolvar is None \
            else np.asarray(indsolvar, np.float64)
        scl = adjust_solcyc_amplitudes(solcycfrac, ind) \
            if (ind != 1.0).any() else np.ones(2)
        mg_now, sb_now = interpolate_indices(solcycfrac)
        svar_f = scl[0] * (mg_now - MG_0) / (MG_AVG - MG_0)
        svar_s = scl[1] * (sb_now - SB_0) / (SB_AVG - SB_0)
        if scon == 0.0:
            svar_i = 1.0
        else:
            mean_f, mean_s = _isolvar1_mean_svars(ind)
            svar_i = (scon - (mean_f * FINT + mean_s * SINT)) / IINT
        return SolarVarWeights(zeros, svar_f * ones, svar_s * ones,
                               svar_i * ones)

    if isolvar == 2:
        ind = np.array([MG_AVG, SB_AVG]) if indsolvar is None \
            else np.asarray(indsolvar, np.float64)
        svar_f = (ind[0] - MG_0) / (MG_AVG - MG_0)
        svar_s = (ind[1] - SB_0) / (SB_AVG - SB_0)
        svar_i = 1.0 if scon == 0.0 \
            else (scon - (svar_f * FINT + svar_s * SINT)) / IINT
        return SolarVarWeights(zeros, svar_f * ones, svar_s * ones,
                               svar_i * ones)

    if isolvar == 3:
        solvar = bscl if scon == 0.0 else (scon / MEAN_TSI) * bscl
        return SolarVarWeights(zeros, solvar, solvar, solvar)

    raise ValueError(f"invalid isolvar {isolvar}")
