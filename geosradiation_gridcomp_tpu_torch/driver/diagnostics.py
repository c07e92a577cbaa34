"""LW diagnostic products: band brightness temperatures and RATS forcing.

Port of geosradiation_gridcomp_tpu/driver/diagnostics.py:
  * the narrow-band Planck inversion of band OLR to a brightness
    temperature, GEOS_IrradGridComp.F90:4132-4212;
  * the RATS loop (:3390-3468): re-run the LW scheme once per radiatively
    active trace species with that gas zeroed, storing flux internals so
    instantaneous radiative forcings (F_all - F_gas_zeroed) can be
    exported and advanced between refreshes like the main fluxes.

What RATS does outside the captured graphs: only while a torch.profiler
records, `rats_refresh` opens a range "rats_refresh/<gas>" over each
gas's zeroing and solve and "rats_refresh/stack" over the stacking of the
states, and `rats_update` one range "rats_update", so that a trace can
name what the host did while the device idled; nothing of it reads a
tensor back or synchronises. `counts()` gives, per function, its calls
and the solves, zero fills and stacked copies they made.
"""

import contextlib
from typing import Sequence, Tuple

import numpy as np
import torch

from ..tables import on_device
from .compiled import _profiling
from .state import RatsState

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

# RATS gas set (GEOS_IrradGridComp.F90:3408-3437 select cases), and the
# AtmosInputs field each one zeroes
RATS_GASES = ("H2O", "O3", "CO2", "CH4", "N2O", "CFC11", "CFC12", "HCFC22")
_RATS_FIELDS = {"H2O": "qv", "O3": "o3", "CO2": "co2", "CH4": "ch4",
                "N2O": "n2o", "CFC11": "cfc11", "CFC12": "cfc12",
                "HCFC22": "hcfc22"}

# calls of rats_refresh / rats_update and what they did outside the
# graphs: LW solves, zero fills of a gas, states copied by the stacking
_COUNTS = {"rats_refresh": dict(calls=0, solves=0, fills=0, copies=0),
           "rats_update": dict(calls=0, fills=0, copies=0)}


def counts():
    """Per RATS function, its calls and the solves, fills and copies they
    made since the process started."""
    return {name: dict(c) for name, c in _COUNTS.items()}


def _range(name, profiling):
    """A profiler range `name` while a profiler records, else nothing."""
    return torch.profiler.record_function(name) if profiling \
        else contextlib.nullcontext()


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


def rats_refresh(inp, doy, config, ict, icb, taua=None,
                 gases: Sequence[str] = RATS_GASES, lw=None) -> RatsState:
    """LW internals with each trace gas zeroed in turn (the RATS loop,
    GEOS_IrradGridComp.F90:3405-3468); each entry costs one full LW solve.

    lw: the RRTMGLW holding the tables, the per-device reference module
    (radiation.reference_modules) when None and the scheme is RRTMG, and
    shared by every solve: on a card the 8 solves then replay one
    rrtmg_lw graph, the zeroed gas copied in.

    Returns RatsState with leading gas axis ordered as `gases`.
    """
    from ..config import Scheme
    from .radiation import irrad_refresh, reference_modules

    for gas in gases:
        if gas not in RATS_GASES:
            raise ValueError(f"unknown RATS gas {gas!r}")
    if lw is None and config.lw_scheme == Scheme.RRTMG:
        lw = reference_modules(inp.t.device)[1]
    profiling = _profiling()
    states = []
    for gas in gases:
        with _range(f"rats_refresh/{gas}", profiling):
            field = _RATS_FIELDS[gas]
            zeroed = inp._replace(
                **{field: torch.zeros_like(getattr(inp, field))})
            states.append(irrad_refresh(zeroed, doy, config, ict, icb,
                                        taua=taua, lw=lw))
    with _range("rats_refresh/stack", profiling):
        out = RatsState(*(torch.stack([getattr(st, f) for st in states])
                          for f in RatsState._fields))
    c = _COUNTS["rats_refresh"]
    c["calls"] += 1
    c["solves"] += len(gases)
    c["fills"] += len(gases)
    c["copies"] += len(RatsState._fields) * len(gases)
    return out


def rats_update(rats: RatsState, irr_state, tsinst
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-heartbeat Ts-linearized advance of the RATS internals plus the
    instantaneous radiative forcing of each gas:
    forcing[g] = F_net(all gases) - F_net(gas g zeroed), both advanced to
    the current Ts.

    Returns (flx_rat [ngas, ncol, nlev+1], forcing [ngas, ncol, nlev+1]).
    """
    with _range("rats_update", _profiling()):
        delt = (tsinst - irr_state.ts)[None, :, None]
        flx_rat = rats.flx + rats.dfdts * delt
        flx_all = (irr_state.flx + irr_state.dfdts
                   * (tsinst - irr_state.ts)[:, None])[None]
        out = flx_rat, flx_all - flx_rat
    _COUNTS["rats_update"]["calls"] += 1
    return out
