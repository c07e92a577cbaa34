"""The RATS loop (GEOS_IrradGridComp.F90:3405-3468): the LW refresh run
once per radiatively active trace species with that gas zeroed, and the
per-heartbeat advance of those fluxes with Ts and each gas's
instantaneous forcing, F_net(all gases) - F_net(gas zeroed).

A frozen copy of the port's driver/diagnostics.py rats_refresh and
rats_update (at commit f88d3de), on this reference's irrad_refresh: every
solve runs the plain twins of K1, K3 and K4, and there is no captured
entry, no profiler range and no counter.
"""

from typing import Sequence, Tuple

import torch

from .radiation import irrad_refresh, reference_modules
from .state import RatsState
from ..config import Scheme

# RATS gas set (GEOS_IrradGridComp.F90:3408-3437 select cases), and the
# AtmosInputs field each one zeroes
RATS_GASES = ("H2O", "O3", "CO2", "CH4", "N2O", "CFC11", "CFC12", "HCFC22")
_RATS_FIELDS = {"H2O": "qv", "O3": "o3", "CO2": "co2", "CH4": "ch4",
                "N2O": "n2o", "CFC11": "cfc11", "CFC12": "cfc12",
                "HCFC22": "hcfc22"}


def rats_refresh(inp, doy, config, ict, icb, taua=None,
                 gases: Sequence[str] = RATS_GASES, lw=None) -> RatsState:
    """LW internals with each trace gas zeroed in turn; one full LW solve
    per gas, all with the tables of `lw` (reference_modules of the
    inputs' device when None). The RatsState's leading axis is the gas,
    ordered as `gases`."""
    for gas in gases:
        if gas not in RATS_GASES:
            raise ValueError(f"unknown RATS gas {gas!r}")
    if lw is None and config.lw_scheme == Scheme.RRTMG:
        lw = reference_modules(inp.t.device)[1]
    states = []
    for gas in gases:
        field = _RATS_FIELDS[gas]
        zeroed = inp._replace(
            **{field: torch.zeros_like(getattr(inp, field))})
        states.append(irrad_refresh(zeroed, doy, config, ict, icb, taua=taua,
                                    lw=lw, plain=True))
    return RatsState(*(torch.stack([getattr(st, f) for st in states])
                       for f in RatsState._fields))


def rats_update(rats: RatsState, irr_state, tsinst
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RATS fluxes advanced to Ts = tsinst, and each gas's forcing
    F_net(all gases) - F_net(gas zeroed), both advanced to that Ts:
    (flx_rat [ngas, ncol, nlev+1], forcing [ngas, ncol, nlev+1])."""
    delt = (tsinst - irr_state.ts)[None, :, None]
    flx_rat = rats.flx + rats.dfdts * delt
    flx_all = (irr_state.flx + irr_state.dfdts
               * (tsinst - irr_state.ts)[:, None])[None]
    return flx_rat, flx_all - flx_rat
