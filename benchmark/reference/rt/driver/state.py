"""Radiation internal states at refresh time (the reference's SolarState,
IrradState and RatsState).

Same fields, same order as geosradiation_gridcomp_tpu/driver/state.py;
the fields are torch tensors.
"""

from typing import NamedTuple

import torch


class SolarState(NamedTuple):
    """Normalized SW internal state: fractions of the refresh-time TOA
    insolation."""
    flxn: torch.Tensor        # [ncol, nlev+1] net downward
    flcn: torch.Tensor        # clear-sky net
    flxun: torch.Tensor       # upward
    flcun: torch.Tensor       # clear upward
    fdir_uv_n: torch.Tensor   # [ncol] surface direct UV
    fdif_uv_n: torch.Tensor
    fdir_par_n: torch.Tensor
    fdif_par_n: torch.Tensor
    fdir_nir_n: torch.Tensor
    fdif_nir_n: torch.Tensor
    flx_sfc_band_n: torch.Tensor  # [ncol, 14] surface net per band
    drband_n: torch.Tensor        # [ncol, 14] surface direct per band
    dfband_n: torch.Tensor        # [ncol, 14] surface diffuse per band
    cldfrc: torch.Tensor          # [ncol, 4] McICA total/high/mid/low
    # no-aerosol variants (== the all-sky values when the run has no
    # aerosols; UNDEF when pruned by config)
    flxnan: torch.Tensor          # [ncol, nlev+1] net, no aerosol
    flcnan: torch.Tensor          # clear net, no aerosol
    flxunan: torch.Tensor         # upward, no aerosol


class IrradState(NamedTuple):
    """LW internal state at refresh time (W/m^2, positive up/down)."""
    flx: torch.Tensor         # [ncol, nlev+1] net downward (dn - up)
    flc: torch.Tensor         # clear-sky net
    flxu: torch.Tensor        # upward
    flxd: torch.Tensor        # downward
    dfdts: torch.Tensor       # [ncol, nlev+1] d(net)/dTs (negative)
    sfcem: torch.Tensor       # [ncol] surface emission (negative)
    ts: torch.Tensor          # [ncol] Ts at refresh
    olrb: torch.Tensor        # [ncol, 16] band OLR
    dolrb_dts: torch.Tensor   # [ncol, 16] band dOLR/dTs
    # no-aerosol variants (== the with-aerosol values when the run has no
    # aerosols; UNDEF when pruned by config)
    flxa: torch.Tensor        # [ncol, nlev+1] net downward, no aerosol
    fla: torch.Tensor         # clear-sky net, no aerosol
    dfdtsna: torch.Tensor     # d(net no-aerosol)/dTs
    dfdtscna: torch.Tensor    # clear-sky no-aerosol derivative


class RatsState(NamedTuple):
    """Radiatively-active-trace-species diagnostics: LW internals from
    re-running the scheme with one gas zeroed per entry
    (GEOS_IrradGridComp.F90:3390-3468 FLX_RAT/DFDTS_RAT/SFCEM_RAT).

    Leading axis = gas, ordered as the `gases` tuple passed to
    diagnostics.rats_refresh."""
    flx: torch.Tensor         # [ngas, ncol, nlev+1] net downward
    flxu: torch.Tensor        # [ngas, ncol, nlev+1]
    flxd: torch.Tensor        # [ngas, ncol, nlev+1]
    dfdts: torch.Tensor       # [ngas, ncol, nlev+1]
    sfcem: torch.Tensor       # [ngas, ncol]
