"""Top-level radiation step: the composite GridComp's Run in functional form.

Port of geosradiation_gridcomp_tpu/driver/step.py: `radiation_refresh` is
the full SW+LW refresh (the RunAlarm branch), `radiation_update` the cheap
per-heartbeat export path; `lit_column_bound` and `sw_partition_bounds`
compute the SW daylight-packing bounds on the host.

The reference jits both entry points with static arguments. Here their
bodies are the module functions `radiation_refresh_eager` and
`radiation_update_eager` (the counterpart of a jitted function's
`__wrapped__`), and `radiation_refresh` / `radiation_update` are those
bodies as captured entries (driver/compiled.py): on a card each static
key is captured once as a CUDA graph and every later call replays it.
The refresh's static arguments are the reference's (config, ict, icb,
sw_nlit, sw_ncld) plus the table modules sw and lw and plain; the
update's is config. CPU tensors and plain=True run the body eagerly.
Both are captured under every config: every scheme pair of Chou-Suarez,
RRTMG and RRTMGP (the facade or, with config.rrtmgp_kdist_sw / _lw, the
native engine), whose bodies copy nothing from host memory and read no
device value. The scheme entries the refresh calls (rrtmg_sw / rrtmg_lw,
chou_sw / chou_lw, rrtmgp_sw / rrtmgp_lw) are captured entries too;
inside the refresh's capture they run their bodies, so the refresh's
graph holds their kernels and they record no graph of their own.
"""

import numpy as np
import torch

from .astronomy import mean_cos_zenith
from ..kernels.twins import twins
from .compiled import captured, with_kernels
from .radiation import (AtmosInputs, heating_rates, irrad_refresh,
                        irrad_update, reference_modules, solar_refresh,
                        solar_update, surface_lw_linearization)


def radiation_refresh_eager(inp: AtmosInputs, doy, utc_hours, *, config,
                            ict, icb, sw_aero=None, lw_aero=None,
                            sw_nlit=None, sw_ncld=None, sw=None, lw=None,
                            plain=False):
    """Full SW+LW refresh, the body of radiation_refresh. Returns
    (solar_state, irrad_state). Called on its own on a card, the scheme
    entries it reaches replay their own graphs; under
    compiled.disable_capture() it runs op by op.

    doy, utc_hours: Python numbers or 0-d float32 tensors.
    sw_aero: optional (taua, ssaa, asya) per-SW-band aerosol optics
    [ncol, nlay, nband]. lw_aero: optional LW aerosol optics, a
    (taua, ssaa, asya) tuple for the Chou scheme (10 bands), or taua
    alone; RRTMG-LW (16 bands, absorption-only) uses taua alone.
    sw_nlit / sw_ncld: optional SW daylight-packing bounds
    (sw_partition_bounds below).
    sw / lw: the RRTMGSW / RRTMGLW modules holding the tables
    (radiation.reference_modules of the inputs' device when None).
    plain=True runs the kernels' plain PyTorch twins (the body under
    kernels.twins.twins).
    """
    with twins(plain):
        slr, lit = mean_cos_zenith(inp.lons, inp.lats, doy, utc_hours,
                                   config.solar_dt / 3600.0)
        zth = torch.where(lit > 0.0, slr / torch.clamp(lit, min=1e-6),
                          torch.zeros_like(slr))
        staua, sssaa, sasya = sw_aero if sw_aero is not None else (None,) * 3
        if lw_aero is None:
            ltaua, lssaa, lasya = None, None, None
        elif isinstance(lw_aero, (tuple, list)):
            ltaua, lssaa, lasya = lw_aero
        else:
            ltaua, lssaa, lasya = lw_aero, None, None
        sol = solar_refresh(inp, zth, doy, config, ict, icb, taua=staua,
                            ssaa=sssaa, asya=sasya, nlit=sw_nlit,
                            ncld=sw_ncld, sw=sw)
        irr = irrad_refresh(inp, doy, config, ict, icb, taua=ltaua,
                            ssaa=lssaa, asya=lasya, lw=lw)
        return sol, irr


def radiation_update_eager(solar_state, irrad_state, tsinst, lons, lats, ple,
                           doy, utc_hours, *, config):
    """Per-heartbeat exports + heating rates, run op by op."""
    mu_now, _ = mean_cos_zenith(lons, lats, doy, utc_hours,
                                config.run_dt / 3600.0)
    sw = solar_update(solar_state, mu_now, doy, config)
    lw = irrad_update(irrad_state, tsinst, config)
    dtdt = heating_rates(sw["fsw"], lw["flw"], ple)
    out = dict(sw=sw, lw=lw, dtdt=dtdt)
    out.update(surface_lw_linearization(irrad_state))
    return out


def _refresh_route(arguments, device):
    """The captured refresh's route: on a card with the kernels (not
    plain), under every scheme pair (Chou-Suarez, RRTMG, RRTMGP, its
    native engine too: the coefficient paths are fields of the static
    config), the table modules filled in when not given."""
    if with_kernels(arguments, device) is None:
        return None
    missing = [k for k in ("sw", "lw") if arguments[k] is None]
    if missing:
        tables = dict(zip(("sw", "lw"), reference_modules(device)))
        arguments = {**arguments, **{k: tables[k] for k in missing}}
    return arguments


radiation_refresh = captured(
    radiation_refresh_eager,
    static_argnames=("config", "ict", "icb", "sw_nlit", "sw_ncld", "sw",
                     "lw", "plain"),
    route=_refresh_route)
radiation_refresh.__doc__ = """Full SW+LW refresh (radiation_refresh_eager's
arguments and results), as a CUDA graph captured once per static key on a
card under every scheme pair; eagerly for CPU tensors and plain=True."""

radiation_update = captured(radiation_update_eager,
                            static_argnames=("config",))
radiation_update.__doc__ = """Per-heartbeat exports + heating rates
(radiation_update_eager's arguments and results), as a CUDA graph
captured once per static key on a card; eagerly on the CPU."""


def _up(n, bucket, ncol):
    return min(-(-int(n) // bucket) * bucket, ncol)


def lit_column_bound(lons, lats, doy, utc_hours, config, bucket=256):
    """Host-side lit-column bound for SW daylight packing.

    Counts columns with nonzero refresh-interval insolation and rounds UP
    to a multiple of `bucket`. Pass the result as radiation_refresh's
    sw_nlit. Returns None when every column is lit.
    """
    _, lit = mean_cos_zenith(lons, lats, doy, utc_hours,
                             config.solar_dt / 3600.0)
    lit = lit.cpu().numpy()
    ncol = int(lit.shape[0])
    nlit = _up(np.sum(lit > 0.0), bucket, ncol)
    return None if nlit >= ncol else nlit


def sw_partition_bounds(lons, lats, fcld, doy, utc_hours, config,
                        bucket=256):
    """Host-side (sw_nlit, sw_ncld) bounds for the SW column partition.

    sw_nlit as in lit_column_bound; sw_ncld bounds the cloudy columns the
    all-sky solve must cover: cloudy AND lit when packing is active,
    all cloudy columns otherwise. Both rounded up to `bucket`.
    fcld: [ncol, nlay] cloud fraction.
    """
    _, lit = mean_cos_zenith(lons, lats, doy, utc_hours,
                             config.solar_dt / 3600.0)
    lit = lit.cpu().numpy() > 0.0
    cloudy = (torch.as_tensor(fcld) > 0.0).any(dim=1).cpu().numpy()
    ncol = int(lit.shape[0])
    nlit = _up(lit.sum(), bucket, ncol)
    nlit = None if nlit >= ncol else nlit
    ncld = _up((cloudy & lit).sum() if nlit is not None else cloudy.sum(),
               bucket, ncol)
    ncld = None if ncld >= (nlit if nlit is not None else ncol) else ncld
    return nlit, ncld
