"""COSP statistics vertical regridding (the 40-level stat grid).

Port of geosradiation_gridcomp_tpu/satsim/stats.py (cosp_stats.F90
COSP_CHANGE_VERTICAL_GRID :148-264): subcolumn profiles on model layers
are mapped onto a fixed-height output grid (the CloudSat 480 m grid when
csat_vgrid, CONSTRUCT_COSP_VGRID, cosp_types.F90:554-605) by
overlap-weighted averaging; radar reflectivities average in linear Z
units (log_units). The weights are one interval-overlap formula and the
weighted mean one batched product over model levels.
"""

import numpy as np
import torch

from ..tables import on_device

R_UNDEF = -1.0e30


def csat_vgrid_bounds(nlr=40, cloudsat=True):
    """(zl, zu) bounds [m] of the stat grid, ascending from the ground
    (CONSTRUCT_COSP_VGRID: 480 m CloudSat spacing, else uniform to
    20 km)."""
    zstep = 480.0 if cloudsat else 20000.0 / nlr
    zl = np.arange(nlr) * zstep
    return zl, zl + zstep


def change_vertical_grid(y, zle, zl, zu, log_units=False):
    """Regrid subcolumn profiles to fixed-height bins.

    Args:
      y:     [np, ncol, nlev] profiles on model layers, TOA-first
      zle:   [np, nlev+1] edge heights (m), TOA-first
      zl/zu: [M] output bin bottom/top heights (m), ground-ascending
      log_units: values are dB; average in linear units (10^(y/10))

    Returns [np, ncol, M] on the stat grid (index 0 = lowest bin);
    R_UNDEF where a bin lies entirely below the model bottom or has no
    weight (COSP_CHANGE_VERTICAL_GRID semantics).
    """
    zl = on_device(zl, y.device, y.dtype)
    zu = on_device(zu, y.device, y.dtype)
    xu = zle[:, :-1]                     # layer tops   [np, nlev]
    xl = zle[:, 1:]                      # layer bottoms
    # interval overlap (the reference's four cases in one expression)
    w = torch.clamp(
        torch.minimum(xu[:, :, None], zu[None, None, :])
        - torch.maximum(xl[:, :, None], zl[None, None, :]), min=0.0)
    # [np, nlev, M]
    if log_units:
        yp = torch.where(y != R_UNDEF, 10.0 ** (y / 10.0),
                         torch.zeros_like(y))
    else:
        yp = y
    ws = w.sum(dim=1)                                        # [np, M]
    swy = torch.bmm(yp, w)                                   # [np, ncol, M]
    undef = torch.full_like(swy, R_UNDEF)
    r = torch.where(ws[:, None, :] > 0.0,
                    swy / torch.clamp(ws, min=1e-30)[:, None, :], undef)
    # bins entirely below the model bottom level stay undefined
    above = zu[None, :] > zle[:, -1:]                        # [np, M]
    r = torch.where(above[:, None, :], r, undef)
    if log_units:
        r = torch.where((r > 0.0) & above[:, None, :],
                        10.0 * torch.log10(torch.clamp(r, min=1e-30)), undef)
    return r
