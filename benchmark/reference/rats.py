"""The RATS part of the comparison that decides `correct`: the plain
reference's RATS loop (rt/driver/rats.py) computed again from the scene
of a compare.Reference, with its tables, its McICA draws and its column
blocks, in float32 with TF32 off, and the two numbers that hold the
port's RATS answers to it.

The McICA draws depend on the column's pressures alone, so they are the
same in all eight solves and in the refresh, as in GEOS. The control
(compare.Reference(control=True)) rounds every RATS state and every
advanced flux and forcing through bfloat16, as it rounds the refresh's.
"""

import math

import torch

from .compare import _bf16, relmax
from .rt.driver.rats import RATS_GASES, rats_refresh, rats_update
from .rt.driver.state import RatsState


class RatsReference:
    """The RATS loop over `gases` (RATS_GASES' names, in the order the
    port is asked for) for the scene, configuration and blocks of ref (a
    compare.Reference)."""

    def __init__(self, ref, gases=RATS_GASES):
        self.ref, self.gases = ref, tuple(gases)

    def refresh(self, doy):
        """The RatsState of a refresh at doy over every column, computed
        block by block."""
        ref, n = self.ref, self.ref.inp.t.shape[0]
        parts = [[] for _ in RatsState._fields]
        for _, sub in ref._blocks(torch.arange(n, device=ref.device)):
            st = rats_refresh(sub, doy, ref.cfg, ref.ict, ref.icb,
                              gases=self.gases, lw=ref.lw)
            for acc, f in zip(parts, st):
                acc.append(f)
        # the gas axis leads; the columns are the second axis
        rats = RatsState(*(torch.cat(p, dim=1) for p in parts))
        if ref.control:
            rats = RatsState(*(_bf16(f) for f in rats))
        return rats

    def update(self, rats, irr, ts):
        """(flx_rat, forcing, flx_all) at the heartbeat's Ts from the
        reference's own RATS and LW states; flx_all [ncol, nlev+1] is
        F_net with every gas, the scale of forcing_relmax."""
        flx_rat, forcing = rats_update(rats, irr, ts)
        flx_all = irr.flx + irr.dfdts * (ts - irr.ts)[:, None]
        if self.ref.control:
            flx_rat, forcing = _bf16(flx_rat), _bf16(forcing)
        return flx_rat, forcing, flx_all


def compare_rats(got, want):
    """rats_relmax: every RatsState field of every gas, its largest error
    over its largest magnitude, the worst of all (inf where a shape, the
    number of gases among them, differs)."""
    if any(getattr(got, f).shape != getattr(want, f).shape
           for f in RatsState._fields):
        return dict(rats_relmax=float("inf"))
    return dict(rats_relmax=max(
        relmax(getattr(got, f)[g], getattr(want, f)[g])
        for f in RatsState._fields for g in range(want.flx.shape[0])))


def compare_rats_update(got, want):
    """forcing_relmax at one heartbeat (got: the port's rats_update
    output or the control's RatsReference.update; want: the
    reference's): flx_rat's relmax over each gas, and the forcing's
    largest error over the largest |F_net(all gases)| of the heartbeat. A forcing is the difference of two fluxes: that of
    HCFC22 or CFC11 is about 1e-4 of the flux, so a relmax over its own
    largest magnitude would read float32's rounding of the two fluxes,
    not a fault; over the flux it reads what an error in either flux
    would."""
    flx_rat, forcing = got[:2]
    w_rat, w_forcing, flx_all = want
    if flx_rat.shape != w_rat.shape or forcing.shape != w_forcing.shape:
        return dict(forcing_relmax=float("inf"))
    worst = max(relmax(flx_rat[g], w_rat[g]) for g in range(w_rat.shape[0]))
    return dict(forcing_relmax=max(worst, _over(forcing, w_forcing,
                                                flx_all)))


def _over(got, want, flx_all):
    """The largest error of got over the largest |flx_all| (floor 1e-6),
    in float64; inf for a non-finite value."""
    err = float((got.double() - want.double()).abs().max())
    if not math.isfinite(err):
        return float("inf")
    return err / max(float(flx_all.double().abs().max()), 1e-6)
