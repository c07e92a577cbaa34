"""The comparison that decides `correct`: the plain reference (rt/, a
frozen copy of the port's plain PyTorch path that imports nothing of the
port) computed again from the scene, and the numbers that hold the
port's answers to it.

The reference works out itself what the port's set-up derived: the
super-layer indices, the daylight-packing bounds, the McICA draws and
the tables. It runs in float32 with TF32 off, on column blocks, once
the window has closed.

The control is the same reference with its answers in the nearest
precision below float32, bfloat16: every state and export rounded
through bfloat16. That is the least error a program computing in
bfloat16 carries, whatever else it rounds, so a limit that fails the
control fails every such program.
"""

import numpy as np
import torch

from .rt.config import RadiationConfig, Scheme
from .rt.driver.astronomy import mean_cos_zenith
from .rt.driver.radiation import (AtmosInputs, RRTMGLW, RRTMGSW,
                                  irrad_refresh, solar_refresh)
from .rt.driver.state import IrradState, SolarState
from .rt.driver.step import radiation_update_eager, sw_partition_bounds

def _bf16(x):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x


class Reference:
    """The reference for one configuration file and one scene (a dict of
    numpy arrays, scene.FIELDS), on device, in blocks of `block`
    columns."""

    def __init__(self, config, arrays, device, block, control=False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = RadiationConfig(
            sw_scheme=Scheme(config["sw_scheme"]),
            lw_scheme=Scheme(config["lw_scheme"]),
            condensate_inhomogeneity=config["condensate_inhomogeneity"],
            run_dt=config["run_dt"], solar_dt=config["solar_dt"])
        self.block, self.control, self.device = block, control, device
        self.inp = AtmosInputs(**{
            k: torch.as_tensor(v, device=device).clone()
            for k, v in arrays.items()})
        ple0 = arrays["ple"][0].astype(np.float64)
        self.ict, self.icb = self.cfg.superlayer_indices(
            0.5 * (ple0[1:] + ple0[:-1]))
        self.sw = RRTMGSW.from_reference_tables(device)
        self.lw = RRTMGLW.from_reference_tables(device)

    def packing(self, schedule, bucket):
        """The SW lit-column bound over the refreshes of the schedule, the
        larger at each: the bound the port must be given (None: every
        column runs)."""
        nlits = [sw_partition_bounds(self.inp.lons, self.inp.lats,
                                     self.inp.fcld, d, u, self.cfg,
                                     bucket)[0] for d, u in schedule]
        return None if any(n is None for n in nlits) else max(nlits)

    def _blocks(self, idx):
        for s in range(0, idx.numel(), self.block):
            i = idx[s:s + self.block]
            yield i, AtmosInputs(*(f[i] for f in self.inp))

    def refresh(self, doy, utc, nlit):
        """(SolarState, IrradState) of a refresh at (doy, utc) over every
        column. With a packing bound nlit the SW runs on the columns the
        port's packing keeps (dark, then clear, last; the first nlit in a
        stable order) and the others read zero, as the port documents."""
        inp, cfg, n = self.inp, self.cfg, self.inp.t.shape[0]
        slr, lit = mean_cos_zenith(inp.lons, inp.lats, doy, utc,
                                   cfg.solar_dt / 3600.0)
        zth = torch.where(lit > 0.0, slr / torch.clamp(lit, min=1e-6),
                          torch.zeros_like(slr))
        every = torch.arange(n, device=self.device)
        if nlit is None:
            keep = every
        else:
            clear = (~(inp.fcld > 0.0).any(dim=1)).to(torch.int32)
            key = 2 * (zth <= 0.0).to(torch.int32) + clear
            keep = torch.argsort(key, stable=True)[:nlit]
        sol = None
        for i, sub in self._blocks(keep):
            part = solar_refresh(sub, zth[i], doy, cfg, self.ict, self.icb,
                                 sw=self.sw)
            if sol is None:
                sol = [torch.zeros((n,) + f.shape[1:], dtype=f.dtype,
                                   device=f.device) for f in part]
            for full, f in zip(sol, part):
                full[i] = f
        irr = [[] for _ in IrradState._fields]
        for i, sub in self._blocks(every):
            for acc, f in zip(irr, irrad_refresh(sub, doy, cfg, self.ict,
                                                 self.icb, lw=self.lw)):
                acc.append(f)
        sol = SolarState(*sol)
        irr = IrradState(*(torch.cat(a) for a in irr))
        if self.control:
            sol = SolarState(*(_bf16(f) for f in sol))
            irr = IrradState(*(_bf16(f) for f in irr))
        return sol, irr

    def update(self, sol, irr, ts, doy, utc):
        """The per-heartbeat exports from the reference's own states."""
        inp, n = self.inp, self.inp.t.shape[0]
        parts = []
        for s in range(0, n, self.block):
            c = slice(s, s + self.block)
            parts.append(radiation_update_eager(
                SolarState(*(f[c] for f in sol)),
                IrradState(*(f[c] for f in irr)), ts[c], inp.lons[c],
                inp.lats[c], inp.ple[c], doy, utc, config=self.cfg))
        out = _cat(parts)
        return _round_tree(out) if self.control else out


def _cat(parts):
    first = parts[0]
    if isinstance(first, dict):
        return {k: _cat([p[k] for p in parts]) for k in first}
    return torch.cat(parts)


def _round_tree(x):
    if isinstance(x, dict):
        return {k: _round_tree(v) for k, v in x.items()}
    return _bf16(x)


def relmax(got, want):
    """The largest error over the largest magnitude of the reference
    (floor 1e-6), in float64; inf for a wrong shape or a non-finite
    value."""
    if got.shape != want.shape:
        return float("inf")
    a, b = got.double(), want.double()
    err = float((a - b).abs().max()) if a.numel() else 0.0
    if not np.isfinite(err):
        return float("inf")
    return err / max(float(b.abs().max()), 1e-6)


def compare_states(got, want):
    """sw_relmax over the SolarState fields but the cloud fractions,
    lw_relmax over the IrradState fields, cldfrc_maxdiff the largest
    difference of a McICA cloud fraction."""
    gs, gi = got
    ws, wi = want
    sw = max(relmax(getattr(gs, f), getattr(ws, f))
             for f in SolarState._fields if f != "cldfrc")
    lw = max(relmax(getattr(gi, f), getattr(wi, f))
             for f in IrradState._fields)
    if gs.cldfrc.shape != ws.cldfrc.shape:
        cld = float("inf")
    else:
        cld = float((gs.cldfrc.double() - ws.cldfrc.double()).abs().max())
        cld = cld if np.isfinite(cld) else float("inf")
    return dict(sw_relmax=sw, lw_relmax=lw, cldfrc_maxdiff=cld)


def compare_update(got, want, ple):
    """update_relmax: the worst relmax over the SW and LW exports, the
    surface linearisation and the heating rates, these taken as the flux
    divergence they stand for (rate times layer thickness)."""
    dp = (ple[:, 1:] - ple[:, :-1])
    worst = relmax(got["dtdt"] * dp, want["dtdt"] * dp)
    for group in ("sw", "lw"):
        for k, w in want[group].items():
            g = got[group].get(k)
            worst = max(worst, float("inf") if g is None else relmax(g, w))
    for k in ("alw", "blw"):
        worst = max(worst, relmax(got[k], want[k]))
    return dict(update_relmax=worst)


def worst(readings):
    """The largest reading of each number over the answers compared."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
