"""The SATSIM part of the comparison that decides `correct`: the plain
reference's COSP simulators (rt/satsim/) run again on the cell's inputs
(satsim_scene.py) with each sampled alarm's key and sun, and the four
numbers that hold the port's COSP answers to them.

The reference runs every point in one call, as the port does (SCOPS
draws [levels, points, subcolumns] from one key, so a block of points
would draw other numbers); its radar blocks the points itself. It runs
in float32 with TF32 off (compare.Reference sets it).

The numbers, over every output of cosp_simulator and prec_frac (the
port's prec_scops on the port's frac_out):
- satsim_relmax: every float field outside fill positions (FILLS), its
  largest error over its largest magnitude. The radar's dBZe fields
  (dbze, ze_non) and attenuations are compared in dB, as they are
  written: an error in dB is a relative error in Z, which weighs a
  cloud's echo at -30 dBZe as much as rain's at +10, while in linear Z
  the strongest echo, 1e4 times the cloud's, would set the scale and
  hide any error in the cloud's. meantaucld is compared as the mean
  albedo it is inverted from, a = tau^0.895 / (tau^0.895 + 6.82): the
  inversion amplifies a's rounding by 1 / (0.895 (1 - a)), over 600 at
  the thickest points.
- satsim_fill_mismatch: positions where exactly one side holds a fill
  value.
- satsim_int_mismatch: entries of the integer fields (frac_out,
  prec_frac, MODIS phase) that differ; SCOPS draws the threefry stream
  exactly.
- satsim_count_flips: the fields counted over subcolumns (COUNTS, k /
  ncol), the share of their entries outside fill positions whose count
  round(value * ncol) differs.

The control (compare.Reference(control=True)) is the reference computed
as a program in bfloat16 would have it: its inputs rounded through
bfloat16, and every float answer. Rounding the answers alone could not
show in the counts (k / 50 rounded through bfloat16 stays within 0.1 of
k) nor in the integers.
"""

import math

import torch

import satsim_scene
from .compare import _bf16, _round_tree
from .rt.satsim.cosp import SatsimConfig, SatsimInputs, cosp_simulator_eager
from .rt.satsim.scops import prec_scops

# the reference's fill values (R_UNDEF, MISSING, MISSING_DBZ, MODIS's
# RE_FILL in m, R_GROUND); beyond 1e29 in magnitude is R_UNDEF too
FILLS = (-1.0e30, -999.0, -999.0e-6, -1.0e20)
# the satsim fields that are a count of subcolumns over ncol
COUNTS = ("fq_isccp", "totalcldarea", "fq_misr", "cldarea", "tau_vs_ctp",
          "cf_total", "cf_water", "cf_ice", "cf_high", "cf_mid", "cf_low",
          "cfad_sr", "cfad_dbze", "lidar_only_freq_cloud",
          "radar_lidar_tcc")
NUMBERS = ("satsim_relmax", "satsim_fill_mismatch", "satsim_int_mismatch",
           "satsim_count_flips")


class SatsimReference:
    """COSP on the cell's inputs for the scene of ref (a
    compare.Reference, whose device and control it takes), with the
    configuration file's `satsim` and solar_dt, the run's seed and the
    day's alarms [(doy, utc)]."""

    def __init__(self, ref, arrays, config, seed, alarms):
        self.ref, self.seed, self.alarms = ref, seed, alarms
        self.cfg = SatsimConfig(**config["satsim"])
        self.arrays, self.solar_dt = arrays, config["solar_dt"]
        self.base = {k: torch.as_tensor(v, device=ref.device)
                     for k, v in satsim_scene.fields(arrays).items()}

    def inputs(self, k):
        """The SatsimInputs of alarm k (the control's rounded through
        bfloat16)."""
        doy, utc = self.alarms[k]
        inp = SatsimInputs(**self.base, mcosz=satsim_scene.mcosz(
            self.arrays, doy, utc, self.solar_dt, self.ref.device))
        if self.ref.control:
            inp = SatsimInputs(*(_bf16(x) for x in inp))
        return inp

    def cosp(self, k):
        """cosp_simulator's answer at alarm k, with prec_frac."""
        inp = self.inputs(k)
        key = satsim_scene.key(self.seed, k, len(self.alarms),
                               self.ref.device)
        out = cosp_simulator_eager(key, inp, self.cfg)
        out["prec_frac"] = prec_scops(inp.qr + inp.qs + inp.qg,
                                      torch.zeros_like(inp.qr),
                                      out["frac_out"])
        return _round_tree(out) if self.ref.control else out


def leaves(out, prefix=""):
    """(group/key, tensor) of every output, depth first."""
    for k, v in out.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def is_fill(x):
    fills = torch.tensor(FILLS, dtype=x.dtype, device=x.device)
    return torch.isin(x, fills) | (x.abs() >= 1e29)


def field_relmax(got, want):
    """The largest error over the largest |want|, in float64; inf for a
    non-finite value."""
    if not want.numel():
        return 0.0
    a, b = got.double(), want.double()
    err = float((a - b).abs().max())
    if not math.isfinite(err):
        return float("inf")
    return err / max(float(b.abs().max()), 1e-30) if err else 0.0


def albedo(tau):
    tau = tau.double().clamp(min=0.0) ** 0.895
    return tau / (tau + 6.82)


def compare_satsim(got, want):
    """The four SATSIM numbers of got (the port's COSP answer with
    prec_frac, or the control's) against want (the reference's); a
    missing output or a shape that differs reads inf in every one."""
    ncol = want["frac_out"].shape[1]
    pairs = dict(leaves(got))
    inf = dict.fromkeys(NUMBERS, float("inf"))
    relmax = fills = ints = flips = entries = 0
    for name, w in leaves(want):
        g = pairs.pop(name, None)
        if g is None or g.shape != w.shape or g.dtype != w.dtype:
            return inf
        if not w.is_floating_point():
            ints += int((g != w).sum())
            continue
        fg, fw = is_fill(g), is_fill(w)
        fills += int((fg != fw).sum())
        keep = ~(fg | fw)
        g, w = g[keep], w[keep]
        if name.rsplit("/", 1)[-1] in COUNTS:
            flips += int((torch.round(g.double() * ncol)
                          != torch.round(w.double() * ncol)).sum())
            entries += w.numel()
            if not bool(torch.isfinite(g).all()):
                return inf
            continue
        if name.endswith("meantaucld"):
            g, w = albedo(g), albedo(w)
        relmax = max(relmax, field_relmax(g, w))
    if pairs:
        return inf
    return dict(satsim_relmax=relmax, satsim_fill_mismatch=float(fills),
                satsim_int_mismatch=float(ints),
                satsim_count_flips=flips / entries if entries else 0.0)
