"""RRTMG-LW gas optical depths and Planck fractions (taumol), plain PyTorch.

Port of the per-band reference engine of geosradiation_gridcomp_tpu/
models/rrtmg/taumol_lw.py (`taumol_lw_ref`, to the contract of its
`taumol_lw`): for each of the 16 bands, the major-species (jp, jt) x eta
interpolation (9 eta points below ~96 hPa with the 0.125/0.875 straddle
weights, 5 above), minor species, self/foreign continua, halocarbons and
Planck fractions; the troposphere split is the mask `coefs.lower`.

All coefficient tables live in one packed float32 vector (`TaumolTables`)
that the CUDA kernel K3 reads too; `pack_taumol_tables` builds it from the
reference's numpy loaders.

`parts` leaves terms out, for the cost bisection P3 (the plain twin of
csrc/taumol_lw_bisect.cu): "major" (major species), "minor" (minor species
and halocarbons), "cont" (self and foreign continua) and "planck" (Planck
fractions). A part left out contributes zeros; the default, every part,
is the reference.
"""

from typing import NamedTuple

import numpy as np
import torch

from .tables_lw import (NG_LW, NGS_LW, NSPA, NSPB, lw_gather_tables,
                        lw_tables)

_ONEMINUS = 1.0 - 1.0e-6

# chi_mls species rows: h2o, co2, o3, n2o, co, ch4, o2
_CHI = {"h2o": 0, "co2": 1, "o3": 2, "n2o": 3, "co": 4, "ch4": 5, "o2": 6}

# per-band table names, in the slot order the CUDA kernel indexes them
BAND_KEYS = ("absa", "absb", "fracrefa", "fracrefb", "ka_mn2", "kb_mn2",
             "ka_mn2o", "kb_mn2o", "ka_mo3", "kb_mo3", "ka_mco2", "kb_mco2",
             "ka_mco", "ka_mo2", "kb_mo2", "ccl4", "cfc11adj", "cfc12",
             "cfc22adj")
# tables shared by all bands: chi_mls (7, 59) and the self (10, 140) and
# foreign (4, 140) continua stacked over all g-points
GLOBAL_KEYS = ("chi_mls", "self10", "for4")

# stratospheric per-g scale tweaks (rrtmg_lw_taumol.F90:948-954 band 4,
# :1323-1329 band 7)
_B4_SCALE = np.ones(14, np.float32)
_B4_SCALE[7:14] = [0.92, 0.88, 1.07, 1.1, 0.99, 0.88, 0.943]
_B7_SCALE = np.ones(12, np.float32)
_B7_SCALE[5:11] = [0.92, 0.88, 1.07, 1.1, 0.99, 0.855]

PARTS = frozenset({"major", "minor", "cont", "planck"})
# the bisection's variants (tools/profiling/taumol_lw_bisect.py:216-225 of
# the reference: full, no_ep, no_em, maj_only, em_only, none), by the parts
# each keeps
VARIANTS = {
    "full": PARTS,
    "no_cont": PARTS - {"cont"},
    "no_minor": PARTS - {"minor"},
    "no_planck": PARTS - {"planck"},
    "maj_only": frozenset({"major"}),
    "minor_only": frozenset({"minor"}),
    "store_only": frozenset(),
}


class TaumolTables(NamedTuple):
    """The packed k-distribution: one float32 vector, the int32 offsets
    the kernel reads (see taumol_offsets) and the index behind both."""
    pack: torch.Tensor     # [n] float32
    offsets: torch.Tensor  # [16 * len(BAND_KEYS) + len(GLOBAL_KEYS)] int32
    index: dict            # (band or 0, key) -> (offset, shape)

    def get(self, band, key):
        off, shape = self.index[(band, key)]
        n = int(np.prod(shape))
        return self.pack[off:off + n].view(shape)


def taumol_offsets(index):
    """int32 element offsets of each band's tables in BAND_KEYS order (-1
    where a band has no such table), then of the GLOBAL_KEYS tables."""
    o = np.full((16, len(BAND_KEYS)), -1, np.int32)
    for b in range(1, 17):
        for k, key in enumerate(BAND_KEYS):
            if (b, key) in index:
                o[b - 1, k] = index[(b, key)][0]
    g = [index[(0, key)][0] for key in GLOBAL_KEYS]
    return np.concatenate([o.ravel(), np.asarray(g, np.int32)])


def pack_taumol_tables():
    """(pack, index) in numpy from the reference's lw_tables() (per-band
    flat absa/absb in the EQUIVALENCE layout, minors, Planck fractions)
    and lw_gather_tables() (stacked continua). Every piece starts on a
    16-byte boundary."""
    t = lw_tables()
    gt = lw_gather_tables()
    pieces, index, off = [], {}, 0

    def add(band, key, arr):
        nonlocal off
        arr = np.ascontiguousarray(arr, np.float32)
        index[(band, key)] = (off, arr.shape)
        pad = (-arr.size) % 4
        pieces.append(np.concatenate([arr.ravel(),
                                      np.zeros(pad, np.float32)]))
        off += arr.size + pad

    add(0, "chi_mls", t["chi_mls"])
    add(0, "self10", gt["self10"])
    add(0, "for4", gt["for4"])
    for b in range(1, 17):
        for key in BAND_KEYS:
            if key in t[b]:
                add(b, key, t[b][key])
    return np.concatenate(pieces), index


def _col(coefs, gas):
    return getattr(coefs, "col" + gas)


def _take(tab, idx):
    """Rows of tab at 0-based idx, clamped to the table (the reference's
    gathers clamp; rows of the unselected regime may fall outside)."""
    return tab[torch.clamp(idx, 0, tab.shape[0] - 1).long()]


def _interp_ind(tab, ind, frac):
    """tab (n, ng); ind 1-based [...]; tab[ind-1] + frac*(tab[ind]-...)."""
    t0 = _take(tab, ind - 1)
    return t0 + frac[..., None] * (_take(tab, ind) - t0)


def _interp_eta_minor(tab, jm, fm, indm, mfrac):
    """tab (neta, 19, ng); bilinear in (eta, T-index); 1-based jm, indm."""
    n2 = tab.shape[1]
    flat = tab.reshape(-1, tab.shape[-1])

    def at(j, i):
        return _take(flat, (j - 1) * n2 + (i - 1))
    m1 = at(jm, indm) + fm[..., None] * (at(jm + 1, indm) - at(jm, indm))
    m2 = at(jm, indm + 1) + fm[..., None] * (at(jm + 1, indm + 1)
                                             - at(jm, indm + 1))
    return m1 + mfrac[..., None] * (m2 - m1)


def _spec(c1, c2, rat, mult):
    """speccomb / specparm / js / fs of a 2-species key."""
    speccomb = c1 + rat * c2
    specparm = torch.clamp(c1 / speccomb, max=_ONEMINUS)
    specmult = mult * specparm
    fl = torch.floor(specmult)
    return speccomb, specparm, 1 + fl.to(torch.int64), specmult - fl


def _pow4(p):
    p2 = p * p
    return p2 * p2


def _tau_major_2sp(absa, speccomb, specparm, js, fs, ind_base, fac0, fac1):
    """Lower 2-species key tau with the 3-branch eta interpolation."""
    p_lo = fs - 1.0
    p_hi = -fs

    def corner(p):
        p4 = _pow4(p)
        return p4, 1.0 - p - 2.0 * p4, p + p4

    def g(off):
        return _take(absa, ind_base + off)

    f0 = fac0[..., None]
    f1 = fac1[..., None]
    fk0l, fk1l, fk2l = (x[..., None] for x in corner(p_lo))
    tau_lo = (fk0l * f0 * g(0) + fk1l * f0 * g(1) + fk2l * f0 * g(2)
              + fk0l * f1 * g(9) + fk1l * f1 * g(10) + fk2l * f1 * g(11))
    fk0h, fk1h, fk2h = (x[..., None] for x in corner(p_hi))
    tau_hi = (fk2h * f0 * g(-1) + fk1h * f0 * g(0) + fk0h * f0 * g(1)
              + fk2h * f1 * g(8) + fk1h * f1 * g(9) + fk0h * f1 * g(10))
    fsx = fs[..., None]
    tau_mid = ((1.0 - fsx) * f0 * g(0) + fsx * f0 * g(1)
               + (1.0 - fsx) * f1 * g(9) + fsx * f1 * g(10))
    lo = (specparm < 0.125)[..., None]
    hi = (specparm > 0.875)[..., None]
    tau = torch.where(lo, tau_lo, torch.where(hi, tau_hi, tau_mid))
    return speccomb[..., None] * tau


def _tau_major_2sp_upper(absb, speccomb, fs, ind_base, fac0, fac1):
    """Upper 2-species key tau (5 eta points, linear)."""
    def g(off):
        return _take(absb, ind_base + off)
    fsx = fs[..., None]
    f0 = fac0[..., None]
    f1 = fac1[..., None]
    tau = ((1.0 - fsx) * f0 * g(0) + fsx * f0 * g(1)
           + (1.0 - fsx) * f1 * g(5) + fsx * f1 * g(6))
    return speccomb[..., None] * tau


def _planck_eta(frac_tab, c1, c2, refrat, mult):
    """Eta-interpolated Planck fraction: frac_tab (neta, ng)."""
    _, _, jpl, fpl = _spec(c1, c2, refrat, mult)
    t0 = _take(frac_tab, jpl - 1)
    return t0 + fpl[..., None] * (_take(frac_tab, jpl) - t0)


class _Band:
    """Per-cell state shared by one band's lower/upper formulas; the terms
    of the parts not in `parts` are zeros."""

    def __init__(self, coefs, tabs, band, parts=PARTS):
        self.c = coefs
        self.band = band
        self.parts = parts
        self.ng = int(NG_LW[band - 1])
        self.chi = tabs.get(0, "chi_mls")
        self.tab = lambda key: tabs.get(band, key)
        g = slice(int(NGS_LW[band - 1]), int(NGS_LW[band]))
        self.self10 = tabs.get(0, "self10")[:, g]
        self.for4 = tabs.get(0, "for4")[:, g]
        self.jp = coefs.jp.long()
        self.jt = coefs.jt.long()
        self.jt1 = coefs.jt1.long()

    def col(self, gas):
        return _col(self.c, gas)

    def _zeros(self):
        return torch.zeros(self.jp.shape + (self.ng,), dtype=torch.float32,
                           device=self.jp.device)

    def rat(self, gas1, gas2, plus1):
        j = self.jp + (0 if plus1 else -1)
        return self.chi[_CHI[gas1]][j] / self.chi[_CHI[gas2]][j]

    def refrat(self, gas1, gas2, level):
        """Fixed reference ratio at a chi_mls level (1-based), in f32."""
        return (self.chi[_CHI[gas1], level - 1]
                / self.chi[_CHI[gas2], level - 1])

    def ind_lower(self, nsp):
        i0 = ((self.jp - 1) * 5 + (self.jt - 1)) * nsp
        i1 = (self.jp * 5 + (self.jt1 - 1)) * nsp
        return i0, i1

    def ind_upper(self, nsp):
        i0 = (torch.clamp(self.jp - 13, min=0) * 5 + (self.jt - 1)) * nsp
        i1 = (torch.clamp(self.jp - 12, min=1) * 5 + (self.jt1 - 1)) * nsp
        return i0, i1

    def tauself(self):
        if "cont" not in self.parts:
            return self._zeros()
        return self.c.selffac[..., None] * _interp_ind(
            self.self10, self.c.indself.long(), self.c.selffrac)

    def taufor(self):
        if "cont" not in self.parts:
            return self._zeros()
        return self.c.forfac[..., None] * _interp_ind(
            self.for4, self.c.indfor.long(), self.c.forfrac)

    def minor(self, key):
        if "minor" not in self.parts:
            return self._zeros()
        return _interp_ind(self.tab(key), self.c.indminor.long(),
                           self.c.minorfrac)

    def eta_minor(self, key, gas1, gas2, level, mult):
        if "minor" not in self.parts:
            return self._zeros()
        _, _, jm, fm = _spec(self.col(gas1), self.col(gas2),
                             self.refrat(gas1, gas2, level), mult)
        return _interp_eta_minor(self.tab(key), jm, fm,
                                 self.c.indminor.long(), self.c.minorfrac)

    def adjcol(self, gas, thresh, base, expo, fixed_ref=None):
        """Empirical minor-gas column adjustment."""
        colgas = self.col(gas)
        coldry = self.c.coldry
        if fixed_ref is None:
            ref = self.chi[_CHI[gas]][self.jp]     # chi_mls(gas, jp+1)
        else:
            ref = torch.full_like(colgas, fixed_ref)
        ratg = 1.0e20 * (colgas / coldry) / ref
        adjfac = base + torch.clamp(ratg - base, min=1e-12) ** expo
        adj = adjfac * ref * coldry * 1.0e-20
        return torch.where(ratg > thresh, adj, colgas)

    def halo(self, key):
        """A halocarbon cross-section row (ccl4, cfc11adj, cfc12,
        cfc22adj), part of "minor"."""
        if "minor" not in self.parts:
            return torch.zeros_like(self.tab(key))
        return self.tab(key)

    def major1(self, key, colgas, i0, i1):
        if "major" not in self.parts:
            return self._zeros()
        tab = self.tab(key)
        c = self.c
        return colgas[..., None] * (
            c.fac00[..., None] * _take(tab, i0)
            + c.fac10[..., None] * _take(tab, i0 + 1)
            + c.fac01[..., None] * _take(tab, i1)
            + c.fac11[..., None] * _take(tab, i1 + 1))

    def major2(self, gas1, gas2):
        """Lower 2-species key tau at (jp, jt) and (jp+1, jt1)."""
        if "major" not in self.parts:
            return self._zeros()
        c = self.c
        nspa = NSPA[self.band - 1]
        i0, i1 = self.ind_lower(nspa)
        absa = self.tab("absa")
        out = 0.0
        for plus1, ib, fa, fb in ((False, i0, c.fac00, c.fac10),
                                  (True, i1, c.fac01, c.fac11)):
            sc, sp, js, fs = _spec(self.col(gas1), self.col(gas2),
                                   self.rat(gas1, gas2, plus1), 8.0)
            out = out + _tau_major_2sp(absa, sc, sp, js, fs, ib + js - 1,
                                       fa, fb)
        return out

    def major2_upper(self, gas1, gas2):
        if "major" not in self.parts:
            return self._zeros()
        c = self.c
        nspb = NSPB[self.band - 1]
        u0, u1 = self.ind_upper(nspb)
        absb = self.tab("absb")
        out = 0.0
        for plus1, ib, fa, fb in ((False, u0, c.fac00, c.fac10),
                                  (True, u1, c.fac01, c.fac11)):
            sc, _, js, fs = _spec(self.col(gas1), self.col(gas2),
                                  self.rat(gas1, gas2, plus1), 4.0)
            out = out + _tau_major_2sp_upper(absb, sc, fs, ib + js - 1,
                                             fa, fb)
        return out

    def planck(self, key, gas1, gas2, level, mult):
        if "planck" not in self.parts:
            return self._zeros()
        return _planck_eta(self.tab(key), self.col(gas1), self.col(gas2),
                           self.refrat(gas1, gas2, level), mult)

    def const(self, key, like):
        """A fracref row (Planck fractions) broadcast like `like`."""
        if "planck" not in self.parts:
            return torch.zeros_like(like)
        return self.tab(key).expand_as(like)


def _band_terms(b):
    """(tlo, plo, thi, phi) of band b.band, as in taumol_lw_ref."""
    c = b.c
    n = b.band
    if n in (1, 2):
        i0, i1 = b.ind_lower(1)
        tlo = b.major1("absa", c.colh2o, i0, i1) + b.tauself() + b.taufor()
        u0, u1 = b.ind_upper(1)
        thi = b.major1("absb", c.colh2o, u0, u1) + b.taufor()
        if n == 1:
            scalen2 = (c.colbrd * c.scaleminorn2)[..., None]
            tlo = tlo + scalen2 * b.minor("ka_mn2")
            corr = torch.where(c.pavel < 250.0,
                               1.0 - 0.15 * (250.0 - c.pavel) / 154.4,
                               torch.ones_like(c.pavel))
            tlo = corr[..., None] * tlo
            thi = thi + scalen2 * b.minor("kb_mn2")
            thi = (1.0 - 0.15 * (c.pavel / 95.6))[..., None] * thi
        else:
            corr = 1.0 - 0.05 * (c.pavel - 100.0) / 900.0
            tlo = corr[..., None] * tlo
        return tlo, b.const("fracrefa", tlo), thi, b.const("fracrefb", thi)

    if n == 3:
        adjn2o = b.adjcol("n2o", 1.5, 0.5, 0.65)[..., None]
        tlo = b.major2("h2o", "co2") + b.tauself() + b.taufor() \
            + adjn2o * b.eta_minor("ka_mn2o", "h2o", "co2", 3, 8.0)
        plo = b.planck("fracrefa", "h2o", "co2", 9, 8.0)
        thi = b.major2_upper("h2o", "co2") + b.taufor() \
            + adjn2o * b.eta_minor("kb_mn2o", "h2o", "co2", 13, 4.0)
        phi = b.planck("fracrefb", "h2o", "co2", 13, 4.0)
        return tlo, plo, thi, phi

    if n == 4:
        tlo = b.major2("h2o", "co2") + b.tauself() + b.taufor()
        plo = b.planck("fracrefa", "h2o", "co2", 11, 8.0)
        thi = b.major2_upper("o3", "co2")
        phi = b.planck("fracrefb", "o3", "co2", 13, 4.0)
        thi = thi * torch.as_tensor(_B4_SCALE, device=thi.device)
        return tlo, plo, thi, phi

    if n == 5:
        ccl4 = c.colccl4[..., None] * b.halo("ccl4")
        tlo = b.major2("h2o", "co2") + b.tauself() + b.taufor() \
            + c.colo3[..., None] * b.eta_minor("ka_mo3", "h2o", "co2", 7,
                                               8.0) \
            + ccl4
        plo = b.planck("fracrefa", "h2o", "co2", 5, 8.0)
        thi = b.major2_upper("o3", "co2") + ccl4
        phi = b.planck("fracrefb", "o3", "co2", 43, 4.0)
        return tlo, plo, thi, phi

    if n == 6:
        i0, i1 = b.ind_lower(1)
        adjco2 = b.adjcol("co2", 3.0, 2.0, 0.77)[..., None]
        cfc = c.colcfc11[..., None] * b.halo("cfc11adj") \
            + c.colcfc12[..., None] * b.halo("cfc12")
        tlo = b.major1("absa", c.colh2o, i0, i1) + b.tauself() \
            + b.taufor() + adjco2 * b.minor("ka_mco2") + cfc
        plo = b.const("fracrefa", tlo)
        return tlo, plo, cfc.expand_as(tlo), plo

    if n == 7:
        tlo = b.major2("h2o", "o3") + b.tauself() + b.taufor() \
            + b.adjcol("co2", 3.0, 3.0, 0.79)[..., None] \
            * b.eta_minor("ka_mco2", "h2o", "o3", 3, 8.0)
        plo = b.planck("fracrefa", "h2o", "o3", 3, 8.0)
        u0, u1 = b.ind_upper(1)
        thi = b.major1("absb", c.colo3, u0, u1) \
            + b.adjcol("co2", 3.0, 2.0, 0.79)[..., None] * b.minor("kb_mco2")
        thi = thi * torch.as_tensor(_B7_SCALE, device=thi.device)
        return tlo, plo, thi, b.const("fracrefb", thi)

    if n == 8:
        i0, i1 = b.ind_lower(1)
        adjco2 = b.adjcol("co2", 3.0, 2.0, 0.65)[..., None]
        tlo = b.major1("absa", c.colh2o, i0, i1) + b.tauself() \
            + b.taufor() + adjco2 * b.minor("ka_mco2") \
            + c.colo3[..., None] * b.minor("ka_mo3") \
            + c.coln2o[..., None] * b.minor("ka_mn2o") \
            + c.colcfc12[..., None] * b.halo("cfc12") \
            + c.colcfc22[..., None] * b.halo("cfc22adj")
        u0, u1 = b.ind_upper(1)
        thi = b.major1("absb", c.colo3, u0, u1) \
            + adjco2 * b.minor("kb_mco2") \
            + c.coln2o[..., None] * b.minor("kb_mn2o") \
            + c.colcfc12[..., None] * b.halo("cfc12") \
            + c.colcfc22[..., None] * b.halo("cfc22adj")
        return tlo, b.const("fracrefa", tlo), thi, b.const("fracrefb", thi)

    if n == 9:
        adjn2o = b.adjcol("n2o", 1.5, 0.5, 0.65)[..., None]
        tlo = b.major2("h2o", "ch4") + b.tauself() + b.taufor() \
            + adjn2o * b.eta_minor("ka_mn2o", "h2o", "ch4", 3, 8.0)
        plo = b.planck("fracrefa", "h2o", "ch4", 9, 8.0)
        u0, u1 = b.ind_upper(1)
        thi = b.major1("absb", c.colch4, u0, u1) \
            + adjn2o * b.minor("kb_mn2o")
        return tlo, plo, thi, b.const("fracrefb", thi)

    if n in (10, 11):
        i0, i1 = b.ind_lower(1)
        u0, u1 = b.ind_upper(1)
        tlo = b.major1("absa", c.colh2o, i0, i1) + b.tauself() + b.taufor()
        thi = b.major1("absb", c.colh2o, u0, u1) + b.taufor()
        if n == 11:
            scaleo2 = (c.colo2 * c.scaleminor)[..., None]
            tlo = tlo + scaleo2 * b.minor("ka_mo2")
            thi = thi + scaleo2 * b.minor("kb_mo2")
        return tlo, b.const("fracrefa", tlo), thi, b.const("fracrefb", thi)

    if n == 12:
        tlo = b.major2("h2o", "co2") + b.tauself() + b.taufor()
        plo = b.planck("fracrefa", "h2o", "co2", 10, 8.0)
        return tlo, plo, torch.zeros_like(tlo), torch.zeros_like(plo)

    if n == 13:
        adjco2 = b.adjcol("co2", 3.0, 2.0, 0.68, fixed_ref=3.55e-4)
        tlo = b.major2("h2o", "n2o") + b.tauself() + b.taufor() \
            + adjco2[..., None] * b.eta_minor("ka_mco2", "h2o", "n2o", 1,
                                              8.0) \
            + c.colco[..., None] * b.eta_minor("ka_mco", "h2o", "n2o", 3,
                                               8.0)
        plo = b.planck("fracrefa", "h2o", "n2o", 5, 8.0)
        thi = c.colo3[..., None] * b.minor("kb_mo3")
        return tlo, plo, thi, b.const("fracrefb", thi)

    if n == 14:
        i0, i1 = b.ind_lower(1)
        u0, u1 = b.ind_upper(1)
        tlo = b.major1("absa", c.colco2, i0, i1) + b.tauself() + b.taufor()
        thi = b.major1("absb", c.colco2, u0, u1)
        return tlo, b.const("fracrefa", tlo), thi, b.const("fracrefb", thi)

    if n == 15:
        tlo = b.major2("n2o", "co2") + b.tauself() + b.taufor() \
            + (c.colbrd * c.scaleminor)[..., None] \
            * b.eta_minor("ka_mn2", "n2o", "co2", 1, 8.0)
        plo = b.planck("fracrefa", "n2o", "co2", 1, 8.0)
        return tlo, plo, torch.zeros_like(tlo), torch.zeros_like(plo)

    # band 16
    tlo = b.major2("h2o", "ch4") + b.tauself() + b.taufor()
    plo = b.planck("fracrefa", "h2o", "ch4", 6, 8.0)
    u0, u1 = b.ind_upper(1)
    thi = b.major1("absb", c.colch4, u0, u1)
    return tlo, plo, thi, b.const("fracrefb", thi)


def _taumol_cells(coefs, tabs, taua, parts):
    low = coefs.lower[..., None]
    taug, pfracs = [], []
    for band in range(1, 17):
        tlo, plo, thi, phi = _band_terms(_Band(coefs, tabs, band, parts))
        taug.append(torch.where(low, tlo, thi))
        pfracs.append(torch.where(low, plo, phi))
    taug = torch.cat(taug, dim=-1)
    pfracs = torch.cat(pfracs, dim=-1)
    if taua is not None:
        ngb = torch.as_tensor(np.repeat(np.arange(16), NG_LW),
                              device=taua.device)
        taug = taug + taua[..., ngb]
    return taug, pfracs


def taumol_lw(coefs, tabs, taua=None, cell_chunk=65536, parts=PARTS):
    """Gas optical depth and Planck fractions for all 140 g-points.

    coefs: LWCoefs of [ncol, nlay] fields; tabs: TaumolTables;
    taua: optional [ncol, nlay, 16] aerosol optical depth per band.
    Cells run in chunks of cell_chunk to bound the temporaries. parts:
    the subset of PARTS computed (the others contribute zeros).
    Returns (taug, pfracs): [ncol, nlay, 140].
    """
    shape = coefs.jp.shape
    n = int(np.prod(shape))
    ta = None if taua is None else taua.reshape(n, 16)
    tg, pf = [], []
    for s in range(0, n, cell_chunk):
        sl = slice(s, min(s + cell_chunk, n))
        a, b = _taumol_cells(_cells(coefs, shape, sl), tabs,
                             None if ta is None else ta[sl], parts)
        tg.append(a)
        pf.append(b)
    return (torch.cat(tg).reshape(shape + (-1,)),
            torch.cat(pf).reshape(shape + (-1,)))


def _cells(coefs, shape, sl):
    """The per-layer fields of coefs flattened to one cell axis, rows sl
    (fields of other shapes, unused by taumol, are passed through)."""
    k = len(shape)

    def f(x):
        if x.shape[:k] == shape:
            return x.reshape((-1,) + x.shape[k:])[sl]
        return x
    return type(coefs)(*(f(x) for x in coefs))
