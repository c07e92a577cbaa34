"""RRTMG-SW gas and Rayleigh optical depths and solar source (taumol_sw),
plain PyTorch.

Port of the per-band reference engine of geosradiation_gridcomp_tpu/
models/rrtmg/taumol_sw.py (`taumol_sw_ref`, with `_laysolfr` and
`sfluxzen_only`): for each of the 14 bands 16..29, one- or two-species
key absorption (a plain two-point eta interpolation, 9 eta points below
~96 hPa and 5 above), the water self/foreign continua, the gray CH4, O3,
CO2, H2O and O2 terms and the per-g or scalar Rayleigh depth (band 24's
lower Rayleigh is eta-interpolated); the troposphere split is the mask
`coefs.lower`.

The k-distribution lives in one packed float32 vector (`TaumolTables`,
shared with taumol_lw) that kernel K5 reads too. The solar source is
computed here in plain PyTorch for both paths, from per-band tables with
the NRLSSI2 weights folded in (`solar_source_tables`).
"""

import numpy as np
import torch

from .tables_sw import (  # noqa: F401
    LAYREFFR, NG_SW, NGS_SW, NSPA, NSPB, SOLFR_UPPER, STRRAT, sw_tables)
from .taumol_lw import TaumolTables, _take

_ONEMINUS = 1.0 - 1.0e-6
_O2ADJ = 1.6
_GIVFAC = 1.029

# per-band table names, in the slot order the CUDA kernel indexes them;
# a scalar rayl is stored broadcast over the band's g-points
BAND_KEYS = ("absa", "absb", "selfref", "forref", "rayl", "rayla", "raylb",
             "absch4", "abso3a", "abso3b", "absco2", "absh2o")
# bands whose solar source is eta-interpolated: (gas1, gas2, strrat)
SFLUX_ETA = {17: ("h2o", "co2", STRRAT[17]), 18: ("h2o", "ch4", STRRAT[18]),
             19: ("h2o", "co2", STRRAT[19]), 21: ("h2o", "co2", STRRAT[21]),
             22: ("h2o", "o2", _O2ADJ * STRRAT[22]),
             24: ("h2o", "o2", STRRAT[24]), 28: ("o3", "o2", STRRAT[28])}


def pack_taumol_tables():
    """(pack, index) in numpy from the reference's sw_tables(): per-band
    flat absa/absb in the EQUIVALENCE layout, continua, Rayleigh and gray
    absorber vectors. Every piece starts on a 16-byte boundary."""
    t = sw_tables()
    pieces, index, off = [], {}, 0
    for b in range(16, 30):
        ng = NG_SW[b - 16]
        for key in BAND_KEYS:
            if key not in t[b]:
                continue
            arr = np.asarray(t[b][key], np.float32)
            if key == "rayl" and arr.ndim == 0:
                arr = np.full(ng, arr, np.float32)
            index[(b, key)] = (off, arr.shape)
            pad = (-arr.size) % 4
            pieces.append(np.concatenate([arr.ravel(),
                                          np.zeros(pad, np.float32)]))
            off += arr.size + pad
    return np.concatenate(pieces), index


def taumol_offsets(index):
    """int32 [2, 14 * len(BAND_KEYS)]: each band's table offsets in
    BAND_KEYS order (-1 where a band has no such table), then the number
    of rows of each table."""
    o = np.full((2, 14, len(BAND_KEYS)), -1, np.int32)
    for b in range(16, 30):
        for k, key in enumerate(BAND_KEYS):
            if (b, key) in index:
                off, shape = index[(b, key)]
                o[0, b - 16, k] = off
                o[1, b - 16, k] = shape[0] if len(shape) == 2 else 1
    return o.reshape(-1)


def taumol_tables(device="cuda"):
    pack, index = pack_taumol_tables()
    return TaumolTables(torch.as_tensor(pack, device=device),
                        torch.as_tensor(taumol_offsets(index), device=device),
                        index)


def solar_source_tables(svw=None):
    """Per-band solar-source tables (numpy float32), the NRLSSI2 weights
    svw (nrlssi2.SolarVarWeights, or None for sfluxref alone) folded in
    exactly as the reference folds them."""
    t = sw_tables()
    out = {}
    for b in range(16, 30):
        bi = b - 16
        if svw is None:
            out[b] = np.asarray(t[b]["sfluxref"])
        else:
            out[b] = np.asarray(
                svw.w_ref[bi] * t[b]["sfluxref"]
                + svw.w_fac[bi] * t[b]["facbrght"]
                + svw.w_sns[bi] * t[b]["snsptdrk"]
                + svw.w_irr[bi] * t[b]["irradnce"], np.float32)
    return out


def _eta(col1, col2, strrat, mult):
    speccomb = col1 + strrat * col2
    specparm = torch.clamp(col1 / speccomb, max=_ONEMINUS)
    specmult = mult * specparm
    fl = torch.floor(specmult)
    return speccomb, 1 + fl.to(torch.int64), specmult - fl


def _interp_ind(tab, ind, frac):
    t0 = _take(tab, ind - 1)
    return t0 + frac[..., None] * (_take(tab, ind) - t0)


def _laysolfr(c, band):
    """Per-column solar reference layer index (TOA-first, 0-based)."""
    nlay = c.jp.shape[-1]
    idx = torch.arange(nlay, device=c.jp.device)
    cand = c.jp >= LAYREFFR[band]
    has = cand.any(dim=-1)
    kmax = torch.where(cand, idx, -1).amax(dim=-1)
    if band in SOLFR_UPPER:
        return torch.where(has, kmax, 0)
    # lowest layer with jp >= L, clamped into the lower atmosphere;
    # default the topmost lower layer
    k_trop = torch.argmax(c.lower.to(torch.int32), dim=-1)
    return torch.where(has, torch.maximum(kmax, k_trop), k_trop)


def sfluxzen_only(c, sources):
    """Solar source per column, [ncol, 112]. c: SWCoefs of [ncol, nlay]
    fields; sources: per-band tables (solar_source_tables) as float32
    tensors on c's device."""
    parts = []
    for band in range(16, 30):
        tab = sources[band]
        if band not in SFLUX_ETA:
            parts.append(tab.expand(c.jp.shape[:-1] + tab.shape))
            continue
        g1, g2, strrat = SFLUX_ETA[band]
        k = _laysolfr(c, band)[..., None]
        col1 = torch.gather(getattr(c, "col" + g1), -1, k)[..., 0]
        col2 = torch.gather(getattr(c, "col" + g2), -1, k)[..., 0]
        mult = 4.0 if band in SOLFR_UPPER else 8.0
        _, js, fs = _eta(col1, col2, strrat, mult)
        t0 = tab[js - 1]
        t1 = _take(tab, js)
        parts.append(t0 + fs[..., None] * (t1 - t0))
    return torch.cat(parts, dim=-1)


def _band(c, tabs, band):
    """(taug, taur) of one band for flat cells, both regimes evaluated
    and selected by c.lower, as taumol_sw_ref."""
    bi = band - 16
    tab = lambda key: tabs.get(band, key)
    x = lambda v: v[..., None]
    f00, f10, f01, f11 = (x(c.fac00), x(c.fac10), x(c.fac01), x(c.fac11))
    jp, jt, jt1 = c.jp.long(), c.jt.long(), c.jt1.long()
    i0b = ((jp - 1) * 5 + (jt - 1)) * NSPA[bi]
    i1b = (jp * 5 + (jt1 - 1)) * NSPA[bi]
    u0b = (torch.clamp(jp - 13, min=0) * 5 + (jt - 1)) * NSPB[bi]
    u1b = (torch.clamp(jp - 12, min=1) * 5 + (jt1 - 1)) * NSPB[bi]

    def major2(t, sc, js, fs, ind0, ind1, estride):
        fsx = x(fs)
        g = lambda base, off: _take(t, base + off)
        return x(sc) * (
            (1 - fsx) * f00 * g(ind0, 0) + fsx * f00 * g(ind0, 1)
            + (1 - fsx) * f10 * g(ind0, estride)
            + fsx * f10 * g(ind0, estride + 1)
            + (1 - fsx) * f01 * g(ind1, 0) + fsx * f01 * g(ind1, 1)
            + (1 - fsx) * f11 * g(ind1, estride)
            + fsx * f11 * g(ind1, estride + 1))

    def eta_major(key, g1, g2, strrat, mult, estride, base0, base1):
        sc, js, fs = _eta(getattr(c, "col" + g1), getattr(c, "col" + g2),
                          strrat, mult)
        return major2(tab(key), sc, js, fs, base0 + js - 1, base1 + js - 1,
                      estride)

    def sum4(t, ind0, ind1):
        g = lambda i: _take(t, i)
        return f00 * g(ind0) + f10 * g(ind0 + 1) + f01 * g(ind1) \
            + f11 * g(ind1 + 1)

    def major1(key, colgas, ind0, ind1):
        return x(colgas) * sum4(tab(key), ind0, ind1)

    def selffor(include_self=True):
        out = x(c.forfac) * _interp_ind(tab("forref"), c.indfor.long(),
                                        c.forfrac)
        if include_self:
            out = out + x(c.selffac) * _interp_ind(
                tab("selfref"), c.indself.long(), c.selffrac)
        return out

    h2o = x(c.colh2o)
    if band == 24:
        _, js, fs = _eta(c.colh2o, c.colo2, STRRAT[24], 8.0)
        rayla = tab("rayla")
        t0 = rayla[js - 1]
        taur = torch.where(
            x(c.lower),
            x(c.colmol) * (t0 + x(fs) * (_take(rayla, js) - t0)),
            x(c.colmol) * tab("raylb"))
    else:
        taur = x(c.colmol) * tab("rayl")

    if band in (16, 18):
        tlo = eta_major("absa", "h2o", "ch4", STRRAT[band], 8.0, 9, i0b,
                        i1b) + h2o * selffor()
        thi = major1("absb", c.colch4, u0b, u1b)
    elif band in (17, 21):
        tlo = eta_major("absa", "h2o", "co2", STRRAT[band], 8.0, 9, i0b,
                        i1b) + h2o * selffor()
        thi = eta_major("absb", "h2o", "co2", STRRAT[band], 4.0, 5, u0b,
                        u1b) + h2o * selffor(include_self=False)
    elif band == 19:
        tlo = eta_major("absa", "h2o", "co2", STRRAT[19], 8.0, 9, i0b,
                        i1b) + h2o * selffor()
        thi = major1("absb", c.colco2, u0b, u1b)
    elif band == 20:
        ch4 = x(c.colch4) * tab("absch4")
        tlo = h2o * (sum4(tab("absa"), i0b, i1b) + selffor()) + ch4
        thi = h2o * (sum4(tab("absb"), u0b, u1b)
                     + selffor(include_self=False)) + ch4
    elif band == 22:
        o2cont = x(4.35e-4 * c.colo2 / (350.0 * 2.0))
        tlo = eta_major("absa", "h2o", "o2", _O2ADJ * STRRAT[22], 8.0, 9,
                        i0b, i1b) + h2o * selffor() + o2cont
        thi = x(c.colo2 * _O2ADJ) * sum4(tab("absb"), u0b, u1b) + o2cont
    elif band == 23:
        tlo = h2o * (_GIVFAC * sum4(tab("absa"), i0b, i1b) + selffor())
        thi = torch.zeros_like(tlo)
    elif band == 24:
        tlo = eta_major("absa", "h2o", "o2", STRRAT[24], 8.0, 9, i0b, i1b) \
            + h2o * selffor() + x(c.colo3) * tab("abso3a")
        thi = major1("absb", c.colo2, u0b, u1b) \
            + x(c.colo3) * tab("abso3b")
    elif band == 25:
        tlo = h2o * sum4(tab("absa"), i0b, i1b) \
            + x(c.colo3) * tab("abso3a")
        thi = x(c.colo3) * tab("abso3b")
    elif band == 26:
        tlo = thi = torch.zeros_like(taur)
    elif band == 27:
        tlo = major1("absa", c.colo3, i0b, i1b)
        thi = major1("absb", c.colo3, u0b, u1b)
    elif band == 28:
        tlo = eta_major("absa", "o3", "o2", STRRAT[28], 8.0, 9, i0b, i1b)
        thi = eta_major("absb", "o3", "o2", STRRAT[28], 4.0, 5, u0b, u1b)
    else:  # band 29
        tlo = h2o * (sum4(tab("absa"), i0b, i1b) + selffor()) \
            + x(c.colco2) * tab("absco2")
        thi = major1("absb", c.colco2, u0b, u1b) + h2o * tab("absh2o")
    return torch.where(x(c.lower), tlo, thi), taur


def taumol_sw(coefs, tabs, cell_chunk=65536):
    """Gas and Rayleigh optical depths for all 112 g-points (the plain
    twin of kernel K5).

    coefs: SWCoefs of [ncol, nlay] fields; tabs: TaumolTables of the SW
    k-distribution. Cells run in chunks of cell_chunk to bound the
    temporaries. Returns (taug, taur): [ncol, nlay, 112].
    """
    shape = coefs.jp.shape
    n = int(np.prod(shape))
    flat = type(coefs)(*(f.reshape(n) for f in coefs))
    tg, tr = [], []
    for s in range(0, n, cell_chunk):
        c = type(coefs)(*(f[s:s + cell_chunk] for f in flat))
        parts = [_band(c, tabs, b) for b in range(16, 30)]
        tg.append(torch.cat([p[0] for p in parts], dim=-1))
        tr.append(torch.cat([p[1] for p in parts], dim=-1))
    return (torch.cat(tg).reshape(shape + (-1,)),
            torch.cat(tr).reshape(shape + (-1,)))

