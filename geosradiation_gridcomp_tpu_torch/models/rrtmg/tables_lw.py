"""RRTMG-LW table assembly: reduced k-tables flattened to gather layout.

The reduced per-band npz (tools/reduce_rrtmg_g.py) stores ka as
(neta, 5, 13, ng) / kb as (neta, 5, 47, ng) in the reference's Fortran
dimension order. The taumol interpolation indexes the EQUIVALENCEd flat
arrays absa(585, ng)/absb(1175, ng) with
ind = ((jp-1)*5 + (jt-1))*nspa + js  (rrtmg_lw_taumol.F90:226-228 etc.),
i.e. column-major flattening over (eta, jt, jp). We reproduce exactly that
layout with an order='F' reshape so the +/-1, +8..+11 eta-straddling offsets
of the 0.125/0.875 special interpolation match the reference bit-for-bit.

The port's copy of geosradiation_gridcomp_tpu/models/rrtmg/tables_lw.py:
lw_tables and lw_gather_tables with their constants, array for array (the
port reads the per-band tables and the stacked continua; the padded TPU
lane layout is not copied).
"""

import functools

import numpy as np

from ...tables import load

NG_LW = [10, 12, 16, 14, 16, 8, 12, 8, 12, 6, 8, 8, 4, 2, 2, 2]
NGS_LW = np.concatenate([[0], np.cumsum(NG_LW)])  # g offsets per band
NGPTLW = 140
NBNDLW = 16
# nspa/nspb from lwdatinit (rrtmg_lw_init.F90:193-195)
NSPA = [1, 1, 9, 9, 9, 1, 9, 1, 9, 1, 1, 9, 9, 1, 9, 9]
NSPB = [1, 1, 5, 5, 5, 0, 1, 1, 1, 1, 1, 0, 0, 1, 0, 0]


def _flat(arr):
    """(eta?, jt, jp, ng) -> (eta*jt*jp, ng) column-major (Fortran flat)."""
    ng = arr.shape[-1]
    return np.reshape(arr, (-1, ng), order="F")


@functools.lru_cache(maxsize=1)
def lw_tables():
    """Returns dict: band index (1-based) -> dict of numpy float32 tables."""
    red = load("rrtmg_lw_reduced")
    ref = load("rrtmg_lw_ref")
    out = {"chi_mls": ref["chi_mls"],           # (7, 59)
           "pref": ref["pref"], "preflog": ref["preflog"],
           "tref": ref["tref"],
           "totplnk": ref["totplnk"],           # (181, 16)
           "totplk16": ref["totplk16"],
           "totplnkderiv": ref["totplnkderiv"],
           "totplk16deriv": ref["totplk16deriv"]}
    for b in range(1, 17):
        p = f"band{b:02d}_"
        d = {}
        for k in red:
            if k.startswith(p):
                d[k[len(p):]] = red[k]
        tabs = {}
        if "ka" in d:
            tabs["absa"] = _flat(d["ka"])
        if "kb" in d:
            tabs["absb"] = _flat(d["kb"])
        for k, v in d.items():
            if k in ("ka", "kb"):
                continue
            tabs[k] = v
        out[b] = tabs
    return out


# ---------------------------------------------------------------------------
# TPU gather layout: one combined major-k table, 4 row-gathers per cell.
#
# The taumol major-species interpolation (rrtmg_lw_taumol.F90, every band's
# ind0/ind1 block) touches, per (column, layer), exactly four (jp', jt')
# table blocks: (jp,jt), (jp,jt+1), (jp+1,jt1), (jp+1,jt1+1). On TPU a
# row-gather costs ~1.4-2.4 cycles per 128-lane tile regardless of width
# (measured), so the fast layout packs EVERY band's eta block for one
# (regime, jp', jt') into a single wide row:
#
#   BIGTAB[row, lane]:
#     row   = 5*(jp-1) + (jt-1)                 for tropospheric (absa) rows
#           = 65 + 5*(jp-13) + (jt-1)           for stratospheric (absb) rows
#     lanes = [e*86 + sp2_offset(band) + g]     9 eta planes x 86 two-key g's
#             [774 + ss_offset(band) + g]       54 single-key g's (no eta)
#
# The troposphere/stratosphere split (laytrop) is folded into the ROW INDEX,
# so lower and upper atmosphere cost one shared gather instead of the 2x
# dense compute of the per-band engine. Stratospheric rows store absb with
# its 5 eta points in planes 0-4 (planes 5-8 zero); single-key-upper bands
# (7, 9, 16) store kb in plane 0 of their sp2 section.
# ---------------------------------------------------------------------------

SP2_BANDS = [3, 4, 5, 7, 9, 12, 13, 15, 16]
SS_BANDS = [1, 2, 6, 8, 10, 11, 14]
SP2_NG = [NG_LW[b - 1] for b in SP2_BANDS]        # sum = 86
SS_NG = [NG_LW[b - 1] for b in SS_BANDS]          # sum = 54
SP2_W = int(np.sum(SP2_NG))
SS_W = int(np.sum(SS_NG))
SP2_OFF = dict(zip(SP2_BANDS, np.concatenate([[0], np.cumsum(SP2_NG)[:-1]])))
SS_OFF = dict(zip(SS_BANDS, np.concatenate([[0], np.cumsum(SS_NG)[:-1]])))
NROW_LOWER = 65            # 13 jp x 5 jt
NROWS = 300                # + 47 jp x 5 jt
BIG_W = 9 * SP2_W + SS_W   # 828

# empirical stratospheric per-g scale tweaks, applied to kb at build time
# (rrtmg_lw_taumol.F90:948-954 band 4, :1323-1329 band 7)
_B4_SCALE = np.ones(14, np.float32)
_B4_SCALE[7:14] = [0.92, 0.88, 1.07, 1.1, 0.99, 0.88, 0.943]
_B7_SCALE = np.ones(12, np.float32)
_B7_SCALE[5:11] = [0.92, 0.88, 1.07, 1.1, 0.99, 0.855]


@functools.lru_cache(maxsize=1)
def lw_gather_tables():
    """Build the combined gather tables (numpy, cached)."""
    t = lw_tables()
    big = np.zeros((NROWS, BIG_W), np.float32)

    def row_lo(jp0, jt0):     # jp0 in [0,13), jt0 in [0,5)
        return 5 * jp0 + jt0

    def row_up(jpu, jt0):     # jpu in [0,47)
        return NROW_LOWER + 5 * jpu + jt0

    for b in SP2_BANDS:
        ng = NG_LW[b - 1]
        off = SP2_OFF[b]
        # absa flat rows are 45*(jp-1)+9*(jt-1)+(js-1): recover the cube
        absa = t[b]["absa"].reshape(13, 5, 9, ng)
        for jp0 in range(13):
            for jt0 in range(5):
                for e in range(9):
                    big[row_lo(jp0, jt0), e * SP2_W + off: e * SP2_W + off + ng] = \
                        absa[jp0, jt0, e]
        if b in (3, 4, 5):     # two-key stratosphere, 5 eta points
            absb = t[b]["absb"].reshape(47, 5, 5, ng)
            scale = _B4_SCALE if b == 4 else np.ones(ng, np.float32)
            for jpu in range(47):
                for jt0 in range(5):
                    for e in range(5):
                        big[row_up(jpu, jt0), e * SP2_W + off: e * SP2_W + off + ng] = \
                            absb[jpu, jt0, e] * scale
        elif b in (7, 9, 16):  # single-key stratosphere in eta plane 0
            absb = t[b]["absb"].reshape(47, 5, ng)
            scale = _B7_SCALE if b == 7 else np.ones(ng, np.float32)
            for jpu in range(47):
                for jt0 in range(5):
                    big[row_up(jpu, jt0), off: off + ng] = \
                        absb[jpu, jt0] * scale
        # bands 12, 13, 15: no stratospheric k contribution -> zeros

    for b in SS_BANDS:
        ng = NG_LW[b - 1]
        off = 9 * SP2_W + SS_OFF[b]
        absa = t[b]["absa"].reshape(13, 5, ng)
        for jp0 in range(13):
            for jt0 in range(5):
                big[row_lo(jp0, jt0), off: off + ng] = absa[jp0, jt0]
        if "absb" in t[b]:     # band 6 has none
            absb = t[b]["absb"].reshape(47, 5, ng)
            for jpu in range(47):
                for jt0 in range(5):
                    big[row_up(jpu, jt0), off: off + ng] = absb[jpu, jt0]

    # self/foreign continua stacked over all bands in g order
    self10 = np.concatenate([t[b]["selfref"] for b in range(1, 17)], axis=1)
    for4 = np.concatenate([t[b]["forref"] for b in range(1, 17)], axis=1)
    return {"big": big, "self10": self10, "for4": for4}
