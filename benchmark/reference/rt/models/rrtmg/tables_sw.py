"""RRTMG-SW table assembly (analog of tables_lw.py).

Flattens the reduced ka/kb tables to the reference's EQUIVALENCE layout for
flat-index gathers (rrtmg_sw_taumol.F90 ind0/ind1 arithmetic).

The port's copy of geosradiation_gridcomp_tpu/models/rrtmg/tables_sw.py:
sw_tables and the per-band constants, array for array (the TPU gather
layout sw_gather_tables is not copied: the port's taumol packs the
per-band tables itself).
"""

import functools

import numpy as np

from ...tables import load

NG_SW = [6, 12, 8, 8, 10, 10, 2, 10, 8, 6, 6, 8, 6, 12]   # bands 16..29
NGS_SW = np.concatenate([[0], np.cumsum(NG_SW)])
NGPTSW = 112
NBNDSW = 14
# nspa/nspb for bands 16..29 (rrtmg_sw_init.F90:198-199)
NSPA = [9, 9, 9, 9, 1, 9, 9, 1, 9, 1, 0, 1, 9, 1]
NSPB = [1, 5, 1, 1, 1, 5, 1, 0, 1, 0, 0, 1, 5, 1]
# key-species ratios strrat (rrtmg_sw_taumol.F90, per band)
STRRAT = {16: 252.131, 17: 0.364641, 18: 38.9589, 19: 5.49281,
          21: 0.0045321, 22: 0.022708, 24: 0.124692, 28: 6.67029e-07}
LAYREFFR = {17: 30, 18: 6, 19: 3, 21: 8, 22: 2, 24: 1, 28: 42}
# bands whose solar-source reference layer is in the lower atmosphere
SOLFR_LOWER = {18, 19, 21, 22, 24}
SOLFR_UPPER = {17, 28}


def _flat(arr):
    ng = arr.shape[-1]
    return np.reshape(arr, (-1, ng), order="F")


@functools.lru_cache(maxsize=1)
def sw_tables():
    red = load("rrtmg_sw_reduced")
    ref = load("rrtmg_sw_ref")
    out = {"pref": ref["pref"], "preflog": ref["preflog"],
           "tref": ref["tref"]}
    for b in range(16, 30):
        p = f"band{b:02d}_"
        d = {k[len(p):]: red[k] for k in red if k.startswith(p)}
        tabs = {}
        if "ka" in d:
            tabs["absa"] = _flat(d["ka"])
        if "kb" in d:
            tabs["absb"] = _flat(d["kb"])
        for k, v in d.items():
            if k not in ("ka", "kb"):
                tabs[k] = v
        out[b] = tabs
    return out
