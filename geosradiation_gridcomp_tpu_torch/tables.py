"""Lazy loading of the numerical tables (npz artifacts) as numpy arrays.

The port's copy of geosradiation_gridcomp_tpu/tables.py. The artifacts
are data, not code: the port reads the very files of the reference's
`data/` directory by path, without importing that package, so the two
always see the same tables. They are produced once by
tools/extract_fortran_data.py + tools/reduce_rrtmg_g.py from the
reference's Fortran DATA statements.
"""

import functools
import os

import numpy as np

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "geosradiation_gridcomp_tpu", "data")


@functools.lru_cache(maxsize=None)
def load(tag: str):
    """Load an npz artifact as a dict of float32 numpy arrays.

    Integer-valued metadata arrays (ngc, ngs, ...) are returned as int32.
    """
    path = os.path.join(DATA_DIR, f"{tag}.npz")
    raw = np.load(path)
    out = {}
    for k in raw.files:
        a = raw[k]
        if k.endswith("__lo") or k in ("ngc", "ngs", "ngm", "ngn", "ngb",
                                       "ng", "nspa", "nspb", "mw", "icxa"):
            out[k] = np.asarray(a, dtype=np.int32)
        else:
            out[k] = np.asarray(a, dtype=np.float32)
    return out


@functools.lru_cache(maxsize=None)
def load64(tag: str):
    """Float64 variant (the NRLSSI2 mean-cycle tables)."""
    path = os.path.join(DATA_DIR, f"{tag}.npz")
    raw = np.load(path)
    return {k: np.asarray(raw[k]) for k in raw.files}
