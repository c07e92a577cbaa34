"""Lazy loading of the numerical tables (npz artifacts) as numpy arrays.

The port's copy of geosradiation_gridcomp_tpu/tables.py. The artifacts
are data, not code: the port reads the very files of the reference's
`data/` directory by path, without importing that package, so the two
always see the same tables. They are produced once by
tools/extract_fortran_data.py + tools/reduce_rrtmg_g.py from the
reference's Fortran DATA statements.

`on_device` puts a numpy table (or an index array derived from one) on a
device once per value, device and dtype.
"""

import functools
import os

import numpy as np
import torch

DATA_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), *[os.pardir] * 3,
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


def on_device(a, device, dtype=None):
    """The numpy array a (or anything np.asarray takes) as a tensor on
    device, in dtype when given, copied from host memory once per value,
    device and dtype and shared by every later call: a copy from host
    memory synchronises the stream, and a captured graph cannot hold one.
    Callers must not write into the tensor."""
    a = np.asarray(a)
    return _on_device(a.tobytes(), a.dtype.str, a.shape, torch.device(device),
                      dtype)


@functools.lru_cache(maxsize=None)
def _on_device(raw, np_dtype, shape, device, dtype):
    a = np.frombuffer(raw, dtype=np.dtype(np_dtype)).reshape(shape)
    return torch.as_tensor(a.copy(), dtype=dtype, device=device)
