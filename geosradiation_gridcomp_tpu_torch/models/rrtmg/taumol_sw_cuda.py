"""SW gas and Rayleigh optical depths (kernel K5) and its plain twin.

Replaces the TPU kernel geosradiation_gridcomp_tpu/models/rrtmg/
taumol_sw_pallas.py:taumol_sw_pallas with a CUDA kernel (csrc/taumol_sw.cu)
that evaluates the per-band reference engine (taumol_sw_ref) for a tile
of 32 columns at one layer per block, each warp one or two bands and one
lane per column: the band's lower or upper formula, looped over its
g-points, reading the packed k-distribution of TaumolTables; the tile's
rows of both outputs are assembled in shared memory and written as
contiguous 16-byte stores. The kernel reads the per-cell fields in place,
one pointer per field. The solar source stays in plain PyTorch
(taumol_sw.sfluxzen_only).
"""

import ctypes

import numpy as np
import torch

from ...kernels import build
from .taumol_sw import BAND_KEYS, taumol_sw

# per-cell inputs, in the order of the kernel's field pointers
FLOAT_FIELDS = ("fac00", "fac01", "fac10", "fac11", "selffac", "selffrac",
                "forfac", "forfrac", "colh2o", "colco2", "colo3", "colch4",
                "colo2", "colmol")
INT_FIELDS = ("lower", "jp", "jt", "jt1", "indself", "indfor")
N_OFFSETS = 2 * 14 * len(BAND_KEYS)


def launch(lib, coefs, tabs):
    """Allocate the outputs and launch K5 from lib on the fields of coefs
    in place (contiguous; float32, `lower` bool, the indices int32, as
    setcoef_sw gives them); returns (taug, taur) [*cells, 112]. The last
    axis of the cells is the layer (a flat cell axis counts as one
    layer)."""
    shape = coefs.jp.shape
    ncells = int(np.prod(shape))
    nlay = shape[-1] if len(shape) > 1 else 1
    dev = coefs.jp.device
    fields = [getattr(coefs, k) for k in FLOAT_FIELDS + INT_FIELDS]
    ptrs = (ctypes.c_void_p * len(fields))(*[f.data_ptr() for f in fields])
    taug = torch.empty(shape + (112,), dtype=torch.float32, device=dev)
    taur = torch.empty(shape + (112,), dtype=torch.float32, device=dev)
    fn = build.entry(lib, "taumol_sw", 5, 4)
    rc = fn(ctypes.addressof(ptrs), tabs.pack.data_ptr(),
            tabs.offsets.data_ptr(), taug.data_ptr(), taur.data_ptr(),
            len(fields), ncells // nlay, nlay, N_OFFSETS,
            build.stream_of(taug))
    build.check(rc, "taumol_sw")
    return taug, taur


def taumol_sw_fast(coefs, tabs):
    """K5: same contract as taumol_sw.taumol_sw.

    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    """
    if coefs.jp.device.type == "cpu":
        return taumol_sw(coefs, tabs)
    fields = [getattr(coefs, k) for k in FLOAT_FIELDS + INT_FIELDS]
    build.require_cuda("taumol_sw_fast", tabs.pack, tabs.offsets, *fields)
    types = dict.fromkeys(FLOAT_FIELDS, torch.float32)
    types.update(dict.fromkeys(INT_FIELDS, torch.int32), lower=torch.bool)
    for k, x in zip(FLOAT_FIELDS + INT_FIELDS, fields):
        if x.shape != coefs.jp.shape:
            raise ValueError(f"taumol_sw_fast: {k} has shape "
                             f"{tuple(x.shape)}, jp {tuple(coefs.jp.shape)}")
        if x.dtype != types[k]:
            raise TypeError(f"taumol_sw_fast: {k} must be {types[k]}")
    if tabs.offsets.dtype != torch.int32 or tabs.offsets.numel() != N_OFFSETS:
        raise ValueError("taumol_sw_fast: offsets must be int32 "
                         f"[{N_OFFSETS}]")
    out = launch(build.library(), coefs, tabs)
    build.LAUNCHES["taumol_sw"] += 1
    return out
